"""Plain PyTorch version of the GEMM kernel.

The product is taken in the accumulator type — float32 for float32 and
bfloat16 inputs, float64 for float64 — and cast back, as the kernel does.
The tests use it, ``chip_smoke.py`` holds the kernel against it on the card,
and :mod:`.ops` uses it for CPU tensors only.
"""

from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator type of the kernel for inputs of ``dtype``."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = acc_dtype(a.dtype)
    return (a.to(acc) @ b.to(acc)).to(a.dtype)


def matmul_accumulate(c: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    acc = acc_dtype(a.dtype)
    return (c.to(acc) + a.to(acc) @ b.to(acc)).to(c.dtype)
