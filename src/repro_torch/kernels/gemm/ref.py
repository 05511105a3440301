"""Plain PyTorch version of the GEMM kernel.

The product is taken in the accumulator type — float32 for float32,
bfloat16 and float16 inputs, float64 for float64 — and rounded once to
the output type (the inputs' unless ``matmul``'s ``out_dtype`` names
another), as the kernel does.  torch's own float64 -> bfloat16 / float16
cast goes through float32 and rounds twice, so that one pair takes
``round_once``.
The tests use it, ``chip_smoke.py`` holds the kernel against it on the card,
and :mod:`.ops` uses it for CPU tensors only.
"""

from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator type of the kernel for inputs of ``dtype``."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def round_once(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` with one rounding to nearest even.

    A float64 ``x`` bound for bfloat16 or float16 goes to float32 by
    round-to-odd (truncated, its last bit set where that lost anything),
    then to nearest even: float32 keeps more than two bits beyond either
    narrow type's, so the two steps round as one (Boldo and Melquiond,
    "When double rounding is odd").  Any other pair is torch's cast."""
    if x.dtype != torch.float64 or dtype not in (torch.bfloat16,
                                                 torch.float16):
        return x.to(dtype)
    f = x.to(torch.float32)
    back = f.to(torch.float64)
    inexact = back != x
    bits = f.view(torch.int32)
    # where rounding went away from zero, one step back toward it
    bits = torch.where(inexact & (back.abs() > x.abs()), bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return bits.view(torch.float32).to(dtype)


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a @ b`` in the accumulator type of ``a``'s dtype, rounded once to
    ``out_dtype`` (default ``a``'s dtype)."""
    acc = acc_dtype(a.dtype)
    return round_once(a.to(acc) @ b.to(acc), out_dtype or a.dtype)


def matmul_accumulate(c: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    acc = acc_dtype(a.dtype)
    return (c.to(acc) + a.to(acc) @ b.to(acc)).to(c.dtype)
