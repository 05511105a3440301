"""Probes and payload conversion between NumPy and PyTorch.

``to_torch`` / ``to_numpy`` carry workflow state across the package
boundary: a NumPy array (or anything ``np.asarray`` accepts, such as a
reference-package jax array) becomes a tensor of the same dtype and values,
and back.  NumPy has no bfloat16 of its own: arrays whose dtype is named
``bfloat16`` (the ``ml_dtypes`` type jax uses) are carried bit for bit, and
a bfloat16 tensor comes back as float32, which holds every bfloat16 value
exactly.  A lazy fused-batch row (``core.backends.base.BatchSlice``) comes
back as its row's values.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

# numpy dtype -> torch dtype (bfloat16 is handled by name, see module doc)
NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
TORCH_TO_NP = {v: k for k, v in NP_TO_TORCH.items()}


def cuda_available() -> bool:
    """True when PyTorch sees at least one CUDA device."""
    return torch.cuda.is_available()


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for a numpy dtype (or dtype-like, e.g. ``np.float32``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = np.dtype(dtype)
    if dt.name == "bfloat16":
        return torch.bfloat16
    try:
        return NP_TO_TORCH[dt]
    except KeyError:
        raise TypeError(f"no torch dtype for numpy dtype {dt}") from None


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a tensor of ``dtype`` converts to (bf16 -> float32)."""
    if dtype is torch.bfloat16:
        return np.dtype(np.float32)
    try:
        return TORCH_TO_NP[dtype]
    except KeyError:
        raise TypeError(f"no numpy dtype for torch dtype {dtype}") from None


def to_torch(payload: Any, device="cpu") -> torch.Tensor:
    """A tensor on ``device`` with ``payload``'s dtype and values."""
    if isinstance(payload, torch.Tensor):
        return payload.to(device)
    arr = np.ascontiguousarray(payload)
    if not arr.flags.writeable:     # e.g. a view of a jax array's buffer
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    torch_dtype(arr.dtype)      # raises on dtypes torch cannot hold
    return torch.from_numpy(arr).to(device)


def to_numpy(tensor: Any) -> np.ndarray:
    """A host NumPy array with ``tensor``'s values (see module doc for bf16)."""
    from repro_torch.core.backends.base import BatchSlice

    if type(tensor) is BatchSlice:
        tensor = tensor.materialize()
    if not isinstance(tensor, torch.Tensor):
        return np.asarray(tensor)
    t = tensor.detach().cpu()
    if t.dtype is torch.bfloat16:
        t = t.float()
    return t.numpy()


__all__ = ["NP_TO_TORCH", "TORCH_TO_NP", "cuda_available", "numpy_dtype",
           "to_numpy", "to_torch", "torch_dtype"]
