"""Probes and payload conversion between NumPy and PyTorch.

``to_torch`` / ``to_numpy`` carry workflow state across the package
boundary: a NumPy array (or anything ``np.asarray`` accepts, such as a
reference-package jax array) becomes a tensor of the same dtype and values,
and back.  NumPy has no bfloat16 of its own: arrays whose dtype is named
``bfloat16`` (the ``ml_dtypes`` type jax uses) are carried bit for bit, and
a bfloat16 tensor comes back as float32, which holds every bfloat16 value
exactly.  A lazy fused-batch row (``core.backends.base.BatchSlice``) comes
back as its row's values.

``jax_operands`` and ``jax_matmul`` evaluate a reference op body's own
expression where the port's kernel does not take the operands: the
reference hands NumPy operands to jax, which (64-bit types off) makes a
32-bit array of them, and promotes mixed dtypes in a matrix product.  A
``jax.Array`` maps to a ``torch.Tensor``: NumPy operands become tensors on
the device of the body's first tensor operand, or on the CPU when there is
none (a NumPy workflow stays on the host).

``shard_map`` and ``axis_size`` are the reference's names for the rank
mesh's SPMD entry points (:mod:`repro_torch.core.spmd`), so code reads as
the reference's does: ``from repro_torch.compat import shard_map``.
"""

from __future__ import annotations

import math
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


# what jax makes of a NumPy operand with 64-bit types off (the reference's
# setting): the 32-bit type of the same kind
_JAX_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32,
                  torch.complex128: torch.complex64}


def jax_operands(*operands) -> list:
    """``operands`` as the reference's jax expression sees them: tensors as
    they are, NumPy arrays as tensors of jax's canonical dtype on the
    device of the first tensor among ``operands`` (the CPU when there is
    none); other values (Python scalars) unchanged."""
    device = next((x.device for x in operands
                   if isinstance(x, torch.Tensor)), torch.device("cpu"))
    out = []
    for x in operands:
        if isinstance(x, np.ndarray):
            t = to_torch(x, device)
            x = t.to(_JAX_CANONICAL.get(t.dtype, t.dtype))
        out.append(x)
    return out


# the largest temporary of an integer matrix product on the card (bytes)
INT_PRODUCT_BYTES = 64 << 20


def jax_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as jax computes it: both operands promoted to one dtype
    first.  The card has no integer matrix product, so there an integer
    one is :func:`int_matmul`."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if a.is_cuda and not (dt.is_floating_point or dt.is_complex):
        return int_matmul(a, b)
    return a @ b


def k_step(a: torch.Tensor, b: torch.Tensor,
           budget: int = INT_PRODUCT_BYTES) -> int:
    """How many of the ``K`` products of ``a @ b`` (``(..., M, K)`` by
    ``(..., K, N)``) :func:`int_matmul` forms at once: as many as fit in
    ``budget`` bytes, at least one."""
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    per_k = (math.prod(batch) * a.shape[-2] * b.shape[-1]
             * a.element_size())
    return max(1, budget // max(per_k, 1))


def int_matmul(a: torch.Tensor, b: torch.Tensor,
               budget: int = INT_PRODUCT_BYTES) -> torch.Tensor:
    """``a @ b`` of two integer tensors of one dtype, at least 2-D, summed
    from their broadcast products in that dtype, wrapping on overflow as
    jax's product does.  The products are formed :func:`k_step` columns of
    ``a`` at a time, so no temporary holds more than ``budget`` bytes (or
    one column's ``M x N`` products, if those are more) and the sum is the
    same modulo the type's range."""
    step = k_step(a, b, budget)
    k = a.shape[-1]
    out = None
    for k0 in range(0, k, step):
        part = (a[..., k0:k0 + step].unsqueeze(-1)
                * b[..., k0:k0 + step, :].unsqueeze(-3)).sum(-2,
                                                            dtype=a.dtype)
        out = part if out is None else out.add_(part)
    if out is None:     # K = 0
        shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        out = a.new_zeros(shape + (a.shape[-2], b.shape[-1]))
    return out


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


# last: importing repro_torch.core (spmd's package) imports this module
from repro_torch.core.spmd import axis_size, shard_map  # noqa: E402

__all__ = ["INT_PRODUCT_BYTES", "NP_TO_TORCH", "TORCH_TO_NP", "axis_size",
           "cuda_available", "int_matmul", "jax_matmul", "jax_operands",
           "k_step", "numpy_dtype", "shard_map", "to_numpy", "to_torch",
           "torch_dtype"]
