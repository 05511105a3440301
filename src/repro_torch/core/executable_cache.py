"""Executable cache — resolve an op signature once, replay forever.

The dominant pattern in tiled linalg workflows is thousands of ops sharing a
handful of *signatures* ``(fn, abstract shapes, dtypes)``: every leaf GEMM of
a Strassen recursion, every per-tile ``iadd``.  The cache resolves each
signature to the callable that executes it exactly once and memoises the
decision, with hit/miss counters for observability.

PyTorch runs eagerly, so every signature resolves to the op's Python body:
a body called on CUDA tensors launches its kernels as it runs (the GEMM
leaves go through :mod:`repro_torch.kernels.gemm.ops`).  ``compiles`` and
``fallbacks`` therefore stay 0; they are kept so the counters read like the
reference's.  NumPy payloads never become tensors (which could move them
off the host or change their dtype): a NumPy signature stays a NumPy
signature.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def _abstract(arg: Any):
    """Abstract signature component of one payload.

    A tensor is keyed on ``(shape, dtype, device)``, a NumPy array on
    ``(shape, dtype, None)``, other objects with a shape and dtype (NumPy
    scalars) likewise, and anything else on its type.
    """
    t = type(arg)
    if t is np.ndarray:
        return (arg.shape, arg.dtype, None)
    if isinstance(arg, torch.Tensor):
        return (arg.shape, arg.dtype, arg.device)
    shape = getattr(arg, "shape", None)
    dtype = getattr(arg, "dtype", None)
    if shape is not None and dtype is not None:
        return (shape, dtype, None)
    return t


MAX_ENTRIES = 1024


class ExecutableCache:
    """Signature-keyed executable store with hit/miss counters.

    Bounded: past ``MAX_ENTRIES`` signatures the table is reset (entries pin
    op functions; a reset only costs re-resolution, and hot signatures
    repopulate immediately).
    """

    __slots__ = ("_entries", "hits", "misses", "compiles", "fallbacks")

    def __init__(self):
        self._entries: dict[tuple, Callable] = {}
        self.hits = 0
        self.misses = 0
        self.compiles = 0      # always 0: nothing is compiled per signature
        self.fallbacks = 0     # always 0: nothing can fail to compile

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self.hits = self.misses = self.compiles = self.fallbacks = 0

    def signature(self, fn: Callable, args) -> tuple:
        return (fn,) + tuple(_abstract(a) for a in args)

    def lookup(self, fn: Callable, args) -> Callable:
        """Resolve ``fn`` for these payloads; O(1) dict hit on replay."""
        key = self.signature(fn, args)
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            return entry
        self.misses += 1
        if len(self._entries) >= MAX_ENTRIES:
            self._entries.clear()
        self._entries[key] = fn
        return fn


# Process-wide cache: signatures are shared across executors and workflows.
EXEC_CACHE = ExecutableCache()
