"""Hand-written Hopper kernels of the port, one package per kernel.

Each package holds the CUDA source (``csrc/``), its build and binding
(``kernel.py``, through the shared :mod:`._build`), the plain PyTorch
version (``ref.py``) and the public wrappers with their launch counters
(``ops.py``).

Every public entry point copies a strided operand of a kernel dtype into
a row-major one (:func:`row_major`) before its checks, so it takes any
view the reference's wrapper takes.

Launch counters are plain integers on the wrapper functions.  Wrappers
may be called from the thread-pool backend's workers, so every increment
goes through :func:`count_launch`, which holds one lock.  A tensor op
body that computes its reference expression instead of launching its
kernel counts that call in ``calls`` on the body function
(:func:`count_body`), so a run can show that no op took that path.  A
call on ``meta`` tensors launches nothing and adds the operations it
stands for to ``meta_flops`` on its entry point (:func:`count_meta`).
"""

from __future__ import annotations

import threading

import torch
from torch._C._functorch import is_batchedtensor

_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper, route: str | None = None) -> None:
    """Add one to ``wrapper.launches`` and, for a kernel with routes, to
    ``wrapper.routes[route]`` (thread-safe)."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
        if route is not None:
            wrapper.routes[route] = wrapper.routes.get(route, 0) + 1


def count_meta(wrapper, flops: int) -> None:
    """Add ``flops`` to ``wrapper.meta_flops``: the operations a call on
    ``meta`` tensors (a dry run, which launches nothing) stands for
    (thread-safe)."""
    with _LAUNCH_LOCK:
        wrapper.meta_flops += flops


def count_body(body) -> None:
    """Add one to ``body.calls`` (thread-safe)."""
    with _LAUNCH_LOCK:
        body.calls += 1


def row_major(dtypes, *operands) -> tuple:
    """``operands`` with every tensor of one of ``dtypes`` that is not
    contiguous, of any rank, copied into a contiguous one (a kernel reads
    row-major operands); every other operand as it is.  A contiguous view
    at any offset stays as it is."""
    return tuple(
        x.contiguous() if (isinstance(x, torch.Tensor)
                           and not is_batchedtensor(x)
                           and x.dtype in dtypes and not x.is_contiguous())
        else x for x in operands)


# the public wrappers, as the reference's package exports them; imported
# after count_launch, which their modules import from here
from .gemm import matmul, matmul_accumulate  # noqa: E402
from .flash_attention import flash_attention  # noqa: E402
from .linear_scan import linear_scan  # noqa: E402

__all__ = ["count_body", "count_launch", "flash_attention", "linear_scan",
           "matmul", "matmul_accumulate", "row_major"]
