"""Hand-written Hopper kernels of the port, one package per kernel.

Each package holds the CUDA source (``csrc/``), its build and binding
(``kernel.py``, through the shared :mod:`._build`), the plain PyTorch
version (``ref.py``) and the public wrappers with their launch counters
(``ops.py``).

Launch counters are plain integers on the wrapper functions.  Wrappers
may be called from the thread-pool backend's workers, so every increment
goes through :func:`count_launch`, which holds one lock.
"""

from __future__ import annotations

import threading

_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper, route: str | None = None) -> None:
    """Add one to ``wrapper.launches`` and, for a kernel with routes, to
    ``wrapper.routes[route]`` (thread-safe)."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
        if route is not None:
            wrapper.routes[route] = wrapper.routes.get(route, 0) + 1


# the public wrappers, as the reference's package exports them; imported
# after count_launch, which their modules import from here
from .gemm import matmul, matmul_accumulate  # noqa: E402
from .flash_attention import flash_attention  # noqa: E402
from .linear_scan import linear_scan  # noqa: E402

__all__ = ["count_launch", "flash_attention", "linear_scan", "matmul",
           "matmul_accumulate"]
