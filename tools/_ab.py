"""What the kernel tools of ``tools/`` share: the card's name and power
limit, building several CUDA libraries at once, and timing two checkouts'
kernels in the order other, this, this, other.

The tools import it as ``from _ab import ...``; running a tool as a script
puts ``tools/`` first on ``sys.path``.  Nothing here imports ``torch`` or
the port at import time: each tool first checks for a card.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = Path("src/repro_torch/kernels")
sys.path.insert(0, str(ROOT))
from chip_smoke import gpu_name_and_power, graph_ms, time_ms  # noqa: E402

SIDES = ("other", "this", "this", "other")


def start(tool: str):
    """``torch`` with a CUDA card, the port importable and TF32 off, after
    printing the card's name and power limit; ``None`` (with a message)
    when there is no card."""
    import torch

    if not torch.cuda.is_available():
        print(f"{tool}: torch.cuda.is_available() is false", file=sys.stderr)
        return None
    sys.path.insert(0, str(ROOT / "src"))
    print(f"[env] nvidia-smi: {gpu_name_and_power()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch


def build_all(libraries, words=("registers", "spill", "error")) -> list:
    """Build ``libraries`` (``CudaLibrary``), one ``nvcc`` each, all
    started together; print each library's name and the compiler lines
    that hold one of ``words``; load them.  Returns the built paths."""
    with ThreadPoolExecutor(len(libraries)) as pool:
        built = list(pool.map(lambda lib: lib.build(), libraries))
    for path, log in built:
        print(f"[build] {path.name}")
        for line in log.splitlines():
            if any(w in line for w in words):
                print(f"[build]   {line.strip()}")
    for lib in libraries:
        lib.load()
    return [path for path, _log in built]


def ab(torch, name: str, fn, iters: int, warmup: int,
       graph: bool = False) -> None:
    """Time ``fn(side)`` with CUDA events in the order other, this, this,
    other and print the four times and each side's mean; with ``graph``,
    ``iters`` calls captured in a CUDA graph (``chip_smoke.graph_ms``: the
    device time of kernels shorter than their host work)."""
    if graph:
        times = [(side, graph_ms(torch, lambda side=side: fn(side), iters))
                 for side in SIDES]
    else:
        times = [(side, time_ms(torch, lambda side=side: fn(side), iters,
                                warmup))
                 for side in SIDES]
    mean = {s: sum(t for x, t in times if x == s) / 2 for s in SIDES[:2]}
    order = ", ".join(f"{s} {t:.4f}" for s, t in times)
    print(f"[ab] {name}: ms in order {order}; mean other "
          f"{mean['other']:.4f} ms, this {mean['this']:.4f} ms "
          f"({mean['this'] / mean['other']:.3f}x)")
