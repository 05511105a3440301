#!/usr/bin/env python3
"""Time this checkout's GEMM kernel against another checkout's, in one call.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/ab_gemm.py OTHER_ROOT

``OTHER_ROOT`` is the root of another checkout of the repository (for
example the parent commit unpacked with ``git archive`` into ``build/``).
Both ``src/repro_torch/kernels/gemm/csrc/gemm.cu`` files are built with the
same ``nvcc`` flags (the two builds started together) and called through
their C entry points on the same inputs.  For ``matmul`` and
``matmul_accumulate`` at 1024^3 in float32, bfloat16 and float64 the
script checks that the two outputs are bit for bit equal, then times the
kernels with CUDA events (20 calls after 3 warm-up calls) in the order
other, this, this, other, and prints each time and the means of each
side.  The card's name and power limit come first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GEMM_CSRC = Path("src/repro_torch/kernels/gemm/csrc")
N = 1024
SYMBOLS = {"float32": "bind_gemm_f32", "bfloat16": "bind_gemm_bf16",
           "float64": "bind_gemm_f64"}
ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("ab_gemm: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import CudaLibrary

    other = Path(argv[0]).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[env] nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False

    libs = {}
    for side, root in (("other", other), ("this", ROOT)):
        csrc = root / GEMM_CSRC
        libs[side] = CudaLibrary(
            f"ab_gemm_{side}", (csrc / "gemm.cu",),
            tuple(sorted(csrc.glob("*.cuh"))),
            {sym: ARGTYPES for sym in SYMBOLS.values()})
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for dname, sym in SYMBOLS.items():
        dt = getattr(torch, dname)
        a, b, c = (torch.randn((N, N), generator=gen, device=dev).to(dt)
                   for _ in range(3))
        for op, c_arg in (("matmul", None), ("matmul_accumulate", c)):
            outs = {}

            def call(side, out):
                libs[side].call(sym, a.data_ptr(), b.data_ptr(),
                                c_arg.data_ptr() if c_arg is not None
                                else None, out.data_ptr(), N, N, N, stream)

            for side in libs:
                outs[side] = torch.empty((N, N), dtype=dt, device=dev)
                call(side, outs[side])
            torch.cuda.synchronize()
            if not torch.equal(outs["other"], outs["this"]):
                print(f"ab_gemm: {op} {dname}: the two kernels' outputs "
                      f"differ", file=sys.stderr)
                return 1
            times = []
            for side in ("other", "this", "this", "other"):
                times.append((side, time_ms(
                    torch, lambda side=side: call(side, outs[side]))))
            mean = {s: sum(t for x, t in times if x == s) / 2 for s in libs}
            order = ", ".join(f"{s} {t:.4f}" for s, t in times)
            print(f"[ab] {op} {N}^3 {dname}: outputs bitwise equal; ms in "
                  f"order {order}; mean other {mean['other']:.4f} ms, this "
                  f"{mean['this']:.4f} ms ({mean['this'] / mean['other']:.3f}"
                  f"x)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
