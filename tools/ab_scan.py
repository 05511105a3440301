#!/usr/bin/env python3
"""Hold this checkout's linear scan kernel against another checkout's, in
one call.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/ab_scan.py OTHER_ROOT

``OTHER_ROOT`` is the root of another checkout of the repository (for
example the parent commit unpacked with ``git archive`` into ``build/``).
Each side's ``src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu`` is
built with the same ``nvcc`` flags, both builds started together, and
called through its C entry points (``bind_linear_scan_{f32,bf16,f16}``,
one signature on both sides; the scratch is sized for this side's, the
larger) on the same inputs:

* at ``chip_smoke.py``'s scan shapes (the reference's, ``LONG_SCANS`` and
  the RG-LRU width (1, 8192, 4096)), in float32, bfloat16 and float16,
  with ``a`` in (0.2, 0.99), at the RG-LRU width also in (0.999, 1], and
  again on views one element into their storage (this side's ``ldg``
  route): the two sides' outputs must be bit for bit equal, and this
  side's must be bit for bit ``ref.linear_scan_chunked``;
* the route this side's launcher takes is printed (a side without
  ``bind_linear_scan_route`` has one way to load);
* at the RG-LRU width each dtype is timed with CUDA events (20 calls after
  3 warm-up calls) in the order other, this, this, other, on aligned
  operands and on the odd-offset views.

The card's name and power limit come first.  Exits non-zero on the first
disagreement.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

from _ab import KERNELS, ROOT, ab, build_all, start
from chip_smoke import FULL_SCAN, LONG_SCANS, SCAN_SHAPES, bits

SUFFIX = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SCAN_ARGS = (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _P)
ROUTE_ARGS = (_I, _P, _P, _I64)


def library(CudaLibrary, side: str, root: Path):
    """The linear scan library of the checkout at ``root``."""
    source = root / KERNELS / "linear_scan" / "csrc" / "linear_scan.cu"
    syms = {f"bind_linear_scan_{s}": SCAN_ARGS for s in SUFFIX.values()}
    if "bind_linear_scan_route" in source.read_text():
        syms["bind_linear_scan_route"] = ROUTE_ARGS
    return CudaLibrary(f"ab_scan_{side}", (source,), (), syms)


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    torch = start("ab_scan")
    if torch is None:
        return 1
    from repro_torch.kernels.linear_scan import kernel, ops, ref
    from repro_torch.kernels._build import CudaLibrary

    other = Path(argv[0]).resolve()
    libs = {side: library(CudaLibrary, side, root)
            for side, root in (("other", other), ("this", ROOT))}
    build_all(list(libs.values()))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def route(side, a, x):
        lib = libs[side]
        if "bind_linear_scan_route" not in lib.symbols:
            return "one loader"
        r = lib.load().bind_linear_scan_route(
            kernel.DTYPE_CODES[a.dtype], a.data_ptr(), x.data_ptr(),
            a.shape[2])
        return ops.ROUTES[r]

    def call(side, dname, a, x, out, scratch):
        b, s, d = a.shape
        libs[side].call(f"bind_linear_scan_{SUFFIX[dname]}", a.data_ptr(),
                        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), b,
                        s, d, kernel.CHUNK, stream)

    def odd(t):
        view = torch.empty(t.numel() + 1, dtype=t.dtype,
                           device=dev)[1:].view(t.shape)
        view.copy_(t)
        return view

    for dname in SUFFIX:
        dt = getattr(torch, dname)
        for shape in (*SCAN_SHAPES, *LONG_SCANS, FULL_SCAN):
            memories = ("forget", "long") if shape == FULL_SCAN else (
                "forget",)
            for memory in memories:
                u = torch.rand(shape, generator=gen, device=dev)
                a = (u * 0.79 + 0.2 if memory == "forget"
                     else 1 - u * 1e-3).to(dt)
                x = torch.randn(shape, generator=gen, device=dev).to(dt)
                scratch = torch.empty(kernel.scratch_words(*shape),
                                      dtype=torch.float32, device=dev)
                exp = ref.linear_scan_chunked(a, x, chunk=kernel.CHUNK)
                for where, (ta, tx) in (("aligned", (a, x)),
                                        ("odd offset", (odd(a), odd(x)))):
                    outs = {s: torch.empty_like(x) for s in libs}
                    for side in libs:
                        call(side, dname, ta, tx, outs[side], scratch)
                    torch.cuda.synchronize()
                    same = torch.equal(bits(torch, outs["this"]),
                                       bits(torch, outs["other"]))
                    chunked = torch.equal(bits(torch, outs["this"]),
                                          bits(torch, exp))
                    print(f"[check] {shape} {dname} a {memory} {where} "
                          f"(route: this {route('this', ta, tx)}): "
                          f"this vs other bitwise "
                          f"{'equal' if same else 'DIFFERENT'}; this vs "
                          f"ref.linear_scan_chunked bitwise "
                          f"{'equal' if chunked else 'DIFFERENT'}")
                    if not (same and chunked):
                        return 1
                del a, x, exp, scratch, outs

    for dname in SUFFIX:
        dt = getattr(torch, dname)
        a = (torch.rand(FULL_SCAN, generator=gen, device=dev) * 0.79
             + 0.2).to(dt)
        x = torch.randn(FULL_SCAN, generator=gen, device=dev).to(dt)
        out = torch.empty_like(x)
        scratch = torch.empty(kernel.scratch_words(*FULL_SCAN),
                              dtype=torch.float32, device=dev)
        for where, (ta, tx) in (("aligned", (a, x)),
                                ("odd offset", (odd(a), odd(x)))):
            ab(torch, f"linear_scan {FULL_SCAN} {dname} {where} (this: "
               f"{route('this', ta, tx)})",
               lambda side, ta=ta, tx=tx: call(side, dname, ta, tx, out,
                                               scratch), 20, 3)
        del a, x, out, scratch
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
