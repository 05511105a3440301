#!/usr/bin/env python3
"""Plant faults in copies of the GEMM's 3xTF32 tile loop (``f32_3xtf32``,
``gemm_tf32.cuh``) and show that ``chip_smoke.py``'s float64 check catches
them.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/gemm_faults.py

For each fault in ``FAULTS`` the GEMM's sources
(``src/repro_torch/kernels/gemm/csrc``) are copied under
``build/gemm_faults/<n>/``, lines of ``gemm_tf32.cuh`` are replaced (each
must occur exactly once), and the copy is built; a copy with no fault is
built the same way as the control, all builds started together.  Each
library runs ``matmul`` and ``matmul_accumulate`` through its float32 C
entry point at ``CASES`` (the 1024^3 leaf, K 8192 and an aligned ragged
shape), unit normals from one seed, and each output is held as
``chip_smoke.py`` holds the route: its largest error against a float64
product at most ``TF32_VS_SIMT`` times that of ``f32_simt`` (the control's
library on copies at an odd offset) on the same values, and within the
GEMM's float32 tolerance (``TOL``) of the plain version.  A fault is
caught when some case fails a check.

Prints each case's ratio for each library.  Exits non-zero when the
control fails a check or a fault is not caught.
"""

from __future__ import annotations

import ctypes
import shutil
import sys

from _ab import KERNELS, ROOT, build_all, start
from chip_smoke import TF32_VS_SIMT, TOL, odd_offset

# (name, lines of gemm_tf32.cuh, their replacements)
FAULTS = (
    # the lo halves zeroed: the product is hi.hi alone (plain TF32)
    ("hi.hi only",
     ("        al[4 * j + i] = __fsub_rn(x[i], hi);",
      "        tf_st(hi + TF_HALF + b_e[e] + 4096 * j, __fsub_rn(x[e], h));"),
     ("        al[4 * j + i] = 0.0f;",
      "        tf_st(hi + TF_HALF + b_e[e] + 4096 * j, 0.0f);")),
    # B's lo half zeroed: hi.lo dropped, lo.hi kept
    ("hi.lo dropped",
     ("        tf_st(hi + TF_HALF + b_e[e] + 4096 * j, __fsub_rn(x[e], h));",),
     ("        tf_st(hi + TF_HALF + b_e[e] + 4096 * j, 0.0f);",)),
    # the three products of every panel in one accumulator that the tensor
    # cores carry over all of K, with no IEEE add of panel sums
    ("one accumulator over all of K",
     ("      wgmma_tf32_n64(lo, &al[4 * j], dh, j > 0);",
      "      wgmma_tf32_n64(lo, &ah[4 * j], dl, 1);",
      "      wgmma_tf32_n64(hh, &ah[4 * j], dh, j > 0);",
      "      acc[i] = __fadd_rn(acc[i], sum);"),
     ("      wgmma_tf32_n64(hh, &al[4 * j], dh, j > 0 || ck > 0);",
      "      wgmma_tf32_n64(hh, &ah[4 * j], dl, 1);",
      "      wgmma_tf32_n64(hh, &ah[4 * j], dh, 1);",
      "      acc[i] = hh[i];")),
)
# (m, k, n): the main path's leaf, a chain_dot's eight levels as one K,
# and an aligned ragged shape
CASES = ((1024, 1024, 1024), (1024, 8192, 1024), (130, 72, 264))
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
GEMM_ARGS = (_P, _P, _P, _P, _I64, _I64, _I64, _I, _P)
ROUTE_ARGS = (_I, _P, _I64, _P, _I64, _I64, _I64, _I64)


def planted(CudaLibrary, index, fault):
    """The GEMM library of a copy of the sources with ``fault`` (``None``:
    the control) planted."""
    copy = ROOT / "build" / "gemm_faults" / str(index)
    if copy.exists():
        shutil.rmtree(copy)
    shutil.copytree(ROOT / KERNELS / "gemm" / "csrc", copy)
    if fault is not None:
        _name, lines, replacements = fault
        path = copy / "gemm_tf32.cuh"
        text = path.read_text()
        for line, replacement in zip(lines, replacements):
            if text.count(line) != 1:
                raise RuntimeError(f"gemm_tf32.cuh: {line!r} occurs "
                                   f"{text.count(line)} times, expected "
                                   f"once")
            text = text.replace(line, replacement)
        path.write_text(text)
    return CudaLibrary(f"gemm_fault_{index}", (copy / "gemm.cu",),
                       tuple(sorted(copy.glob("*.cuh"))),
                       {"bind_gemm_f32": GEMM_ARGS,
                        "bind_gemm_route": ROUTE_ARGS})


def main(argv: list[str]) -> int:
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    torch = start("gemm_faults")
    if torch is None:
        return 1
    from repro_torch.kernels._build import CudaLibrary
    from repro_torch.kernels.gemm.ops import ROUTES

    faults = (None,) + FAULTS
    libs = [planted(CudaLibrary, i, f) for i, f in enumerate(faults)]
    build_all(libs, ("error",))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    control = libs[0]

    def call(lib, a, b, c, out):
        m, k = a.shape
        lib.call("bind_gemm_f32", a.data_ptr(), b.data_ptr(),
                 None if c is None else c.data_ptr(), out.data_ptr(), m,
                 b.shape[1], k, 0, stream)

    def route(lib, a, b):
        m, k = a.shape
        return ROUTES[lib.load().bind_gemm_route(
            0, a.data_ptr(), 0, b.data_ptr(), 0, m, b.shape[1], k)]

    cases = []
    for m, k, n in CASES:
        a = torch.randn((m, k), generator=gen, device=dev)
        b = torch.randn((k, n), generator=gen, device=dev)
        c = torch.randn((m, n), generator=gen, device=dev)
        odd = (odd_offset(a), odd_offset(b))
        if route(control, a, b) != "f32_3xtf32" or \
                route(control, *odd) != "f32_simt":
            raise RuntimeError(f"({m}, {k}, {n}): routes "
                               f"{route(control, a, b)}, "
                               f"{route(control, *odd)}")
        for op, cc in (("matmul", None), ("matmul_accumulate", c)):
            exact = a.double() @ b.double()
            if cc is not None:
                exact += cc.double()
            simt = torch.empty((m, n), device=dev)
            call(control, *odd, cc, simt)
            torch.cuda.synchronize()
            base = (simt.double() - exact).abs().max().item()
            plain = exact.float()
            cases.append((f"{op} ({m}, {k}, {n})", a, b, cc, exact, base,
                          plain))

    rtol, atol = TOL["float32"]
    failed = False
    for fault, lib in zip(faults, libs):
        name = "control" if fault is None else fault[0]
        caught = {"float64": 0, "tolerance": 0}
        worst = 0.0
        for label, a, b, cc, exact, base, plain in cases:
            out = torch.empty(exact.shape, device=dev)
            call(lib, a, b, cc, out)
            torch.cuda.synchronize()
            err = (out.double() - exact).abs().max().item()
            ratio = err / max(base, 1e-30)
            worst = max(worst, ratio)
            far = ratio > TF32_VS_SIMT
            off = not torch.allclose(out, plain, rtol=rtol, atol=atol)
            caught["float64"] += far
            caught["tolerance"] += off
            print(f"[{name}] {label}: against float64 {err:.3e}, f32_simt "
                  f"{base:.3e} ({ratio:.2f} x, limit {TF32_VS_SIMT})"
                  f"{' CAUGHT' if far else ''}; plain version "
                  f"{'outside' if off else 'within'} rtol {rtol} atol "
                  f"{atol}")
        hits = caught["float64"] + caught["tolerance"]
        print(f"[{name}] worst ratio {worst:.2f}; cases failing the float64 "
              f"check {caught['float64']} of {len(cases)}, the tolerance "
              f"{caught['tolerance']}")
        if fault is None and hits:
            print("[control] FAILED: the fault-free copy fails a check")
            failed = True
        elif fault is not None and not caught["float64"]:
            print(f"[{name}] NOT CAUGHT by the float64 check")
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
