#!/usr/bin/env python3
"""Plant faults in copies of the GEMM's tensor-core tile loops and show
that ``chip_smoke.py``'s float64 check catches them: the 3xTF32 loop
(``f32_3xtf32``, ``gemm_tf32.cuh``) in float32 and the 16-bit loop
(``f16_wgmma``, ``gemm_wgmma.cuh``) in float16.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/gemm_faults.py

For each fault in ``FAULTS`` the GEMM's sources
(``src/repro_torch/kernels/gemm/csrc``) are copied under
``build/gemm_faults/<n>/``, lines of the fault's file are replaced (each
must occur exactly once), and the copy is built; a copy with no fault is
built the same way as the control, all builds started together.  Each
library runs ``matmul`` and ``matmul_accumulate`` through the C entry
point of the fault's dtype at ``CASES`` (the 1024^3 leaf, K 8192 and an
aligned ragged shape), unit normals from one seed, and each output is
held as ``chip_smoke.py`` holds the route: its largest error against a
float64 product at most ``TF32_VS_SIMT`` (float32) or
``F16_VS_SIMT["float16"]`` (float16) times that of the CUDA-core route
(the control's library on copies at an odd offset) on the same values,
and within the GEMM's tolerance (``TOL``) of the plain version.  A fault
is caught when some case fails a check.

A fault marked ``informational`` is one no output can show: the tool
then requires its outputs to be the control's bit for bit.  The bf16
tensor map on float16 data is one: TMA copies bytes, and its data type
only sets the element size (2 bytes for both) and the fill of a
non-finite out-of-bounds request, which the maps do not make.

Prints each case's ratio for each library.  Exits non-zero when the
control fails a check, a fault that must be caught is not, or an
informational one changes an output.
"""

from __future__ import annotations

import ctypes
import shutil
import sys

from _ab import KERNELS, ROOT, build_all, start
from chip_smoke import F16_VS_SIMT, TF32_VS_SIMT, TOL, odd_offset

# (name, dtype, file, lines of the file, their replacements, informational)
FAULTS = (
    # the lo halves zeroed: the product is hi.hi alone (plain TF32)
    ("hi.hi only", "float32", "gemm_tf32.cuh",
     ("        al[4 * j + i] = __fsub_rn(x[i], hi);",
      "        tf_st(hi + TF_HALF + b_e[e] + 4096 * j, __fsub_rn(x[e], h));"),
     ("        al[4 * j + i] = 0.0f;",
      "        tf_st(hi + TF_HALF + b_e[e] + 4096 * j, 0.0f);"), False),
    # B's lo half zeroed: hi.lo dropped, lo.hi kept
    ("hi.lo dropped", "float32", "gemm_tf32.cuh",
     ("        tf_st(hi + TF_HALF + b_e[e] + 4096 * j, __fsub_rn(x[e], h));",),
     ("        tf_st(hi + TF_HALF + b_e[e] + 4096 * j, 0.0f);",), False),
    # the three products of every panel in one accumulator that the tensor
    # cores carry over all of K, with no IEEE add of panel sums
    ("one accumulator over all of K", "float32", "gemm_tf32.cuh",
     ("      wgmma_tf32_n64(lo, &al[4 * j], dh, j > 0);",
      "      wgmma_tf32_n64(lo, &ah[4 * j], dl, 1);",
      "      wgmma_tf32_n64(hh, &ah[4 * j], dh, j > 0);",
      "      acc[i] = __fadd_rn(acc[i], sum);"),
     ("      wgmma_tf32_n64(hh, &al[4 * j], dh, j > 0 || ck > 0);",
      "      wgmma_tf32_n64(hh, &ah[4 * j], dl, 1);",
      "      wgmma_tf32_n64(hh, &ah[4 * j], dh, 1);",
      "      acc[i] = hh[i];"), False),
    # float16 operands multiplied as bfloat16 (the instruction's type)
    ("f16 operands read by the .bf16 instruction", "float16",
     "gemm_wgmma.cuh",
     ('  if constexpr (WgElem<T>::F16) BIND_WG_N64("f16"); '
      'else BIND_WG_N64("bf16");',),
     ('  BIND_WG_N64("bf16");',), False),
    # float16 data through a bfloat16 tensor map
    ("bf16 tensor map on f16 data", "float16", "gemm_wgmma.cuh",
     ("  static constexpr CUtensorMapDataType TMA = "
      "CU_TENSOR_MAP_DATA_TYPE_FLOAT16;",),
     ("  static constexpr CUtensorMapDataType TMA = "
      "CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;",), True),
)
# per dtype: the C entry point, its output-type code, the tensor-core
# route, the CUDA-core route (odd-offset copies) and the float64 limit
DTYPES = {"float32": ("bind_gemm_f32", 0, "f32_3xtf32", "f32_simt",
                      TF32_VS_SIMT),
          "float16": ("bind_gemm_f16", 3, "f16_wgmma", "f16_simt",
                      F16_VS_SIMT["float16"])}
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
        _name, _dtype, name, lines, replacements, _info = fault
        path = copy / name
        text = path.read_text()
        for line, replacement in zip(lines, replacements):
            if text.count(line) != 1:
                raise RuntimeError(f"{name}: {line!r} occurs "
                                   f"{text.count(line)} times, expected "
                                   f"once")
            text = text.replace(line, replacement)
        path.write_text(text)
    return CudaLibrary(f"gemm_fault_{index}", (copy / "gemm.cu",),
                       tuple(sorted(copy.glob("*.cuh"))),
                       {"bind_gemm_f32": GEMM_ARGS,
                        "bind_gemm_f16": GEMM_ARGS,
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

    def call(lib, dname, a, b, c, out):
        m, k = a.shape
        symbol, code = DTYPES[dname][:2]
        lib.call(symbol, a.data_ptr(), b.data_ptr(),
                 None if c is None else c.data_ptr(), out.data_ptr(), m,
                 b.shape[1], k, code, stream)

    def route(lib, dname, a, b):
        m, k = a.shape
        return ROUTES[lib.load().bind_gemm_route(
            DTYPES[dname][1], a.data_ptr(), 0, b.data_ptr(), 0, m,
            b.shape[1], k)]

    cases = {dname: [] for dname in DTYPES}
    for dname, (_sym, _code, tc, simt_route, _limit) in DTYPES.items():
        dt = getattr(torch, dname)
        for m, k, n in CASES:
            a = torch.randn((m, k), generator=gen, device=dev).to(dt)
            b = torch.randn((k, n), generator=gen, device=dev).to(dt)
            c = torch.randn((m, n), generator=gen, device=dev).to(dt)
            odd = (odd_offset(a), odd_offset(b))
            if route(control, dname, a, b) != tc or \
                    route(control, dname, *odd) != simt_route:
                raise RuntimeError(f"({m}, {k}, {n}) {dname}: routes "
                                   f"{route(control, dname, a, b)}, "
                                   f"{route(control, dname, *odd)}")
            for op, cc in (("matmul", None), ("matmul_accumulate", c)):
                exact = a.double() @ b.double()
                if cc is not None:
                    exact += cc.double()
                simt = torch.empty((m, n), dtype=dt, device=dev)
                call(control, dname, *odd, cc, simt)
                torch.cuda.synchronize()
                base = (simt.double() - exact).abs().max().item()
                # the plain version: the float32 sum rounded once
                plain = exact.float().to(dt)
                cases[dname].append((f"{op} ({m}, {k}, {n}) {dname}", a, b,
                                     cc, exact, base, plain))

    failed = False
    outputs = {}
    for index, (fault, lib) in enumerate(zip(faults, libs)):
        name = "control" if fault is None else fault[0]
        dnames = list(DTYPES) if fault is None else [fault[1]]
        caught = {"float64": 0, "tolerance": 0}
        worst = 0.0
        changed = 0
        n_cases = 0
        for dname in dnames:
            rtol, atol = TOL[dname]
            limit = DTYPES[dname][4]
            for label, a, b, cc, exact, base, plain in cases[dname]:
                out = torch.empty(exact.shape, dtype=a.dtype, device=dev)
                call(lib, dname, a, b, cc, out)
                torch.cuda.synchronize()
                if fault is None:
                    outputs[label] = out
                else:
                    changed += not torch.equal(out, outputs[label])
                n_cases += 1
                err = (out.double() - exact).abs().max().item()
                ratio = err / max(base, 1e-30)
                worst = max(worst, ratio)
                far = not ratio <= limit
                off = not torch.allclose(out.float(), plain.float(),
                                         rtol=rtol, atol=atol)
                caught["float64"] += far
                caught["tolerance"] += off
                print(f"[{name}] {label}: against float64 {err:.3e}, "
                      f"{DTYPES[dname][3]} {base:.3e} ({ratio:.2f} x, limit "
                      f"{limit}){' CAUGHT' if far else ''}; plain version "
                      f"{'outside' if off else 'within'} rtol {rtol} atol "
                      f"{atol}")
        hits = caught["float64"] + caught["tolerance"]
        print(f"[{name}] worst ratio {worst:.2f}; cases failing the float64 "
              f"check {caught['float64']} of {n_cases}, the tolerance "
              f"{caught['tolerance']}"
              + ("" if fault is None else
                 f"; {changed} of {n_cases} outputs differ from the "
                 f"control's"))
        if fault is None:
            if hits:
                print("[control] FAILED: the fault-free copy fails a check")
                failed = True
        elif fault[5]:
            if hits or changed:
                print(f"[{name}] FAILED: informational, expected the "
                      f"control's bits")
                failed = True
            else:
                print(f"[{name}] informational: the control's bits, as "
                      f"expected")
        elif not caught["float64"]:
            print(f"[{name}] NOT CAUGHT by the float64 check")
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
