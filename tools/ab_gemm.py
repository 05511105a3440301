#!/usr/bin/env python3
"""Hold this checkout's GEMM and ``chain_dot`` kernels against another
checkout's, in one call.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/ab_gemm.py OTHER_ROOT

``OTHER_ROOT`` is the root of another checkout of the repository (for
example the parent commit unpacked with ``git archive`` into ``build/``).
Each side's GEMM (``src/repro_torch/kernels/gemm/csrc/gemm.cu``) and chain
kernels (``.../chain/csrc/chain.cu``) are built with the same ``nvcc``
flags, all four builds started together, and called through their C entry
points on the same inputs:

* ``matmul``, ``matmul_accumulate`` and ``chain_dot`` (per-level and
  shared ``a``/``b``) at 1024^3 (x 8 levels for the chain), (130, 70,
  260) (x 3), (1, 128, 1) and (130, 72, 264), a ragged shape the
  tensor-core routes take, and on a view at an odd element offset, which
  they do not; float16 through the GEMM alone (there is no float16 chain
  kernel);
* every output must lie within ``chip_smoke.py``'s tolerance (``TOL``,
  ``atol`` times the levels for the chain) of the plain PyTorch version;
  where both sides take the same route (``f32_simt``, every bfloat16,
  float64 and float16 route) the outputs must be bit for bit equal; where
  this side takes ``f32_3xtf32`` and the other ``f32_simt``, both are held
  to a float64 product and this side's largest error must be at most
  ``TF32_VS_SIMT`` times the other's;
* the route each side's launcher took is printed (a side without
  ``bind_gemm_route`` has one tile loop for every dtype);
* a side whose entry points take an output-type code (``int out_dtype``)
  is asked for the inputs' own type, so its same-dtype output is held
  to the other side's;
* at 1024^3 the three kernels are timed in each dtype with CUDA events (20
  calls after 3 warm-up calls, 5 after 1 for the chain) in the order
  other, this, this, other.

The card's name and power limit come first.  Exits non-zero on the first
disagreement.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

from _ab import KERNELS, ROOT, ab, build_all, start
from chip_smoke import TF32_VS_SIMT

N = 1024
LEVELS = 8
SUFFIX = {"float32": "f32", "bfloat16": "bf16", "float64": "f64"}
# the GEMM's entry points (the chain kernel has no float16 one)
GEMM_SUFFIX = {**SUFFIX, "float16": "f16"}
# bind_gemm_route's element-type codes (a side whose entry point takes the
# element size has the first four routes)
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float64": 2, "float16": 3}
# chip_smoke.py's TOL: kernel vs plain version, (rtol, atol) per dtype
TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-1),
       "float64": (1e-10, 1e-9), "float16": (1e-2, 1e-2)}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
GEMM_ARGS = (_P, _P, _P, _P, _I64, _I64, _I64, _P)
# entry points with the output type's code before the stream
GEMM_OUT_ARGS = (_P, _P, _P, _P, _I64, _I64, _I64, _I, _P)
DOT_ARGS = (_P, _P, _I64, _P, _I64, _P, _I64, _I64, _I64, _I64, _P)
ROUTE_ARGS = (_I, _P, _I64, _P, _I64, _I64, _I64, _I64)


def libraries(CudaLibrary, side: str, root: Path):
    """(gemm, chain) libraries of the checkout at ``root``."""
    gemm_dir = root / KERNELS / "gemm" / "csrc"
    headers = tuple(sorted(gemm_dir.glob("*.cuh"))) + tuple(sorted(
        (root / KERNELS / "flash_attention" / "csrc").glob("*.cuh")))
    source = (gemm_dir / "gemm.cu").read_text()
    out_code = "int out_dtype" in source
    gemm_syms = {f"bind_gemm_{s}": GEMM_OUT_ARGS if out_code else GEMM_ARGS
                 for s in GEMM_SUFFIX.values()}
    if "bind_gemm_route" in source:
        gemm_syms["bind_gemm_route"] = ROUTE_ARGS
    gemm = CudaLibrary(f"ab_gemm_{side}", (gemm_dir / "gemm.cu",), headers,
                       gemm_syms)
    gemm.route_by_size = "int elem_bytes" in source
    gemm.out_code = out_code
    chain = CudaLibrary(
        f"ab_chain_{side}", (root / KERNELS / "chain" / "csrc" / "chain.cu",),
        headers, {f"bind_chain_dot_{s}": DOT_ARGS for s in SUFFIX.values()})
    return gemm, chain


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    torch = start("ab_gemm")
    if torch is None:
        return 1
    from repro_torch.kernels._build import CudaLibrary
    from repro_torch.kernels.gemm.ops import ROUTES

    other = Path(argv[0]).resolve()
    libs = {side: libraries(CudaLibrary, side, root)
            for side, root in (("other", other), ("this", ROOT))}
    build_all([lib for pair in libs.values() for lib in pair])

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rand(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def route(side, dt, a, a_stride, b, b_stride, m, n, k):
        gemm = libs[side][0]
        if "bind_gemm_route" not in gemm.symbols:
            return "one loop"
        code = (a.element_size() if gemm.route_by_size
                else DTYPE_CODES[str(a.dtype)[6:]])
        r = gemm.load().bind_gemm_route(code, a.data_ptr(), a_stride,
                                        b.data_ptr(), b_stride, m, n, k)
        return ROUTES[r]

    def gemm_call(side, dname, a, b, c, out):
        m, k = a.shape
        gemm = libs[side][0]
        code = (DTYPE_CODES[dname],) if gemm.out_code else ()
        gemm.call(f"bind_gemm_{GEMM_SUFFIX[dname]}", a.data_ptr(),
                  b.data_ptr(),
                  None if c is None else c.data_ptr(), out.data_ptr(), m,
                  b.shape[1], k, *code, stream)

    def dot_call(side, dname, c, a, a_stride, b, b_stride, L, out):
        m, n = c.shape
        libs[side][1].call(f"bind_chain_dot_{SUFFIX[dname]}", c.data_ptr(),
                           a.data_ptr(), a_stride, b.data_ptr(), b_stride,
                           out.data_ptr(), m, n, a.shape[-1], L, stream)

    def plain_levels(c, A, B, L, per_level):
        acc = torch.float64 if c.dtype == torch.float64 else torch.float32
        v = c
        for level in range(L):
            a = A[level] if per_level else A
            b = B[level] if per_level else B
            v = (v.to(acc) + a.to(acc) @ b.to(acc)).to(c.dtype)
        return v

    def agree(name, dname, outs, exp, routes, exact=None, levels=1):
        """Both sides within TOL of the plain version ``exp``; bit for bit
        where they take one route, else (this side on f32_3xtf32, the
        other on f32_simt) this side's error against the float64
        ``exact`` at most TF32_VS_SIMT times the other's."""
        torch.cuda.synchronize()
        rtol, atol = TOL[dname]
        ok = all(torch.allclose(x.double(), exp.double(), rtol=rtol,
                                atol=atol * levels) for x in outs.values())
        same = torch.equal(outs["other"], outs["this"])
        err = (outs["this"].double() - exp.double()).abs().max().item()
        if routes["this"] == routes["other"] or exact is None:
            ok = ok and same
            what = "bit for bit"
        else:
            e = {s: (outs[s].double() - exact).abs().max().item()
                 for s in outs}
            ratio = e["this"] / max(e["other"], 1e-30)
            ok = ok and ratio <= TF32_VS_SIMT
            what = (f"against float64 {e['this']:.3e}, the other's "
                    f"{e['other']:.3e} ({ratio:.2f} x, limit "
                    f"{TF32_VS_SIMT})")
        print(f"[check] {name}: this vs other {what}: "
              f"{'ok' if ok else 'FAILED'} (bit for bit: "
              f"{'yes' if same else 'no'}); within rtol {rtol} atol {atol} "
              f"x {levels} of the plain version, this side's max_abs_err "
              f"{err:.3e}")
        return ok

    every = [(N, N, N), (130, 70, 260), (1, 128, 1), (130, 72, 264), "odd"]
    shapes = {"float32": every, "bfloat16": every,
              "float64": [(N, N, N), (130, 70, 260), (1, 128, 1)],
              "float16": every}
    for dname, cases in shapes.items():
        dt = getattr(torch, dname)
        for shape in cases:
            if shape == "odd":
                # contiguous views one element into their storage
                m, k, n = N, N, N
                a = rand((m * k + 1,), dt)[1:].view(m, k)
                b = rand((k * n + 1,), dt)[1:].view(k, n)
            else:
                m, k, n = shape
                a, b = rand((m, k), dt), rand((k, n), dt)
            c = rand((m, n), dt)
            label = f"{shape} {dname}"
            routes = {s: route(s, dt, a, 0, b, 0, m, n, k) for s in libs}
            for op, c_arg in (("matmul", None), ("matmul_accumulate", c)):
                outs = {s: torch.empty((m, n), dtype=dt, device=dev)
                        for s in libs}
                for side in libs:
                    gemm_call(side, dname, a, b, c_arg, outs[side])
                exp = plain_levels(torch.zeros_like(c) if c_arg is None
                                   else c, a, b, 1, False)
                exact = None
                if dname == "float32":
                    exact = a.double() @ b.double()
                    if c_arg is not None:
                        exact += c.double()
                if not agree(f"{op} {label} (routes: this {routes['this']},"
                             f" other {routes['other']})", dname, outs, exp,
                             routes, exact):
                    return 1
            if shape == "odd" or dname not in SUFFIX:
                continue
            L = LEVELS if m == N else 3
            A, B = rand((L, m, k), dt), rand((L, k, n), dt)
            for per_level in (True, False):
                a_arg, b_arg = (A, B) if per_level else (A[0], B[0])
                a_stride = m * k if per_level else 0
                b_stride = k * n if per_level else 0
                r = {s: route(s, dt, a_arg, a_stride, b_arg, b_stride, m, n,
                              k) for s in libs}
                outs = {s: torch.empty((m, n), dtype=dt, device=dev)
                        for s in libs}
                for side in libs:
                    dot_call(side, dname, c, a_arg, a_stride, b_arg,
                             b_stride, L, outs[side])
                exp = plain_levels(c, a_arg, b_arg, L, per_level)
                exact = None
                if dname == "float32":
                    exact = c.double() + (
                        torch.einsum("lmk,lkn->mn", A.double(), B.double())
                        if per_level else L * (A[0].double() @ B[0].double()))
                layout = "xs" if per_level else "single"
                if not agree(f"chain_dot {label} x {L} {layout} (routes: "
                             f"this {r['this']}, other {r['other']})", dname,
                             outs, exp, r, exact, L):
                    return 1

    for dname in SUFFIX:
        dt = getattr(torch, dname)
        a, b, c = rand((N, N), dt), rand((N, N), dt), rand((N, N), dt)
        A, B = rand((LEVELS, N, N), dt), rand((LEVELS, N, N), dt)
        out = torch.empty((N, N), dtype=dt, device=dev)
        calls = {
            "matmul": (lambda side: gemm_call(side, dname, a, b, None, out),
                       20, 3),
            "matmul_accumulate": (
                lambda side: gemm_call(side, dname, a, b, c, out), 20, 3),
            f"chain_dot x {LEVELS}": (
                lambda side: dot_call(side, dname, c, A, N * N, B, N * N,
                                      LEVELS, out), 5, 1),
        }
        for op, (fn, iters, warmup) in calls.items():
            ab(torch, f"{op} {N}^3 {dname}", fn, iters, warmup)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
