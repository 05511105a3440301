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
  they do not; float16 ``matmul`` also written as float32; float16
  ``chain_dot`` only where a side has the entry point (a side without it
  replays float16 chains level by level): a side alone with it is held
  bit for bit to its own GEMM's per-level ``matmul_accumulate`` replay;
* every output must lie within ``chip_smoke.py``'s tolerance (``TOL``,
  ``atol`` times the levels for the chain) of the plain PyTorch version;
  where both sides take the same route the outputs must be bit for bit
  equal; where this side takes a tensor-core route and the other the
  CUDA cores (``f32_3xtf32`` against ``f32_simt``, ``f16_wgmma`` against
  ``f16_simt``), both are held to a float64 product and this side's
  largest error must be at most ``TF32_VS_SIMT`` times the other's
  (``F16_VS_SIMT`` of the output type in float16);
* the route each side's launcher took is printed (a side without
  ``bind_gemm_route`` has one tile loop for every dtype);
* a side whose entry points take an output-type code (``int out_dtype``)
  is asked for the inputs' own type, so its same-dtype output is held
  to the other side's;
* at 1024^3 the three kernels are timed in each dtype with CUDA events (20
  calls after 3 warm-up calls, 5 after 1 for the chain) in the order
  other, this, this, other; float16's ``chain_dot`` where both sides have
  it.

The card's name and power limit come first.  Exits non-zero on the first
disagreement.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

from _ab import KERNELS, ROOT, ab, build_all, start
from chip_smoke import F16_VS_SIMT, TF32_VS_SIMT

N = 1024
LEVELS = 8
# the entry points' suffixes (a side's chain library may lack float16's)
SUFFIX = {"float32": "f32", "bfloat16": "bf16", "float64": "f64",
          "float16": "f16"}
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
                 for s in SUFFIX.values()}
    if "bind_gemm_route" in source:
        gemm_syms["bind_gemm_route"] = ROUTE_ARGS
    gemm = CudaLibrary(f"ab_gemm_{side}", (gemm_dir / "gemm.cu",), headers,
                       gemm_syms)
    gemm.route_by_size = "int elem_bytes" in source
    gemm.out_code = out_code
    chain_cu = root / KERNELS / "chain" / "csrc" / "chain.cu"
    chain_source = chain_cu.read_text()
    chain = CudaLibrary(
        f"ab_chain_{side}", (chain_cu,), headers,
        {f"bind_chain_dot_{s}": DOT_ARGS for s in SUFFIX.values()
         if f"BIND_CHAIN_ENTRY_POINTS({s}," in chain_source})
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
        code = ((DTYPE_CODES[str(out.dtype)[6:]],) if gemm.out_code
                else ())
        gemm.call(f"bind_gemm_{SUFFIX[dname]}", a.data_ptr(),
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

    def has_dot(side, dname):
        return f"bind_chain_dot_{SUFFIX[dname]}" in libs[side][1].symbols

    def agree(name, dname, outs, exp, routes, exact=None, levels=1):
        """Both sides within TOL of the plain version ``exp`` (of the
        output's dtype); bit for bit where they take one route, else (this
        side on a tensor-core route, the other on the CUDA cores) this
        side's error against the float64 ``exact`` at most TF32_VS_SIMT
        (F16_VS_SIMT of the output type) times the other's."""
        torch.cuda.synchronize()
        out_name = str(exp.dtype)[6:]
        rtol, atol = TOL[out_name if dname == "float16" else dname]
        limit = (F16_VS_SIMT[out_name] if dname == "float16"
                 else TF32_VS_SIMT)
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
            ok = ok and ratio <= limit
            what = (f"against float64 {e['this']:.3e}, the other's "
                    f"{e['other']:.3e} ({ratio:.2f} x, limit {limit})")
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
            ops_ = [("matmul", None, dt), ("matmul_accumulate", c, dt)]
            if dname == "float16":
                ops_.append(("matmul -> float32", None, torch.float32))
            for op, c_arg, out_dt in ops_:
                outs = {s: torch.empty((m, n), dtype=out_dt, device=dev)
                        for s in libs}
                for side in libs:
                    gemm_call(side, dname, a, b, c_arg, outs[side])
                exp = plain_levels(torch.zeros_like(c) if c_arg is None
                                   else c, a, b, 1, False).to(out_dt) \
                    if out_dt == dt else a.float() @ b.float()
                exact = None
                if dname in ("float32", "float16"):
                    exact = a.double() @ b.double()
                    if c_arg is not None:
                        exact += c.double()
                if not agree(f"{op} {label} (routes: this {routes['this']},"
                             f" other {routes['other']})", dname, outs, exp,
                             routes, exact):
                    return 1
            if shape == "odd" or not has_dot("this", dname):
                continue
            L = LEVELS if m == N else 3
            A, B = rand((L, m, k), dt), rand((L, k, n), dt)
            for per_level in (True, False):
                a_arg, b_arg = (A, B) if per_level else (A[0], B[0])
                a_stride = m * k if per_level else 0
                b_stride = k * n if per_level else 0
                sides = [s for s in libs if has_dot(s, dname)]
                r = {s: route(s, dt, a_arg, a_stride, b_arg, b_stride, m, n,
                              k) for s in libs}
                outs = {s: torch.empty((m, n), dtype=dt, device=dev)
                        for s in libs}
                for side in sides:
                    dot_call(side, dname, c, a_arg, a_stride, b_arg,
                             b_stride, L, outs[side])
                if "other" not in sides:
                    # the other side replays the chain level by level: hold
                    # this side's chain to its own GEMM's replay instead
                    v = c
                    for level in range(L):
                        nxt = torch.empty_like(c)
                        gemm_call("this", dname,
                                  A[level] if per_level else A[0],
                                  B[level] if per_level else B[0], v, nxt)
                        v = nxt
                    outs["other"] = v
                    r["other"] = r["this"] + " (this side's GEMM replay)"
                exp = plain_levels(c, a_arg, b_arg, L, per_level)
                exact = None
                if dname in ("float32", "float16"):
                    exact = c.double() + (
                        torch.einsum("lmk,lkn->mn", A.double(), B.double())
                        if per_level else L * (A[0].double() @ B[0].double()))
                layout = "xs" if per_level else "single"
                if "other" not in sides:
                    exact = None     # one route: bit for bit
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
        }
        if all(has_dot(side, dname) for side in libs):
            calls[f"chain_dot x {LEVELS}"] = (
                lambda side: dot_call(side, dname, c, A, N * N, B, N * N,
                                      LEVELS, out), 5, 1)
        for op, (fn, iters, warmup) in calls.items():
            ab(torch, f"{op} {N}^3 {dname}", fn, iters, warmup)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
