#!/usr/bin/env python3
"""Hold this checkout's flash-attention and ``chain_attn`` kernels against
another checkout's, in one call.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/ab_attn.py OTHER_ROOT

``OTHER_ROOT`` is the root of another checkout of the repository (for
example the parent commit unpacked with ``git archive`` into ``build/``).
Each side's flash attention
(``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``) and
chain kernels (``.../chain/csrc/chain.cu``) are built with the same
``nvcc`` flags, all four builds started together, and called through their
C entry points on the same inputs:

* flash attention in float32 at the reference's cases (``ATTN_CASES`` of
  ``chip_smoke.py``), h2o-danube-1.8b's head dim 80 and full
  RecurrentGemma-9B, Qwen3-14B and Gemma-7B width, and again at head dims
  32, 64, 80, 96, 128 and 256 and at ``MID_ATTN`` at d 64, 80, 128 and
  256: where this side
  takes ``f32_simt``, bit for bit equal on the two sides; where both take
  ``f32_3xtf32``, bit for bit equal too; where this side takes
  ``f32_3xtf32`` and the other ``f32_simt`` (an older side's float32 at a
  head dim its 3xTF32 loop did not take), each side within the
  reference's float32 tolerance (2e-5) of the oracle, and this side's
  largest error against a float64 computation at most ``TF32_VS_SIMT``
  times the other side's, per slice of 8 heads; where this side has
  ``bind_flash_attention_f32_lse``, its output on every ``f32_3xtf32``
  case bit for bit its own ``bind_flash_attention_f32`` output and its
  log-sum-exp within ``LSE_TOL`` of ``ref.attention_lse``'s;
* flash attention in bfloat16 at the same cases with the head dim raised
  to 64 and 128, at ``chip_smoke.py``'s ``MID_ATTN`` cases (many key tiles
  per query tile) at every head dim of ``MID_HEAD_DIMS`` (64, 80, 96, 128,
  192, 256), at h2o-danube's d 80 and at full width: each side within the
  reference's bf16 tolerance (3e-2) of the oracle on the padded inputs
  and within ``chip_smoke.py``'s limits scaled to each value against the
  float32 oracle (``half_attention_error``), and a row that sees no key
  exactly zero; where both sides take ``bf16_wgmma``, this side's output
  bit for bit the other's; the route each side takes is printed (a side
  without ``bind_flash_attention_route`` has one loop);
* where this side has ``bind_flash_attention_bf16_lse`` (the forward
  that hands the backward each row's log-sum-exp), its output on every
  bf16 case that takes ``bf16_wgmma`` bit for bit its own
  ``bind_flash_attention_bf16`` output, and its log-sum-exp within
  ``LSE_TOL`` of the plain version's (``ref.attention_lse`` in float32 on
  the same inputs; +inf on exactly the rows that see no key) and, where
  the other side has the entry point and takes ``bf16_wgmma`` too, bit for
  bit the other side's;
* flash attention in float16 (since the ``f16_wgmma`` route: the
  bfloat16 loop instantiated for f16) at the reference's cases at d 64
  and 128, at ``MID_ATTN`` at every head dim of ``MID_HEAD_DIMS``, at
  h2o-danube's d 80 and at ``FULL_ATTN_F16``'s full widths: each side
  within ``ATTN_TOL["float16"]`` (1e-2) of the oracle and within
  ``chip_smoke.py``'s float16 limits (``HALF_LIMITS``), where both sides
  take one route (``f16_simt``, or ``f16_wgmma`` on both) bit for bit the
  other's, and ``bind_flash_attention_f16_lse`` held as the bf16 one is;
  this side's ``f16_wgmma`` against an older side's ``f16_simt`` on the
  same values;
* the attention backward (``.../flash_attention/csrc/
  flash_attention_bwd.cu``, where the other side has one) in float32 and
  bfloat16 at the reference's cases at d 64 and 128, at ``MID_ATTN``
  (float32 at d 64, 128 and 256, bfloat16 at ``MID_HEAD_DIMS``) and at
  ``chip_smoke.py``'s ``BWD_SHAPES``, float32 also at d 32, 80, 96 and
  256: on
  the CUDA-core routes (``f32_simt``, ``bf16_simt``: the
  ``bind_flash_attention_bwd_{f32,bf16}`` entry points) bit for bit the
  other side's; where this side's ``bind_flash_attention_bwd_route``
  gives ``f32_3xtf32``, that route, given this side's log-sum-exp, within
  ``BWD_F32_NRMS`` rms per head slice of the plain version, at most
  ``TF32_VS_SIMT`` times this side's ``f32_simt`` error against a float64
  gradient per slice of 8 heads, two calls bit for bit, and bit for bit
  the other side's where it takes ``f32_3xtf32`` too; and, where it gives
  ``bf16_wgmma``, that route,
  given this side's log-sum-exp, within ``chip_smoke.py``'s
  ``BF16_SLICE_NRMS`` rms per head slice of the plain version
  (``ref.attention_grad`` in float32) and, where the other side takes
  ``bf16_wgmma`` too, dq, dk and dv bit for bit the other side's on the
  same inputs and log-sum-exp (where it does not, as the parent of the
  d 80 / 96 routes does not, held to the plain version only); float16
  the same way, on ``f16_simt`` (bit for bit the other side's) and on
  ``f16_wgmma`` (within ``F16_SLICE_NRMS``, 2^-10), at the reference's
  cases at d 64 and 128, ``MID_ATTN`` at ``MID_HEAD_DIMS`` and
  ``BWD_SHAPES``' float16 shapes;
* ``chain_attn`` in float32, bfloat16, float64 and float16 (where the
  other side has it) at ``chip_smoke.py``'s two shapes (a 512-row
  Qwen3-14B tile x 16 levels of 512 keys, and a ragged (100, 70, d 40, dv
  24) x 3) in its three layouts, each side called with what its entry
  point takes (a workspace and row-tile counters; since the tensor-core
  routes also the chunks of a level's keys, from this checkout's
  ``kernel.attn_chunks``, and a workspace and counters sized by its
  rules), each side's route printed (``bind_chain_route_attn``; a side
  without it has the CUDA-core loop alone): where both sides take one
  route, bit for bit equal; where this side takes a tensor-core route and
  the other the CUDA-core loop, this side within ``chip_smoke.py``'s TOL
  times the levels of the plain version and its largest error against a
  float64 computation at most ``TF32_VS_SIMT`` (float32) or
  ``CHAIN_HALF_VS_SIMT`` (bfloat16, float16) times the other side's; and
  on copies of the same values one element into their storage, which
  every side's CUDA-core loop takes, bit for bit equal;
* the kernels are timed with CUDA events in the order other, this, this,
  other: flash attention at both full widths in both dtypes and at
  ``FAMILY_ATTN``'s shapes whose head dim is no multiple of 64
  (Phi-3-vision's d 96, h2o-danube's d 80) in bf16, each side on the
  route it takes, and the float32 training forward at ``FAMILY_F32_ATTN``
  (h2o-danube-1.8b's FSDP step shape); the backward at ``BWD_SHAPES`` and
  those two shapes (each side's tensor-core route where it takes one with
  the forward's log-sum-exp, else its CUDA-core entry point); and
  ``chain_attn`` at the 512-row tile x 16 levels in float32, bfloat16 and
  float16 and one float32 level (each side on the route it takes, and on
  the odd-offset copies on the CUDA-core loop), device time from CUDA
  graphs (a level's kernel takes less time than the wrapper's host
  work).

The card's name and power limit come first.  Exits non-zero on the first
disagreement.
"""

from __future__ import annotations

import ctypes
import re
import sys
from pathlib import Path

from _ab import KERNELS, ROOT, ab, build_all, start
from chip_smoke import (ATTN_CASES, ATTN_TOL, BWD_SHAPES, BWD_F32_NRMS,
                        CHAIN_HALF_VS_SIMT, FAMILY_ATTN, FAMILY_F32_ATTN,
                        chain_attn64,
                        FULL_ATTN, FULL_ATTN_F16, HALF_LIMITS, MID_ATTN,
                        MID_HEAD_DIMS, ODD_ATTN, TF32_VS_SIMT, TOL,
                        attention64, attention_grad64, half_attention_error,
                        half_within, odd_offset, slice_nrms, tf32_vs_simt)

# the routes in the order of flash_attention.cu's Route enum; a side whose
# bind_flash_attention_route takes the element size has the first three
ROUTES = ("f32_simt", "bf16_simt", "bf16_wgmma", "f32_3xtf32", "f16_simt",
          "f16_wgmma")
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}
F32_TOL = ATTN_TOL["float32"]
# the 16-bit dtypes' tensor-core routes, forward and backward
WGMMA = {"bfloat16": "bf16_wgmma", "float16": "f16_wgmma"}
CHAIN_SHAPES = ((512, 512, 128, 128, 16), (100, 70, 40, 24, 3))
CHAIN_LAYOUTS = (("single", "single", "xs", "xs"),
                 ("single", "xs", "xs", "xs"),
                 ("single", "single", "single", "single"))
FA_SUFFIX = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}
CHAIN_SUFFIX = {"float32": "f32", "bfloat16": "bf16", "float64": "f64",
                "float16": "f16"}
_P, _I, _I64, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_double)
FA_ARGS = (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _D, _I, _I,
           _I64, _P)
FA_ROUTE_ARGS = (_I, _P, _P, _P, _P, _I64)
LSE_SYMBOL = "bind_flash_attention_bf16_lse"
F32_LSE_SYMBOL = "bind_flash_attention_f32_lse"
LSE_SYMBOLS = {"bfloat16": LSE_SYMBOL, "float32": F32_LSE_SYMBOL,
               "float16": "bind_flash_attention_f16_lse"}
FA_LSE_ARGS = FA_ARGS[:4] + (_P,) + FA_ARGS[4:]
BWD_ARGS = (_P,) * 10 + (_I64,) * 6 + (_D, _I, _I, _I64, _P)
BWD_LSE_SYMBOL = "bind_flash_attention_bwd_bf16_lse"
BWD_F16_LSE_SYMBOL = "bind_flash_attention_bwd_f16_lse"
BWD_HALF_SYMBOLS = {"bfloat16": BWD_LSE_SYMBOL,
                    "float16": BWD_F16_LSE_SYMBOL}
BWD_LSE_ARGS = (_P,) * 11 + (_I64,) * 6 + (_D, _I, _I, _I64, _I64, _P)
BWD_F32_LSE_SYMBOL = "bind_flash_attention_bwd_f32_lse"
# the backward's route: (element-type code, d, q, k, v, out, dout, lse),
# an index of BWD_ROUTES
BWD_ROUTE_SYMBOL = "bind_flash_attention_bwd_route"
BWD_ROUTE_ARGS = (_I, _I64) + (_P,) * 6
BWD_ROUTES = ("f32_simt", "bf16_simt", "f16_simt", "bf16_wgmma",
              "f32_3xtf32", "f16_wgmma")
# the log-sum-exp against the plain version's in float32 on the same bf16
# inputs: the same f32 scores summed in another order, one MUFU ex2 a key
# (a few float32 ulps of values up to ~10)
LSE_TOL = 1e-5
# bind_chain_attn_*: with (work, done) after out and the chunks after the
# levels (the tensor-core routes), with (work, done) alone, or without
CHAIN_ARGS = {"chunks": (_P, _P, _I64, _P, _I64, _P, _I64, _P, _P, _P, _I64,
                         _I64, _I64, _I64, _I64, _I64, _D, _P),
              "work": (_P, _P, _I64, _P, _I64, _P, _I64, _P, _P, _P, _I64,
                       _I64, _I64, _I64, _I64, _D, _P),
              "plain": (_P, _P, _I64, _P, _I64, _P, _I64, _P, _I64, _I64,
                        _I64, _I64, _I64, _D, _P)}
# chain_attn's route: (element-type code, q, q_stride, k, k_stride, v,
# v_stride, N, d, dv, n_levels), an index of this checkout's ATTN_ROUTES
CHAIN_ROUTE_SYMBOL = "bind_chain_route_attn"
CHAIN_ROUTE_ARGS = (_I, _P, _I64, _P, _I64, _P, _I64, _I64, _I64, _I64,
                    _I64)
CHAIN_DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float64": 2,
                     "float16": 3}


def libraries(CudaLibrary, side: str, root: Path):
    """(flash attention, chain) libraries of the checkout at ``root``,
    whether its ``chain_attn`` takes a workspace, and its attention
    backward's library (None where it has none)."""
    fa_dir = root / KERNELS / "flash_attention" / "csrc"
    headers = tuple(sorted((root / KERNELS / "gemm" / "csrc").glob("*.cuh"))
                    + sorted(fa_dir.glob("*.cuh")))
    source = (fa_dir / "flash_attention.cu").read_text()
    fa_syms = {f"bind_flash_attention_{s}": FA_ARGS
               for s in FA_SUFFIX.values()}
    if "bind_flash_attention_route" in source:
        fa_syms["bind_flash_attention_route"] = FA_ROUTE_ARGS
    for sym in LSE_SYMBOLS.values():
        if sym in source:
            fa_syms[sym] = FA_LSE_ARGS
    bwd = None
    bwd_cu = fa_dir / "flash_attention_bwd.cu"
    if bwd_cu.is_file():
        bwd_syms = {f"bind_flash_attention_bwd_{s}": BWD_ARGS
                    for s in FA_SUFFIX.values()}
        for sym in BWD_HALF_SYMBOLS.values():
            if sym in bwd_cu.read_text():
                bwd_syms[sym] = BWD_LSE_ARGS
        f32_groups = False
        if BWD_F32_LSE_SYMBOL in bwd_cu.read_text():
            # an entry point that takes d 256's head groups and partials
            entry = re.search(r"int bind_flash_attention_bwd_f32_lse\((.*?)\)",
                              bwd_cu.read_text(), re.S).group(1)
            f32_groups = "groups" in entry
            bwd_syms[BWD_F32_LSE_SYMBOL] = (BWD_LSE_ARGS if f32_groups
                                            else BWD_ARGS)
        if BWD_ROUTE_SYMBOL in bwd_cu.read_text():
            bwd_syms[BWD_ROUTE_SYMBOL] = BWD_ROUTE_ARGS
        bwd = CudaLibrary(f"ab_fa_bwd_{side}", (bwd_cu,), headers, bwd_syms)
        bwd.f32_groups = f32_groups
    fa = CudaLibrary(f"ab_fa_{side}", (fa_dir / "flash_attention.cu",),
                     headers, fa_syms)
    # how its route entry point names the element type
    fa.route_by_size = "int elem_bytes" in source
    chain_cu = root / KERNELS / "chain" / "csrc" / "chain.cu"
    chain_src = chain_cu.read_text()
    # what the entry point takes: the level-parallel kernel's names its
    # workspace, the tensor-core routes' also the chunks
    entry = re.search(r"int bind_chain_attn_##SUFFIX\((.*?)\)", chain_src,
                      re.S).group(1)
    kind = ("chunks" if "chunks" in entry else
            "work" if "work" in entry else "plain")
    has_f16 = "BIND_CHAIN_ENTRY_POINTS(f16" in chain_src
    chain_syms = {f"bind_chain_attn_{s}": CHAIN_ARGS[kind]
                  for d, s in CHAIN_SUFFIX.items()
                  if d != "float16" or has_f16}
    if CHAIN_ROUTE_SYMBOL in chain_src:
        chain_syms[CHAIN_ROUTE_SYMBOL] = CHAIN_ROUTE_ARGS
    # chain.cu and, where the side has them, the translation units of
    # chain_attn's tensor-core kernels
    chain = CudaLibrary(
        f"ab_chain_{side}",
        (chain_cu,) + tuple(sorted(set(chain_cu.parent.glob("*.cu"))
                                   - {chain_cu})),
        headers + tuple(sorted(chain_cu.parent.glob("*.cuh"))), chain_syms)
    return fa, chain, kind, bwd


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    torch = start("ab_attn")
    if torch is None:
        return 1
    from repro_torch.kernels._build import CudaLibrary
    from repro_torch.kernels.chain import ref as chain_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    other = Path(argv[0]).resolve()
    libs = {side: libraries(CudaLibrary, side, root)
            for side, root in (("other", other), ("this", ROOT))}
    build_all([lib for sides in libs.values() for lib in sides
               if isinstance(lib, CudaLibrary)],
              ("registers", "spill", "error", "wgmma"))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rand(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def fa_route(side, q, k, v, out):
        fa = libs[side][0]
        if "bind_flash_attention_route" not in fa.symbols:
            return "one loop"
        code = (q.element_size() if fa.route_by_size
                else DTYPE_CODES[str(q.dtype)[6:]])
        r = fa.load().bind_flash_attention_route(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.shape[3])
        return ROUTES[r]

    def fa_call(side, q, k, v, out, causal, window):
        b, hq, sq, d = q.shape
        libs[side][0].call(
            f"bind_flash_attention_{FA_SUFFIX[str(q.dtype)[6:]]}",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            k.shape[1], sq, k.shape[2], d, d ** -0.5, int(causal),
            int(window is not None), 0 if window is None else window, stream)

    def fa_case(label, shape, dname, blk):
        b, hq, hkv, sq, skv, d, causal, window = shape
        dt = getattr(torch, dname)
        q = rand((b, hq, sq, d), dt)
        k, v = rand((b, hkv, skv, d), dt), rand((b, hkv, skv, d), dt)
        q, k, v = fa_ops.pad(q, k, v, causal=causal, window=window, bq=blk,
                             bkv=blk)
        outs = {s: torch.empty_like(q) for s in libs}
        routes = {s: fa_route(s, q, k, v, outs[s]) for s in libs}
        for side in libs:
            fa_call(side, q, k, v, outs[side], causal, window)
        torch.cuda.synchronize()
        exp = fa_ref.attention(q, k, v, causal=causal, window=window)
        seen = fa_ref.mask(q.shape[2], k.shape[2], causal=causal,
                           window=window, device=dev)
        blind = ~seen.any(dim=-1)
        both_wgmma = (routes["this"] == routes["other"]
                      and routes["this"] in WGMMA.values())
        lse_ok, lse_what = True, ""
        if both_wgmma:
            lse_ok = torch.equal(outs["this"], outs["other"])
            lse_what = (f"; both {routes['this']}: out bit for bit the "
                        f"other's")
        if (routes["this"] in ("bf16_wgmma", "f16_wgmma", "f32_3xtf32")
                and LSE_SYMBOLS[dname] in libs["this"][0].symbols):
            out, lse = lse_call("this", q, k, v, causal, window)
            _, want = fa_ref.attention_lse(q.float(), k.float(), v.float(),
                                           causal=causal, window=window)
            fin = torch.isfinite(want)
            lerr = ((lse[fin] - want[fin]).abs().max().item()
                    if fin.any() else 0.0)
            lse_ok = (lse_ok and torch.equal(out, outs["this"])
                      and torch.equal(torch.isinf(lse), ~fin)
                      and bool((lse[~fin] > 0).all()) and lerr <= LSE_TOL)
            lse_what += (f"; with the log-sum-exp: out bit for bit the "
                         f"entry point's without it, lse within {lerr:.2e} "
                         f"(<= {LSE_TOL}), +inf on the {int((~fin).sum())} "
                         f"blind rows")
            if ((both_wgmma or routes["other"] == routes["this"])
                    and LSE_SYMBOLS[dname] in libs["other"][0].symbols):
                out2, lse2 = lse_call("other", q, k, v, causal, window)
                lse_ok = (lse_ok and torch.equal(out, out2)
                          and torch.equal(lse, lse2))
                lse_what += ", out and lse bit for bit the other's"
                del out2, lse2
        name = (f"flash_attention {label}{(b, hq, hkv, sq, skv, d)} causal "
                f"{causal} window {window} {dname} (routes: this "
                f"{routes['this']}, other {routes['other']})")
        if dname == "float32" and (routes["this"] != "f32_3xtf32"
                                   or routes["other"] == "f32_3xtf32"):
            ok = torch.equal(outs["this"], outs["other"])
            what = f"both {routes['this']}: this vs other bitwise equal"
        elif dname == "float32":
            # no bits to match across routes: both to the oracle, and this
            # side to float64 beside the other's CUDA-core loop
            ok = all(torch.allclose(outs[s], exp, rtol=F32_TOL,
                                    atol=F32_TOL) for s in libs)
            worst = 0.0
            if routes["other"] == "f32_simt":
                for h0 in range(0, hq, 8):
                    heads = range(h0, min(hq, h0 + 8))
                    e64 = attention64(torch, fa_ref, q, k, v, causal,
                                      window, heads)
                    e = {s: (outs[s][:, h0:h0 + 8].double() - e64).abs()
                         .max().item() for s in libs}
                    ratio = e["this"] / max(e["other"], 1e-30)
                    worst = max(worst, ratio)
                    ok = ok and ratio <= TF32_VS_SIMT
                    del e64
            what = (f"both sides within {F32_TOL} of the oracle; this side's "
                    f"float64 error at most {worst:.2f} x the other's "
                    f"(limit {TF32_VS_SIMT})")
        else:
            tol = ATTN_TOL[dname]      # the reference's, rtol = atol
            exp32 = fa_ref.attention(q.float(), k.float(), v.float(),
                                     causal=causal, window=window)
            stats = {s: half_attention_error(outs[s], exp32, v)
                     for s in libs}
            ok = all(torch.allclose(outs[s].float(), exp.float(),
                                    rtol=tol, atol=tol)
                     and half_within(stats[s], dname) for s in libs)
            ok = ok and not outs["this"][:, :, blind].any().item()
            what = (f"both sides within {tol} of the oracle and within "
                    f"the {dname} limits (this: element "
                    f"{stats['this']['element']:.3f}, slice "
                    f"{stats['this']['slice']:.2e}, row "
                    f"{stats['this']['row']:.2e}; other: slice "
                    f"{stats['other']['slice']:.2e}), {int(blind.sum())} "
                    f"blind rows zero")
            if routes["this"] == routes["other"]:
                same = torch.equal(outs["this"], outs["other"])
                ok = ok and same
                what += (f"; both {routes['this']}: this vs other bitwise "
                         f"equal: {same}")
        err = (outs["this"].double() - exp.double()).abs().max().item()
        ok = ok and lse_ok
        print(f"[check] {name}: {what}{lse_what}: {'ok' if ok else 'FAILED'}"
              f"; this vs oracle max_abs_err {err:.3e}")
        return ok

    def lse_call(side, q, k, v, causal, window):
        """The side's forward of q's dtype with each row's log-sum-exp."""
        b, hq, sq, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
        libs[side][0].call(
            LSE_SYMBOLS[str(q.dtype)[6:]], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, hq, k.shape[1], sq,
            k.shape[2], d, d ** -0.5, int(causal), int(window is not None),
            0 if window is None else window, stream)
        return out, lse

    def bwd_call(side, q, k, v, out, dout, causal, window):
        """The side's CUDA-core backward of q's dtype."""
        b, hq, sq, d = q.shape
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
        delta = torch.empty_like(lse)
        libs[side][3].call(
            f"bind_flash_attention_bwd_{FA_SUFFIX[str(q.dtype)[6:]]}",
            *(t.data_ptr() for t in (q, k, v, out, dout, *grads, lse,
                                     delta)),
            b, hq, k.shape[1], sq, k.shape[2], d, d ** -0.5, int(causal),
            int(window is not None), 0 if window is None else window,
            stream)
        return grads

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def bwd_wgmma_call(side, q, k, v, out, dout, lse, causal, window):
        """The side's bf16 or f16 backward on the tensor cores."""
        b, hq, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
        groups = fa_kernel.dkv_groups(hq, hkv, b, skv, sms)
        part = (torch.empty((2, b, groups, hkv, skv, d), dtype=torch.float32,
                            device=dev) if groups > 1 else None)
        libs[side][3].call(
            BWD_HALF_SYMBOLS[str(q.dtype)[6:]],
            *(t.data_ptr() for t in (q, k, v, out, dout, *grads, lse,
                                     delta)),
            None if part is None else part.data_ptr(), b, hq, hkv, sq, skv,
            d, d ** -0.5, int(causal), int(window is not None),
            0 if window is None else window, groups, stream)
        return grads

    def bwd_route(side, q, k, v, out, dout, lse):
        """The route the side's backward takes on these operands, given
        the log-sum-exp ``lse`` (None: a side without the route entry
        point)."""
        bwd = libs[side][3]
        if BWD_ROUTE_SYMBOL not in bwd.symbols:
            return None
        r = bwd.load().bind_flash_attention_bwd_route(
            DTYPE_CODES[str(q.dtype)[6:]], q.shape[3],
            *(t.data_ptr() for t in (q, k, v, out, dout, lse)))
        return BWD_ROUTES[r]

    def wgmma_bwd(side, q, k, v, out, dout):
        """Whether the side's backward takes its 16-bit tensor-core route
        (bf16_wgmma, f16_wgmma) on these operands with the forward's
        log-sum-exp."""
        dname = str(q.dtype)[6:]
        if (dname not in WGMMA
                or BWD_HALF_SYMBOLS[dname] not in libs[side][3].symbols):
            return False
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
        return bwd_route(side, q, k, v, out, dout, lse) == WGMMA[dname]

    def tf32_bwd(side, q, k, v, out, dout):
        """Whether the side's backward takes f32_3xtf32 on these operands
        with the forward's log-sum-exp."""
        if (str(q.dtype) != "torch.float32"
                or BWD_F32_LSE_SYMBOL not in libs[side][3].symbols):
            return False
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
        return bwd_route(side, q, k, v, out, dout, lse) == "f32_3xtf32"

    def bwd_tf32_call(side, q, k, v, out, dout, lse, causal, window):
        """The side's float32 backward on the tensor cores (3xTF32), with
        this checkout's head groups at d 256 where its entry point takes
        them."""
        b, hq, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in (q, k, v, out, dout, *grads, lse,
                                       delta)]
        mask = (int(causal), int(window is not None),
                0 if window is None else window)
        if not libs[side][3].f32_groups:
            libs[side][3].call(BWD_F32_LSE_SYMBOL, *ptrs, b, hq, hkv, sq,
                               skv, d, d ** -0.5, *mask, stream)
            return grads
        groups = (fa_kernel.dkv_groups(hq, hkv, b, skv, sms,
                                       fa_kernel.BWD_TF32_KEY_BLOCK)
                  if d > 128 else 1)
        part = (torch.empty((2, b, groups, hkv, skv, d), dtype=torch.float32,
                            device=dev) if groups > 1 else None)
        libs[side][3].call(BWD_F32_LSE_SYMBOL, *ptrs,
                           None if part is None else part.data_ptr(), b, hq,
                           hkv, sq, skv, d, d ** -0.5, *mask, groups, stream)
        return grads

    def bwd_case(label, shape, dname, blk):
        b, hq, hkv, sq, skv, d, causal, window = shape
        dt = getattr(torch, dname)
        q = rand((b, hq, sq, d), dt)
        k, v = rand((b, hkv, skv, d), dt), rand((b, hkv, skv, d), dt)
        q, k, v = fa_ops.pad(q, k, v, causal=causal, window=window, bq=blk,
                             bkv=blk)
        dout = rand(q.shape, dt)
        out = torch.empty_like(q)
        fa_call("this", q, k, v, out, causal, window)
        got = {side: bwd_call(side, q, k, v, out, dout, causal, window)
               for side in libs}
        torch.cuda.synchronize()
        ok = all(torch.equal(a, c) for a, c in zip(got["this"],
                                                   got["other"]))
        what = f"{FA_SUFFIX[dname]}_simt this vs other bitwise equal"
        simt = got["this"]
        del got
        if tf32_bwd("this", q, k, v, out, dout):
            out, lse = lse_call("this", q, k, v, causal, window)
            grads = bwd_tf32_call("this", q, k, v, out, dout, lse, causal,
                                  window)
            again = bwd_tf32_call("this", q, k, v, out, dout, lse, causal,
                                  window)
            exp = fa_ref.attention_grad(q, k, v, dout, causal=causal,
                                        window=window)
            exp64 = attention_grad64(torch, fa_ref, q, k, v, dout, causal,
                                     window)
            nrms = max(slice_nrms(g, e) for g, e in zip(grads, exp))
            vs = max(tf32_vs_simt(g, s_, x)
                     for g, s_, x in zip(grads, simt, exp64))
            twice = all(torch.equal(a, c) for a, c in zip(grads, again))
            ok = ok and nrms <= BWD_F32_NRMS and vs <= TF32_VS_SIMT and twice
            what += (f"; f32_3xtf32 within {nrms:.2e} rms per head slice of "
                     f"the plain version (<= {BWD_F32_NRMS:.0e}), "
                     f"{vs:.2f} x f32_simt's float64 error (limit "
                     f"{TF32_VS_SIMT}), two calls bit for bit: {twice}")
            if tf32_bwd("other", q, k, v, out, dout):
                other = bwd_tf32_call("other", q, k, v, out, dout, lse,
                                      causal, window)
                torch.cuda.synchronize()
                same = all(torch.equal(a, c) for a, c in zip(grads, other))
                ok = ok and same
                what += f", bit for bit the other side's f32_3xtf32: {same}"
                del other
            else:
                what += " (the other side's float32 route is the CUDA cores)"
            del grads, again, exp, exp64
        del simt
        if wgmma_bwd("this", q, k, v, out, dout):
            out, lse = lse_call("this", q, k, v, causal, window)
            grads = bwd_wgmma_call("this", q, k, v, out, dout, lse, causal,
                                   window)
            exp = fa_ref.attention_grad(q.float(), k.float(), v.float(),
                                        dout.float(), causal=causal,
                                        window=window)
            nrms = max(slice_nrms(g, e) for g, e in zip(grads, exp))
            limit = HALF_LIMITS[dname][2]
            ok = ok and nrms <= limit
            what += (f"; {WGMMA[dname]} within {nrms:.2e} rms per head "
                     f"slice of the plain version (<= {limit:.2e})")
            if wgmma_bwd("other", q, k, v, out, dout):
                other = bwd_wgmma_call("other", q, k, v, out, dout, lse,
                                       causal, window)
                torch.cuda.synchronize()
                same = all(torch.equal(a, c) for a, c in zip(grads, other))
                ok = ok and same
                what += (f", dq, dk, dv bit for bit the other side's "
                         f"{WGMMA[dname]}: {same}")
                del other
            else:
                what += (f" (the other side's {dname} route is the CUDA "
                         f"cores)")
        print(f"[check] flash_attention_bwd {label}{(b, hq, hkv, sq, skv, d)}"
              f" causal {causal} window {window} {dname}: {what}: "
              f"{'ok' if ok else 'FAILED'}")
        return ok

    cases = [("", case, "float32", 16) for case in ATTN_CASES]
    for d in (64, 128):
        for dname in ("float32", "bfloat16", "float16"):
            cases += [("", case[:5] + (d,) + case[6:], dname, 16)
                      for case in ATTN_CASES]
            # Sq > Skv under causal + window: rows past Skv + window see no
            # key
            cases.append(("", (1, 2, 2, 64, 32, d, True, 8), dname, 16))
    # float32 at every head dim of the 3xTF32 loop (d 256 on its own
    # blocks)
    for d in (32, 80, 96, 256):
        cases += [("", case[:5] + (d,) + case[6:], "float32", 16)
                  for case in ATTN_CASES]
        cases.append(("", (1, 2, 2, 64, 32, d, True, 8), "float32", 16))
    for d in (64, 80, 128, 256):
        cases += [("mid ", (b, hq, hkv, sq, skv, d, causal, window),
                   "float32", blk)
                  for b, hq, hkv, sq, skv, causal, window, blk in MID_ATTN]
    for d in MID_HEAD_DIMS:
        cases += [("mid ", (b, hq, hkv, sq, skv, d, causal, window),
                   dname, blk)
                  for b, hq, hkv, sq, skv, causal, window, blk in MID_ATTN
                  for dname in ("bfloat16", "float16")]
    for dname in ("float32", "bfloat16", "float16"):
        for model, (b, hq, hkv, s, d, window) in (ODD_ATTN,
                                                  *FULL_ATTN.items()):
            if dname == "float16" and model not in (ODD_ATTN[0],
                                                    *FULL_ATTN_F16):
                continue
            cases.append((f"{model} ", (b, hq, hkv, s, s, d, True, window),
                          dname, 512))
    for label, shape, dname, blk in cases:
        if not fa_case(label, shape, dname, blk):
            return 1
    if libs["this"][3] is not None and libs["other"][3] is not None:
        bwd_cases = [("", case[:5] + (d,) + case[6:], "float32", 16)
                     for d in (32, 80, 96, 256) for case in ATTN_CASES]
        bwd_cases += [("mid ", (b, hq, hkv, sq, skv, 256, causal, window),
                       "float32", blk)
                      for b, hq, hkv, sq, skv, causal, window, blk
                      in MID_ATTN]
        for d in (64, 128):
            for dname in ("float32", "bfloat16", "float16"):
                bwd_cases += [("", case[:5] + (d,) + case[6:], dname, 16)
                              for case in ATTN_CASES]
                bwd_cases.append(("", (1, 2, 2, 64, 32, d, True, 8), dname,
                                  16))
            bwd_cases += [("mid ", (b, hq, hkv, sq, skv, d, causal, window),
                           "float32", blk)
                          for b, hq, hkv, sq, skv, causal, window, blk
                          in MID_ATTN]
        for d in MID_HEAD_DIMS:
            bwd_cases += [("mid ", (b, hq, hkv, sq, skv, d, causal, window),
                           dname, blk)
                          for b, hq, hkv, sq, skv, causal, window, blk
                          in MID_ATTN for dname in ("bfloat16", "float16")]
        for model, (b, hq, hkv, s, d, window, dnames) in BWD_SHAPES.items():
            bwd_cases += [(f"{model} ", (b, hq, hkv, s, s, d, True, window),
                           dname, 512) for dname in dnames]
        for label, shape, dname, blk in bwd_cases:
            if not bwd_case(label, shape, dname, blk):
                return 1

    from repro_torch.kernels.chain import kernel as chain_kernel
    from repro_torch.kernels.chain import ops as chain_ops

    def chain_route(side, dname, q, qs, k, ks, v, vs, L):
        """The route the side's library takes (``f32_simt`` and the like
        for a side without the route entry point: its one loop)."""
        lib = libs[side][1]
        if CHAIN_ROUTE_SYMBOL not in lib.symbols:
            return f"{CHAIN_SUFFIX[dname]}_simt"
        n, d = k.shape[-2:]
        r = getattr(lib.load(), CHAIN_ROUTE_SYMBOL)(
            CHAIN_DTYPE_CODES[dname], q.data_ptr(), qs, k.data_ptr(), ks,
            v.data_ptr(), vs, n, d, v.shape[-1], L)
        return chain_ops.ATTN_ROUTES[r]

    def chain_call(side, dname, layout, L, o, q, k, v, out):
        """One launch of the side's chain_attn entry point into ``out``,
        with the workspace, counters and chunks its entry point takes."""
        m, dv = o.shape
        n, d = k.shape[-2:]
        qs, ks, vs = (t[0].numel() if lay == "xs" else 0
                      for lay, t in zip(layout[1:], (q, k, v)))
        kind = libs[side][2]
        args = [o.data_ptr(), q.data_ptr(), qs, k.data_ptr(), ks,
                v.data_ptr(), vs, out.data_ptr()]
        tail = []
        if kind == "chunks":
            route = chain_route(side, dname, q, qs, k, ks, v, vs, L)
            tc = route in chain_kernel.TC_ROUTES
            chunks = chain_kernel.attn_chunks(route, m, n, d)
            acc = 4 if tc or dname != "float64" else 8
            work = torch.empty(chain_kernel.level_bytes(
                m, dv, o.dtype, chunks if tc else None) * L // acc,
                dtype=torch.float32 if acc == 4 else torch.float64,
                device=dev)
            args += [work.data_ptr(), done[side].data_ptr()]
            tail = [chunks]
        elif kind == "work":
            acc = torch.float64 if dname == "float64" else torch.float32
            work = torch.empty((L, m, dv), dtype=acc, device=dev)
            args += [work.data_ptr(), done[side].data_ptr()]
        # the stream current at the call (a CUDA graph's capture stream
        # when timed)
        libs[side][1].call(f"bind_chain_attn_{CHAIN_SUFFIX[dname]}", *args,
                           m, n, d, dv, L, *tail, 1.0 / float(d) ** 0.5,
                           torch.cuda.current_stream(dev).cuda_stream)

    done = {s: torch.zeros(1 << 16, dtype=torch.int32, device=dev)
            for s in libs}

    def chain_operands(layout, m, n, d, dv, L, dt):
        shapes = ((m, dv), (m, d), (n, d), (n, dv))
        return tuple(rand(((L,) if lay == "xs" else ()) + shape, dt)
                     for lay, shape in zip(layout, shapes))

    chain_dtypes = [d for d in CHAIN_SUFFIX
                    if all(f"bind_chain_attn_{CHAIN_SUFFIX[d]}"
                           in libs[s][1].symbols for s in libs)]
    for dname in chain_dtypes:
        dt = getattr(torch, dname)
        for m, n, d, dv, L in CHAIN_SHAPES:
            for layout in CHAIN_LAYOUTS:
                args = chain_operands(layout, m, n, d, dv, L, dt)
                odd = (args[0],) + tuple(odd_offset(t) for t in args[1:])
                exp = chain_ref.chain_attn(layout, 0, L, *args)
                for label, ops_ in (("", args), (" one element in", odd)):
                    routes = {}
                    outs = {}
                    for side in libs:
                        o, q, k, v = ops_
                        qs, ks, vs = (t[0].numel() if lay == "xs" else 0
                                      for lay, t in zip(layout[1:],
                                                        (q, k, v)))
                        routes[side] = chain_route(side, dname, q, qs, k,
                                                   ks, v, vs, L)
                        outs[side] = torch.empty_like(o)
                        chain_call(side, dname, layout, L, *ops_,
                                   outs[side])
                    torch.cuda.synchronize()
                    err = (outs["this"].double() - exp.double()).abs().max(
                        ).item()
                    name = (f"chain_attn ({m},{n},{d},{dv}) x {L} {dname} "
                            f"{layout[1:]}{label} (routes: this "
                            f"{routes['this']}, other {routes['other']})")
                    if routes["this"] == routes["other"]:
                        ok = torch.equal(outs["this"].view(torch.uint8),
                                         outs["other"].view(torch.uint8))
                        print(f"[check] {name}: this vs other bitwise "
                              f"equal: {'ok' if ok else 'FAILED'}; this vs "
                              f"plain max_abs_err {err:.3e}")
                    else:
                        rtol, atol = TOL[dname]
                        exact = chain_attn64(torch, layout, L, *ops_)
                        e_this = (outs["this"].double() - exact).abs().max(
                            ).item()
                        e_other = (outs["other"].double() - exact).abs(
                            ).max().item()
                        limit = (TF32_VS_SIMT if dname == "float32"
                                 else CHAIN_HALF_VS_SIMT)
                        ratio = e_this / max(e_other, 1e-30)
                        close = torch.allclose(outs["this"], exp, rtol=rtol,
                                               atol=atol * L)
                        ok = close and ratio <= limit
                        print(f"[check] {name}: this within rtol {rtol} "
                              f"atol {atol} x {L} of the plain version "
                              f"(max_abs_err {err:.3e}): {close}; float64 "
                              f"error {e_this:.3e} = {ratio:.2f}x the "
                              f"other's {e_other:.3e} (limit {limit}): "
                              f"{'ok' if ok else 'FAILED'}")
                    if not ok:
                        return 1
    print(f"[check] row-tile counters left at zero: "
          f"{all(not t.any().item() for t in done.values())}")

    # (B, Hq, Hkv, S, D, window, dtypes) of the timed forwards and
    # backwards: the full widths, and the families' shapes whose last
    # 64-column panel is partly real
    timed = {**{model: (b, hq, hkv, s, d, window, ("float32", "bfloat16")
                        + (("float16",) if model in FULL_ATTN_F16 else ()))
                for model, (b, hq, hkv, s, d, window) in FULL_ATTN.items()},
             **{model: (b, hq, hkv, sq, d, None, ("bfloat16",))
                for model, (b, hq, hkv, sq, skv, d, causal)
                in FAMILY_ATTN.items() if d % 64 and causal and sq == skv}}
    for model, (b, hq, hkv, s, d, window, dnames) in timed.items():
        for dname in dnames:
            dt = getattr(torch, dname)
            q = rand((b, hq, s, d), dt)
            k, v = rand((b, hkv, s, d), dt), rand((b, hkv, s, d), dt)
            out = torch.empty_like(q)
            routes = {side: fa_route(side, q, k, v, out) for side in libs}
            ab(torch, f"flash_attention {model} {dname} (routes: this "
               f"{routes['this']}, other {routes['other']})",
               lambda side: fa_call(side, q, k, v, out, True, window), 5, 1)
            del q, k, v, out
    # the float32 training forward (with its log-sum-exp where the side's
    # route hands one back) at the FSDP step's shape
    for model, (b, hq, hkv, s, d, window) in FAMILY_F32_ATTN.items():
        q = rand((b, hq, s, d), torch.float32)
        k, v = (rand((b, hkv, s, d), torch.float32) for _ in range(2))
        out = torch.empty_like(q)
        routes = {side: fa_route(side, q, k, v, out) for side in libs}
        lse_fwd = {side: routes[side] == "f32_3xtf32" and F32_LSE_SYMBOL
                   in libs[side][0].symbols for side in libs}

        def fwd(side, q=q, k=k, v=v, out=out, window=window):
            if lse_fwd[side]:
                return lse_call(side, q, k, v, True, window)
            return fa_call(side, q, k, v, out, True, window)
        ab(torch, f"flash_attention {model} float32 training forward "
           f"(routes: this {routes['this']}, other {routes['other']})",
           fwd, 5, 1)
        del q, k, v, out
    if libs["this"][3] is not None and libs["other"][3] is not None:
        shapes = {**BWD_SHAPES, **{m: t for m, t in timed.items()
                                   if m not in FULL_ATTN}}
        for model, (b, hq, hkv, s, d, window, dnames) in shapes.items():
            for dname in dnames:
                dt = getattr(torch, dname)
                q = rand((b, hq, s, d), dt)
                k, v = rand((b, hkv, s, d), dt), rand((b, hkv, s, d), dt)
                dout = rand(q.shape, dt)
                out = torch.empty_like(q)
                fa_call("this", q, k, v, out, True, window)
                lse = None
                if (wgmma_bwd("this", q, k, v, out, dout)
                        or tf32_bwd("this", q, k, v, out, dout)):
                    out, lse = lse_call("this", q, k, v, True, window)
                # each side on the route its library takes with the
                # forward's log-sum-exp
                tc = {side: None if lse is None
                      else WGMMA[dname] if wgmma_bwd(side, q, k, v, out, dout)
                      else "f32_3xtf32" if tf32_bwd(side, q, k, v, out, dout)
                      else None for side in libs}
                label = ", ".join(f"{side} {tc[side] or 'CUDA cores'}"
                                  for side in ("this", "other"))

                def run(side, q=q, k=k, v=v, out=out, dout=dout, lse=lse,
                        window=window, tc=tc):
                    if tc[side] in WGMMA.values():
                        return bwd_wgmma_call(side, q, k, v, out, dout, lse,
                                              True, window)
                    if tc[side] == "f32_3xtf32":
                        return bwd_tf32_call(side, q, k, v, out, dout, lse,
                                             True, window)
                    return bwd_call(side, q, k, v, out, dout, True, window)
                ab(torch, f"flash_attention_bwd {model} {dname} ({label})",
                   run, 5, 1)
                del q, k, v, out, dout, lse
    # chain_attn at the 512-row tile: each side on the route it takes, and
    # on copies one element in (every side's CUDA-core loop); device time
    # from CUDA graphs
    m, n, d, dv, _L = CHAIN_SHAPES[0]
    layout = CHAIN_LAYOUTS[0]
    for dname, L in (("float32", 16), ("bfloat16", 16), ("float16", 16),
                     ("float32", 1)):
        if dname not in chain_dtypes:
            continue
        args = chain_operands(layout, m, n, d, dv, L, getattr(torch, dname))
        odd = (args[0],) + tuple(odd_offset(t) for t in args[1:])
        out = torch.empty_like(args[0])
        for label, ops_ in (("", args), (", one element in", odd)):
            o, q, k, v = ops_
            qs, ks, vs = (t[0].numel() if lay == "xs" else 0
                          for lay, t in zip(layout[1:], (q, k, v)))
            routes = {side: chain_route(side, dname, q, qs, k, ks, v, vs, L)
                      for side in libs}
            ab(torch, f"chain_attn ({m},{n},{d},{dv}) x {L} {dname}, k and "
               f"v per level{label} (routes: this {routes['this']}, other "
               f"{routes['other']})",
               lambda side, ops_=ops_, L=L, dname=dname: chain_call(
                   side, dname, layout, L, *ops_, out), 20, 3, graph=True)
    return 0
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
