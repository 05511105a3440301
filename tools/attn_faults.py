#!/usr/bin/env python3
"""Plant faults in copies of the tensor-core attention kernels (bfloat16
and 3xTF32, and the 3xTF32 backward) and show that ``chip_smoke.py``'s
checks catch them.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/attn_faults.py          # every fault
    python3 tools/attn_faults.py chain    # chain_attn's alone

For each fault in ``FAULTS`` the flash-attention sources
(``src/repro_torch/kernels/flash_attention/csrc`` and the GEMM headers
they include) are copied under ``build/attn_faults/<fault>/``, one line of
them (or each of a few) is replaced (the line must occur exactly once),
and the copy is built, all builds started together.  A copy with no fault
is built the same way as the control.  A bfloat16 fault's library runs,
through its bfloat16 C entry point, the cases of ``chip_smoke.py``'s
``MID_ATTN`` at every head dim of ``MID_HEAD_DIMS`` on the same inputs,
each output checked as ``chip_smoke.py`` checks it: within the
reference's tolerance (3e-2) of the oracle on the padded inputs, within
the limits scaled to each value against the float32 oracle
(``half_attention_error``), and zero where a row sees no key.  A float32
fault's library (the ``f32_3xtf32`` route) runs ``MID_ATTN`` at d 64,
128 and 256, the reference's cases at d 64, 128 and 256 and two long
causal cases (``LONG_F32``: eight heads over two, S 8192 at Qwen3-14B's
d 128, S 16384 at d 256) in float32,
each output held as ``chip_smoke.py`` holds the route: within the
reference's float32 tolerance (2e-5) of the oracle, and, per slice of at
most 8 heads, no farther from a float64 computation than
``TF32_VS_SIMT`` times the CUDA-core route's (``f32_simt``, this
checkout's library, on copies at an odd offset) on the same inputs.  A
fault of the float32 backward (``f32_3xtf32``, ``attn_bwd_tf32.cuh``) is
planted in a copy of the backward library, which runs ``BWD_F32`` (h2o-
danube-1.8b's FSDP shape, ``MID_ATTN``'s causal cases at d 80 and 256 and
long causal cases at d 128 and 256) from this checkout's forward and its
log-sum-exp, each gradient
held as ``chip_smoke.py`` holds the route: within ``BWD_F32_NRMS`` (2e-5)
rms per head slice of the plain version, and, per slice of at most 8
heads, no farther from a float64 gradient than ``TF32_VS_SIMT`` times
``f32_simt``'s on the same inputs.  The faults named ``d 256`` are
planted in the blocks of head dim 256 alone (``attn_tf32_wide.cuh``,
``attn_bwd_tf32_wide.cuh``), so only its cases can catch them.  The
float16 faults (P, and in the backward dS, rounded through bfloat16 on
the ``f16_wgmma`` route: attn_wgmma.cuh's f16 packing) run the float16
forward at ``chip_smoke.py``'s full widths in ``FULL_ATTN_F16`` (within
``ATTN_TOL["float16"]`` of the plain version and within the float16
limits of ``HALF_LIMITS`` against the float32 oracle) and the float16
backward at ``BWD_SHAPES``' float16 shapes from this checkout's forward
and its log-sum-exp (within ``F16_SLICE_NRMS`` rms per head slice of the
plain version in float32), each printed as a ratio to its limit beside
the control's.  The control runs all five sets.  A
fault is caught when some case fails a check; how many cases each check
fails is printed.

``chain_attn``'s tensor-core routes (``kernels/chain/csrc/
chain_attn_tc.cuh``) have faults of their own, ``CHAIN_FAULTS``, run by
``chain_faults`` (alone with ``python3 tools/attn_faults.py chain``):
chunks merged without their weights 2^(m_c - m*) (planted in a copy of
``chain_attn_tc.cuh``), P rounded through bfloat16 on ``f16_wgmma`` (the
same line of a copy of ``attn_wgmma.cuh``, which the chain library
includes) and the chunk count taken from the chain's length (the wrapper's
``kernel.attn_chunks`` patched for the run: one chunk for a chain of more
than one level, the level's own count for one).  Each copy's chain library
stands in for the built one under ``chain_ops.chain_attn`` and runs
``chip_smoke.py``'s chain checks: the 512-row Qwen3-14B tile x 16 levels
in float32, bfloat16 and float16, in the three layouts, bit for bit its
per-level ``attn_step`` replay and within ``TOL`` times the levels of the
plain version; and the 16 levels and one served level from a zero carry
against float64, at most ``TF32_VS_SIMT`` (float32) or
``CHAIN_HALF_VS_SIMT`` times the CUDA-core loop's error on odd-offset
copies of the same values.

Prints, per fault, how many cases caught it and the worst statistics over
the cases.  Exits non-zero when the control fails a check or a fault
marked as one the checks must catch is not caught.
"""

from __future__ import annotations

import ctypes
import shutil
import sys

from _ab import KERNELS, ROOT, build_all, start
from chip_smoke import (ATTN_CASES, ATTN_TILE, ATTN_LEVELS, ATTN_TOL,
                        BWD_F32_NRMS, BWD_SHAPES, CHAIN_ATTN_ROUTES,
                        CHAIN_HALF_VS_SIMT, F16_SLICE_NRMS, FULL_ATTN,
                        FULL_ATTN_F16, HALF_LIMITS, MID_ATTN, MID_HEAD_DIMS,
                        TF32_VS_SIMT, TOL, attention64, attention_grad64,
                        chain_attn64,
                        half_attention_error, half_within, odd_offset,
                        slice_nrms, tf32_vs_simt)

# the f16 packing of P and dS into A registers (attn_wgmma.cuh
# Elem<__half>::pack), and the same through bfloat16 first
F16_PACK = "    const __half2 v = __floats2half2_rn(lo, hi);"
F16_PACK_BF16 = ("    const __half2 v = __floats2half2_rn(\n"
                 "        __bfloat162float(__float2bfloat16_rn(lo)),\n"
                 "        __bfloat162float(__float2bfloat16_rn(hi)));")
# (name, dtype, file, line, replacement, whether the checks must catch it);
# line and replacement may be tuples of lines, each replaced in turn
FAULTS = (
    ("no O rescale", "bfloat16", "attn_wgmma.cuh",
     "if (!__all_sync(0xffffffffu, corr[0] == 1.0f && corr[1] == 1.0f)) {",
     "if (false) {", True),
    ("P of the previous tile", "bfloat16", "attn_wgmma.cuh",
     "pa[i] = Elem<T>::pack(p0, p1);",
     "if (k0 == 0) pa[i] = Elem<T>::pack(p0, p1);", True),
    ("scale without log2(e)", "bfloat16", "flash_attention.cu",
     "scale * 1.4426950408889634f, mask};", "scale, mask};", True),
    ("ragged keys unmasked", "bfloat16", "attn_wgmma.cuh",
     "bool vis = key < sh.skv;", "bool vis = true;", True),
    ("causal diagonal hidden", "bfloat16", "attn_wgmma.cuh",
     "vis = vis && key <= row;", "vis = vis && key < row;", True),
    ("window one key wider", "bfloat16", "attn_wgmma.cuh",
     "vis = vis && row - key < mask.window;",
     "vis = vis && row - key <= mask.window;", True),
    # the last 64-column panel of d 80 / 96, partly real: its k16 slices
    # of Q K^T, and its P V product at N = d % 64
    ("last panel left out of Q K^T", "bfloat16", "attn_wgmma.cuh",
     "  for (int kk = 0; kk < D / 16; ++kk) {",
     "  for (int kk = 0; kk < D / 64 * 4; ++kk) {", True),
    ("last panel left out of P V", "bfloat16", "attn_wgmma.cuh",
     "    if constexpr (D % 64 != 0)\n      wgmma_rs<T>(first<D % 64>",
     "    if constexpr (false)\n      wgmma_rs<T>(first<D % 64>", True),
    ("l rounded to bf16 every tile", "bfloat16", "attn_wgmma.cuh",
     "l[h] = corr[h] * l[h] + sum[h];",
     "l[h] = __bfloat162float(__float2bfloat16(corr[h] * l[h] + sum[h]));",
     False),
    ("lo products dropped (plain TF32)", "float32", "attn_tf32.cuh",
     ("*reinterpret_cast<float4*>(lo + off) = l;",
      "*reinterpret_cast<float*>(lo + off) = tf32_rna(x - h);",
      "pl[i] = tf32_rna(p - hi);"),
     ("*reinterpret_cast<float4*>(lo + off) = make_float4(0, 0, 0, 0);",
      "*reinterpret_cast<float*>(lo + off) = 0.0f;",
      "pl[i] = 0.0f;"), True),
    ("V's lo half dropped", "float32", "attn_tf32.cuh",
     "*reinterpret_cast<float*>(lo + off) = tf32_rna(x - h);",
     "*reinterpret_cast<float*>(lo + off) = 0.0f;", True),
    # every key tile's P V accumulated into O inside the tensor cores,
    # whose sums truncate, instead of summed from zero per tile and added
    # to O with an IEEE add (the route's first design)
    ("tile sums added in the tensor cores", "float32", "attn_tf32.cuh",
     ("      issue_pv<D>(ot, s, pl, vh, vl);",
      "                wg_desc(v_hi + va, 16, 1024), kk > 0);",
      "      for (int i = 0; i < C::OR; ++i) o[i] = __fadd_rn(o[i], ot[i]);"),
     ("      issue_pv<D>(o, s, pl, vh, vl);",
      "                wg_desc(v_hi + va, 16, 1024), 1);",
      ""), True),
    # S's three products in one accumulator: hi.hi's large terms truncate
    # the lo products' small ones
    ("S in one accumulator", "float32", "attn_tf32.cuh",
     ("    wgmma_ss<C::BKV>(s_lo, wg_desc(q_lo + qa, 16, 1024),\n"
      "                     wg_desc(k_hi + ka, 16, 1024), kk > 0);\n"
      "    wgmma_ss<C::BKV>(s_lo, wg_desc(q_hi + qa, 16, 1024),\n"
      "                     wg_desc(k_lo + ka, 16, 1024), 1);\n"
      "    wgmma_ss<C::BKV>(s, wg_desc(q_hi + qa, 16, 1024),\n"
      "                     wg_desc(k_hi + ka, 16, 1024), kk > 0);\n",
      "      for (int i = 0; i < C::SR; ++i) s[i] = __fadd_rn(s[i], pl[i]);"),
     ("    wgmma_ss<C::BKV>(s, wg_desc(q_lo + qa, 16, 1024),\n"
      "                     wg_desc(k_hi + ka, 16, 1024), kk > 0);\n"
      "    wgmma_ss<C::BKV>(s, wg_desc(q_hi + qa, 16, 1024),\n"
      "                     wg_desc(k_lo + ka, 16, 1024), 1);\n"
      "    wgmma_ss<C::BKV>(s, wg_desc(q_hi + qa, 16, 1024),\n"
      "                     wg_desc(k_hi + ka, 16, 1024), 1);\n",
      ""), False),
    # the backward: every key tile's dQ and every query tile's dK and dV
    # accumulated inside the tensor cores across the sweep, instead of
    # summed from zero per tile and added with an IEEE add
    ("backward tile sums added in the tensor cores", "float32 backward",
     "attn_bwd_tf32.cuh",
     ("    issue_grad<D>(dqt, s, sl, kth, ktl);",
      "    for (int i = 0; i < C::OR; ++i) dq[i] = __fadd_rn(dq[i], dqt[i]);",
      "    issue_grad<D>(at, st, stl, th, tl);",
      "    for (int i = 0; i < C::OR; ++i) acc[i] = __fadd_rn(acc[i], at[i]);",
      "                desc(t_hi, kk * 32), kk > 0);"),
     ("    issue_grad<D>(dq, s, sl, kth, ktl);", "",
      "    issue_grad<D>(acc, st, stl, th, tl);", "",
      "                desc(t_hi, kk * 32), 1);"), True),
    # dS's (and P's) lo halves dropped: their products in plain TF32
    ("backward dS and P in plain TF32", "float32 backward",
     "attn_bwd_tf32.cuh", "  lo = tf32_rna(x - hi);", "  lo = 0.0f;", True),
    # the same faults planted in d 256's blocks alone (attn_tf32_wide.cuh,
    # attn_bwd_tf32_wide.cuh): caught only by the d 256 cases
    ("d 256: tile sums added in the tensor cores", "float32",
     "attn_tf32_wide.cuh",
     ("    issue_pv<D>(ot, s, pl, vh, vl);",
      "                           desc64(v_hi + kk * 32), kk > 0);",
      "    for (int i = 0; i < C::OR; ++i) o[i] = __fadd_rn(o[i], ot[i]);"),
     ("    issue_pv<D>(o, s, pl, vh, vl);",
      "                           desc64(v_hi + kk * 32), 1);",
      ""), True),
    # S's lo products and P's lo half dropped: S and P V in plain TF32 but
    # for V's lo half
    ("d 256: S and P in plain TF32", "float32", "attn_tf32_wide.cuh",
     ("          make_float4(__fadd_rn(s[i], pl[i]), __fadd_rn(s[i + 1], "
      "pl[i + 1]),\n                      __fadd_rn(s[i + 2], pl[i + 2]),\n"
      "                      __fadd_rn(s[i + 3], pl[i + 3]));",
      "    pl[i] = tf32_rna(p - hi);"),
     ("          make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]);",
      "    pl[i] = 0.0f;"), True),
    ("d 256: backward tile sums added in the tensor cores",
     "float32 backward", "attn_bwd_tf32_wide.cuh",
     ("    issue_grad<D>(dqt, s, sl, kth, ktl);",
      "    for (int i = 0; i < C::OR; ++i) dq[i] = __fadd_rn(dq[i], dqt[i]);",
      "    issue_grad<D>(dkt, st, stl, qth, qtl);",
      "    for (int i = 0; i < C::OR; ++i) acc[i] = __fadd_rn(acc[i], dkt[i]);",
      "    issue_grad<D>(dvt, st, stl, dth, dtl);",
      "    for (int i = 0; i < C::OR; ++i) acc[i] = __fadd_rn(acc[i], dvt[i]);",
      "                           desc64(t_hi + kk * 32), kk > 0);"),
     ("    issue_grad<D>(dq, s, sl, kth, ktl);", "",
      "    issue_grad<D>(acc, st, stl, qth, qtl);", "",
      "    issue_grad<D>(acc, st, stl, dth, dtl);", "",
      "                           desc64(t_hi + kk * 32), 1);"), True),
    ("d 256: backward dS and P in plain TF32", "float32 backward",
     "attn_bwd_tf32_wide.cuh",
     ("    for (int i = 0; i < C::AR; ++i) split(s[i], sl[i]);",
      "    for (int i = 0; i < C::AR; ++i) split(st[i], stl[i]);",
      "          split(st[i], stl[i]);"),
     ("    for (int i = 0; i < C::AR; ++i) { s[i] = tf32_rna(s[i]); "
      "sl[i] = 0.0f; }",
      "    for (int i = 0; i < C::AR; ++i) { st[i] = tf32_rna(st[i]); "
      "stl[i] = 0.0f; }",
      "          st[i] = tf32_rna(st[i]); stl[i] = 0.0f;"), True),
    # float16 (f16_wgmma): P, and in the backward dS, rounded through
    # bfloat16 before f16 (3 bits fewer), in the f16 packing of the
    # A registers that both directions share
    ("P rounded through bf16", "float16", "attn_wgmma.cuh",
     F16_PACK, F16_PACK_BF16, True),
    ("P and dS rounded through bf16", "float16 backward", "attn_wgmma.cuh",
     F16_PACK, F16_PACK_BF16, True),
)
# chain_attn's faults: (name, file of the copy or None for a fault of the
# wrapper, line, replacement); every one must be caught
CHAIN_FAULTS = (
    ("chunks merged without the rescale", "chain_attn_tc.cuh",
     "      const float wc = exp2f(__fsub_rn(w[c * ROWS + r], mx));",
     "      const float wc = 1.0f;"),
    ("P rounded through bf16 on f16_wgmma", "attn_wgmma.cuh", F16_PACK,
     F16_PACK_BF16),
    ("chunks from the chain's length", None, None, None),
)
# the float32 backward's cases: (B, Hq, Hkv, S, d, window), causal;
# h2o-danube-1.8b's FSDP step shape, and one long enough (512 key tiles a
# row block, 2048 query tiles a key block) for the tensor cores'
# truncating sums to show
BWD_F32 = ((8, 32, 8, 1024, 80, 4096), (1, 8, 2, 8192, 128, None),
           # d 256's blocks: 256 key tiles of 16 a row block, 1024 query
           # tiles of 16 a key block
           (1, 8, 2, 4096, 256, None))
# (B, Hq, Hkv, S, d): float32 cases long enough (256 key tiles a row
# block at d 128, 1024 of 16 keys at d 256) for error that grows with the
# number of key tiles to show; at d 256 f32_simt's own error against
# float64 is larger (its dot products run over 256 columns): on an H100
# the planted drift reached 3.79 times it at S 8192, under TF32_VS_SIMT,
# and 5.23 at S 16384
LONG_F32 = ((1, 8, 2, 8192, 128), (1, 8, 2, 16384, 256))
_P, _I, _I64, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_double)
# bind_flash_attention_bwd_{f32,f16}_lse: ten tensors, the head groups'
# partials, sizes, scale, mask, head groups, stream
BWD_ARGS = (_P,) * 11 + (_I64,) * 6 + (_D, _I, _I, _I64, _I64, _P)
FA_ARGS = (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _D, _I, _I,
           _I64, _P)
ROUTE_ARGS = (_I, _P, _P, _P, _P, _I64)
# flash_attention.cu's Route enum and its element-type codes
ROUTES = ("f32_simt", "bf16_simt", "bf16_wgmma", "f32_3xtf32", "f16_simt",
          "f16_wgmma")
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}
SUFFIX = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}
WANT = {"float32": "f32_3xtf32", "bfloat16": "bf16_wgmma",
        "float16": "f16_wgmma"}


def planted(CudaLibrary, index, fault, backward: bool = False):
    """The flash-attention library of a copy of the sources with ``fault``
    (``None``: the control) planted; the backward's library for a fault of
    the backward, or ``backward``."""
    copy = ROOT / "build" / "attn_faults" / str(index)
    if copy.exists():
        shutil.rmtree(copy)
    for part in ("flash_attention", "gemm"):
        shutil.copytree(ROOT / KERNELS / part / "csrc",
                        copy / part / "csrc")
    if fault is not None:
        _name, _dtype, file, lines, replacements, _must = fault
        if isinstance(lines, str):
            lines, replacements = (lines,), (replacements,)
        path = copy / "flash_attention" / "csrc" / file
        text = path.read_text()
        for line, replacement in zip(lines, replacements):
            if text.count(line) != 1:
                raise RuntimeError(f"{file}: {line!r} occurs "
                                   f"{text.count(line)} times, expected "
                                   f"once")
            text = text.replace(line, replacement)
        path.write_text(text)
    headers = tuple(sorted((copy / "gemm" / "csrc").glob("*.cuh"))
                    + sorted((copy / "flash_attention" / "csrc")
                             .glob("*.cuh")))
    if backward or (fault is not None and fault[1].endswith("backward")):
        return CudaLibrary(f"attn_fault_bwd_{index}",
                           (copy / "flash_attention" / "csrc" /
                            "flash_attention_bwd.cu",), headers,
                           {"bind_flash_attention_bwd_f32_lse": BWD_ARGS,
                            "bind_flash_attention_bwd_f16_lse": BWD_ARGS})
    return CudaLibrary(f"attn_fault_{index}",
                       (copy / "flash_attention" / "csrc" /
                        "flash_attention.cu",), headers,
                       {**{f"bind_flash_attention_{s}": FA_ARGS
                           for s in SUFFIX.values()},
                        "bind_flash_attention_route": ROUTE_ARGS})


def chain_planted(CudaLibrary, index, fault, symbols):
    """The chain library of a copy of the chain, flash-attention and GEMM
    sources with ``fault`` (one of CHAIN_FAULTS; None or a wrapper's fault:
    the sources as they are) planted."""
    copy = ROOT / "build" / "attn_faults" / f"chain{index}"
    if copy.exists():
        shutil.rmtree(copy)
    for part in ("chain", "flash_attention", "gemm"):
        shutil.copytree(ROOT / KERNELS / part / "csrc", copy / part / "csrc")
    if fault is not None and fault[1] is not None:
        _name, file, line, replacement = fault
        part = "chain" if file.startswith("chain") else "flash_attention"
        path = copy / part / "csrc" / file
        text = path.read_text()
        if text.count(line) != 1:
            raise RuntimeError(f"{file}: {line!r} occurs {text.count(line)} "
                               f"times, expected once")
        path.write_text(text.replace(line, replacement))
    headers = tuple(sorted(copy.glob("*/csrc/*.cuh")))
    chain_cu = copy / "chain" / "csrc" / "chain.cu"
    return CudaLibrary(f"attn_fault_chain_{index}",
                       (chain_cu,) + tuple(sorted(
                           set(chain_cu.parent.glob("*.cu")) - {chain_cu})),
                       headers, symbols)


def chain_faults(torch, libs) -> bool:
    """Run chip_smoke.py's chain_attn checks through each library of
    ``libs`` (the control's first, then CHAIN_FAULTS' in order); returns
    whether the control passed and every fault was caught."""
    from repro_torch.kernels.chain import kernel as chain_kernel
    from repro_torch.kernels.chain import ops as chain_ops
    from repro_torch.kernels.chain import ref as chain_ref
    from repro_torch.kernels.flash_attention.ops import attn_step

    dev = torch.device("cuda", 0)
    m, n, d, dv = ATTN_TILE
    layouts = (("single", "single", "xs", "xs"), ("single", "xs", "xs", "xs"),
               ("single", "single", "single", "single"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def operands(layout, L, dt, zero=False):
        shapes = ((m, dv), (m, d), (n, d), (n, dv))
        out = [torch.randn(((L,) if lay == "xs" else ()) + shape,
                           generator=gen, device=dev).to(dt)
               for lay, shape in zip(layout, shapes)]
        if zero:
            out[0] = torch.zeros_like(out[0])
        return out

    cases = []
    for dname in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, dname)
        for layout in layouts:
            cases.append((f"{dname} x {ATTN_LEVELS} {layout[1:]}", dname,
                          layout, ATTN_LEVELS,
                          operands(layout, ATTN_LEVELS, dt)))
        cases.append((f"{dname} one served level", dname, layouts[0], 1,
                      operands(layouts[0], 1, dt, zero=True)))
    real_lib, real_launch = chain_kernel.LIBRARY, chain_kernel.launch_attn
    real_chunks = chain_kernel.attn_chunks
    levels_now = {}

    def launch_noting_levels(out, o, q, qs, k, ks, v, vs, n_levels, route):
        levels_now["n"] = n_levels
        return real_launch(out, o, q, qs, k, ks, v, vs, n_levels, route)

    def chunks_from_length(route, m_, n_, d_):
        own = real_chunks(route, m_, n_, d_)
        return own if levels_now.get("n", 1) == 1 else 1

    ok = True
    for lib, fault in zip(libs, (None,) + CHAIN_FAULTS):
        name = "control" if fault is None else fault[0]
        chain_kernel.LIBRARY = lib
        if fault is not None and fault[1] is None:
            chain_kernel.launch_attn = launch_noting_levels
            chain_kernel.attn_chunks = chunks_from_length
        caught = {"replay": 0, "tolerance": 0, "float64": 0}
        worst = 0.0
        try:
            for label, dname, layout, L, args in cases:
                tc, simt = CHAIN_ATTN_ROUTES[dname]
                got = chain_ops.chain_attn(layout, 0, L, *args)
                replay = chain_ref.run_levels(attn_step, layout, 0, L, args)
                odd = (args[0],) + tuple(odd_offset(t) for t in args[1:])
                base = chain_ops.chain_attn(layout, 0, L, *odd)
                torch.cuda.synchronize()
                exp = chain_ref.chain_attn(layout, 0, L, *args)
                exact = chain_attn64(torch, layout, L, *args)
                rtol, atol = TOL[dname]
                limit = (TF32_VS_SIMT if dname == "float32"
                         else CHAIN_HALF_VS_SIMT)
                ratio = ((got.double() - exact).abs().max().item()
                         / max((base.double() - exact).abs().max().item(),
                               1e-30))
                worst = max(worst, ratio) if ratio == ratio else float("inf")
                bad = {"replay": not torch.equal(got.view(torch.uint8),
                                                 replay.view(torch.uint8)),
                       "tolerance": not torch.allclose(
                           got, exp, rtol=rtol, atol=atol * L),
                       "float64": not ratio <= limit}
                for key, b in bad.items():
                    caught[key] += b
                if fault is None and any(bad.values()):
                    print(f"[fault] chain control {label}: fails {bad} "
                          f"(float64 {ratio:.2f}x)")
        finally:
            chain_kernel.LIBRARY = real_lib
            chain_kernel.launch_attn = real_launch
            chain_kernel.attn_chunks = real_chunks
        total = sum(caught.values())
        print(f"[fault] chain_attn {name}: cases failing each check "
              f"{caught} of {len(cases)}; float64 error at most "
              f"{worst:.2f} x the CUDA-core loop's")
        ok &= (total == 0) if fault is None else (total > 0)
    return ok


def main(argv: list[str]) -> int:
    if argv not in ([], ["chain"]):
        print(__doc__, file=sys.stderr)
        return 2
    torch = start("attn_faults")
    if torch is None:
        return 1
    from repro_torch.kernels._build import CudaLibrary
    from repro_torch.kernels.chain import kernel as chain_kernel
    chain_libs = [chain_planted(CudaLibrary, i, f,
                                chain_kernel.LIBRARY.symbols)
                  for i, f in enumerate((None,) + CHAIN_FAULTS)]
    if argv == ["chain"]:
        build_all(chain_libs, ("error",))
        ok = chain_faults(torch, chain_libs)
        print(f"[fault] {'ok' if ok else 'FAILED'}: chain_attn's control "
              f"passes and every fault is caught")
        return 0 if ok else 1
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    faults = (None,) + FAULTS
    libs = [planted(CudaLibrary, i, f) for i, f in enumerate(faults)]
    control_bwd = planted(CudaLibrary, "control_bwd", None, backward=True)
    build_all(libs + [control_bwd, fa_kernel.LIBRARY, fa_kernel.BWD_LIBRARY]
              + chain_libs, ("error",))
    chain_ok = chain_faults(torch, chain_libs)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cases = {"bfloat16": [], "float32": []}
    for d in MID_HEAD_DIMS:
        for b, hq, hkv, sq, skv, causal, window, blk in MID_ATTN:
            q = torch.randn((b, hq, sq, d), generator=gen, device=dev)
            k = torch.randn((b, hkv, skv, d), generator=gen, device=dev)
            v = torch.randn((b, hkv, skv, d), generator=gen, device=dev)
            q, k, v = fa_ops.pad(*(t.to(torch.bfloat16) for t in (q, k, v)),
                                 causal=causal, window=window, bq=blk,
                                 bkv=blk)
            exp = fa_ref.attention(q, k, v, causal=causal, window=window)
            exp32 = fa_ref.attention(q.float(), k.float(), v.float(),
                                     causal=causal, window=window)
            seen = fa_ref.mask(q.shape[2], k.shape[2], causal=causal,
                               window=window, device=dev)
            cases["bfloat16"].append((
                f"({b}, {hq}, {hkv}, {sq}, {skv}, {d}) causal {causal} "
                f"window {window}", q, k, v, causal, window, exp, exp32,
                ~seen.any(dim=-1)))
    # float32 on the 3xTF32 route: MID_ATTN and the reference's cases at the
    # head dims it takes, and LONG_F32
    f32_shapes = [(b, hq, hkv, sq, skv, d, causal, window, blk)
                  for d in (64, 128, 256)
                  for b, hq, hkv, sq, skv, causal, window, blk in MID_ATTN]
    f32_shapes += [case[:5] + (d,) + case[6:] + (16,)
                   for d in (64, 128, 256) for case in ATTN_CASES]
    f32_shapes += [(b, hq, hkv, s, s, d, True, None, 512)
                   for b, hq, hkv, s, d in LONG_F32]
    for b, hq, hkv, sq, skv, d, causal, window, blk in f32_shapes:
        q = torch.randn((b, hq, sq, d), generator=gen, device=dev)
        k = torch.randn((b, hkv, skv, d), generator=gen, device=dev)
        v = torch.randn((b, hkv, skv, d), generator=gen, device=dev)
        q, k, v = fa_ops.pad(q, k, v, causal=causal, window=window, bq=blk,
                             bkv=blk)
        exp = fa_ref.attention(q, k, v, causal=causal, window=window)
        seen = fa_ref.mask(q.shape[2], k.shape[2], causal=causal,
                           window=window, device=dev)
        # float64 and f32_simt's error from it, per slice of 8 heads
        copies = [odd_offset(t) for t in (q, k, v)]
        if fa_ops.route(torch.float32, d, [t.data_ptr() for t in copies]) \
                != "f32_simt":
            raise RuntimeError("odd-offset copies do not take f32_simt")
        simt = fa_ops.flash_attention(*copies, causal=causal, window=window,
                                      bq=q.shape[2], bkv=k.shape[2])
        exp64 = attention64(torch, fa_ref, q, k, v, causal, window)
        bases = [(simt[:, h0:h0 + 8].double() - exp64[:, h0:h0 + 8])
                 .abs().max().item() for h0 in range(0, q.shape[1], 8)]
        del copies, simt
        cases["float32"].append((
            f"({b}, {hq}, {hkv}, {sq}, {skv}, {d}) causal {causal} window "
            f"{window}", q, k, v, causal, window, exp, (exp64, bases),
            ~seen.any(dim=-1)))

    # the float32 backward: this checkout's forward and its log-sum-exp,
    # the plain version, float64 and f32_simt (no log-sum-exp) on the same
    # inputs
    bwd_cases = []
    bwd_shapes = [(b, hq, hkv, sq, d, window) for d in (80, 256)
                  for b, hq, hkv, sq, skv, causal, window, blk in MID_ATTN
                  if causal and sq == skv] + list(BWD_F32)
    for b, hq, hkv, s, d, window in bwd_shapes:
        q = torch.randn((b, hq, s, d), generator=gen, device=dev)
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev)
                for _ in range(2))
        kw = dict(causal=True, window=window, scale=d ** -0.5)
        out, lse = fa_ops._attend(q, k, v, lse=True, **kw)
        dout = torch.randn(q.shape, generator=gen, device=dev)
        simt = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse=None, **kw)
        if fa_ops.bwd_route(torch.float32, d, fa_ops._bwd_addresses(
                q, k, v, out, dout, lse)) != "f32_3xtf32":
            raise RuntimeError(f"d {d}: the backward does not take "
                               f"f32_3xtf32")
        exp = fa_ref.attention_grad(q, k, v, dout, **kw)
        exp64 = attention_grad64(torch, fa_ref, q, k, v, dout, True, window)
        bwd_cases.append((f"({b}, {hq}, {hkv}, {s}, {s}, {d}) causal True "
                          f"window {window}", q, k, v, out, dout, lse,
                          window, exp, exp64, simt))
    cases["float32 backward"] = bwd_cases

    # float16 on f16_wgmma at the full widths both ways: the forward held
    # as the bf16 cases are, to f16's limits; the backward from this
    # checkout's forward and its log-sum-exp, against the plain version in
    # float32
    cases["float16"], cases["float16 backward"] = [], []
    for model in FULL_ATTN_F16:
        b, hq, hkv, s, d, window = FULL_ATTN[model]
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
                   .half() for h in (hq, hkv, hkv))
        exp = fa_ref.attention(q, k, v, causal=True, window=window)
        exp32 = fa_ref.attention(q.float(), k.float(), v.float(),
                                 causal=True, window=window)
        seen = fa_ref.mask(s, s, causal=True, window=window, device=dev)
        cases["float16"].append((
            f"{model} ({b}, {hq}, {hkv}, {s}, {s}, {d}) causal True window "
            f"{window}", q, k, v, True, window, exp, exp32,
            ~seen.any(dim=-1)))
    for model, (b, hq, hkv, s, d, window, dnames) in BWD_SHAPES.items():
        if "float16" not in dnames:
            continue
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
                   .half() for h in (hq, hkv, hkv))
        kw = dict(causal=True, window=window, scale=d ** -0.5)
        out, lse = fa_ops._attend(q, k, v, lse=True, **kw)
        dout = torch.randn(q.shape, generator=gen, device=dev).half()
        if fa_ops.bwd_route(torch.float16, d, fa_ops._bwd_addresses(
                q, k, v, out, dout, lse)) != "f16_wgmma":
            raise RuntimeError(f"{model}: the f16 backward does not take "
                               f"f16_wgmma")
        exp = fa_ref.attention_grad(q.float(), k.float(), v.float(),
                                    dout.float(), **kw)
        cases["float16 backward"].append((
            f"{model} ({b}, {hq}, {hkv}, {s}, {s}, {d}) causal True window "
            f"{window}", q, k, v, out, dout, lse, window, exp))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def run_bwd(lib, q, k, v, out, dout, lse, window):
        grads = [torch.empty_like(t) for t in (q, k, v)]
        delta = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
        b, hq, s, d = q.shape
        hkv = k.shape[1]
        # the head groups, as the port's launch_bwd picks them (float32:
        # at d 256 only)
        if q.dtype == torch.float16:
            groups = fa_kernel.dkv_groups(hq, hkv, b, s, sms)
        else:
            groups = (fa_kernel.dkv_groups(hq, hkv, b, s, sms,
                                           fa_kernel.BWD_TF32_KEY_BLOCK)
                      if d > 128 else 1)
        part = (torch.empty((2, b, groups, hkv, s, d), dtype=torch.float32,
                            device=dev) if groups > 1 else None)
        lib.call(f"bind_flash_attention_bwd_{SUFFIX[str(q.dtype)[6:]]}_lse",
                 *(t.data_ptr() for t in (q, k, v, out, dout, *grads, lse,
                                          delta)),
                 None if part is None else part.data_ptr(),
                 b, hq, hkv, s, k.shape[2], d, d ** -0.5, 1,
                 int(window is not None), 0 if window is None else window,
                 groups, stream)
        torch.cuda.synchronize()
        return grads

    def run_case(lib, dname, label, q, k, v, causal, window):
        out = torch.empty_like(q)
        b, hq, sq, d = q.shape
        route = ROUTES[lib.load().bind_flash_attention_route(
            DTYPE_CODES[dname], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), d)]
        if route != WANT[dname]:
            raise RuntimeError(f"{label}: route {route}, expected "
                               f"{WANT[dname]}")
        lib.call(f"bind_flash_attention_{SUFFIX[dname]}", q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
                 k.shape[1], sq, k.shape[2], d, d ** -0.5, int(causal),
                 int(window is not None), 0 if window is None else window,
                 stream)
        torch.cuda.synchronize()
        return out

    failed = False
    # the control's worst ratio to the limit in each float16 set
    control_ratio = {}
    for fault, lib in zip(faults, libs):
        dnames = (("bfloat16", "float32", "float32 backward", "float16",
                   "float16 backward") if fault is None else (fault[1],))
        for dname in dnames:
            name = "control (no fault)" if fault is None else fault[0]
            name = f"{name} [{dname}]"
            if dname == "float16 backward":
                lib_b = control_bwd if fault is None else lib
                caught, ratios = 0, []
                for (label, q, k, v, out, dout, lse, window,
                     exp) in cases[dname]:
                    got = run_bwd(lib_b, q, k, v, out, dout, lse, window)
                    nrms = max(slice_nrms(g, e) for g, e in zip(got, exp))
                    finite = all(bool(torch.isfinite(g).all()) for g in got)
                    ratio = nrms / F16_SLICE_NRMS if finite else float("inf")
                    ratios.append(f"{label}: {ratio:.2f}")
                    caught += not ratio <= 1.0
                    control_ratio.setdefault((dname, label), ratio)
                print(f"[fault] {name}: caught by {caught} of "
                      f"{len(cases[dname])} cases; rms error per head slice "
                      f"over its limit {F16_SLICE_NRMS:.3e} (control's in "
                      f"parentheses): " + "; ".join(
                          f"{r} ({control_ratio[(dname, r.split(': ')[0])]:.2f})"
                          for r in ratios))
                if fault is None:
                    failed |= caught > 0
                elif fault[5] and not caught:
                    failed = True
                continue
            if dname == "float32 backward":
                lib_b = control_bwd if fault is None else lib
                caught, by_nrms, by_limits, first = 0, 0, 0, None
                worst = {"nrms": 0.0, "vs_simt": 0.0}
                for (label, q, k, v, out, dout, lse, window, exp, exp64,
                     simt) in cases[dname]:
                    got = run_bwd(lib_b, q, k, v, out, dout, lse, window)
                    nrms = max(slice_nrms(g, e) for g, e in zip(got, exp))
                    vs = max(tf32_vs_simt(g, s_, x)
                             for g, s_, x in zip(got, simt, exp64))
                    finite = all(bool(torch.isfinite(g).all()) for g in got)
                    by_nrms += not (finite and nrms <= BWD_F32_NRMS)
                    by_limits += not vs <= TF32_VS_SIMT
                    for key, x in (("nrms", nrms), ("vs_simt", vs)):
                        if not x <= worst[key] and worst[key] == worst[key]:
                            worst[key] = x
                    if not (finite and nrms <= BWD_F32_NRMS
                            and vs <= TF32_VS_SIMT):
                        caught += 1
                        first = first or label
                n = len(cases[dname])
                what = (f"caught by {caught} of {n} cases (first: {first}; "
                        f"by the {BWD_F32_NRMS:.0e} rms per head slice "
                        f"{by_nrms}, by the float64 limit {by_limits})"
                        if caught else f"passes all {n} cases")
                print(f"[fault] {name}: {what}; rms error per head slice at "
                      f"most {worst['nrms']:.3e} of the plain version's, "
                      f"error against float64 at most "
                      f"{worst['vs_simt']:.2f} x f32_simt's (limit "
                      f"{TF32_VS_SIMT})")
                if fault is None:
                    failed |= caught > 0
                elif fault[5] and not caught:
                    failed = True
                continue
            caught, by_limits, by_tolerance, first = 0, 0, 0, None
            worst = {"element": 0.0, "slice": 0.0, "row": 0.0,
                     "max_abs": 0.0, "vs_simt": 0.0}
            for (label, q, k, v, causal, window, exp, exp32,
                 blind) in cases[dname]:
                out = run_case(lib, dname, label, q, k, v, causal, window)
                max_abs = (out.double() - exp.double()).abs().max().item()
                if dname == "float32":
                    tol = ATTN_TOL["float32"]
                    tolerance = (bool(torch.isfinite(out).all())
                                 and torch.allclose(out, exp, rtol=tol,
                                                    atol=tol)
                                 and not out[:, :, blind].any().item())
                    exp64, bases = exp32
                    vs_simt = max(
                        (out[:, h0:h0 + 8].double() - exp64[:, h0:h0 + 8])
                        .abs().max().item() / max(base, 1e-30)
                        for h0, base in zip(range(0, out.shape[1], 8),
                                            bases))
                    limits = vs_simt <= TF32_VS_SIMT
                    stats = {"max_abs": max_abs, "vs_simt": vs_simt}
                    by_tolerance += not tolerance
                    by_limits += not limits
                    ok = tolerance and limits
                else:
                    stats = half_attention_error(out, exp32, v)
                    stats["max_abs"] = max_abs
                    # the reference's tolerance alone, and the limits
                    # scaled to each value
                    tol = ATTN_TOL[dname]
                    tolerance = (bool(torch.isfinite(out).all())
                                 and torch.allclose(out.float(), exp.float(),
                                                    rtol=tol, atol=tol)
                                 and not out[:, :, blind].any().item())
                    if dname == "float16":
                        slice_lim = HALF_LIMITS[dname][2]
                        control_ratio.setdefault((dname, label),
                                                 stats["slice"] / slice_lim)
                        print(f"[fault]   {name} {label}: slice rms "
                              f"{stats['slice'] / slice_lim:.2f} x its "
                              f"limit {slice_lim:.3e} (control "
                              f"{control_ratio[(dname, label)]:.2f} x), "
                              f"row rms {stats['row']:.3e}, element "
                              f"{stats['element']:.3f}")
                    limits = half_within(stats, dname)
                    by_tolerance += not tolerance
                    by_limits += not limits
                    ok = tolerance and limits
                for key, x in stats.items():
                    # a non-finite statistic is the worst there is, and
                    # stays
                    if not x <= worst[key] and worst[key] == worst[key]:
                        worst[key] = x
                if not ok:
                    caught += 1
                    first = first or label
            n = len(cases[dname])
            if dname == "float32":
                what = (f"caught by {caught} of {n} cases (first: {first}; "
                        f"by the 2e-5 tolerance {by_tolerance}, by the "
                        f"float64 limit {by_limits})" if caught
                        else f"passes all {n} cases")
                print(f"[fault] {name}: {what}; max_abs_err "
                      f"{worst['max_abs']:.3e} against the oracle, error "
                      f"against float64 at most {worst['vs_simt']:.2f} x "
                      f"f32_simt's (limit {TF32_VS_SIMT})")
            else:
                what = (f"caught by {caught} of {n} cases (first: {first};"
                        f" by the scaled limits {by_limits}, by the "
                        f"{ATTN_TOL[dname]} tolerance {by_tolerance})"
                        if caught else f"passes all {n} cases")
                print(f"[fault] {name}: {what}; worst element "
                      f"{worst['element']:.3f} of its limit, slice rms "
                      f"{worst['slice']:.3e}, row rms {worst['row']:.3e}, "
                      f"max_abs_err {worst['max_abs']:.3e} against the "
                      f"{dname} oracle")
            if fault is None:
                failed |= caught > 0
            elif fault[5] and not caught:
                failed = True
    failed |= not chain_ok
    print(f"[fault] {'FAILED' if failed else 'ok'}: the control passes and "
          f"every fault the checks must catch is caught")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
