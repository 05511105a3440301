#!/usr/bin/env python3
"""Plant faults in copies of the bfloat16 tensor-core attention kernel and
show that ``chip_smoke.py``'s bf16 checks catch them.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/attn_faults.py

For each fault in ``FAULTS`` the flash-attention sources
(``src/repro_torch/kernels/flash_attention/csrc`` and the GEMM headers
they include) are copied under ``build/attn_faults/<fault>/``, one line of
them is replaced (the line must occur exactly once), and the copy is
built, all builds started together.  A copy with no fault is built the
same way as the control.  Each library runs, through its bfloat16 C entry
point, the cases of ``chip_smoke.py``'s ``MID_ATTN`` at every head dim of
``MID_HEAD_DIMS`` on the same inputs, and each output is checked as
``chip_smoke.py`` checks it: within the reference's tolerance (3e-2) of
the oracle on the padded inputs, within the limits scaled to each value
against the float32 oracle (``bf16_attention_error``), and zero where a
row sees no key.  A fault is caught when some case fails a check; how
many cases the scaled limits and the 3e-2 tolerance each fail is printed.

Prints, per fault, how many cases caught it and the worst statistics over
the cases.  Exits non-zero when the control fails a check or a fault
marked as one the checks must catch is not caught.
"""

from __future__ import annotations

import ctypes
import shutil
import sys

from _ab import KERNELS, ROOT, build_all, start
from chip_smoke import (ATTN_TOL, MID_ATTN, MID_HEAD_DIMS,
                        bf16_attention_error, bf16_within)

# (name, file, line, replacement, whether the checks must catch it)
FAULTS = (
    ("no O rescale", "attn_wgmma.cuh",
     "if (!__all_sync(0xffffffffu, corr[0] == 1.0f && corr[1] == 1.0f)) {",
     "if (false) {", True),
    ("P of the previous tile", "attn_wgmma.cuh",
     "pa[i] = pack_bf16(p0, p1);",
     "if (k0 == 0) pa[i] = pack_bf16(p0, p1);", True),
    ("scale without log2(e)", "flash_attention.cu",
     "scale * 1.4426950408889634f", "scale", True),
    ("ragged keys unmasked", "attn_wgmma.cuh",
     "bool vis = key < sh.skv;", "bool vis = true;", True),
    ("causal diagonal hidden", "attn_wgmma.cuh",
     "vis = vis && key <= row;", "vis = vis && key < row;", True),
    ("window one key wider", "attn_wgmma.cuh",
     "vis = vis && row - key < mask.window;",
     "vis = vis && row - key <= mask.window;", True),
    ("l rounded to bf16 every tile", "attn_wgmma.cuh",
     "l[h] = corr[h] * l[h] + sum[h];",
     "l[h] = __bfloat162float(__float2bfloat16(corr[h] * l[h] + sum[h]));",
     False),
)
_P, _I, _I64, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_double)
FA_ARGS = (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _D, _I, _I,
           _I64, _P)
ROUTE_ARGS = (_I, _P, _P, _P, _P, _I64)
ROUTES = ("f32_simt", "bf16_simt", "bf16_wgmma")
TOL = ATTN_TOL["bfloat16"]      # the reference's, rtol = atol


def planted(CudaLibrary, index: int, fault):
    """The flash-attention library of a copy of the sources with ``fault``
    (``None``: the control) planted."""
    copy = ROOT / "build" / "attn_faults" / str(index)
    if copy.exists():
        shutil.rmtree(copy)
    for part in ("flash_attention", "gemm"):
        shutil.copytree(ROOT / KERNELS / part / "csrc",
                        copy / part / "csrc")
    if fault is not None:
        _name, file, line, replacement, _must = fault
        path = copy / "flash_attention" / "csrc" / file
        text = path.read_text()
        if text.count(line) != 1:
            raise RuntimeError(f"{file}: {line!r} occurs {text.count(line)} "
                               f"times, expected once")
        path.write_text(text.replace(line, replacement))
    headers = tuple(sorted((copy / "gemm" / "csrc").glob("*.cuh"))
                    + sorted((copy / "flash_attention" / "csrc")
                             .glob("*.cuh")))
    return CudaLibrary(f"attn_fault_{index}",
                       (copy / "flash_attention" / "csrc" /
                        "flash_attention.cu",), headers,
                       {"bind_flash_attention_bf16": FA_ARGS,
                        "bind_flash_attention_route": ROUTE_ARGS})


def main(argv: list[str]) -> int:
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    torch = start("attn_faults")
    if torch is None:
        return 1
    from repro_torch.kernels._build import CudaLibrary
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    faults = (None,) + FAULTS
    libs = [planted(CudaLibrary, i, f) for i, f in enumerate(faults)]
    build_all(libs, ("error",))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cases = []
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
            cases.append((f"({b}, {hq}, {hkv}, {sq}, {skv}, {d}) causal "
                          f"{causal} window {window}", q, k, v, causal,
                          window, exp, exp32, ~seen.any(dim=-1)))

    failed = False
    for fault, lib in zip(faults, libs):
        name = "control (no fault)" if fault is None else fault[0]
        caught, by_limits, by_tolerance, first = 0, 0, 0, None
        worst = {"element": 0.0, "slice": 0.0, "row": 0.0, "max_abs": 0.0}
        for label, q, k, v, causal, window, exp, exp32, blind in cases:
            out = torch.empty_like(q)
            b, hq, sq, d = q.shape
            route = ROUTES[lib.load().bind_flash_attention_route(
                2, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                d)]
            if route != "bf16_wgmma":
                raise RuntimeError(f"{label}: route {route}, expected "
                                   f"bf16_wgmma")
            lib.call("bind_flash_attention_bf16", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), b, hq, k.shape[1], sq,
                     k.shape[2], d, d ** -0.5, int(causal),
                     int(window is not None),
                     0 if window is None else window, stream)
            torch.cuda.synchronize()
            stats = bf16_attention_error(out, exp32, v)
            stats["max_abs"] = (out.double() - exp.double()).abs().max().item()
            # the reference's tolerance alone, and the limits scaled to
            # each value
            tolerance = (bool(torch.isfinite(out).all())
                         and torch.allclose(out.float(), exp.float(),
                                            rtol=TOL, atol=TOL)
                         and not out[:, :, blind].any().item())
            limits = bf16_within(stats)
            by_tolerance += not tolerance
            by_limits += not limits
            ok = tolerance and limits
            for key, x in stats.items():
                # a non-finite statistic is the worst there is, and stays
                if not x <= worst[key] and worst[key] == worst[key]:
                    worst[key] = x
            if not ok:
                caught += 1
                first = first or label
        what = (f"caught by {caught} of {len(cases)} cases (first: {first};"
                f" by the scaled limits {by_limits}, by the 3e-2 tolerance "
                f"{by_tolerance})"
                if caught else f"passes all {len(cases)} cases")
        print(f"[fault] {name}: {what}; worst element {worst['element']:.3f}"
              f" of its limit, slice rms {worst['slice']:.3e}, row rms "
              f"{worst['row']:.3e}, max_abs_err {worst['max_abs']:.3e} "
              f"against the bf16 oracle")
        if fault is None:
            failed |= caught > 0
        elif fault[4] and not caught:
            failed = True
    print(f"[fault] {'FAILED' if failed else 'ok'}: the control passes and "
          f"every fault the checks must catch is caught")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
