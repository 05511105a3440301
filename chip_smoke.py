#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each on its own lines; any failure raises and exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions; TF32 is switched off for float32 products;
2. build: the hand-written GEMM kernel is compiled from
   ``src/repro_torch/kernels/gemm/csrc/gemm.cu`` into ``build/``;
3. the GEMM kernel against its plain PyTorch version on the card, at the
   main path's leaf shape 1024^3 in float32, bfloat16 and float64, at the
   ragged shapes (130, 70, 260) and (1, 128, 1), and for
   ``matmul_accumulate``; at 1024^3 the kernel's time beside the plain
   version's, ``torch.matmul``'s (``torch.addmm``'s for the accumulate) as
   a yardstick the port never calls, and the card's bound;
4. Listing 1 (``run_distributed_gemm``) at n=8192, ib=1024, float32, a
   2x2 grid of simulated ranks on the one card, cold then warm: 512 kernel
   launches and a relative error <= 1e-4 against a float64 product;
5. Strassen (``gemm_strassen``) on the same 8x8 grid of 1024 tiles: 343
   kernel launches and a relative error <= 1e-3;
   after each run of 4 and of 5, dropping the result must give back the
   device memory the run allocated (a finished workflow is freed by
   reference counting, not at the next cyclic garbage collection);
   after the warm run of 4 and of 5, one more run under ``torch.profiler``
   prints the device time by kernel and the device's busy share, and
   checks that the card ran exactly as many GEMM kernels as were counted;
6. a ``kernels`` JSON line (every ported kernel with its launches on the
   main path and its times), the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when CUDA is unavailable or when the
port's sources are not beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_LISTING = 8192          # Listing 1 / Strassen matrix size
IB = 1024                 # tile size: the leaf GEMM is IB^3
SEED = 0

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W):
# HBM 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s; bfloat16
# tensor cores 989 TFLOP/s; float64 tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float64": 67e12}
# kernel vs plain version: (rtol, atol) per dtype.  float32 and bfloat16 are
# the reference's GEMM contract (tests/test_kernels.py); the two versions sum
# in different orders.  float64 sums of 1024 unit-variance products carry
# errors near 1e-13.
TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-1),
       "float64": (1e-10, 1e-9)}


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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


def bound_ms(nbytes: int, flops: int, dtype: str) -> tuple[float, str]:
    """Least time for the work: the larger of bytes over HBM rate and
    operations over the dtype's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_profile(torch, label: str, run, wall_s: float,
                   gemm_launches: int) -> None:
    """Run ``run`` once more under ``torch.profiler`` and print where the
    device time goes: kernel time by name, and the device's busy share of
    the unprofiled warm wall time ``wall_s``.  The profiled count of GEMM
    kernels must equal ``gemm_launches``: the card ran the hand-written
    kernel, not something in its place."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0),
        reverse=True)
    total = sum(ms for ms, _n, _k in kernels)
    gemm = [(ms, cnt) for ms, cnt, key in kernels if "gemm_kernel" in key]
    gemm_ms = sum(ms for ms, _ in gemm)
    gemm_n = sum(cnt for _, cnt in gemm)
    check(gemm_n == gemm_launches,
          f"{label}: profiler saw {gemm_n} GEMM kernels, expected "
          f"{gemm_launches}")
    print(f"[profile] {label} warm: device kernel time {total:.3f} ms of "
          f"{wall_s * 1e3:.3f} ms wall (busy {100 * total / (wall_s * 1e3):.1f}"
          f"%); gemm_kernel {gemm_n} launches {gemm_ms:.3f} ms (mean "
          f"{gemm_ms / gemm_n:.4f} ms, {100 * gemm_ms / total:.1f}% of "
          f"device time)")
    for ms, cnt, key in kernels[:6]:
        print(f"[profile] {label}:   {ms:9.3f} ms {cnt:5d}x {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import core as bind
    from repro_torch.kernels.gemm import kernel, ops, ref
    from repro_torch.linalg import Tiled, gemm_strassen
    from repro_torch.linalg.distributed import run_distributed_gemm

    # -- 1. environment ---------------------------------------------------------
    card = gpu_name_and_power()
    print(f"[env] nvidia-smi: {card}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # -- 2. build -----------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = kernel.build()
    kernel.load()
    print(f"[build] {lib_path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.3f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"[build] {line.strip()}")

    # -- 3. kernel against its plain version --------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def compare(name, got, exp, dtype_name):
        rtol, atol = TOL[dtype_name]
        torch.cuda.synchronize()
        err = (got.double() - exp.double()).abs().max().item() \
            if got.numel() else 0.0
        check(got.dtype == exp.dtype and got.shape == exp.shape,
              f"{name}: {got.dtype}{tuple(got.shape)} != "
              f"{exp.dtype}{tuple(exp.shape)}")
        torch.testing.assert_close(got, exp, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name}: {m}")
        print(f"[gemm] {name}: max_abs_err {err:.3e} within rtol {rtol} "
              f"atol {atol}: ok")
        return err

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float64": torch.float64}
    leaf = {}
    for dname, dt in dtypes.items():
        a, b = rand((IB, IB), dt), rand((IB, IB), dt)
        err = compare(f"matmul {IB}^3 {dname}", ops.matmul(a, b),
                      ref.matmul(a, b), dname)
        ms = time_ms(torch, lambda: ops.matmul(a, b))
        plain = time_ms(torch, lambda: ref.matmul(a, b))
        lib = time_ms(torch, lambda: torch.matmul(a, b))
        flops = 2 * IB ** 3
        bnd, by = bound_ms(3 * IB * IB * a.element_size(), flops, dname)
        print(f"[gemm] matmul {IB}^3 {dname}: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, "
              f"torch.matmul {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
        leaf[("matmul", dname)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                       bound_ms=bnd, bound_by=by,
                                       library_ms=lib)
    for dname, dt in dtypes.items():
        c, a, b = rand((IB, IB), dt), rand((IB, IB), dt), rand((IB, IB), dt)
        err = compare(f"matmul_accumulate {IB}^3 {dname}",
                      ops.matmul_accumulate(c, a, b),
                      ref.matmul_accumulate(c, a, b), dname)
        ms = time_ms(torch, lambda: ops.matmul_accumulate(c, a, b))
        plain = time_ms(torch, lambda: ref.matmul_accumulate(c, a, b))
        lib = time_ms(torch, lambda: torch.addmm(c, a, b))
        flops = 2 * IB ** 3 + IB * IB
        bnd, by = bound_ms(4 * IB * IB * a.element_size(), flops, dname)
        print(f"[gemm] matmul_accumulate {IB}^3 {dname}: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, "
              f"torch.addmm {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
        leaf[("matmul_accumulate", dname)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=lib)
    for m, k, n in ((130, 70, 260), (1, 128, 1)):
        for dname, dt in dtypes.items():
            a, b, c = rand((m, k), dt), rand((k, n), dt), rand((m, n), dt)
            compare(f"matmul ({m},{k},{n}) {dname}", ops.matmul(a, b),
                    ref.matmul(a, b), dname)
            compare(f"matmul_accumulate ({m},{k},{n}) {dname}",
                    ops.matmul_accumulate(c, a, b),
                    ref.matmul_accumulate(c, a, b), dname)

    def device_mallocs():
        # segments the caching allocator has taken with cudaMalloc so far
        return torch.cuda.memory_stats(dev).get("num_device_alloc", 0)

    def freed(label, base):
        # the finished workflow, its executor and every tile must go with
        # the last reference to them, not at the next cyclic collection
        left = torch.cuda.memory_allocated(dev) - base
        print(f"[{label}] device memory held after the run: {left} bytes")
        check(left < IB * IB * 4, f"{label}: {left} bytes still allocated "
              f"after the workflow was dropped")

    # -- 4. Listing 1 ---------------------------------------------------------------
    n = N_LISTING
    A = torch.randn((n, n), generator=gen, device=dev)
    B = torch.randn((n, n), generator=gen, device=dev)
    exact = A.double() @ B.double()
    exact_norm = torch.linalg.norm(exact).item()
    nt = n // IB
    flops = 2 * n ** 3

    def rel_err(C):
        return (torch.linalg.norm(C.double() - exact).item() / exact_norm)

    def listing1():
        C, stats, _ = run_distributed_gemm(A, B, ib=IB, NP=2, NQ=2,
                                           device=dev, backend="serial")
        return C, stats

    launches, walls = {}, {}
    for label in ("cold", "warm"):
        ops.matmul.launches = 0
        ops.matmul_accumulate.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        mallocs = device_mallocs()
        t0 = time.perf_counter()
        C, stats = listing1()
        torch.cuda.synchronize()
        wall = walls["listing1"] = time.perf_counter() - t0
        launches["matmul"] = ops.matmul.launches
        err = rel_err(C)
        print(f"[listing1] {label}: n={n} ib={IB} float32 2x2 ranks: wall "
              f"{wall:.4f} s ({flops / wall / 1e12:.3f} TFLOP/s), "
              f"rel_err {err:.3e}, matmul launches {launches['matmul']}, "
              f"messages {stats.message_count}, bytes "
              f"{stats.bytes_transferred}, wavefronts {len(stats.wavefronts)}, "
              f"cudaMalloc calls {device_mallocs() - mallocs}")
        check(tuple(C.shape) == (n, n) and C.dtype == torch.float32,
              f"listing1: result {C.dtype}{tuple(C.shape)}")
        check(bool(torch.isfinite(C).all()), "listing1: non-finite values")
        check(err <= 1e-4, f"listing1: relative error {err} > 1e-4")
        check(launches["matmul"] == nt ** 3,
              f"listing1: {launches['matmul']} matmul launches, expected "
              f"{nt ** 3}")
        check(ops.matmul_accumulate.launches == 0,
              "listing1: unexpected matmul_accumulate launches")
        del C
        freed("listing1", base)
    device_profile(torch, "listing1", listing1, walls["listing1"], nt ** 3)

    # -- 5. Strassen ----------------------------------------------------------------
    def strassen():
        ex = bind.LocalExecutor(1)
        with bind.Workflow(executor=ex) as wf:
            ta = Tiled.from_array(wf, A, IB, "A")
            tb = Tiled.from_array(wf, B, IB, "B")
            tc = Tiled.zeros(wf, nt, nt, IB, torch.float32, "C", device=dev)
            gemm_strassen(ta, tb, tc)
            C = tc.to_array()
        return C, ex.stats

    for label in ("cold", "warm"):
        ops.matmul.launches = 0
        ops.matmul_accumulate.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        mallocs = device_mallocs()
        t0 = time.perf_counter()
        C, stats = strassen()
        torch.cuda.synchronize()
        wall = walls["strassen"] = time.perf_counter() - t0
        launches["matmul_accumulate"] = ops.matmul_accumulate.launches
        err = rel_err(C)
        print(f"[strassen] {label}: n={n} ib={IB} float32: wall {wall:.4f} s "
              f"({flops / wall / 1e12:.3f} TFLOP/s classical-equivalent), "
              f"rel_err {err:.3e}, matmul_accumulate launches "
              f"{launches['matmul_accumulate']}, ops {stats.ops_executed}, "
              f"wavefronts {len(stats.wavefronts)}, peak live bytes "
              f"{stats.peak_live_bytes}, cudaMalloc calls "
              f"{device_mallocs() - mallocs}")
        check(bool(torch.isfinite(C).all()), "strassen: non-finite values")
        check(err <= 1e-3, f"strassen: relative error {err} > 1e-3")
        check(launches["matmul_accumulate"] == 7 ** 3,
              f"strassen: {launches['matmul_accumulate']} launches, "
              f"expected {7 ** 3}")
        check(ops.matmul.launches == 0, "strassen: unexpected matmul launches")
        del C
        freed("strassen", base)
    device_profile(torch, "strassen", strassen, walls["strassen"], 7 ** 3)
    print(f"[memory] peak allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB")

    # -- 6. result lines --------------------------------------------------------------
    source = "src/repro_torch/kernels/gemm/csrc/gemm.cu"
    replaces = "src/repro/kernels/gemm/kernel.py:47"
    kernels = []
    for name in ("matmul", "matmul_accumulate"):
        check(launches[name] > 0, f"{name}: never launched on the main path")
        kernels.append(dict(name=f"gemm.{name}", route="cuda", source=source,
                            replaces=replaces, launches=launches[name],
                            **leaf[(name, "float32")]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
