"""Quickstart on PyTorch: the Bind programming model, end to end, on the GPU.

The port's counterpart of ``examples/quickstart.py``, with tensor payloads
on the card: sections 1-7 (recording, tiled linear algebra, plan replay,
backends, chain fusion, stitching, the topology model), 8 (fault
tolerance), 9 (the process pool: one worker process per rank, each with
its own CUDA context on the card), 10 (serving), 11 (overload safety) and
12 (the rank mesh: 4 ranks that share the card, or the host).

    PYTHONPATH=src python examples/torch_quickstart.py          # on the GPU
    PYTHONPATH=src python examples/torch_quickstart.py --cpu    # on the host

Without a GPU, and without ``--cpu``, it stops with a message.
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import core as bind  # noqa: E402
from repro_torch.linalg import Tiled, gemm_strassen  # noqa: E402


# 1. declare operations with argument intents (C++ const-ness analogue)
@bind.op
def gemm(a: bind.In, b: bind.In, c: bind.InOut):
    return c + a @ b


@bind.op
def scale(a: bind.InOut, s: bind.In):
    return a * s


@bind.op
def axpy(y: bind.InOut, x: bind.In, s: bind.In):
    return y + x * s


@bind.op
def guard(x: bind.InOut):
    if float(torch.min(x)) < 0:
        raise ValueError("negative activation")
    return x


def close(got, want, rtol):
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host instead of the GPU")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("torch_quickstart: no GPU (torch.cuda.is_available() is "
              "false); pass --cpu to run on the host", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if args.cpu else "cuda")
    print(f"device: {dev}"
          + (f" ({torch.cuda.get_device_name(0)})" if dev.type == "cuda"
             else ""))
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float64):
        return torch.randn(shape, generator=gen, dtype=dtype).to(dev)

    A = randn(4, 4)

    # 2. sequential user code -> transactional DAG (paper Fig. 1)
    ex = bind.LocalExecutor(n_nodes=4)
    with bind.Workflow(n_nodes=4, executor=ex) as wf:
        a = wf.array(A, "a")
        cs = [wf.array(torch.zeros((4, 4), dtype=A.dtype, device=dev), f"c{i}")
              for i in range(4)]
        for i in range(2):
            with bind.node(i):             # placement scope guard
                gemm(a, a, cs[i])          # reads a.v0
        scale(a, 2.0)                       # a.v1 = 2*a.v0
        for i in range(2, 4):
            with bind.node(i):
                gemm(a, a, cs[i])          # reads a.v1 — runs in parallel
        wf.sync()                           # paper's bind::sync()

    print("versions of a:", [repr(v) for v in a.ref.versions])
    print("wavefronts (ops per parallel level):", ex.stats.wavefronts)
    print("implicit transfers:", ex.stats.message_count,
          f"({ex.stats.bytes_transferred} bytes)")
    close(ex.value(cs[3].ref.head), 4 * A @ A, 1e-9)

    # 3. the same model scales to tiled linear algebra: Strassen in 5 lines
    M = randn(64, 64)
    with bind.Workflow() as wf:
        ta = Tiled.from_array(wf, M, ib=16)
        tb = Tiled.from_array(wf, M, ib=16)
        tc = Tiled.zeros(wf, 4, 4, 16, dtype=M.dtype, device=dev)
        gemm_strassen(ta, tb, tc)
        close(tc.to_array(), M @ M, 1e-9)
    n_gemms = sum(1 for op in wf.ops if op.name == "gemm")
    print(f"strassen: {n_gemms} leaf gemms (classical would use 64)")

    # 4. iterative loops replay a *compiled plan*: re-recording the same
    #    DAG hits the process-wide plan cache, so analysis is paid once.
    def sweep():
        ex = bind.LocalExecutor(1)
        with bind.Workflow(executor=ex) as wf:
            u = wf.array(torch.ones((32, 32), device=dev), "u")
            for _ in range(200):
                scale(u, 0.999)
            t0 = time.perf_counter()
            wf.sync()
            ex.flush()      # sync marks the segment; flush executes it
            return time.perf_counter() - t0

    before = dict(bind.PLAN_CACHE_STATS)
    cold, warm = sweep(), sweep()
    h = bind.PLAN_CACHE_STATS
    print(f"plan replay: cold {cold / 200 * 1e6:.1f} us/op -> "
          f"warm {warm / 200 * 1e6:.1f} us/op (host clock: on the GPU, the "
          f"time to enqueue; "
          f"plan cache hits={h['hits'] - before['hits']} "
          f"misses={h['misses'] - before['misses']})")

    # 5. choosing an execution backend: `backend=` only picks the dispatch
    #    strategy for the compiled plan, so values and transfer accounting
    #    are identical across all of them (serial: one op at a time;
    #    threads: a level's ops on a worker pool; fused: same-signature
    #    ops of a level as one torch.func.vmap call).
    for backend in ("serial", "threads", "fused"):
        ex = bind.LocalExecutor(n_nodes=4, backend=backend)
        with bind.Workflow(n_nodes=4, executor=ex) as wf:
            a = wf.array(A, "a")
            cs = [wf.array(torch.zeros((4, 4), dtype=A.dtype, device=dev),
                           f"c{i}") for i in range(4)]
            for i in range(4):
                with bind.node(i):
                    gemm(a, a, cs[i])
            wf.sync()
            close(ex.value(cs[3].ref.head), A @ A, 1e-9)
        print(f"backend={backend:7s}: {ex.stats.message_count} transfers, "
              f"{ex.stats.bytes_transferred} bytes (identical by contract)")

    # 5b. chain fusion: a deep same-signature chain runs as ONE call —
    #     interior versions never materialise, yet live-set stats stay
    #     identical to serial.
    fb = bind.FusedBatchBackend()
    cex = bind.LocalExecutor(1, backend=fb)
    with bind.Workflow(executor=cex) as wf:
        u = wf.array(torch.ones((16, 16), device=dev), "u")
        for _ in range(64):
            scale(u, 1.01)                 # 64 aligned levels, one signature
        wf.fetch(u)
    print(f"chain fusion: {fb.ops_chained} ops ran as "
          f"{fb.chains_dispatched} chain dispatch(es); "
          f"peak live payloads {cex.stats.peak_live_payloads}")

    #     Binary-op chains fuse too: the other operand rides along, and
    #     per-level varying constants are hoisted into one stacked tensor.
    fb2 = bind.FusedBatchBackend()
    cex2 = bind.LocalExecutor(1, backend=fb2)
    with bind.Workflow(executor=cex2) as wf:
        y = wf.array(torch.zeros((16, 16), device=dev), "y")
        x = wf.array(torch.ones((16, 16), device=dev), "x")
        for lvl in range(64):
            axpy(y, x, 1.0 + 0.01 * lvl)   # constant varies per level
        wf.fetch(y)
    print(f"binary-op chain: {fb2.ops_chained} axpy ops ran as "
          f"{fb2.chains_dispatched} chain dispatch(es)")

    # 6. program-level execution: sync() segments accumulate into one
    #    stitched plan, run at the next materialisation boundary.
    fb3 = bind.FusedBatchBackend()
    sex = bind.LocalExecutor(1, backend=fb3)
    with bind.Workflow(executor=sex) as wf:
        u = wf.array(torch.ones((16, 16), device=dev), "u")
        for _seg in range(4):                      # 4 incremental segments
            for _ in range(16):
                scale(u, 1.001)
            wf.sync()                              # seam: deferred, stitched
        wf.fetch(u)                                # materialisation flushes
    print(f"stitched: {fb3.ops_chained} ops across 4 sync() segments ran as "
          f"{fb3.chains_dispatched} chain dispatch(es)")

    #    Loop-shaped programs re-bind iteration 1's stitched plan through
    #    the relocatable program-trace cache: iteration N replans nothing.
    lex = bind.LocalExecutor(1)
    with bind.Workflow(executor=lex) as wf:
        v = wf.array(torch.ones((8, 8), dtype=torch.float64, device=dev), "v")
        for _it in range(5):
            for _ in range(20):
                scale(v, 0.999)
            wf.fetch(v)
    print(f"program-trace cache: {lex.stats.program_cache_hits}/5 loop "
          f"iterations replayed the stitched plan with zero replanning")

    # 7. the topology cost model turns those transfers into simulated time
    from repro_torch.launch.mesh import make_topology

    topo = make_topology("ring", 4, latency_s=1e-6, bandwidth_Bps=10e9)
    print(f"estimated comm makespan on a 4-node ring: "
          f"{ex.stats.estimated_makespan(topo) * 1e6:.2f} us")

    # 8. fault tolerance: the executor records which op produced every
    #    version, so losing a rank does NOT mean replaying the program.
    #    A FaultInjector kills rank 2 mid-GEMM; the recovery planner walks
    #    the lineage of the lost versions back to surviving replicas /
    #    initial placements, recomputes only that ancestor closure, and
    #    resumes the interrupted plan from the failed wavefront:
    from repro_torch.linalg.distributed import (distributed_gemm_listing1,
                                                make_distributed_inputs,
                                                run_distributed_gemm)

    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((32, 32), generator=gen, device=dev)
    B = torch.randn((32, 32), generator=gen, device=dev)
    NP = NQ = 2
    want, _, _ = run_distributed_gemm(A, B, ib=8, NP=NP, NQ=NQ, device=dev)
    inj = bind.FaultInjector.kill_rank(2, wavefront=3)
    fex = bind.LocalExecutor(NP * NQ, fault_injector=inj,
                             topology=make_topology("ring", NP * NQ))
    with bind.Workflow(n_nodes=NP * NQ, executor=fex) as wf:
        a, b, c = make_distributed_inputs(wf, A, B, ib=8, NP=NP, NQ=NQ)
        distributed_gemm_listing1(wf, a, b, c, NP, NQ)
        out = c.to_array()
    assert torch.equal(out, want)
    st = fex.stats
    print(f"killed rank 2 at wavefront 3: {st.recoveries} recovery, "
          f"{st.recomputed_ops}/{st.ops_executed} ops recomputed "
          f"(ratio {st.recompute_ratio:.2f}) — C bit for bit the fault-free "
          f"one")

    #    A *permanently* dead rank additionally triggers elastic rebind:
    #    the cached plan skeleton is re-bound to the surviving n-1 ranks
    #    (replacement priced by the topology model), and every later op
    #    placement is remapped — the dead rank never holds data again.
    #    decommission_rank() exposes the same machinery for planned
    #    shrinks:
    eex = bind.LocalExecutor(NP * NQ, topology=make_topology("ring", NP * NQ))
    with bind.Workflow(n_nodes=NP * NQ, executor=eex) as wf:
        a, b, c = make_distributed_inputs(wf, A, B, ib=8, NP=NP, NQ=NQ)
        distributed_gemm_listing1(wf, a, b, c, NP, NQ)
        wf.sync()
        moved_to = eex.decommission_rank(wf, 2)    # elastic n -> n-1
        distributed_gemm_listing1(wf, a, b, c, NP, NQ)   # c += A@B again
        out = c.to_array()
    close(out, 2 * want, 1e-5)
    assert not eex._stores[2]
    print(f"decommissioned rank 2 (state migrated to ring neighbour "
          f"{moved_to}); second GEMM ran on 3 ranks")

    # 9. real parallelism: backend="procs" executes the SAME compiled plan
    #    on a pool of long-lived OS worker processes, one per simulated
    #    rank, each with its own CUDA context on the card.  Versions live
    #    in multiprocessing.shared_memory segments owned by their worker
    #    (a CUDA tile staged through host memory); ships are cross-process
    #    memcpys; the frontend keeps ShmRef handles and replays the
    #    commit/GC/transfer accounting, so values, stats and the transfer
    #    stream stay identical to serial.  Warm iterations cost ONE
    #    control message per worker ("run plan N").
    #
    #      backend   dispatch                    wins when
    #      serial    in-process, op at a time    chains; reference/debugging
    #      threads   in-process thread pool      bodies that release the GIL
    #      fused     batched (vmap) calls        many small aligned ops
    #      procs     one OS process per rank     NumPy bodies on many cores;
    #                                            real isolation, real kills
    from repro_torch.core.backends.procs import shutdown_pools

    procs = bind.ProcessPoolBackend()
    got, pst, _ = run_distributed_gemm(A, B, ib=8, NP=NP, NQ=NQ, device=dev,
                                       backend=procs)
    assert torch.equal(got, want) and procs.fallbacks == 0
    print(f"procs backend: Listing 1 in {procs.plans_run} plan(s) on "
          f"{NP * NQ} worker processes, {pst.control_messages} control "
          f"messages, {pst.message_count} simulated transfers — C bit for "
          f"bit serial's")

    #    worker-kill recovery: the injector SIGKILLs the rank-1 *process*
    #    mid-plan.  The frontend detects the death at a wavefront boundary,
    #    reads the barrier slots for the proven fully-committed prefix,
    #    respawns the worker, and section 8's lineage recovery recomputes
    #    only the lost closure — same bits out.
    kex = bind.LocalExecutor(NP * NQ, backend=bind.ProcessPoolBackend(),
                             fault_injector=bind.FaultInjector.kill_rank(
                                 1, wavefront=2))
    with bind.Workflow(n_nodes=NP * NQ, executor=kex) as wf:
        a, b, c = make_distributed_inputs(wf, A, B, ib=8, NP=NP, NQ=NQ)
        distributed_gemm_listing1(wf, a, b, c, NP, NQ)
        out = c.to_array()
    assert torch.equal(out, want) and kex.backend.fallbacks == 0
    print(f"SIGKILLed worker 1 mid-plan: {kex.stats.recoveries} recovery, "
          f"{kex.stats.recomputed_ops} ops recomputed — C bit for bit")
    shutdown_pools()

    # 10. always-on serving: a background thread owns the executor and one
    #     long-lived workflow; clients submit step closures and get
    #     futures.  Steps that arrive together flush as ONE program, and on
    #     the fused backend their same-signature ops become one batched
    #     call.  On the GPU a future resolves once the request's kernels
    #     are enqueued: p50/p99 below are host time to enqueue.
    from repro_torch.serve import ServingRuntime

    with ServingRuntime(n_nodes=1, backend="fused", autostart=False) as rt:
        def decode_step(sess):
            x = sess.state.get("x")
            if x is None:                     # first step: allocate state
                x = sess.state["x"] = sess.array(
                    torch.full((8,), float(sess.sid), device=dev), name="x")
            scale(x, 1.01)
            return x

        futs = [rt.session().submit(decode_step) for _ in range(6)]
        rt.start()
        outs = [f.result(timeout=60).cpu() for f in futs]
        for sid, v in zip(range(1, 7), outs):
            close(v, torch.full((8,), sid * 1.01), 1e-6)
        m = rt.metrics
        fb = rt.executor.backend
        print(f"serving: {m.requests_completed} requests in "
              f"{m.flushes} flush(es), {m.coalesced_requests} coalesced, "
              f"{fb.ops_fused} ops fused into {fb.batches_dispatched} "
              f"batched dispatch(es), submit to result (on the GPU: to enqueue) "
              f"p50={m.latency.p50 * 1e3:.2f}ms p99={m.latency.p99 * 1e3:.2f}ms")

    # 11. overload safety: bounded admission sheds the excess retriably; a
    #     failed batch is bisected so one bad request poisons only its own
    #     session; compaction keeps the shared trace bounded.
    from repro_torch.serve import RuntimeOverloaded, SessionPoisoned

    with ServingRuntime(n_nodes=1, backend="fused", autostart=False,
                        max_queue=2, compact_threshold=8) as rt:
        def step_for(value):
            def step(sess):
                x = sess.state.get("x")
                if x is None:
                    x = sess.state["x"] = sess.array(
                        torch.full((8,), value, device=dev), name="x")
                guard(x)
                scale(x, 1.01)
                return x
            return step

        # a) backpressure: the third submission is shed, retriably
        sessions = [rt.session() for _ in range(3)]
        futs = [sessions[0].submit(step_for(1.0)),
                sessions[1].submit(step_for(-1.0))]   # <- the poison pill
        try:
            sessions[2].submit(step_for(3.0))
            raise AssertionError("bounded queue must shed")
        except RuntimeOverloaded:
            pass
        rt.start()

        # b) bisection: only session 1 (the negative input) is poisoned
        close(futs[0].result(timeout=60).cpu(), torch.full((8,), 1.01), 1e-6)
        try:
            futs[1].result(timeout=60)
            raise AssertionError("poison step must fail")
        except ValueError:
            pass
        assert sessions[1].poisoned is not None
        try:
            sessions[1].submit(step_for(1.0))
            raise AssertionError("a poisoned session must refuse")
        except SessionPoisoned:
            pass

        # c) bounded trace: 30 more steps through session 0
        for _ in range(30):
            sessions[0].submit(step_for(1.0)).result(timeout=60)
        m = rt.metrics
        assert m.trace_ops_hwm <= 8
        print(f"overload: {m.requests_shed} shed (retriable), "
              f"{m.bisections} bisection x {m.bisect_probes} probes "
              f"salvaged {m.requests_salvaged} request(s); "
              f"{m.compactions} compactions kept the trace at "
              f"<= {m.trace_ops_hwm} ops across "
              f"{m.requests_completed} requests")

    # 12. lowering onto a rank mesh: the mesh backend executes the SAME
    #     compiled plan on one device per rank — here 4 ranks that share
    #     one device, as the reference's fake CPU devices share a host.
    #     Broadcast ships run as log-depth ppermute rounds (tree / ring /
    #     hierarchical, picked from the topology model), each a copy into
    #     the destination rank's own allocation; kernel-tagged chains run
    #     as ONE chain-kernel launch.  Values, stats and the transfer
    #     stream stay identical to the simulated backends.
    from repro_torch.kernels.gemm.ops import gemm_tile
    from repro_torch.kernels.linear_scan.ops import scan_step

    mesh_b = bind.MeshBackend(devices=(dev,) * 4)
    ex12 = bind.LocalExecutor(4, collective_mode="tree", mode="plan",
                              backend=mesh_b)
    T = 32
    gen12 = torch.Generator().manual_seed(12)
    At = [[torch.randn((T, T), generator=gen12).to(dev) for _ in range(2)]
          for _ in range(2)]
    Bt = [[torch.randn((T, T), generator=gen12).to(dev) for _ in range(2)]
          for _ in range(2)]
    with bind.Workflow(n_nodes=4, executor=ex12) as wf:
        # distributed GEMM: operand tiles live where they were produced,
        # each C tile accumulates on its own rank — every remote operand
        # read becomes a broadcast ship the planner derives, which the
        # mesh backend runs as ppermute rounds
        a12 = [[wf.array(At[i][k], f"A{i}{k}", rank=2 * i + k)
                for k in range(2)] for i in range(2)]
        b12 = [[wf.array(Bt[k][j], f"B{k}{j}", rank=2 * k + j)
                for j in range(2)] for k in range(2)]
        c12 = [[wf.array(torch.zeros((T, T), device=dev), f"C{i}{j}",
                         rank=2 * i + j) for j in range(2)] for i in range(2)]
        for i in range(2):
            for j in range(2):
                with bind.node(2 * i + j):
                    for k in range(2):      # 2-level gemm_tile kernel chain
                        wf.call(gemm_tile, (c12[i][j], a12[i][k], b12[k][j]),
                                name="gemm_tile")
        wf.sync()
        for i in range(2):
            for j in range(2):
                want = At[i][0] @ Bt[0][j] + At[i][1] @ Bt[1][j]
                close(wf.fetch(c12[i][j]), want, 1e-4)
    # ... and a width-1 kernel-tagged scan chain: the whole 8-level run
    # dispatches as ONE chain-kernel launch
    ex12b = bind.LocalExecutor(1, mode="plan", backend=mesh_b)
    with bind.Workflow(n_nodes=1, executor=ex12b) as wf:
        y12 = wf.array(torch.ones((T,), device=dev), "y")
        x12 = wf.array(torch.full((T,), 0.25, device=dev), "x")
        for _ in range(8):
            wf.call(scan_step, (y12, 0.5, x12), name="scan_step")
        got = wf.fetch(y12)
    ref12 = torch.ones((T,), device=dev)
    for _ in range(8):
        ref12 = scan_step(ref12, 0.5, torch.full((T,), 0.25, device=dev))
    assert torch.equal(got, ref12)
    assert mesh_b.ships_lowered > 0 and mesh_b.ships_simulated == 0
    assert mesh_b.pallas_chains_dispatched >= 1
    print(f"mesh backend on 4 ranks sharing {dev}: collectives ACTIVE — "
          f"{mesh_b.ships_lowered} ships lowered / "
          f"{mesh_b.ships_simulated} simulated "
          f"(schedule={mesh_b._schedule_eff}, "
          f"{mesh_b.mesh(4).copies} copies), "
          f"{mesh_b.pallas_chains_dispatched} chain kernel launch(es); "
          f"transfer stream identical to serial by construction")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
