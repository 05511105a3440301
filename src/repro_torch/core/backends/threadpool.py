"""Parallel wavefront replay: each level's op bodies run on a thread pool.

The plan's wavefront levels are exactly the sets of ops with no mutual
version dependencies, so their *bodies* may run concurrently — NumPy BLAS
calls and PyTorch operators both release the GIL.  On CUDA tensors a body
only enqueues its kernels; the workers enqueue on the same (default)
stream, so the card runs them in the order they arrive and the overlap is
between the workers' host-side dispatch.  Kernel launch counters are
incremented under a lock (:func:`repro_torch.kernels.count_launch`).

Determinism discipline (see :mod:`.base`): per level, all ships, argument
gathering and callable resolution happen on the main thread in plan order;
only the op bodies are submitted to the pool; results are then committed in
plan order.  The transfer event stream is therefore byte-identical to the
serial backend's — the only legitimate difference is ``peak_live_*``, which
may report *higher* (true-concurrency) peaks because a whole level's inputs
are in flight at once.

Singleton levels bypass the pool entirely, so chain-shaped plans pay no
coordination overhead.  Wider levels are still only *worth* dispatching when
their op bodies outweigh the pool's per-future cost (~tens of µs each): a
level whose widest op's estimated work — ``OpNode.flops`` plus its argument
bytes, a proxy that covers elementwise ops with no flops annotation — falls
below ``dispatch_threshold`` runs inline on the main thread instead
(``inlined_levels``/``pooled_levels`` count the split).  Small-payload
wavefronts therefore degrade to serial-equivalent dispatch instead of
paying 6× pool overhead for µs-scale bodies.

The threshold itself is seeded from the executor's *calibrated* topology
model when one is attached (:func:`threshold_from_topology` scales the
pool's break-even point by the measured ``flops_per_s``); the static
``DISPATCH_THRESHOLD`` only covers uncalibrated executors.  And when a
static pre-sweep shows *no* level of a plan could ever reach the
threshold, the whole plan delegates to the serial backend's tight loop
(``plans_delegated``) — per-level inlining through the generic primitives
still pays ~20% over serial's locals-mirrored hot path, which is exactly
the width-32 bench regression this closes.

A body whose operands lie on the card is priced by its host cost alone:
it only enqueues kernels, which the card runs in order on one stream, so
a future can overlap nothing but the enqueue itself and costs more than
it.  Such an op counts no work (:func:`_on_card`; an op that writes a
version from card operands passes that on to the versions' readers), so
its levels run inline, and a plan whose operands all lie on the card
delegates to the serial backend.  On NumPy and CPU-tensor payloads the
pricing, and every counter, is the reference's.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from operator import attrgetter
from typing import Optional

import torch

from .base import Backend, apply_ships, commit, gather_args, resolve_call
from .serial import SerialPlanBackend

# Default-sized backends share one process-wide pool: executors are created
# per run, test or training step, and a pool per backend instance would leak
# its idle worker threads for the process lifetime.
_SHARED_POOL: Optional[ThreadPoolExecutor] = None
_SHARED_POOL_LOCK = threading.Lock()


def _shared_pool() -> ThreadPoolExecutor:
    global _SHARED_POOL
    if _SHARED_POOL is None:
        with _SHARED_POOL_LOCK:
            if _SHARED_POOL is None:
                _SHARED_POOL = ThreadPoolExecutor(
                    max_workers=min(32, (os.cpu_count() or 4)),
                    thread_name_prefix="bind-wavefront",
                )
    return _SHARED_POOL


# Estimated work units (1 flop ~ 1 byte touched) below which an op's body
# is cheaper than submitting it: a future costs tens of µs of pool overhead
# while NumPy streams ~1 work unit/ns, so ~200k units ≈ break-even.  The
# uncalibrated fallback — an executor carrying a *calibrated* topology model
# (``Topology.calibrate``) seeds the threshold from its measured
# ``flops_per_s`` instead, via :func:`threshold_from_topology`.
DISPATCH_THRESHOLD = 200_000

# Pool cost model behind the calibrated threshold: one future costs ~50 µs
# of submit/wake/result overhead, and a body is only worth pooling once it
# outweighs that by the break-even multiple.  At the generic 1 work-unit/ns
# this reproduces the 200k default exactly.
_FUTURE_COST_S = 50e-6
_BREAK_EVEN_MULTIPLE = 4.0


def threshold_from_topology(topology) -> Optional[int]:
    """Dispatch threshold seeded by a calibrated topology's compute rate.

    ``Topology.calibrate`` fits ``flops_per_s`` from measured op samples;
    the pool's break-even point in *work units* scales linearly with how
    fast this host actually streams them.  Returns None when the model is
    absent or uncalibrated (callers fall back to the static default).
    """
    fps = getattr(topology, "flops_per_s", 0) or 0
    if fps <= 0:
        return None
    return int(fps * _FUTURE_COST_S * _BREAK_EVEN_MULTIPLE)


_flops = attrgetter("flops")


def _on_card(payload) -> bool:
    """True for a payload whose op bodies only enqueue work on the card."""
    return isinstance(payload, torch.Tensor) and payload.is_cuda


def _payload(ex, key):
    """The payload of a materialised version key, or ``None``."""
    ranks = ex._where.get(key)
    return ex._stores[next(iter(ranks))][key] if ranks else None


class ThreadPoolBackend(Backend):
    """Dispatch each wavefront level's independent ops over a worker pool."""

    name = "threads"

    def __init__(self, max_workers: Optional[int] = None,
                 dispatch_threshold: Optional[int] = None):
        self.max_workers = max_workers
        # None = auto: the executor's calibrated topology when it has one,
        # else the static default (an explicit value always wins)
        self.dispatch_threshold = dispatch_threshold
        self._serial = SerialPlanBackend()
        self._pool: Optional[ThreadPoolExecutor] = None   # dedicated only
        self._threshold = DISPATCH_THRESHOLD    # resolved per execute()
        self.inlined_levels = 0     # multi-op levels run on the main thread
        self.pooled_levels = 0      # multi-op levels actually dispatched
        self.plans_delegated = 0    # whole plans handed to the serial loop

    def _get_pool(self) -> ThreadPoolExecutor:
        if self.max_workers is None:
            return _shared_pool()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.max_workers,
                thread_name_prefix="bind-wavefront",
            )
        return self._pool

    def close(self) -> None:
        """Shut down a dedicated (max_workers=...) pool; the shared default
        pool is process-wide and lives until interpreter exit."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _resolve_threshold(self, ex) -> int:
        """The effective dispatch threshold for this executor (see __init__)."""
        if self.dispatch_threshold is not None:
            return self.dispatch_threshold
        calibrated = threshold_from_topology(getattr(ex, "topology", None))
        return DISPATCH_THRESHOLD if calibrated is None else calibrated

    def _plan_inline_throughout(self, ex, wf, plan, threshold: int) -> bool:
        """:meth:`_sweep`'s verdict, reused while nothing it reads changed.

        The sweep reads the threshold, every op's flops and, of the plan's
        input keys (those read before the plan writes them), each one's
        bytes and whether it lies on the card.  A plan replayed from the
        plan cache on inputs of the same sizes and placement therefore gets
        the same verdict, and the check costs a pass over the inputs
        instead of one over every argument of every op.
        """
        memo = plan.inline_memo
        if memo is None:
            written: set = set()
            inputs: dict = {}
            for p in plan.schedule:
                for k in p.arg_keys:
                    if k is not None and k not in written:
                        inputs[k] = None
                written.update(p.write_keys)
            memo = plan.inline_memo = [
                tuple(inputs), tuple(p.op_id for p in plan.schedule), None]
        inputs, op_ids, last = memo
        # map() over C callables: this runs on every replay of the plan
        seen = (threshold,
                tuple(map(_flops, map(wf.ops.__getitem__, op_ids))),
                tuple(map(ex._key_bytes.get, inputs)),
                tuple(map(_on_card, map(partial(_payload, ex), inputs))))
        if last is not None and last[0] == seen:
            return last[1]
        verdict = self._sweep(ex, wf, plan, threshold)
        memo[2] = (seen, verdict)   # one store: threads may share the plan
        return verdict

    def _sweep(self, ex, wf, plan, threshold: int) -> bool:
        """True when no level of the whole plan could reach ``threshold``.

        A static sweep over the schedule *before* execution: per-op work is
        flops plus argument bytes, with not-yet-written keys estimated by
        the widest input of their producing op (elementwise proxy — the
        same one :meth:`_below_threshold` applies to known sizes).  When
        every multi-op level stays below threshold the per-level inline
        loop would run anyway, but paying generic per-op primitives; the
        serial backend's tight loop replays the same plan order faster, so
        such plans delegate wholesale (transitions identical to serial).
        """
        ops = wf.ops
        key_bytes = ex._key_bytes
        est: dict = {}
        on_card: set = set()    # versions an op on card operands writes
        for lo, hi in plan.levels:
            wide = hi - lo > 1
            for idx in range(lo, hi):
                p = plan.schedule[idx]
                work = ops[p.op_id].flops or 0
                widest = 0
                card = False
                for k in p.arg_keys:
                    if k is not None:
                        nb = key_bytes.get(k)
                        if nb is None:
                            nb = est.get(k, 0)
                            card = card or k in on_card
                        else:
                            card = card or _on_card(_payload(ex, k))
                        work += nb
                        if nb > widest:
                            widest = nb
                if card:
                    work = 0        # the host only enqueues (module doc)
                if wide and work >= threshold:
                    return False
                for wk in p.write_keys:
                    est[wk] = widest
                    if card:
                        on_card.add(wk)
        return True

    def _below_threshold(self, ex, ops, schedule, lo: int, hi: int) -> bool:
        """True when every op body of the level is too small to dispatch.

        Work estimate per op: ``OpNode.flops`` when the lowering annotated
        it, plus the summed nbytes of version-key arguments (elementwise
        bodies touch each input byte about once); none for an op with an
        operand on the card (module doc).  The *widest* op decides: one
        heavy body is enough to make overlap worth the pool.
        """
        threshold = self._threshold
        if threshold <= 0:
            return False
        key_bytes = ex._key_bytes
        for idx in range(lo, hi):
            p = schedule[idx]
            work = ops[p.op_id].flops or 0
            for k in p.arg_keys:
                if k is not None:
                    if _on_card(_payload(ex, k)):
                        work = 0
                        break
                    work += key_bytes.get(k, 0)
            if work >= threshold:
                return False
        return True

    def execute(self, ex, wf, plan) -> None:
        self._threshold = threshold = self._resolve_threshold(ex)
        if threshold > 0 and self._plan_inline_throughout(
                ex, wf, plan, threshold):
            # auto-inline: the whole plan is below break-even — the serial
            # backend's locals-mirrored hot loop beats both the pool AND
            # this backend's generic inline loop (the width-32 soft spot)
            self.plans_delegated += 1
            self._serial.execute(ex, wf, plan)
            return
        ops = wf.ops
        schedule = plan.schedule
        inj = getattr(ex, "fault_injector", None)
        if inj is not None and not inj.armed:
            inj = None
        for li, (lo, hi) in enumerate(plan.levels):
            if inj is not None:
                # consult the injector before any of this level's state
                # mutates — a raised RankFailure sees a boundary-consistent
                # executor (all prior levels fully committed)
                inj.check(ex, ex._wavefront_base + li, level=li)
            if hi - lo == 1:                      # chain fast path: no pool
                p = schedule[lo]
                if p.ships:
                    apply_ships(ex, p)
                node = ops[p.op_id]
                args = gather_args(ex, p, node)
                commit(ex, p, node, resolve_call(ex, p, args)(*args))
                continue
            if self._below_threshold(ex, ops, schedule, lo, hi):
                # µs-scale bodies: serial in-place dispatch beats the pool's
                # per-future overhead; transitions are identical to serial
                # (op-at-a-time commits — peaks match the serial reference)
                self.inlined_levels += 1
                for idx in range(lo, hi):
                    p = schedule[idx]
                    if p.ships:
                        apply_ships(ex, p)
                    node = ops[p.op_id]
                    args = gather_args(ex, p, node)
                    commit(ex, p, node, resolve_call(ex, p, args)(*args))
                continue
            self.pooled_levels += 1
            # stage the whole level on the main thread, plan order
            staged = []
            for idx in range(lo, hi):
                p = schedule[idx]
                if p.ships:
                    apply_ships(ex, p)
                node = ops[p.op_id]
                args = gather_args(ex, p, node)
                staged.append((p, node, resolve_call(ex, p, args), args))
            pool = self._get_pool()
            futures = [pool.submit(call, *args) for _, _, call, args in staged]
            # commit in plan order (futures may complete in any order)
            for (p, node, _, _), fut in zip(staged, futures):
                commit(ex, p, node, fut.result())
