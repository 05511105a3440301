"""Reference planned replay: one op at a time, wavefront-level-major.

The semantics reference every other backend must match, and the fastest
dispatch for plans with little intra-level parallelism.  State is mirrored
into locals for the tight loop and written back once at the end; the
structured per-op primitives in :mod:`.base` compute the exact same
transitions.  Both GC sites go through :func:`~.base.drop_versions`, the
one shared drop idiom.

Op bodies run eagerly.  On CUDA tensors each body enqueues its kernels on
the current stream and returns at once, so the loop runs ahead of the card;
nothing here synchronises.
"""

from __future__ import annotations

from ..stats import TransferEvent, _nbytes
from .base import (Backend, apply_ships, commit, drop_versions, gather_args,
                   resolve_call)


class SerialPlanBackend(Backend):
    """Sequential plan replay with O(1) bookkeeping per step."""

    name = "serial"

    def execute(self, ex, wf, plan) -> None:
        inj = getattr(ex, "fault_injector", None)
        if inj is not None and inj.armed:
            # fault-checked replay via the shared per-op primitives: the
            # executor's counters stay authoritative at every step, so a
            # RankFailure raised at a level boundary observes consistent
            # state (the local-mirroring hot loop below writes back only at
            # the end and must never be interrupted mid-flight)
            return self._execute_checked(ex, wf, plan, inj)
        ops = wf.ops
        stores = ex._stores
        where = ex._where
        key_bytes = ex._key_bytes
        stats = ex._stats
        events = stats.transfers
        lookup = ex._exec_cache.lookup
        base_round = ex._round_counter
        single = ex.n_nodes == 1
        store0 = stores[0]
        wf_base = ex._wavefront_base
        live_b, live_c = ex._live_bytes, ex._live_entries
        peak_b, peak_c = stats.peak_live_bytes, stats.peak_live_payloads

        for p in plan.schedule:
            node = ops[p.op_id]
            if p.ships:
                wavefront = wf_base + p.level - 1
                for vkey, root, transfers in p.ships:
                    payload = stores[root][vkey]
                    nb = _nbytes(payload)
                    ranks = where[vkey]
                    for src, dst, kind, rel in transfers:
                        stores[dst][vkey] = payload
                        ranks.add(dst)
                        live_c += 1
                        events.append(
                            TransferEvent(vkey, src, dst, nb,
                                          base_round + rel, kind, wavefront))
            if single and p.binary_simple:
                # unrolled fast path for the dominant shape: two args, one
                # written payload, one rank — skips list/zip construction
                k0, k1 = p.arg_keys
                a0 = store0[k0] if k0 is not None else node.args[0][1]
                a1 = store0[k1] if k1 is not None else node.args[1][1]
                types = (type(a0), type(a1))
                if types == p.cached_types:
                    call = p.cached_call
                else:
                    call = lookup(p.fn, (a0, a1))
                    # call before types: plans are shared process-wide, and
                    # a concurrent replayer must never see matching types
                    # with the callable still unset.
                    p.cached_call = call
                    p.cached_types = types
                result = call(a0, a1)
                if not isinstance(result, tuple):
                    wk = p.write_keys[0]
                    nb = _nbytes(result)
                    key_bytes[wk] = nb
                    live_b += nb
                    rank = p.exec_ranks[0]
                    where[wk] = {rank}
                    stores[rank][wk] = result
                    live_c += 1
                    if live_b > peak_b:
                        peak_b = live_b
                    if live_c > peak_c:
                        peak_c = live_c
                    if p.gc_keys:
                        live_b, live_c = drop_versions(
                            p.gc_keys, stores, where, key_bytes,
                            live_b, live_c)
                    continue
                # a tuple result for one write: generic handling below
            else:
                if single:
                    args = [store0[k] if k is not None else a[1]
                            for k, a in zip(p.arg_keys, node.args)]
                else:
                    args = [stores[next(iter(where[k]))][k]
                            if k is not None else a[1]
                            for k, a in zip(p.arg_keys, node.args)]
                types = tuple(map(type, args))
                if types == p.cached_types:
                    call = p.cached_call
                else:
                    call = lookup(p.fn, args)
                    p.cached_call = call
                    p.cached_types = types
                result = call(*args)
            if p.simple_write and not isinstance(result, tuple):
                # dominant case: one payload, one executing rank
                wk = p.write_keys[0]
                nb = _nbytes(result)
                key_bytes[wk] = nb
                live_b += nb
                rank = p.exec_ranks[0]
                where[wk] = {rank}
                stores[rank][wk] = result
                live_c += 1
            else:
                if not isinstance(result, tuple):
                    result = (result,)
                if len(result) != p.n_writes:
                    raise ValueError(
                        f"{node.name} returned {len(result)} payloads for "
                        f"{p.n_writes} written args")
                for wk, payload in zip(p.write_keys, result):
                    nb = _nbytes(payload)
                    key_bytes[wk] = nb
                    live_b += nb
                    holders = set(p.exec_ranks)
                    where[wk] = holders
                    for rank in holders:
                        stores[rank][wk] = payload
                    live_c += len(holders)
            if live_b > peak_b:
                peak_b = live_b
            if live_c > peak_c:
                peak_c = live_c
            if p.gc_keys:
                live_b, live_c = drop_versions(
                    p.gc_keys, stores, where, key_bytes, live_b, live_c)

        ex._live_bytes, ex._live_entries = live_b, live_c
        stats.peak_live_bytes, stats.peak_live_payloads = peak_b, peak_c

    def _execute_checked(self, ex, wf, plan, inj) -> None:
        """Level-major replay consulting the fault injector at every
        wavefront boundary; identical transitions to the hot loop (both
        flow through the :mod:`.base` primitives' semantics)."""
        ops = wf.ops
        schedule = plan.schedule
        for li, (lo, hi) in enumerate(plan.levels):
            inj.check(ex, ex._wavefront_base + li, level=li)
            for idx in range(lo, hi):
                p = schedule[idx]
                node = ops[p.op_id]
                if p.ships:
                    apply_ships(ex, p)
                args = gather_args(ex, p, node)
                commit(ex, p, node, resolve_call(ex, p, args)(*args))
