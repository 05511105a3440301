"""Backend protocol + the shared per-op replay primitives.

A backend's :meth:`Backend.execute` replays one compiled
:class:`~repro_torch.core.plan.ExecutionPlan` against a ``LocalExecutor``'s
live state.  The primitives here are the *only* ways a backend touches that
state, and they must be applied **in plan order** for everything except the
op body itself:

* :func:`apply_ships`  — replay an op's precomputed transfer schedule;
* :func:`gather_args`  — resolve an op's payload arguments from the stores;
* :func:`resolve_call` — memoised executable-cache resolution for the body;
* :func:`commit`       — place written payloads, sample live peaks, run GC
  (through :func:`drop_versions`, the one shared drop idiom).

The serial backend inlines the same transitions in its hot loop; the
primitives are the structured form later backends build on.

The frontend↔backend contract: during ``execute`` the executor's
``_round_counter`` still holds the segment's base round (the frontend
advances it by ``plan.n_rounds`` afterwards), and ``ops_executed`` /
``copies_elided`` / ``wavefronts`` accounting is the frontend's job.
Concurrent backends may reorder/overlap **op bodies** freely within one
wavefront level (the plan guarantees level-mates share no version
dependencies) but must keep ships and commits in plan order so the transfer
event stream stays byte-identical across backends.
"""

from __future__ import annotations

from ..stats import TransferEvent, _nbytes


class Backend:
    """Dispatch strategy for a compiled plan (see package docstring)."""

    name = "base"

    def execute(self, ex, wf, plan) -> None:
        raise NotImplementedError

    def reset(self, ex) -> None:
        """Drop any backend-owned state tied to ``ex``'s current payloads.

        Called when the executor forgets its stores (a new ``Workflow``
        restarts the version-id streams, so every held key is stale).
        Simulated backends keep no payload state of their own.
        """

    def __repr__(self) -> str:
        return f"<{type(self).__name__} name={self.name!r}>"


def drop_versions(gc_keys, stores, where, key_bytes, live_b, live_c):
    """Apply an op's GC drop list; returns updated ``(live_bytes, live_c)``.

    Pops the version from every holder rank's store and debits the
    live-footprint accounting.  Callers mirroring the executor's counters
    into locals pass and reassign them; others pass ``ex._live_bytes`` /
    ``ex._live_entries`` directly.
    """
    for dk in gc_keys:
        ranks = where.pop(dk)
        for r in ranks:
            del stores[r][dk]
        live_c -= len(ranks)
        live_b -= key_bytes.pop(dk, 0)
    return live_b, live_c


def apply_ships(ex, p) -> None:
    """Replay ``p``'s precomputed ship schedule (plan order, main thread)."""
    stores, where = ex._stores, ex._where
    events = ex._stats.transfers
    base_round = ex._round_counter
    wavefront = ex._wavefront_base + p.level - 1
    for vkey, root, transfers in p.ships:
        payload = stores[root][vkey]
        nb = _nbytes(payload)
        ranks = where[vkey]
        for src, dst, kind, rel in transfers:
            stores[dst][vkey] = payload
            ranks.add(dst)
            ex._live_entries += 1
            events.append(
                TransferEvent(vkey, src, dst, nb, base_round + rel, kind,
                              wavefront))


def gather_args(ex, p, node) -> list:
    """Resolve ``p``'s call arguments (payloads from stores, constants inline)."""
    if ex.n_nodes == 1:
        store0 = ex._stores[0]
        return [store0[k] if k is not None else a[1]
                for k, a in zip(p.arg_keys, node.args)]
    stores, where = ex._stores, ex._where
    return [stores[next(iter(where[k]))][k] if k is not None else a[1]
            for k, a in zip(p.arg_keys, node.args)]


def resolve_call(ex, p, args):
    """Executable-cache resolution with the plan-op's type memo.

    The cache always resolves to the op's Python body, which is valid for
    any shapes, so the memo keys on payload types alone.
    """
    types = tuple(map(type, args))
    if types == p.cached_types:
        return p.cached_call
    call = ex._exec_cache.lookup(p.fn, args)
    # call before types: plans are shared process-wide, and a concurrent
    # replayer must never see matching types with the callable unset.
    p.cached_call = call
    p.cached_types = types
    return call


def commit(ex, p, node, result) -> None:
    """Place ``p``'s written payloads, sample live peaks, apply GC."""
    stores, where, key_bytes = ex._stores, ex._where, ex._key_bytes
    stats = ex._stats
    if not isinstance(result, tuple):
        result = (result,)
    if len(result) != p.n_writes:
        raise ValueError(f"{node.name} returned {len(result)} payloads for "
                         f"{p.n_writes} written args")
    for wk, payload in zip(p.write_keys, result):
        nb = _nbytes(payload)
        key_bytes[wk] = nb
        ex._live_bytes += nb
        holders = set(p.exec_ranks)
        where[wk] = holders
        for rank in holders:
            stores[rank][wk] = payload
        ex._live_entries += len(holders)
    if ex._live_bytes > stats.peak_live_bytes:
        stats.peak_live_bytes = ex._live_bytes
    if ex._live_entries > stats.peak_live_payloads:
        stats.peak_live_payloads = ex._live_entries
    if p.gc_keys:
        ex._live_bytes, ex._live_entries = drop_versions(
            p.gc_keys, stores, where, key_bytes,
            ex._live_bytes, ex._live_entries)
