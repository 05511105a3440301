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

A :class:`FaultInjector` on the executor is consulted by every backend at
each wavefront boundary, before the level mutates any state; a due kill or
ship drop raises :class:`RankFailure`, which the executor recovers from.

The fused backends keep a level's results as one stacked buffer
(:class:`BatchBucket`) whose rows live in the stores as lazy
:class:`BatchSlice` payloads; :func:`spill_dead_buckets` concretises the
survivors of a partly consumed bucket so the buffer can go.

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


class RankFailure(RuntimeError):
    """A simulated rank failure, raised at a wavefront boundary.

    Carries everything the recovery planner (:mod:`repro_torch.core.recovery`)
    needs: the lost ``rank``, the global ``wavefront`` ordinal the failure
    precedes (an index into ``ExecutionStats.wavefronts``), the
    plan-relative ``level`` ordinal (``None`` under the interpreter, which
    reports ``op_index`` instead), the failure ``kind`` (``"kill"`` wipes
    the rank's whole store, ``"ship"`` loses one in-flight replica listed
    in ``lost_keys``), and whether the rank is ``permanent``ly dead
    (triggering elastic rebind instead of transient recovery).
    """

    def __init__(self, rank: int, wavefront: int, *, level=None,
                 op_index=None, kind: str = "kill", permanent: bool = False,
                 lost_keys=None):
        super().__init__(
            f"rank {rank} {'lost a ship' if kind == 'ship' else 'failed'} "
            f"at wavefront {wavefront}"
            f"{' (permanent)' if permanent else ''}")
        self.rank = rank
        self.wavefront = wavefront
        self.level = level
        self.op_index = op_index
        self.kind = kind
        self.permanent = permanent
        self.lost_keys = lost_keys


class FaultInjector:
    """Deterministic seeded fault policies, consulted at wavefront boundaries.

    Every backend calls :meth:`check` once per wavefront level (the
    interpreter: once per op) *before* mutating any state for that level,
    so a raised :class:`RankFailure` always observes a consistent store.
    Policies are one-shot and fire at the **first** boundary whose global
    wavefront ordinal reaches their target (fused chains dispatch several
    levels atomically, so a mid-chain target fires at the chain's exit
    boundary).  The executor suspends the injector while a recovery
    sub-plan runs — recovery never re-faults itself.

    Construct via the policy classmethods (each returns a fresh injector,
    so a fuzzer replaying one scenario across backends builds one per run)
    or compose several policies with ``FaultInjector([...])``.
    """

    def __init__(self, policies=()):
        self.policies = [dict(p) for p in policies]
        self.fired: list[dict] = []
        self.delays = 0
        self.delay_s = 0.0
        self._suspended = 0

    # -- policy constructors -------------------------------------------------
    @classmethod
    def kill_rank(cls, rank: int, wavefront: int,
                  permanent: bool = False) -> "FaultInjector":
        """Kill rank ``rank`` at the first boundary >= ``wavefront``."""
        return cls([{"kind": "kill", "rank": rank, "wavefront": wavefront,
                     "permanent": permanent, "fired": False}])

    @classmethod
    def drop_ship(cls, wavefront: int, seed: int = 0) -> "FaultInjector":
        """Lose one replicated version from one holder rank (a transfer
        that never arrived) at the first boundary >= ``wavefront`` where a
        replica exists; ``seed`` picks the victim deterministically."""
        return cls([{"kind": "ship", "wavefront": wavefront, "seed": seed,
                     "fired": False}])

    @classmethod
    def delay_rank(cls, rank: int, wavefront: int,
                   seconds: float = 0.0) -> "FaultInjector":
        """A straggler, not a failure: counted (and optionally priced) but
        raising nothing — the plan's wavefront barrier absorbs it."""
        return cls([{"kind": "delay", "rank": rank, "wavefront": wavefront,
                     "seconds": seconds, "fired": False}])

    # -- executor-side protocol ----------------------------------------------
    @property
    def armed(self) -> bool:
        """True while an un-fired policy could still raise."""
        return (not self._suspended
                and any(not p["fired"] for p in self.policies))

    def suspend(self) -> None:
        self._suspended += 1

    def resume(self) -> None:
        self._suspended -= 1

    def _pick_replica(self, ex, seed: int):
        """Deterministic (version, holder) victim for a ship drop: a
        non-root replica of some multiply-held version, or None if nothing
        is replicated yet (the policy then waits for a later boundary)."""
        cands = sorted(
            (k, tuple(sorted(rs))) for k, rs in ex._where.items()
            if len(rs) >= 2)
        if not cands:
            return None
        vkey, ranks = cands[seed % len(cands)]
        return vkey, ranks[-1]

    def check(self, ex, wavefront: int, level=None, op_index=None) -> None:
        """Fire any due policy; raises :class:`RankFailure` for kill/ship."""
        if self._suspended:
            return
        for pol in self.policies:
            if pol["fired"] or wavefront < pol["wavefront"]:
                continue
            kind = pol["kind"]
            if kind == "delay":
                pol["fired"] = True
                self.delays += 1
                self.delay_s += pol.get("seconds", 0.0)
                continue
            if kind == "ship":
                victim = self._pick_replica(ex, pol.get("seed", 0))
                if victim is None:
                    continue
                vkey, dst = victim
                pol["fired"] = True
                self.fired.append(pol)
                raise RankFailure(dst, wavefront, level=level,
                                  op_index=op_index, kind="ship",
                                  lost_keys=(vkey,))
            pol["fired"] = True
            self.fired.append(pol)
            raise RankFailure(pol["rank"], wavefront, level=level,
                              op_index=op_index, kind="kill",
                              permanent=pol.get("permanent", False))


class Backend:
    """Dispatch strategy for a compiled plan (see package docstring)."""

    name = "base"

    def execute(self, ex, wf, plan) -> None:
        raise NotImplementedError

    def reset(self, ex) -> None:
        """Drop any backend-owned state tied to ``ex``'s current payloads.

        Called when the executor forgets its stores (a new ``Workflow``
        restarts the version-id streams, so every held key is stale).
        Simulated backends keep no payload state of their own — the
        process-pool backend overrides this to clear worker arenas.
        """

    def __repr__(self) -> str:
        return f"<{type(self).__name__} name={self.name!r}>"


class BatchBucket:
    """Residency bookkeeping for one fused dispatch's stacked result buffer.

    ``live`` holds the row indices whose store payload is still a lazy
    :class:`BatchSlice` of this buffer; ``rows`` maps each committed row to
    its version key.  Every path that removes a lazy row from the stores —
    GC, ship/fetch materialisation, spill — must :meth:`BatchSlice.release`
    it, so :func:`spill_dead_buckets` can tell a fully-consumed bucket (the
    chain-of-wavefronts case: drop the registry entry, nothing to do) from a
    partially-GC'd one whose survivors are pinning the whole buffer.
    """

    __slots__ = ("buffer", "n", "live", "rows")

    def __init__(self, buffer, n: int):
        self.buffer = buffer
        self.n = n
        self.live = set(range(n))
        self.rows: dict = {}            # row index -> version key


class BatchSlice:
    """Lazy row ``index`` of a fused bucket's stacked result buffer.

    Stored in the executor's stores like any payload; ``nbytes`` reports the
    row's size so transfer and live-set accounting stay identical to per-op
    execution.  ``aval`` is the row's ``(shape, dtype, device)``.

    ``materialize()`` returns the row as a *view* of the buffer — fine for
    an op body that consumes it at once, but a view keeps the whole stacked
    buffer alive, so anything that keeps the row in the stores takes
    ``concrete()``, a copy of the row alone (the reference's
    ``buffer[index]`` is a new array either way).  ``release()`` tells the
    owning :class:`BatchBucket` the row no longer pins the buffer (the
    caller has dropped or concretised its store entries).
    """

    __slots__ = ("buffer", "index", "_nb", "aval", "bucket")

    def __init__(self, buffer, index: int, nb: int, aval, bucket=None):
        self.buffer = buffer
        self.index = index
        self._nb = nb
        self.aval = aval        # (shape, dtype, device) of the row
        self.bucket = bucket

    @property
    def nbytes(self) -> int:
        return self._nb

    @property
    def shape(self):
        return self.aval[0]

    @property
    def dtype(self):
        return self.aval[1]

    @property
    def device(self):
        return self.aval[2]

    def materialize(self):
        """The row as a view of the stacked buffer."""
        return self.buffer[self.index]

    def concrete(self):
        """The row as a tensor of its own (no reference to the buffer)."""
        return self.buffer[self.index].clone()

    def release(self) -> None:
        if self.bucket is not None:
            self.bucket.live.discard(self.index)

    def __repr__(self) -> str:
        shape, dtype, device = self.aval
        return (f"BatchSlice({dtype}{list(shape)} on {device}, "
                f"row {self.index})")


def materialize(payload):
    """Resolve a possibly-lazy payload to a tensor (a view for a row)."""
    if type(payload) is BatchSlice:
        return payload.materialize()
    return payload


def drop_versions(gc_keys, stores, where, key_bytes, live_b, live_c):
    """Apply an op's GC drop list; returns updated ``(live_bytes, live_c)``.

    Pops the version from every holder rank's store, releases lazy
    :class:`BatchSlice` rows from their bucket (so
    :func:`spill_dead_buckets` sees the same row-liveness regardless of
    which backend executed the drop), and debits the live-footprint
    accounting.  Callers mirroring the executor's counters into locals pass
    and reassign them; others pass ``ex._live_bytes`` / ``ex._live_entries``
    directly.
    """
    for dk in gc_keys:
        ranks = where.pop(dk)
        for r in ranks:
            dead = stores[r].pop(dk)
            if type(dead) is BatchSlice:
                dead.release()
        live_c -= len(ranks)
        live_b -= key_bytes.pop(dk, 0)
    return live_b, live_c


def spill_dead_buckets(ex) -> int:
    """Concretise the surviving rows of partially-dead buckets.

    Once any of a bucket's rows have been GC'd (or fetched/shipped), a
    surviving lazy row would pin the *whole* stacked buffer — device
    residency exceeding ``stats.peak_live_bytes`` (which prices rows
    individually) by up to the batch width.  This pass copies every
    surviving row of such a bucket out of the buffer
    (:meth:`BatchSlice.concrete`) and drops the buffer, making actual
    residency match the accounting; fully-live buckets are left lazy (the
    chain pass-through case) and fully-dead ones just leave the registry.
    Called by the fused backend at each level boundary and by the executor
    frontend at the end of each program flush.  Returns the number of rows
    spilled.
    """
    buckets = ex._lazy_buckets
    if not buckets:
        return 0
    stores, where = ex._stores, ex._where
    spilled = 0
    for bucket in list(buckets):
        live = bucket.live
        if len(live) == bucket.n:       # untouched: stays one lazy buffer
            continue
        for idx in sorted(live):
            vkey = bucket.rows.get(idx)
            ranks = where.get(vkey) if vkey is not None else None
            if not ranks:
                continue
            concrete = None
            for r in ranks:
                payload = stores[r].get(vkey)
                if type(payload) is BatchSlice and payload.bucket is bucket:
                    if concrete is None:
                        concrete = payload.concrete()
                    stores[r][vkey] = concrete
            if concrete is not None:
                spilled += 1
        live.clear()
        buckets.discard(bucket)
    return spilled


def apply_ships(ex, p, lower=None) -> None:
    """Replay ``p``'s precomputed ship schedule (plan order, main thread).

    ``lower(payload, root)``, where given, runs the ship and returns what
    each rank then holds, indexed by rank; where it returns ``None`` the
    destinations hold the payload itself (the ship is simulated).
    """
    stores, where = ex._stores, ex._where
    events = ex._stats.transfers
    base_round = ex._round_counter
    wavefront = ex._wavefront_base + p.level - 1
    for vkey, root, transfers in p.ships:
        payload = stores[root][vkey]
        held = None if lower is None else lower(payload, root)
        nb = _nbytes(payload)
        ranks = where[vkey]
        for src, dst, kind, rel in transfers:
            stores[dst][vkey] = payload if held is None else held[dst]
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
