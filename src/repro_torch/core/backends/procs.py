"""Process-pool backend: one long-lived worker process per simulated rank.

The reference's only backend with real parallelism for NumPy op bodies
(they hold the GIL, so ``threads`` cannot overlap them): this one spawns
one worker per rank, keeps every rank-local store in a shared-memory arena
(:mod:`repro_torch.core.shm_store`), and replays wavefronts in lockstep
behind a spin barrier.  Ships are cross-process
memcpys between arenas; per-op GC drop lists are re-bucketed per rank so
workers free segments eagerly.

Control-plane economics: a plan is sliced per rank
(:func:`repro_torch.core.plan.slice_for_ranks`) and shipped **once**; a later run
whose plan is a per-ref key translation of a shipped template (the
program-trace-cache loop case, detected by
:func:`repro_torch.core.plan.key_map`) sends only a "run plan N, epoch K"
message carrying the translation table — steady-state loop iterations cost one
tiny message per worker, no per-op traffic (``stats.control_messages``
tracks this).

The frontend never trusts workers with semantics: after a run it *virtually
replays* the plan's ship/commit/GC accounting against its own stores
(placing :class:`~repro_torch.core.shm_store.ShmRef` proxies carrying the
worker-reported nbytes), so ``ExecutionStats`` and the transfer-event
stream stay byte-identical to serial replay — the conformance contract
every backend owes.

Failure handling: a worker that dies (real SIGKILL — injected by a
``kill_rank`` fault policy or delivered externally) or stops heartbeating
(the :mod:`repro_torch.runtime.supervisor` protocol) surfaces as a
:class:`RankFailure` at the exact wavefront boundary the shared ``slots``
array proves fully committed, and the existing narrow-recovery machinery
does the rest.  Armed fault policies the real path cannot realise
physically (ship drops, which need mid-plan replica introspection) fall
back to the serial checked path after materialising worker-resident
payloads; so do plans whose op bodies or constants cannot be pickled
(closures).  Each fallback is counted (``fallbacks``).

On the card: a worker is a process of its own with its own CUDA context.
Payloads cross process boundaries only through the arenas — never through
the control pipe, where ``torch``'s reducers would send a CUDA tensor as an
IPC handle — so a CUDA operand is staged through host memory: the frontend
copies its seeds device-to-host into the arenas, every operand a worker
reads is copied host-to-device, every result device-to-host, and a fetch
copies host-to-device again.  Op bodies run as on ``serial``; a GEMM leaf
on CUDA tiles launches the hand-written kernel inside the worker, counted
in that process.
"""

from __future__ import annotations

import atexit
import itertools
import os
import pickle
import shutil
import signal
import tempfile
import time
import weakref

from ..plan import key_map, plan_consts, slice_for_ranks, translate
from ..shm_store import (BarrierAborted, ShmBarrier, ShmRef, WorkerArena,
                         pack, peek_nbytes, segment_name, unlink_segment,
                         unpack, write_segment)
from ..stats import TransferEvent, _nbytes
from .base import Backend, RankFailure, drop_versions, materialize
from .serial import SerialPlanBackend

_FALLBACK = object()          # sentinel: this plan must run on the serial path
_OWNER_SEQ = itertools.count(1)
_UID_SEQ = itertools.count(1)

# Inside a pool worker this is the worker's rank; None in the frontend.
# Observability for op bodies and tests (e.g. hang exactly one rank).
_CURRENT_RANK = None


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------

def _worker_main(rank, conn, barrier, slots, session, hb_path, hb_interval,
                 barrier_timeout):
    """Long-lived rank worker: serve sliced plans from the parent forever.

    Protocol (the pipe is FIFO, so messages need no acks for ordering; the
    reset's reply orders the frontend's seed segments, which travel
    outside the pipe):

    * ``("plan", uid, n_levels, fns, consts, levels)`` — cache a sliced
      plan; ``levels[li] = (pulls, ops, drops)`` in template keys; tensor
      constants arrive packed (:func:`~repro_torch.core.shm_store.pack`).
    * ``("run", uid, trans, consts, seeds, kill_at)`` — execute a cached
      plan with keys translated through the per-ref ``trans`` table
      (:func:`~repro_torch.core.plan.key_map`; ``None`` → identity),
      optionally overriding the constant vector, adopting first the
      segments the frontend seeded under this rank's name (``seeds``:
      absolute version keys).  ``kill_at`` (fault injection) SIGKILLs
      this process at the start of that level.
      Replies ``("done", uid, commits)`` / ``("aborted", uid, commits)``
      / ``("error", uid, traceback)``; ``commits`` are ``(key, nbytes)``
      for writes this rank reports (it is the op's first exec rank).
    * ``("reset",)`` — clear the arena and plan cache (new plan epoch:
      ``Workflow()`` restarts the version-id streams, so keys would
      collide across owners), then reply ``("reset",)``: the frontend
      waits for it before it seeds segments under the same names.
    * ``("shutdown",)`` — clear the arena and exit.

    Level loop invariant (one barrier per level, race-free): pulls for
    level *l* happen between barrier *l-1* and barrier *l*; the pulled
    segment was committed before barrier *p* ≤ *l-1* (its producing
    level) and is dropped by its owner only after barrier of its last
    reading level ≥ *l* — so every cross-process read is fenced by at
    least one barrier on each side.  ``slots[rank]`` (completed-level
    count) is advanced *before* the barrier, making ``min(slots)`` a
    proven fully-committed wavefront boundary for failure recovery.
    """
    from ...runtime.supervisor import touch_heartbeat

    global _CURRENT_RANK
    _CURRENT_RANK = rank
    arena = WorkerArena(session, rank)
    plans = {}
    last_hb = [0.0]

    def hb():
        now = time.monotonic()
        if now - last_hb[0] >= hb_interval:
            touch_heartbeat(hb_path)
            last_hb[0] = now

    hb()
    while True:
        while not conn.poll(0.05):
            hb()
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        except Exception:
            # a message that fails to *unpickle* (e.g. a plan slice whose
            # fn module only imports in the parent) must not kill the
            # worker — report it and let the frontend surface the cause
            import traceback
            try:
                conn.send(("error", None, traceback.format_exc()))
            except OSError:
                break
            continue
        cmd = msg[0]
        if cmd == "plan":
            _, uid, n_levels, fns, consts, levels = msg
            plans[uid] = [n_levels, fns, [unpack(c) for c in consts], levels]
            continue
        if cmd == "reset":
            arena.clear()
            plans.clear()
            conn.send(("reset",))
            continue
        if cmd == "shutdown":
            arena.clear()
            break
        # cmd == "run"
        _, uid, trans, new_consts, seeds, kill_at = msg
        commits = []
        try:
            n_levels, fns, consts, levels = plans[uid]
            if new_consts is not None:
                consts = [unpack(c) for c in new_consts]
                plans[uid][2] = consts
            if trans:
                def tr(k, _t=trans):
                    return translate(_t, k)
            else:
                def tr(k):
                    return k
            for key in seeds:                # seeds arrive in absolute keys
                arena.adopt(key)
            # seed fence: level-0 pulls read *seeded* segments on other
            # ranks, which have no producing level (and hence no barrier)
            # before them — one extra round serialises seeding vs pulling
            barrier.wait(timeout=barrier_timeout, poke=hb)
            for li in range(n_levels):
                hb()
                if kill_at == li:
                    os.kill(os.getpid(), signal.SIGKILL)
                pulls, ops, drops = levels[li]
                for k, src in pulls:
                    arena.pull(tr(k), src)
                for fi, argspec, wkeys, report in ops:
                    # the port's executable cache resolves every signature
                    # to the op's Python body, so the body is called as is
                    args = [arena.view(tr(v)) if tag == 0 else consts[v]
                            for tag, v in argspec]
                    result = fns[fi](*args)
                    del args
                    if len(wkeys) == 1 and not isinstance(result, tuple):
                        k2 = tr(wkeys[0])
                        arena.put(k2, result)
                        if report:
                            commits.append((k2, _nbytes(result)))
                    else:
                        if not isinstance(result, tuple):
                            result = (result,)
                        for wk, payload in zip(wkeys, result):
                            k2 = tr(wk)
                            arena.put(k2, payload)
                            if report:
                                commits.append((k2, _nbytes(payload)))
                slots[rank] = li + 1
                barrier.wait(timeout=barrier_timeout, poke=hb)
                for k in drops:
                    arena.drop(tr(k))
            conn.send(("done", uid, tuple(commits)))
        except BarrierAborted:
            conn.send(("aborted", uid, tuple(commits)))
        except Exception:
            import traceback
            barrier.abort()     # unblock siblings before reporting
            try:
                conn.send(("error", uid, traceback.format_exc()))
            except OSError:
                break
    conn.close()


# ---------------------------------------------------------------------------
# Worker pool (shared per world size, persistent across executors)
# ---------------------------------------------------------------------------

class _ShippedPlan:
    """Frontend record of a plan family resident in the workers."""

    __slots__ = ("levels_ref", "template", "consts", "read_holders", "uid")

    def __init__(self, levels_ref, template, consts, read_holders, uid):
        self.levels_ref = levels_ref    # strong ref keeps id() stable
        self.template = template
        self.consts = consts
        self.read_holders = read_holders
        self.uid = uid


class WorkerPool:
    """``n_ranks`` spawned rank workers + their shared coordination state.

    Pools are shared per world size and persist across executors (spawn +
    the ``torch`` import is the expensive part); :meth:`bind` hands the pool to a new
    owner by materialising the previous owner's worker-resident payloads,
    resetting arenas, and respawning any dead workers.
    """

    def __init__(self, n_ranks: int, hb_interval: float,
                 barrier_timeout: float):
        import multiprocessing
        self.ctx = multiprocessing.get_context("spawn")
        self.n_ranks = n_ranks
        self.session = f"{os.getpid():x}-{next(_OWNER_SEQ)}"
        self.hb_interval = hb_interval
        self.barrier_timeout = barrier_timeout
        self.hb_dir = tempfile.mkdtemp(prefix="bind_hb_")
        self.barrier = ShmBarrier(self.ctx, n_ranks)
        self.slots = self.ctx.RawArray("l", n_ranks)
        self.procs = [None] * n_ranks
        self.conns = [None] * n_ranks
        self.spawned_at = [0.0] * n_ranks
        self.alive = [False] * n_ranks
        self.owner_ex = lambda: None    # weakref to the owning executor
        self.shipped: dict[int, _ShippedPlan] = {}
        for r in range(n_ranks):
            self.spawn(r)
        atexit.register(self.shutdown)

    def hb_path(self, rank: int) -> str:
        return os.path.join(self.hb_dir, f"hb_r{rank}")

    def spawn(self, rank: int) -> None:
        if self.conns[rank] is not None:
            self.conns[rank].close()
        parent, child = self.ctx.Pipe()
        try:
            os.unlink(self.hb_path(rank))
        except OSError:
            pass
        p = self.ctx.Process(
            target=_worker_main,
            args=(rank, child, self.barrier, self.slots, self.session,
                  self.hb_path(rank), self.hb_interval,
                  self.barrier_timeout),
            daemon=True, name=f"bind-rank{rank}")
        p.start()
        child.close()
        self.procs[rank] = p
        self.conns[rank] = parent
        self.spawned_at[rank] = time.time()
        self.alive[rank] = True

    def alive_ranks(self) -> list[int]:
        return [r for r in range(self.n_ranks) if self.alive[r]]

    def bind(self, ex) -> None:
        """Make ``ex`` the pool's owner (reset arenas on a change of hands,
        respawning dead workers; a same-owner rebind only heals deaths)."""
        owner = self.owner_ex()
        if owner is ex:
            for r in range(self.n_ranks):
                if self.alive[r] and not self.procs[r].is_alive():
                    # died outside a run (e.g. killed between plans): its
                    # arena is gone — surface as data loss on next access,
                    # but keep the pool usable
                    self.alive[r] = False
                    self.shipped.clear()
            return
        if owner is not None:
            _materialize_stores(owner)      # rescue its worker payloads
        running = []
        for r in range(self.n_ranks):
            if self.procs[r] is None or not self.procs[r].is_alive():
                self.spawn(r)           # a fresh arena: nothing to reset
            else:
                running.append(r)
                self.alive[r] = True
        self.reset_workers(running)
        self.barrier.reset(self.n_ranks)
        for r in range(self.n_ranks):
            self.slots[r] = 0
        self.owner_ex = weakref.ref(ex)

    def reset_workers(self, ranks=None) -> None:
        """Clear the arenas and plans of ``ranks`` (default: every live
        worker), and wait until each has: the frontend writes seed segments
        under the names the workers' old segments had, so a reset still in
        flight would unlink them.  A worker that does not answer is
        replaced by a fresh one."""
        sent = []
        for r in self.alive_ranks() if ranks is None else ranks:
            try:
                self.conns[r].send(("reset",))
                sent.append(r)
            except OSError:
                self.respawn(r)
        for r in sent:
            try:
                ok = (self.conns[r].poll(self.barrier_timeout)
                      and self.conns[r].recv() == ("reset",))
            except (EOFError, OSError):
                ok = False
            if not ok:
                self.respawn(r)
        self.shipped.clear()

    def respawn(self, rank: int) -> None:
        """Replace rank ``rank``'s worker by a fresh one (empty arena)."""
        p = self.procs[rank]
        if p is not None and p.is_alive():
            p.kill()
            p.join()
        self.spawn(rank)

    def decommission(self, rank: int) -> None:
        self.alive[rank] = False
        self.barrier.resize(len(self.alive_ranks()))

    def shutdown(self) -> None:
        atexit.unregister(self.shutdown)
        for r in range(self.n_ranks):
            p = self.procs[r]
            if p is None:
                continue
            if p.is_alive():
                try:
                    self.conns[r].send(("shutdown",))
                except OSError:
                    pass
        deadline = time.monotonic() + 10.0
        for r, p in enumerate(self.procs):
            if p is not None:
                p.join(max(0.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join()
                self.conns[r].close()
            self.procs[r] = None
            self.alive[r] = False
        shutil.rmtree(self.hb_dir, ignore_errors=True)


_POOLS: dict[int, WorkerPool] = {}


def shared_pool(n_ranks: int, hb_interval: float,
                barrier_timeout: float) -> WorkerPool:
    pool = _POOLS.get(n_ranks)
    if pool is None:
        _POOLS[n_ranks] = pool = WorkerPool(n_ranks, hb_interval,
                                            barrier_timeout)
    return pool


def shutdown_pools() -> None:
    """Shut every shared pool down now (at exit otherwise): the owners'
    worker-resident payloads are copied into their stores first, then each
    worker unlinks its segments and exits."""
    for pool in list(_POOLS.values()):
        owner = pool.owner_ex()
        if owner is not None:
            _materialize_stores(owner)
        pool.shutdown()
    _POOLS.clear()


def _materialize_stores(ex) -> None:
    """Concretise every :class:`ShmRef` in ``ex``'s stores (worker arenas
    are about to be reset, or a serial fallback needs real payloads)."""
    cache: dict = {}
    for vkey, ranks in ex._where.items():
        for r in ranks:
            payload = ex._stores[r].get(vkey)
            if type(payload) is ShmRef:
                concrete = cache.get(vkey)
                if concrete is None:
                    cache[vkey] = concrete = payload.materialize()
                ex._stores[r][vkey] = concrete


# ---------------------------------------------------------------------------
# Backend
# ---------------------------------------------------------------------------

class ProcessPoolBackend(Backend):
    """One worker process per rank; shared-memory stores; real parallelism.

    Parameters
    ----------
    heartbeat_timeout:
        Seconds without a worker heartbeat before it is declared hung and
        killed (surfacing as a *permanent* :class:`RankFailure`, driving
        elastic rebind).  ``None`` (default) detects only real process
        deaths — heartbeats are still written, only the watchdog is off.
    heartbeat_interval:
        How often workers touch their heartbeat file.
    barrier_timeout:
        Worker-side cap on one wavefront barrier wait.
    """

    name = "procs"

    def __init__(self, heartbeat_timeout=None, heartbeat_interval: float = 0.25,
                 barrier_timeout: float = 120.0):
        self.heartbeat_timeout = heartbeat_timeout
        self.heartbeat_interval = heartbeat_interval
        self.barrier_timeout = barrier_timeout
        self._serial = SerialPlanBackend()
        # observability: plans the workers ran, and plans that fell back to
        # the serial path in this process (ship-drop policies, unpicklable
        # bodies or constants, no live worker)
        self.plans_run = 0
        self.fallbacks = 0

    # -- fault-policy translation -------------------------------------------
    def _translate_kills(self, ex, inj, plan, pool):
        """Realise armed fault policies as *real* worker kills.

        Returns ``{rank: (level, permanent)}`` for the earliest due kill
        (serial fires one failure per boundary; later policies stay armed
        for the replanned suffix), ``_FALLBACK`` if any armed policy cannot
        be realised physically (ship drops need mid-plan replica state;
        kills of already-dead ranks need the simulated store), or ``{}``.
        """
        n_levels = len(plan.levels)
        due = None
        for pol in inj.policies:
            if pol["fired"]:
                continue
            kind = pol["kind"]
            if kind == "delay":
                if pol["wavefront"] - ex._wavefront_base < n_levels:
                    pol["fired"] = True
                    inj.delays += 1
                    inj.delay_s += pol.get("seconds", 0.0)
                continue
            if kind == "ship":
                return _FALLBACK
            li = max(0, pol["wavefront"] - ex._wavefront_base)
            if li >= n_levels:
                continue
            rank = pol["rank"]
            if rank >= pool.n_ranks or not pool.alive[rank]:
                return _FALLBACK
            if due is None or li < due[1]:
                due = (pol, li)
        if due is None:
            return {}
        pol, li = due
        pol["fired"] = True
        inj.fired.append(pol)
        return {pol["rank"]: (li, pol.get("permanent", False))}

    # -- store reset ---------------------------------------------------------
    def reset(self, ex) -> None:
        """Clear worker arenas/plans when ``ex`` forgets its stores.

        A new ``Workflow`` restarts the version-id streams, so every key a
        worker still holds (payload segments, cached plan slices keyed on
        those versions) is stale and would collide with the fresh
        workflow's keys.  Only acts when this executor owns the pool — a
        different owner's arenas are its problem (``pool.bind`` resets on
        the change of hands).
        """
        pool = _POOLS.get(ex.n_nodes)
        if pool is None or pool.owner_ex() is not ex:
            return
        pool.reset_workers()

    # -- execution -----------------------------------------------------------
    def execute(self, ex, wf, plan) -> None:
        if not plan.schedule:
            return
        pool = shared_pool(ex.n_nodes, self.heartbeat_interval,
                           self.barrier_timeout)
        pool.bind(ex)
        kills = {}
        inj = getattr(ex, "fault_injector", None)
        if inj is not None and inj.armed:
            kills = self._translate_kills(ex, inj, plan, pool)
            if kills is _FALLBACK:
                return self._fall_back(ex, wf, plan)

        # decommissioned ranks (elastic rebind) never appear in the plan's
        # exec ranks / ships, but the pool must agree on who participates
        for dead in getattr(ex, "_decommissioned", {}):
            if dead < pool.n_ranks and pool.alive[dead]:
                pool.decommission(dead)
        alive = pool.alive_ranks()
        if not alive:
            return self._fall_back(ex, wf, plan)

        sent = self._ship_or_delta(ex, wf, plan, pool, alive, kills)
        if sent is _FALLBACK:           # unpicklable fns/consts
            return self._fall_back(ex, wf, plan)
        msgs, uid = sent
        ex._stats.control_messages += msgs
        self.plans_run += 1
        self._await_and_replay(ex, wf, plan, pool, alive, uid, kills)

    def _fall_back(self, ex, wf, plan) -> None:
        """Run ``plan`` on the serial path in this process, after copying
        the worker-resident payloads into the stores."""
        self.fallbacks += 1
        _materialize_stores(ex)
        self._serial.execute(ex, wf, plan)

    def _ship_or_delta(self, ex, wf, plan, pool, alive, kills):
        """Ship plan slices (or just a delta/epoch trigger), seed missing
        payloads, and start the run on every participating worker.
        Returns ``(messages_sent, uid)`` or ``_FALLBACK``."""
        sk = id(plan.levels)
        rec = pool.shipped.get(sk)
        trans = consts_msg = None
        use_delta = False
        if rec is not None and rec.levels_ref is plan.levels:
            trans = key_map(rec.template, plan)
            if trans is not None:
                def tr(k):
                    return translate(trans, k)
                ok = all(
                    tuple(sorted(ex._where.get(tr(k), ()))) == hs
                    for k, hs in rec.read_holders.items())
                if ok:
                    consts = plan_consts(plan, wf)
                    if not _consts_equal(consts, rec.consts):
                        consts_msg = tuple(pack(c) for c in consts)
                        rec.consts = consts
                    use_delta = True
        msgs = 0
        if use_delta:
            uid = rec.uid
            read_keys = [tr(k) for k in rec.read_holders]
        else:
            slices = slice_for_ranks(plan, wf, ex._where, pool.n_ranks)
            consts = tuple(pack(c) for c in slices.consts)
            try:
                pickle.dumps((slices.fns, consts))
            except (pickle.PicklingError, TypeError, AttributeError):
                return _FALLBACK
            uid = next(_UID_SEQ)
            for r in alive:
                pool.conns[r].send(("plan", uid, slices.n_levels, slices.fns,
                                    consts, slices.worker_levels[r]))
                msgs += 1
            pool.shipped[sk] = _ShippedPlan(plan.levels, plan, slices.consts,
                                            slices.read_holders, uid)
            trans = None
            read_keys = list(slices.read_holders)

        # seed payloads the workers don't hold (anything not a ShmRef):
        # written into segments under the holder rank's name, which the
        # worker adopts — payloads never cross the pipe
        seeds = {r: [] for r in alive}
        seeded = []
        for k in read_keys:
            ranks = ex._where.get(k)
            if not ranks:
                continue
            for r in ranks:
                payload = ex._stores[r].get(k)
                if type(payload) is ShmRef or r not in seeds:
                    continue
                concrete = materialize(payload)
                if concrete is not payload and hasattr(payload, "release"):
                    payload.release()
                write_segment(segment_name(pool.session, k, r), concrete)
                seeds[r].append(k)
                seeded.append((k, r))
        try:
            for r in alive:
                pool.slots[r] = 0
            for r in alive:
                kill = kills.get(r)
                pool.conns[r].send(("run", uid, trans or None, consts_msg,
                                    tuple(seeds[r]),
                                    kill[0] if kill else None))
                msgs += 1
        except OSError:                 # a worker's pipe broke
            return _FALLBACK
        # the workers now hold these payloads; re-point the frontend copies
        for k, r in seeded:
            ex._stores[r][k] = ShmRef(k, r, ex._key_bytes.get(k, 0),
                                      pool.session)
        return msgs, uid

    def _await_and_replay(self, ex, wf, plan, pool, alive, uid, kills):
        """Wait for every worker's reply, then replay accounting virtually
        (full plan on success; the proven prefix before raising
        :class:`RankFailure` on a worker death or hang)."""
        pending = set(alive)
        commits: dict = {}
        failed = None
        worker_error = None
        hung = False
        while pending and failed is None and worker_error is None:
            progressed = False
            for r in list(pending):
                if not pool.conns[r].poll(0.0):
                    continue
                progressed = True
                try:
                    msg = pool.conns[r].recv()
                except (EOFError, OSError):
                    failed = r
                    break
                if msg[0] == "done":
                    commits.update(msg[2])
                    pending.discard(r)
                elif msg[0] == "aborted":
                    commits.update(msg[2])
                    pending.discard(r)
                else:                   # "error"
                    worker_error = (r, msg[2])
                    break
            if failed is not None or worker_error is not None:
                break
            if not progressed:
                for r in pending:
                    if not pool.procs[r].is_alive():
                        failed = r
                        break
                    if self.heartbeat_timeout is not None:
                        from ...runtime.supervisor import heartbeat_age
                        age = heartbeat_age(pool.hb_path(r),
                                            pool.spawned_at[r])
                        if age > self.heartbeat_timeout:
                            pool.procs[r].kill()    # hung, not dead: reap it
                            failed = r
                            hung = True
                            break
                if failed is None:
                    time.sleep(0.002)

        if worker_error is not None:
            r, tb = worker_error
            self._drain(pool, pending - {r}, commits)
            pool.barrier.reset(len(pool.alive_ranks()))
            raise RuntimeError(
                f"procs worker (rank {r}) raised during plan replay:\n{tb}")
        if failed is None:
            self._virtual_replay(ex, plan, commits, pool.session)
            return

        # -- worker death / hang -------------------------------------------
        pool.barrier.abort()
        self._drain(pool, pending - {failed}, commits)
        participants = [r for r in alive if r != failed]
        boundary = pool.slots[failed]
        for r in participants:
            if pool.slots[r] < boundary:
                boundary = pool.slots[r]
        lo = (plan.levels[boundary][0] if boundary < len(plan.levels)
              else len(plan.schedule))
        # commit sizes the dead rank never reported: its segments survive
        for p in plan.schedule[:lo]:
            if p.exec_ranks and p.exec_ranks[0] == failed:
                for wk in p.write_keys:
                    if wk not in commits:
                        try:
                            commits[wk] = peek_nbytes(
                                segment_name(pool.session, wk, failed))
                        except FileNotFoundError:
                            commits[wk] = 0
        self._virtual_replay(ex, plan, commits, pool.session, upto=lo)
        # physical cleanup of the dead rank's arena (the frontend wipes its
        # virtual store next, in apply_failure)
        for vkey, ranks in ex._where.items():
            if failed in ranks:
                unlink_segment(segment_name(pool.session, vkey, failed))
        kill = kills.get(failed)
        permanent = hung or bool(kill and kill[1])
        pool.shipped.clear()    # respawned/removed workers lose their plans
        if permanent:
            pool.decommission(failed)
        else:
            pool.spawn(failed)
        pool.barrier.reset(len(pool.alive_ranks()))
        raise RankFailure(failed, ex._wavefront_base + boundary,
                          level=boundary, kind="kill", permanent=permanent)

    @staticmethod
    def _drain(pool, ranks, commits, timeout: float = 30.0) -> None:
        """Collect pending replies from surviving workers after an abort."""
        deadline = time.monotonic() + timeout
        for r in ranks:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not pool.procs[r].is_alive():
                continue
            if pool.conns[r].poll(remaining):
                try:
                    msg = pool.conns[r].recv()
                    if msg[0] in ("done", "aborted"):
                        commits.update(msg[2])
                except (EOFError, OSError):
                    pass

    @staticmethod
    def _virtual_replay(ex, plan, nbytes_by_key, session, upto=None) -> None:
        """Replay ship/commit/GC accounting against the frontend stores.

        Byte-identical to :class:`SerialPlanBackend`'s transitions: same
        transfer events (tree-shaped, even though the physical memcpys pull
        from the root), same peak sampling points (after an op's commits,
        before its GC), same drop idiom — but payloads are
        :class:`ShmRef` proxies carrying worker-reported sizes.
        """
        from ..recovery import PlanCheckpoint

        schedule = plan.schedule if upto is None else plan.schedule[:upto]
        stores, where, key_bytes = ex._stores, ex._where, ex._key_bytes
        stats = ex._stats
        events = stats.transfers
        base_round = ex._round_counter
        wf_base = ex._wavefront_base
        live_b, live_c = ex._live_bytes, ex._live_entries
        peak_b, peak_c = stats.peak_live_bytes, stats.peak_live_payloads
        for p in schedule:
            if type(p.fn) is PlanCheckpoint:
                # the barrier's body ran on a copy in a worker and its
                # level committed: its versions now restore from disk
                p.fn.saved = True
            if p.ships:
                wavefront = wf_base + p.level - 1
                for vkey, root, transfers in p.ships:
                    nb = key_bytes.get(vkey, 0)
                    ranks = where[vkey]
                    for src, dst, kind, rel in transfers:
                        stores[dst][vkey] = ShmRef(vkey, dst, nb, session)
                        ranks.add(dst)
                        live_c += 1
                        events.append(TransferEvent(vkey, src, dst, nb,
                                                    base_round + rel, kind,
                                                    wavefront))
            for wk in p.write_keys:
                nb = nbytes_by_key[wk]
                key_bytes[wk] = nb
                live_b += nb
                holders = set(p.exec_ranks)
                where[wk] = holders
                for r in holders:
                    stores[r][wk] = ShmRef(wk, r, nb, session)
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


def _consts_equal(a, b) -> bool:
    """Conservative constant-vector equality (False → just resend them)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x is y:
            continue
        try:
            if not bool(x == y):
                return False
        except (TypeError, ValueError, RuntimeError):
            return False
    return True
