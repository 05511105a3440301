"""Always-on serving runtime: admission queue + continuous cross-request batching.

Turns the run-to-completion :class:`~repro_torch.core.scheduler.LocalExecutor`
into a service: clients submit *step closures* from any
thread and get back futures; a single background serving thread owns the
executor and one long-lived shared :class:`~repro_torch.core.trace.Workflow`,
records each admitted step as its own program segment, and flushes a whole
batch of requests as ONE stitched program.

That one-flush-per-batch shape is where the existing machinery becomes
*continuous batching* for free:

* steps from different sessions touch disjoint refs, so their ops land in
  the same wavefront levels of the stitched plan; same-signature
  level-mates are exactly what ``backend="fused"`` stacks into one
  ``torch.func.vmap`` call (:class:`~repro_torch.core.backends.FusedBatchBackend`)
  — N clients' decode steps cost one batched dispatch, not N;
* planning policy per flush: a *single* client's step stream replays its
  cached per-step plans at recorded segment boundaries
  (:func:`~repro_torch.core.program.probe_plan` — the streaming client pays
  planning cost once even as its program grows); a *multi-client* batch
  plans the whole stitched program instead, because prefix splitting
  would fence each request's ops into their own sub-plan and forfeit
  cross-request fusion — those whole-batch plans are themselves
  relocatable-cached by structure.

Overload safety (this layer's failure-mode contract):

* **Backpressure** — the admission queue is bounded (``max_queue``) and
  each session has an in-flight budget (``max_inflight``); a submit that
  finds either full is *shed* with the retriable
  :class:`~repro_torch.serve.session.RuntimeOverloaded` (or blocks up to
  ``timeout=`` seconds for space).  Load the service cannot absorb is
  refused at the door instead of growing an unbounded queue.
* **Flush-failure bisection** — every batch flush runs *input-atomic*
  (``protect_inputs``: the executor keeps the program's external inputs
  materialised through a failure), so when a multi-request flush fails
  the serving thread re-drives per-request sub-ranges through
  :meth:`~repro_torch.core.scheduler.LocalExecutor.flush_slice` in a bisect
  loop: group probes narrow to the truly-failing request, only its
  session is poisoned, and every innocent request still completes with
  values identical to a serial execution.
* **Trace compaction** — after a flush, once the shared trace exceeds
  ``compact_threshold`` ops, the executed prefix is truncated and
  rebased (:meth:`~repro_torch.core.scheduler.LocalExecutor.compact`), so a
  runtime serving forever holds O(live state), not O(steps ever served);
  the relocatable program-trace cache survives rebasing, so warm clients
  keep their zero-replan hits.

Threading model (single-writer): *recording is only ever done by the
serving thread*; client threads touch nothing but the admission queue and
their futures.  The executor's own lock additionally makes direct
``runtime.executor`` reads (stats, values) safe from test/monitor threads.

On the GPU: the serving thread launches every kernel on its current
stream, which is the legacy default stream, as is every client thread's;
so a tensor a client made before it submitted is ready for the kernels
that read it, without an event or a sync.  A future resolves when
``executor.value`` returns, which on the card is when the request's
kernels are *enqueued*, not when they finish: ``metrics.latency`` is the
host time to enqueue, as the reference's was under JAX's asynchronous
dispatch.  A client that needs the values on the host waits for them
itself (``.cpu()``), and that wait is its own measure.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from ..core.scheduler import LocalExecutor
from ..core.trace import BindArray, Workflow
from .metrics import ServeMetrics
from .session import (RuntimeClosed, RuntimeOverloaded, ServeRequest,
                      Session, SessionPoisoned)

__all__ = ["ServingRuntime"]


class ServingRuntime:
    """Background-threaded serving frontend over one executor.

    Parameters
    ----------
    n_nodes, backend, mode, collective_mode:
        Forwarded to the owned :class:`LocalExecutor` (``backend="fused"``
        is the one that turns cross-request coalescing into single
        batched dispatches; any backend is correct).
    max_batch:
        Most requests admitted into one flush.
    admission_window:
        After the first queued request is seen, how long (seconds) the
        serving thread lingers for more before flushing — the knob trading
        a little p50 for batch width under bursty traffic.  0 flushes
        whatever is queued immediately.
    max_queue:
        Bound on the admission queue; a submit that finds it full is shed
        with :class:`RuntimeOverloaded` (reject-newest) unless it passed
        ``timeout=`` to block for space.  ``None`` = unbounded (the
        pre-backpressure behaviour).
    max_inflight:
        Per-session cap on unresolved requests (queued or executing);
        submits beyond it are shed the same way.  ``None`` = uncapped.
    prefix_cache:
        Forwarded to the executor (default True here — the streaming-client
        planning amortisation is the point of a serving runtime).
    compact_threshold:
        Once the shared trace reaches this many ops after a flush, the
        executed prefix is compacted away.  ``None`` disables compaction
        (the trace then grows with every request served).
    executor:
        Bring-your-own executor (overrides the construction knobs).
    autostart:
        ``False`` leaves the serving thread unstarted until
        :meth:`start` — deterministic batch composition for tests
        (everything submitted before ``start()`` lands in one batch, up
        to ``max_batch``).
    """

    def __init__(self, n_nodes: int = 1, backend: str = "fused",
                 mode: str = "plan", collective_mode: str = "tree",
                 max_batch: int = 32, admission_window: float = 0.002,
                 max_queue: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 prefix_cache: bool = True,
                 compact_threshold: Optional[int] = 512,
                 executor: Optional[LocalExecutor] = None,
                 autostart: bool = True):
        if executor is not None:
            self._ex = executor
        else:
            self._ex = LocalExecutor(n_nodes, collective_mode, mode=mode,
                                     backend=backend, stitch=True,
                                     prefix_cache=prefix_cache)
        self._prefix_cache = (prefix_cache if executor is None
                              else bool(executor.prefix_cache))
        self.max_batch = max(1, int(max_batch))
        self.admission_window = float(admission_window)
        self.max_queue = None if max_queue is None else max(1, int(max_queue))
        self.max_inflight = (None if max_inflight is None
                             else max(1, int(max_inflight)))
        self.compact_threshold = (None if compact_threshold is None
                                  else max(1, int(compact_threshold)))
        self._wf = Workflow(n_nodes=self._ex.n_nodes, executor=self._ex)
        self.metrics = ServeMetrics()
        self._queue: deque[ServeRequest] = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._sessions = 0
        self._loop_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._serve_loop, daemon=True,
                                        name="bind-serve")
        self._started = False
        if autostart:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingRuntime":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop admitting, drain everything already queued, join the thread.

        A *started* runtime's serving thread drains the queue before
        exiting, so every admitted future resolves.  A never-started (or
        already-dead) runtime has no thread to drain: anything still
        queued is cancelled here — a queued future must never be left
        unresolved by ``close()``.
        """
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._started:
            self._thread.join(timeout)
        if not self._started or not self._thread.is_alive():
            with self._cv:
                leftovers = list(self._queue)
                self._queue.clear()
            for req in leftovers:
                if req.future.cancel():
                    self.metrics.requests_cancelled += 1
                elif not req.future.done():
                    req.future.set_exception(RuntimeClosed(
                        "runtime closed before this request ran"))

    def __enter__(self) -> "ServingRuntime":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @property
    def executor(self) -> LocalExecutor:
        """The owned executor (its lock makes stats/value reads safe)."""
        return self._ex

    # -- client surface ------------------------------------------------------
    def session(self) -> Session:
        """Open a new client session."""
        with self._cv:
            self._sessions += 1
            return Session(self, self._sessions)

    def submit(self, session: Session, step: Callable[[Session], Any],
               timeout: Optional[float] = None):
        """Enqueue ``step`` to run against ``session``; returns a future.

        ``step(session)`` is *recorded* on the serving thread (it may
        create arrays via ``session.array`` and call ``@op`` functions);
        whatever handles it returns come back through the future as
        concrete payloads once the batch executes.  The future supports
        standard ``concurrent.futures`` semantics: ``cancel()`` works
        while the request is still queued (a cancelled request records
        nothing and never touches the executor), ``result(timeout=...)``
        raises ``TimeoutError`` without disturbing the in-flight request.

        Admission control: a full queue (``max_queue``) or session
        in-flight budget (``max_inflight``) sheds the submit with the
        retriable :class:`RuntimeOverloaded` — unless ``timeout`` is
        given, in which case the submit blocks up to that many seconds
        for space before shedding.  A closed runtime (or one whose
        serving thread died — then ``__cause__`` carries the loop's
        exception) raises :class:`RuntimeClosed`; a poisoned session
        raises :class:`SessionPoisoned`.
        """
        m = self.metrics
        deadline = (None if timeout is None
                    else time.monotonic() + max(0.0, timeout))
        with self._cv:
            while True:
                self._check_alive()
                if session.poisoned is not None:
                    m.requests_rejected += 1
                    raise SessionPoisoned(
                        f"session {session.sid} failed earlier; open a new "
                        f"one") from session.poisoned
                over = self._overload_reason(session)
                if over is None:
                    break
                remaining = (0.0 if deadline is None
                             else deadline - time.monotonic())
                if remaining <= 0.0:
                    m.requests_shed += 1
                    raise RuntimeOverloaded(over)
                self._cv.wait(min(remaining, 0.05))
            req = ServeRequest(session, step, time.perf_counter())
            session.inflight += 1
            req.future.add_done_callback(
                lambda _f, s=session: self._request_resolved(s))
            self._queue.append(req)
            m.requests_admitted += 1
            if len(self._queue) > m.queue_depth_hwm:
                m.queue_depth_hwm = len(self._queue)
            self._cv.notify()
        return req.future

    def _check_alive(self) -> None:
        # caller holds _cv
        if self._closed:
            if self._loop_error is not None:
                raise RuntimeClosed(
                    "serving thread died") from self._loop_error
            raise RuntimeClosed("serving runtime is closed")
        if self._started and not self._thread.is_alive():
            raise RuntimeClosed("serving thread is dead")

    def _overload_reason(self, session: Session) -> Optional[str]:
        # caller holds _cv
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            return (f"admission queue full ({self.max_queue}); retry after "
                    f"backoff")
        if (self.max_inflight is not None
                and session.inflight >= self.max_inflight):
            return (f"session {session.sid} already has "
                    f"{session.inflight} requests in flight")
        return None

    def _request_resolved(self, session: Session) -> None:
        # future done-callback (serving thread on resolve, client thread
        # on cancel): free the session's in-flight slot and wake any
        # submitter blocked on backpressure
        with self._cv:
            session.inflight -= 1
            self._cv.notify_all()

    # -- serving thread ------------------------------------------------------
    def _serve_loop(self) -> None:
        try:
            while True:
                batch = self._next_batch()
                if batch is None:
                    return
                try:
                    self._execute_batch(batch)
                except BaseException as e:
                    # a failure the bisection could not contain: poison
                    # the batch, never the serving thread
                    for req in batch:
                        if not req.future.done():
                            req.session.poisoned = e
                            self.metrics.requests_failed += 1
                            req.future.set_exception(e)
        except BaseException as e:
            self._die(e)

    def _die(self, e: BaseException) -> None:
        """An exception escaped the loop itself (e.g. out of
        ``_next_batch``): record it so the next ``submit`` surfaces
        :class:`RuntimeClosed` with this as ``__cause__``, and fail
        everything already queued — a silent dead thread with an
        accepting queue hangs clients forever."""
        with self._cv:
            self._loop_error = e
            self._closed = True
            leftovers = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        for req in leftovers:
            if not req.future.done():
                self.metrics.requests_failed += 1
                req.future.set_exception(RuntimeClosed(
                    "serving thread died before this request ran"))

    def _next_batch(self) -> Optional[list]:
        with self._cv:
            while not self._queue:
                if self._closed:
                    return None
                self._cv.wait(0.05)
            if (self.admission_window > 0.0 and not self._closed
                    and len(self._queue) < self.max_batch):
                # linger briefly: under concurrent submitters the rest of
                # the burst usually lands within the window, widening the
                # fused buckets the flush will dispatch
                deadline = time.monotonic() + self.admission_window
                while len(self._queue) < self.max_batch and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0.0:
                        break
                    self._cv.wait(remaining)
            n = min(len(self._queue), self.max_batch)
            batch = [self._queue.popleft() for _ in range(n)]
            # queue slots freed: wake submitters blocked on backpressure
            self._cv.notify_all()
            return batch

    def _execute_batch(self, batch: list) -> None:
        ex, wf, m = self._ex, self._wf, self.metrics
        now = time.perf_counter()
        recorded: list[ServeRequest] = []
        # contiguous (request, start, end) tiles over the batch's op range
        # — the bisection's probe granularity.  ``request=None`` marks the
        # orphan ops of a closure that raised mid-recording (they cannot
        # be unrecorded; they are never re-driven).
        items: list[tuple[Optional[ServeRequest], int, int]] = []
        with wf.recording():
            for req in batch:
                if not req.future.set_running_or_notify_cancel():
                    m.requests_cancelled += 1
                    continue
                if req.session.poisoned is not None:
                    m.requests_rejected += 1
                    req.future.set_exception(SessionPoisoned(
                        f"session {req.session.sid} failed earlier"))
                    continue
                req.admitted_s = now
                start = len(wf.ops)
                try:
                    req.handles = _as_handles(req.step(req.session))
                except BaseException as e:
                    # bad request: poison only this session, and fence its
                    # partial ops into their own segment so a flush
                    # failure they cause is attributable to them
                    req.session.poisoned = e
                    m.requests_failed += 1
                    req.future.set_exception(e)
                    wf.sync()
                    if len(wf.ops) > start:
                        items.append((None, start, len(wf.ops)))
                    continue
                # one segment per request: the granularity at which the
                # prefix cache can replay this step's plan later — and at
                # which a failed flush is bisected
                wf.sync()
                if len(wf.ops) > start:
                    items.append((req, start, len(wf.ops)))
                recorded.append(req)
        if not recorded:
            try:
                # still materialise any orphan ops (dead work, executed
                # once); their sessions are already poisoned, so a
                # failure here is swallowed — the executor rolled back
                ex.flush(protect_inputs=True)
            except BaseException:
                pass
            self._maybe_compact()
            return
        m.flushes += 1
        n = len(recorded)
        if n >= 2:
            m.batched_flushes += 1
            m.coalesced_requests += n
        if n > m.max_batch:
            m.max_batch = n
        bisected = False
        try:
            # planning policy: a single client's step stream replays its
            # cached per-segment plans (pay planning once, however the
            # steps got grouped); a multi-client batch plans the whole
            # stitched program instead — prefix splitting would isolate
            # each request's ops in their own sub-plan and the fused
            # backend could never stack cross-request level-mates.  The
            # whole-program plan is itself relocatable-cached by
            # structure, so repeating batch shapes stop paying builds
            # too.  protect_inputs makes the flush input-atomic: a
            # failure leaves every request's inputs materialised for the
            # bisection below.
            ex.flush(prefix_cache=self._prefix_cache and n == 1,
                     protect_inputs=True)
        except BaseException as e:
            if len(items) == 1 and items[0][0] is not None:
                # single-request program: attribution is already known,
                # a probe would only re-run the failure
                req = items[0][0]
                req.session.poisoned = e
                m.requests_failed += 1
                req.future.set_exception(e)
            else:
                # the executor rolled the whole program back (flush
                # failure contract) but the trace still holds every
                # request's segment: narrow the blame by re-driving
                # sub-ranges
                self._bisect(items, e)
                bisected = True
        done = time.perf_counter()
        pre_completed = m.requests_completed
        for req in recorded:
            if req.future.done():
                continue
            try:
                values = tuple(
                    ex.value(h.ref.head) if isinstance(h, BindArray) else h
                    for h in req.handles)
            except BaseException as e:
                req.session.poisoned = e
                m.requests_failed += 1
                req.future.set_exception(e)
                continue
            m.latency.record(done - req.submitted_s)
            m.queue_latency.record(req.admitted_s - req.submitted_s)
            m.requests_completed += 1
            if not req.handles:
                req.future.set_result(None)
            elif len(req.handles) == 1:
                req.future.set_result(values[0])
            else:
                req.future.set_result(values)
        if bisected:
            m.requests_salvaged += m.requests_completed - pre_completed
        self._maybe_compact()

    def _bisect(self, items: list, err: BaseException) -> None:
        """Attribute a failed batch flush to the request(s) that caused it.

        Recursive group probing over the per-request tiles: a contiguous
        all-live group is re-driven as one :meth:`flush_slice` probe — on
        success the whole group is salvaged in a single shot; on failure
        it splits in half.  Probes run input-atomically themselves, so a
        failing *group* probe cannot GC an innocent member's inputs out
        from under the narrower probes that follow.  Orphan tiles and
        tiles of sessions poisoned earlier in this bisection are never
        re-driven: their outputs are unfetchable by construction (a
        poisoned session's later tile fails with ``SessionPoisoned``
        chained to the root cause).  Worst case cost is O(k·log n) probes
        for k culprits among n requests; the common one-bad-request case
        is ~2·log n.
        """
        ex, wf, m = self._ex, self._wf, self.metrics
        m.bisections += 1

        def fail(req: ServeRequest, e: BaseException) -> None:
            if req.session.poisoned is None:
                req.session.poisoned = e
            m.requests_failed += 1
            if not req.future.done():
                req.future.set_exception(e)

        def drive(group: list) -> None:
            if not group:
                return
            live = all(it[0] is not None and it[0].session.poisoned is None
                       for it in group)
            if live:
                try:
                    m.bisect_probes += 1
                    ex.flush_slice(wf, group[0][1], group[-1][2])
                    return           # whole group salvaged in one probe
                except BaseException as e:
                    if len(group) == 1:
                        fail(group[0][0], e)
                        return
            elif len(group) == 1:
                req = group[0][0]
                if req is not None and not req.future.done():
                    # same-session casualty: an earlier tile of this
                    # session failed in this very bisection
                    e = SessionPoisoned(
                        f"session {req.session.sid} failed earlier in "
                        f"this batch")
                    e.__cause__ = req.session.poisoned
                    fail(req, e)
                return
            mid = len(group) // 2
            drive(group[:mid])
            drive(group[mid:])

        drive(items)

    def _maybe_compact(self) -> None:
        wf, m = self._wf, self.metrics
        if len(wf.ops) > m.trace_ops_hwm:
            m.trace_ops_hwm = len(wf.ops)
        if (self.compact_threshold is not None
                and len(wf.ops) >= self.compact_threshold):
            removed = self._ex.compact(wf)
            if removed:
                m.compactions += 1
                m.ops_compacted += removed


def _as_handles(result: Any) -> tuple:
    """Normalise a step closure's return into a tuple of fetchables."""
    if result is None:
        return ()
    if isinstance(result, (tuple, list)):
        return tuple(result)
    return (result,)
