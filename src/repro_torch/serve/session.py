"""Client-facing serving primitives: sessions, requests, failure types.

A :class:`Session` is one client's stream of requests against a
:class:`~repro_torch.serve.runtime.ServingRuntime`.  Clients never touch the
executor or the shared workflow directly — they submit *step closures*
that the serving thread records (single-writer discipline), so arbitrary
numbers of client threads can stream steps concurrently without racing on
the trace.

The blast radius of a failure is deliberately per-session, not
per-service: a step closure that raises (bad request) or an op body that
fails mid-flush poisons the session(s) the flush-failure bisection
attributes the failure to — their later submits raise
:class:`SessionPoisoned` — while the runtime, the executor, and every
other session keep serving (the executor's flush failure contract
guarantees their payloads survive).  Overload is likewise surfaced, not
absorbed: when the admission queue or a session's in-flight budget is
full, ``submit`` sheds the request with :class:`RuntimeOverloaded` — a
*retriable* condition, unlike the terminal :class:`RuntimeClosed` /
:class:`SessionPoisoned`.
"""

from __future__ import annotations

import concurrent.futures
from typing import Any, Callable, Optional


class ServeError(RuntimeError):
    """Base class for serving-layer failures."""


class RuntimeClosed(ServeError):
    """The serving runtime was shut down (or its serving thread died —
    then ``__cause__`` carries the loop's exception); no further submits
    are accepted."""


class RuntimeOverloaded(ServeError):
    """The request was shed at admission: the bounded queue (or the
    session's in-flight budget) is full.  Retriable — back off and
    resubmit; the session is *not* poisoned."""


class SessionPoisoned(ServeError):
    """A previous step of this session failed; its state is untrusted.

    Carries the original failure as ``__cause__``.  Other sessions are
    unaffected — open a fresh session to continue.
    """


class Session:
    """One client's stream of steps over runtime-resident state.

    ``state`` is a scratch dict for the client's step closures (the
    conventional home for its :class:`~repro_torch.core.trace.BindArray`
    handles — e.g. the KV cache of a decode loop).  Step closures run *on
    the serving thread* with the shared workflow active, so inside one
    they may call ``self.array(...)`` and any recorded ``@op``.

    ``inflight`` counts this session's unresolved requests (queued or
    executing); the runtime's per-session cap sheds submits beyond it.
    """

    __slots__ = ("runtime", "sid", "state", "poisoned", "inflight")

    def __init__(self, runtime, sid: int):
        self.runtime = runtime
        self.sid = sid
        self.state: dict = {}
        self.poisoned: Optional[BaseException] = None
        self.inflight = 0

    def array(self, value: Any, name: str = "", rank: int = 0):
        """Create a runtime-resident array (serving thread only — call
        from inside a step closure)."""
        return self.runtime._wf.array(
            value, name=f"s{self.sid}.{name}" if name else f"s{self.sid}",
            rank=rank)

    def submit(self, step: Callable[["Session"], Any],
               timeout: Optional[float] = None
               ) -> concurrent.futures.Future:
        """Enqueue one step; returns its future (see ``ServingRuntime.submit``)."""
        return self.runtime.submit(self, step, timeout=timeout)

    def __repr__(self) -> str:
        status = "poisoned" if self.poisoned is not None else "ok"
        return f"Session({self.sid}, {status})"


class ServeRequest:
    """One admitted step: the closure, its future, and latency timestamps.

    ``submitted_s`` is stamped at submit (queue time starts), ``admitted_s``
    when the serving thread picks the request into a batch; the request
    latency recorded on completion is end-to-end (submit → value ready),
    the number a client actually experiences.
    """

    __slots__ = ("session", "step", "future", "submitted_s", "admitted_s",
                 "handles")

    def __init__(self, session: Session, step: Callable, submitted_s: float):
        self.session = session
        self.step = step
        self.future: concurrent.futures.Future = concurrent.futures.Future()
        self.submitted_s = submitted_s
        self.admitted_s = 0.0
        self.handles: tuple = ()
