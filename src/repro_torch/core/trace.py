"""Sequential-trace → transactional-DAG extraction (paper §II-A/B).

The user writes classical sequential code over :class:`BindArray` handles.
Functions are declared with ``@op`` and *argument intent annotations* — the
Python analogue of C++ ``const``-ness inspection:

    @op
    def gemm(a: In, b: In, c: InOut):
        return a @ b + c          # returns payload for c's new version

Calling ``gemm(x, y, z)`` inside an active :class:`Workflow` does **not**
execute anything; it records an :class:`OpNode` that reads the current
versions of ``x``/``y``/``z`` and generates a *new* version of ``z``.  The
resulting DAG is the paper's transactional DAG: deterministic, replayable by
any process, race-free by construction.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import itertools
import threading
from typing import Any, Callable, Optional, Sequence

from .versioning import Ref, Version, reset_ids


class In:
    """Argument is read-only (C++ ``const&``)."""


class Out:
    """Argument is write-only — a fresh version is generated, old not read.

    The op body receives ``None`` at that position (C++ out-ref semantics:
    the previous payload's *content* is never an input), so version GC is
    free to reclaim a superseded version the moment its true last reader
    ran — program-wide GC under stitching relies on this (an Out op must
    not resurrect a demand for a payload the model says it never reads).
    """


class InOut:
    """Argument is read and replaced by a new version (C++ non-const ref)."""


_INTENTS = (In, Out, InOut)


@dataclasses.dataclass
class OpNode:
    """One transaction in the DAG."""

    op_id: int
    fn: Callable
    name: str
    # Versions read / generated, positionally aligned with the call args.
    reads: tuple[Version, ...]
    writes: tuple[Version, ...]
    # Placement: None → unpinned (scheduler's choice = node 0); otherwise the
    # node rank (paper's ``bind::node``) or an abstract placement object.
    placement: Any
    # All args in call order as (ref, version, intent) for replay.
    args: tuple[tuple[Ref, Version, type], ...]
    flops: int = 0

    def __repr__(self) -> str:
        r = ",".join(map(repr, self.reads))
        w = ",".join(map(repr, self.writes))
        return f"op{self.op_id}:{self.name}({r})->({w})@{self.placement}"


class BindArray:
    """User-facing handle: a versioned array in the global workflow."""

    __slots__ = ("ref", "workflow")

    def __init__(self, workflow: "Workflow", ref: Ref):
        self.ref = ref
        self.workflow = workflow

    @property
    def shape(self):
        return getattr(self.ref.meta, "shape", None)

    @property
    def dtype(self):
        return getattr(self.ref.meta, "dtype", None)

    def __repr__(self):
        return f"BindArray({self.ref!r})"

    # Natural arithmetic sugar so user code stays "classical sequential".
    def __iadd__(self, other: "BindArray"):
        self.workflow.call(_add_inplace, (self, other), name="iadd")
        return self

    def __imul__(self, other):
        self.workflow.call(_scale_inplace, (self, other), name="iscale")
        return self


def _add_inplace(c, x):
    return c + x


_add_inplace.__bind_intents__ = (InOut, In)


def _scale_inplace(c, s):
    return c * s


_scale_inplace.__bind_intents__ = (InOut, In)


_INTENT_NAMES = {"In": In, "Out": Out, "InOut": InOut}


def intents_of(fn: Callable) -> tuple[type, ...]:
    """Extract argument intents from annotations (compile-time inspection).

    Handles stringified annotations (``from __future__ import annotations``)
    by resolving on the terminal name.
    """
    cached = getattr(fn, "__bind_intents__", None)
    if cached is not None:
        return cached
    sig = inspect.signature(fn)
    intents = []
    for p in sig.parameters.values():
        ann = p.annotation
        if isinstance(ann, str):
            ann = _INTENT_NAMES.get(ann.split(".")[-1], ann)
        if ann in _INTENTS:
            intents.append(ann)
        else:
            # un-annotated / other → assumed constant input (safe default)
            intents.append(In)
    out = tuple(intents)
    try:
        fn.__bind_intents__ = out
    except AttributeError:
        pass
    return out


_TLS = threading.local()

# Hash-consing for per-op structural signatures: identical op structure →
# identical small int, so plan-cache keys hash/compare in O(ops) int work
# instead of re-hashing nested tuples every sync.  Ids come from a monotonic
# counter (never reused), so two *different* structures can never share an
# id even across the table reset below; ``setdefault`` keeps the mapping
# consistent under concurrent per-thread tracing (a skipped counter value is
# harmless).  The table is cleared once it exceeds _SIG_INTERN_MAX — drivers
# whose version keys advance forever (incremental sync loops) would
# otherwise grow it one entry per op while pinning op functions; a reset
# only costs later plan-cache misses, never correctness.
_SIG_INTERN: dict[tuple, int] = {}
_SIG_IDS = itertools.count()
_SIG_INTERN_MAX = 1 << 18


def _intern_sig(sig: tuple) -> int:
    sid = _SIG_INTERN.get(sig)
    if sid is None:
        if len(_SIG_INTERN) >= _SIG_INTERN_MAX:
            _SIG_INTERN.clear()
        sid = _SIG_INTERN.setdefault(sig, next(_SIG_IDS))
    return sid


def current_workflow() -> Optional["Workflow"]:
    return getattr(_TLS, "wf", None)


class Workflow:
    """Records the global workflow DAG from sequential user code.

    Every process executing the same user code produces byte-identical
    ``OpNode`` lists — the "partitioned *global* workflow".  Use as::

        with Workflow() as wf:
            a = wf.array(np.ones((4, 4)))
            with node(1):
                scale(a, 2.0)
            wf.sync()
    """

    def __init__(self, n_nodes: int = 1, executor: Any = None):
        reset_ids()
        self.ops: list[OpNode] = []
        self.refs: dict[int, Ref] = {}
        self.initial: dict[tuple[int, int], Any] = {}
        self.n_nodes = n_nodes
        self._placement_stack: list[Any] = []
        self._executor = executor
        self._synced_upto = 0
        # producer/consumer maps maintained incrementally at record time —
        # analyses (wavefronts, collective inference, planning) read them
        # without ever rescanning the op list.
        self._producers: dict[tuple[int, int], OpNode] = {}
        self._consumers: dict[tuple[int, int], list[OpNode]] = {}
        # per-op structural signatures (see core.plan.segment_signature),
        # built at record time so plan-cache keys are a slice, not a rescan.
        self._op_sigs: list[tuple] = []
        # version_key -> (PlanCheckpoint, leaf index): versions saved by a
        # checkpoint barrier — recovery's lineage walk terminates here.
        self._ckpt_sources: dict[tuple[int, int], tuple[Any, int]] = {}
        self._ckpt_counter = 0

    # -- context management ------------------------------------------------
    def __enter__(self):
        _TLS.wf = self
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.sync()
        _TLS.wf = None
        return False

    @contextlib.contextmanager
    def recording(self):
        """Make this workflow the current recording target, *without* the
        exit-sync of the ``with Workflow()`` form.

        The serving runtime records many client step closures into one
        long-lived workflow and controls sync/flush boundaries itself —
        an implicit sync per closure would defeat cross-request batching.
        Restores the previous recording target on exit (even on a raise:
        a failing closure must not leave a poisoned thread-local behind).
        """
        prev = getattr(_TLS, "wf", None)
        _TLS.wf = self
        try:
            yield self
        finally:
            _TLS.wf = prev

    # -- placement ----------------------------------------------------------
    def push_placement(self, p: Any) -> None:
        self._placement_stack.append(p)

    def pop_placement(self) -> None:
        self._placement_stack.pop()

    @property
    def placement(self) -> Any:
        return self._placement_stack[-1] if self._placement_stack else None

    # -- array creation -----------------------------------------------------
    def array(self, value: Any, name: str = "", rank: int = 0) -> BindArray:
        """Create a versioned array from user data, resident on ``rank``."""
        ref = Ref(name=name, meta=value)
        self.refs[ref.ref_id] = ref
        self.initial[ref.head.key] = (value, rank)
        return BindArray(self, ref)

    # -- op-created arrays ----------------------------------------------------
    def apply(
        self,
        fn: Callable,
        args: Sequence[Any],
        name: str = "",
        n_out: int = 1,
        meta: Any = None,
        flops: int = 0,
    ):
        """Record an op whose outputs are *fresh* arrays (no preallocation).

        The returned handles' initial versions are produced by this op —
        this is how temporaries are born inside a workflow without a
        user-visible zero-fill + copy (zero-copy temp creation).
        """
        op_id = len(self.ops)
        reads, rec_args = [], []
        for a in args:
            if isinstance(a, BindArray):
                v = a.ref.head
                reads.append(v)
                rec_args.append((a.ref, v, In))
            else:
                rec_args.append((None, a, In))
        outs = []
        for i in range(n_out):
            ref = Ref(name=f"{name or fn.__name__}.out{i}", meta=meta,
                      first_producer=op_id)
            self.refs[ref.ref_id] = ref
            outs.append(ref.head)
        node = OpNode(
            op_id=op_id,
            fn=fn,
            name=name or getattr(fn, "__name__", "op"),
            reads=tuple(reads),
            writes=tuple(outs),
            placement=self.placement,
            args=tuple(rec_args),
            flops=flops,
        )
        self.ops.append(node)
        self._index_op(node)
        handles = tuple(BindArray(self, self.refs[v.ref_id]) for v in outs)
        return handles[0] if n_out == 1 else handles

    # -- op recording ---------------------------------------------------------
    def call(
        self,
        fn: Callable,
        args: Sequence[Any],
        name: str = "",
        flops: int = 0,
    ) -> Optional[tuple[BindArray, ...]]:
        intents = intents_of(fn)
        if len(intents) < len(args):
            intents = intents + (In,) * (len(args) - len(intents))
        reads, writes, rec_args = [], [], []
        op_id = len(self.ops)
        # Pass 1 — snapshot every argument's head *before* any version bump:
        # an op like ``mul(a, a)`` must read a.v_k through both arguments,
        # not its own freshly created output version (self-dependency bug
        # caught by tests/test_core_properties.py).
        snap = []
        for a, intent in zip(args, intents):
            if isinstance(a, BindArray):
                snap.append((a.ref, a.ref.head, intent))
            else:
                snap.append((None, a, In))  # constant: embed by value
        # Pass 2 — record reads on the snapshot, then create new versions.
        for ref, v, intent in snap:
            if ref is None:
                rec_args.append((None, v, In))
                continue
            if intent is Out:
                # write-only: replay passes None (see :class:`Out`) — the
                # superseded version is never demanded at dispatch, so GC
                # may have reclaimed it by then
                rec_args.append((None, None, Out))
                continue
            reads.append(v)
            rec_args.append((ref, v, intent))
        for ref, v, intent in snap:
            if ref is not None and intent in (Out, InOut):
                writes.append(ref.new_version(op_id))
        node = OpNode(
            op_id=op_id,
            fn=fn,
            name=name or getattr(fn, "__name__", "op"),
            reads=tuple(reads),
            writes=tuple(writes),
            placement=self.placement,
            args=tuple(rec_args),
            flops=flops,
        )
        self.ops.append(node)
        self._index_op(node)
        return None

    def _index_op_maps(self, node: OpNode) -> None:
        """Extend the cached producer/consumer maps with one op."""
        consumers = self._consumers
        for v in node.reads:
            lst = consumers.get(v.key)
            if lst is None:
                consumers[v.key] = [node]
            else:
                lst.append(node)
        producers = self._producers
        for v in node.writes:
            producers[v.key] = node

    def _index_op(self, node: OpNode) -> None:
        """Extend the cached producer/consumer maps with one recorded op."""
        self._index_op_maps(node)
        self._op_sigs.append(_intern_sig((
            node.fn, node.name, node.placement, node.flops,
            tuple((v.key if ref is not None else None)
                  for ref, v, _ in node.args),
            tuple(v.key for v in node.writes),
            tuple(v.key for v in node.reads),
        )))

    # -- consumer map (drives implicit-collective inference) -----------------
    def consumers(self) -> dict[tuple[int, int], list[OpNode]]:
        """version_key -> reading ops (cached; extended as ops are recorded).

        Returns the live map — treat it as read-only.
        """
        return self._consumers

    def producers(self) -> dict[tuple[int, int], OpNode]:
        """version_key -> producing op (cached; extended as ops are recorded).

        Returns the live map — treat it as read-only.
        """
        return self._producers

    # -- trace compaction -----------------------------------------------------
    def compact_trace(self, upto: int, placed_init: int = 0
                      ) -> tuple[int, int]:
        """Truncate the executed prefix ``ops[:upto]`` of the trace.

        The always-on serving runtime records an unbounded step stream into
        one long-lived workflow; without compaction ``ops``, the
        producer/consumer maps and every ref's version history grow
        forever.  Once a prefix has *executed* (its effects live in the
        executor's payload stores), its op records are only needed for
        lineage-based recovery — this drops them and rebases everything
        positional:

        * ``ops[:upto]`` and their interned signatures are removed and the
          surviving ops' ``op_id`` renumbered (the ``op_id == index``
          invariant every plan consumer relies on);
        * the producer/consumer maps are rebuilt from the survivors, so a
          pinned head produced below the horizon reads like an initial
          array (no producer — already materialised);
        * each ref's version history is truncated to its head plus any
          version a surviving op still references (indices are preserved,
          never reused — see :meth:`Ref.compact`);
        * ``initial`` entries already placed by the executor are dropped
          unless still live (a ref's current head), and checkpoint sources
          for compacted versions are forgotten.

        The cost is recoverability below the horizon: lineage-based fault
        recovery cannot recompute what it can no longer see (the same
        truncation contract as an executed checkpoint barrier, without the
        disk copy) — callers that need deep recovery should checkpoint
        before compacting.  The relocatable program-trace cache survives:
        its keys are normalized to (ref-ordinal, index-delta), which
        rebasing preserves, so steady-state loops keep their zero-replan
        hits across compactions.

        ``placed_init`` is how many ``initial`` entries the executor has
        materialised (its ``_init_seen``).  Returns ``(ops_removed,
        new_placed_init)``.
        """
        upto = min(upto, self._synced_upto)
        if upto <= 0:
            return 0, placed_init
        del self.ops[:upto]
        del self._op_sigs[:upto]
        for i, node in enumerate(self.ops):
            node.op_id = i
        self._synced_upto -= upto
        self._producers.clear()
        self._consumers.clear()
        live: set[tuple[int, int]] = set()
        for node in self.ops:
            self._index_op_maps(node)
            for v in node.reads:
                live.add(v.key)
            for v in node.writes:
                live.add(v.key)
        keep: dict[int, set[int]] = {}
        for rid, idx in live:
            keep.setdefault(rid, set()).add(idx)
        for ref in self.refs.values():
            ref.compact(keep.get(ref.ref_id, ()))
        # initial entries form a placed prefix (executor materialises them
        # in insertion order); drop placed entries unless still live
        new_initial: dict[tuple[int, int], Any] = {}
        new_placed = 0
        for i, (k, item) in enumerate(self.initial.items()):
            if i >= placed_init:
                new_initial[k] = item
                continue
            if k in live or self.refs[k[0]].head.key == k:
                new_initial[k] = item
                new_placed += 1
        self.initial = new_initial
        if self._ckpt_sources:
            self._ckpt_sources = {
                k: v for k, v in self._ckpt_sources.items()
                if k in live or self.refs[k[0]].head.key == k}
        return upto, new_placed

    # -- execution boundary ---------------------------------------------------
    def sync(self) -> None:
        """Paper's ``bind::sync()``: execute everything recorded so far."""
        if self._executor is None:
            from .scheduler import LocalExecutor

            self._executor = LocalExecutor(self.n_nodes)
        self._executor.run(self, start=self._synced_upto)
        self._synced_upto = len(self.ops)

    def fetch(self, arr: BindArray) -> Any:
        """Read back the head payload of an array (implies sync)."""
        self.sync()
        return self._executor.value(arr.ref.head)

    def checkpoint(self, arrays: Sequence[BindArray], manager,
                   step: Optional[int] = None, name: str = "ckpt"):
        """Record an atomic checkpoint barrier over ``arrays``.

        The barrier is a normal recorded op (all-``In``, zero writes) whose
        body saves the read payloads through ``manager``
        (:class:`repro_torch.ckpt.CheckpointManager`) — it rides plans,
        backends and caches like any op.  Once executed, the recovery
        planner's lineage walk *terminates* at the checkpointed versions:
        they rehydrate from disk instead of recomputing their ancestry
        (:mod:`repro_torch.core.recovery`).  Returns the barrier op's callable.
        """
        from .recovery import PlanCheckpoint

        arrays = tuple(arrays)
        if step is None:
            step = self._ckpt_counter
        self._ckpt_counter = step + 1
        ckpt = PlanCheckpoint(manager, step)
        ckpt.__bind_intents__ = (In,) * len(arrays)
        # snapshot heads BEFORE recording: these are the versions the
        # barrier reads and can later restore
        saved_keys = tuple(a.ref.head.key for a in arrays)
        self.call(ckpt, arrays, name=name)
        for i, k in enumerate(saved_keys):
            self._ckpt_sources[k] = (ckpt, i)
        return ckpt


def op(fn: Callable = None, *, flops: int = 0) -> Callable:
    """Decorator registering ``fn`` as a Bind operation.

    When called inside an active :class:`Workflow` the call is *recorded*;
    outside any workflow the function executes eagerly (plain Python), which
    keeps user code runnable in both modes — the paper's "classical
    sequential code design".
    """

    def wrap(f):
        intents = intents_of(f)

        def caller(*args, **kwargs):
            wf = current_workflow()
            if wf is None:
                return f(*args, **kwargs)
            assert not kwargs, "bind ops are positional-only when traced"
            return wf.call(f, args, flops=flops)

        caller.__name__ = getattr(f, "__name__", "op")
        caller.__wrapped__ = f
        caller.__bind_intents__ = intents
        # The *raw* ``f`` is what plans record, but the module attribute now
        # holds ``caller`` — repoint f's qualname through the wrapper so
        # pickle-by-reference resolves ``module.<name>.__wrapped__`` back
        # to this exact object.
        if hasattr(f, "__qualname__"):
            caller.__qualname__ = f.__qualname__
            f.__qualname__ = f.__qualname__ + ".__wrapped__"
        return caller

    if fn is not None:
        return wrap(fn)
    return wrap
