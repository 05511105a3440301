"""Fused-batch dispatch: same-signature level-mates become one vmapped call,
and whole signature *chains* become one chain call.

Tiled linalg and MapReduce wavefronts are dominated by N ops sharing one
``(fn, shapes, dtypes, device)`` signature — N leaf GEMMs, N per-tile adds.
The serial backend pays N dispatches; this backend dispatches each such
*bucket* as a single ``torch.func.vmap(fn)`` call through the
:class:`~repro_torch.core.executable_cache.ExecutableCache`'s batched
entries.

A bucket's result stays one stacked buffer (**batched residency**), and
each member op's payload is a lazy :class:`~.base.BatchSlice` row of it.
When the next level's bucket consumes exactly those members (the
chain-of-wavefronts shape), the whole buffer is passed through as ONE
argument and returned as ONE result.  Rows materialise only at the
boundaries: a non-fused consumer (a view of the row), a transfer or a user
``fetch()`` (a copy of the row).

**Chain fusion** goes one step further: when the plan detects a
:class:`~repro_torch.core.plan.ChainSlice` — consecutive levels of one
signature whose dataflow is elementwise-aligned on a carry operand and
whose carried interior versions live and die inside the run — the whole
chain dispatches as one call: a Python loop over the levels
(``torch.func.vmap`` inside for width > 1), the reference's ``lax.scan``.
Interior levels are never stored.  The remaining operands are
chain-exterior versions, passed through whole when every level reads the
same version or stacked into an ``xs`` tensor when they vary per level
(and when those exterior rows already live in one fused bucket's stacked
buffer, that buffer is used directly).  Constants that vary per level are
hoisted into one ``xs_const`` tensor when that keeps serial replay's
arithmetic.  The interior ops' commit/GC accounting is still replayed
(virtually), so live-set stats stay byte-identical to serial.

Eligibility is decided in two halves:

* **static** (plan time, :attr:`ExecutionPlan.level_groups` /
  :attr:`ExecutionPlan.chains`): level-mates sharing ``(fn,
  constant-position mask)`` with a single written version; chains
  additionally need carry-aligned dataflow, chain-local carried lifetimes,
  and chain-exterior remaining operands;
* **dynamic** (replay time, here): members must agree on payload
  shape/dtype/device, constants must be per-level-uniform and
  loop-invariant or hoistable, and every payload must already be a
  ``torch.Tensor`` (or a :class:`BatchSlice` of one) — NumPy payloads are
  never promoted to tensors, they take the per-op path instead.

Ops that fail either half — and every op of a ``fn`` that vmap could not
batch (``TypeError`` / ``ValueError``) — fall back to per-op (or per-level)
dispatch, so the backend degrades to serial semantics.  A body marked
``__bind_vmap__ = False`` (one that launches a hand-written kernel, which
cannot read a vmap-batched tensor: ``gemm_tile``, ``linalg.tiles``'s GEMM
accumulate) is never stacked at all: its buckets and its chains wider than
one op run per op from the start.  Every other error (a kernel launch that
fails, a body that raises at run time) propagates.
Plans with no fusion opportunity at all delegate to
:class:`~.serial.SerialPlanBackend` wholesale.

Ships and commits stay in plan order (see :mod:`.base`), so the transfer
stream is byte-identical to serial; ``peak_live_*`` may report the higher
true-concurrency peak of a whole level in flight.  Once any of a bucket's
rows are GC'd, the survivors are copied out at the next level boundary
(:func:`~.base.spill_dead_buckets`) and the stacked buffer released, so
device residency never exceeds ``stats.peak_live_bytes`` by more than one
in-flight bucket.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...compat import NP_TO_TORCH
from ..stats import _nbytes
from .base import (Backend, BatchBucket, BatchSlice, apply_ships, commit,
                   drop_versions, gather_args, materialize, resolve_call,
                   spill_dead_buckets)
from .serial import SerialPlanBackend

_PENDING = object()     # "not produced by a fused bucket" sentinel

# per-position layouts of a batched/chained call's flat argument list
FLAT = "flat"           # n_batch consecutive member payloads, stacked inside
STACKED = "stacked"     # one pre-stacked buffer (batched residency pass-through)
CONST = "const"         # one shared constant, broadcast by vmap
SINGLE = "single"       # one tensor: a width-1 chain's carry or exterior
XS = "xs"               # per-level varying exterior payloads, pre-stacked
                        # to (n_levels, [width,] ...), one slice per level
XS_CONST = "xs_const"   # per-level varying constants hoisted into one
                        # (n_levels,) tensor, one element per level

# constant types eligible for xs hoisting: uniform-typed scalar runs
_HOISTABLE = (bool, int, float, np.bool_, np.integer, np.floating)
_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1
# the dtype jax gives a hoisted array under its default 32-bit config; the
# reference accepts a hoist only when that dtype promotes into the carry's
_CANONICAL = {np.dtype(np.float64): torch.float32,
              np.dtype(np.int64): torch.int32,
              np.dtype(np.uint64): torch.uint32}


def _const_key(v):
    """Identity of one constant for chain sharing/invariance decisions.

    Type included (2, 2.0 and True compare equal but promote differently)
    and, for float zeros, the sign bit: ``0.0 == -0.0`` yet replaying one
    for the other diverges bitwise from serial, so signed-zero mixes must
    read as *varying* (the hoisted xs path preserves -0.0 exactly).
    """
    if isinstance(v, (float, np.floating)) and v == 0.0:
        return (type(v), v, math.copysign(1.0, v))
    return (type(v), v)


def _batchable(fn) -> bool:
    """False for a body marked ``__bind_vmap__ = False``: vmap cannot batch
    it, so it is never stacked (decided before any work, not by failing)."""
    return getattr(fn, "__bind_vmap__", True)


def _aval(t: torch.Tensor):
    """The batching contract of one tensor: ``(shape, dtype, device)``."""
    return (t.shape, t.dtype, t.device)


def _bucket_key(p, args):
    """Dynamic fusion signature of one staged op, or None if ineligible."""
    parts = []
    for i, k in enumerate(p.arg_keys):
        a = args[i]
        if k is not None:
            if type(a) is BatchSlice:
                parts.append(a.aval)
            elif isinstance(a, torch.Tensor):
                parts.append(_aval(a))
            else:
                return None
        else:
            try:
                hash(a)
            except TypeError:
                return None
            # type included: 2, 2.0 and True compare/hash equal but must
            # not share a bucket (member 0's constant would impose its
            # dtype on the whole batch)
            parts.append(("const", type(a), a))
    return tuple(parts)


def _common_buffer(column):
    """The shared stacked buffer behind a bucket's argument column, if any.

    Returns the buffer when every member's payload is a :class:`BatchSlice`
    of one buffer covering rows ``0..n-1`` in member order (the chain case);
    None otherwise.
    """
    first = column[0]
    if type(first) is not BatchSlice or first.index != 0:
        return None
    buf = first.buffer
    n = len(column)
    if buf.shape[0] != n:
        return None
    for i in range(1, n):
        a = column[i]
        if type(a) is not BatchSlice or a.buffer is not buf or a.index != i:
            return None
    return buf


def _hoisted_dtype(carry_dtype: torch.dtype, vals: list, arr: np.ndarray):
    """The dtype of the hoisted ``xs_const`` tensor, or None to fall back.

    Accepted exactly when the reference accepts: the hoisted array's dtype
    under jax's default 32-bit config promotes into the carry's dtype
    (``np.asarray`` of Python floats is float64, which jax reads as
    float32).  The tensor is built in ``torch.result_type(carry, v0)``,
    the dtype serial replay computes in, on the carry's device.  Serial
    replay converts a scalar to the operator's math type (float32 for
    float16 / bfloat16); a reduced-precision carry therefore also needs
    every value to be exact in its own dtype, or the hoist would round
    where serial does not.
    """
    canon = _CANONICAL.get(arr.dtype, NP_TO_TORCH.get(arr.dtype))
    if canon is None:
        return None
    if torch.promote_types(carry_dtype, canon) != carry_dtype:
        return None
    v0 = vals[0]
    probe = torch.empty((), dtype=carry_dtype)
    dtype = torch.result_type(
        probe, v0.item() if isinstance(v0, np.generic) else v0)
    if dtype in (torch.float16, torch.bfloat16):
        as32 = torch.tensor([float(v) for v in vals], dtype=torch.float32)
        if not torch.equal(as32.to(dtype).float(), as32):
            return None
    return dtype


class FusedBatchBackend(Backend):
    """Bucket same-signature ops per wavefront (one vmapped dispatch each)
    and dispatch whole signature chains as one call."""

    name = "fused"

    def __init__(self, min_batch: int = 2, min_chain_levels: int = 2):
        self.min_batch = max(2, int(min_batch))
        # minimum chain depth worth a chain dispatch; 0/None disables chain
        # fusion entirely (per-level dispatch only)
        self.min_chain_levels = (0 if not min_chain_levels
                                 else max(2, int(min_chain_levels)))
        self._serial = SerialPlanBackend()
        self._no_fuse: set = set()      # fns vmap could not batch
        self._no_chain: set = set()     # fns whose chain call raised
        self.batches_dispatched = 0
        self.ops_fused = 0
        self.chains_dispatched = 0
        self.ops_chained = 0
        # varying-exterior xs grids served straight from a fused bucket's
        # stacked buffer (no per-row materialise + restack)
        self.xs_passthrough = 0

    def _probe_payload(self, ex, k):
        """Version ``k``'s resident payload, or None if not yet
        materialised (produced mid-segment)."""
        if ex.n_nodes == 1:
            return ex._stores[0].get(k)
        ranks = ex._where.get(k)
        return ex._stores[next(iter(ranks))][k] if ranks else None

    def _chain_inputs_tensor(self, ex, plan, chain) -> bool:
        """Cheap replay-time probe: could this chain possibly dispatch?

        Checks the first member's payload at *every* payload position
        (carry and exteriors — O(arity), width-independent): a resident
        non-tensor operand can never pass the dynamic eligibility check
        (NumPy is never promoted), so such chains skip the full
        stage-and-gather work on every replay.  A payload that does not
        exist yet counts as viable.
        """
        p = plan.schedule[chain.members[0][0]]
        for pos in chain.payload_positions:
            a = self._probe_payload(ex, p.arg_keys[pos])
            if not (a is None or type(a) is BatchSlice
                    or isinstance(a, torch.Tensor)):
                return False
        return True

    def _chain_maybe_viable(self, ex, plan, chain) -> bool:
        """Viability gate for the wholesale-serial-delegation decision —
        plans holding only never-dispatchable chains keep the delegation."""
        return (chain.n_levels >= self.min_chain_levels
                and chain.fn not in self._no_chain
                and (chain.width == 1 or _batchable(chain.fn))
                and self._chain_inputs_tensor(ex, plan, chain))

    def _delegate_wholesale(self, ex, wf, plan) -> bool:
        """Serial-delegation decision.

        Wholesale delegation is only safe while the stores cannot hold
        lazy rows — the serial loop feeds payloads to op bodies (and ships
        them cross-rank) without materialising.  While any bucket has live
        rows, the level loop runs instead, materialising at every boundary.
        """
        if plan.has_fusion_groups or ex._lazy_buckets:
            return False
        min_chain = self.min_chain_levels
        return not min_chain or not any(
            self._chain_maybe_viable(ex, plan, c) for c in plan.chains)

    def _apply_ships(self, ex, p) -> None:
        """Concretise and replay one op's ship schedule."""
        self._materialize_shipped(ex, p)
        apply_ships(ex, p)

    def execute(self, ex, wf, plan) -> None:
        min_chain = self.min_chain_levels
        if self._delegate_wholesale(ex, wf, plan):
            self._serial.execute(ex, wf, plan)
            return
        ops = wf.ops
        schedule = plan.schedule
        levels = plan.levels
        groups = plan.level_groups
        chain_at = ({c.first_level: c for c in plan.chains}
                    if plan.chains and min_chain else None)
        li = 0
        n_levels = len(levels)
        inj = getattr(ex, "fault_injector", None)
        if inj is not None and not inj.armed:
            inj = None
        while li < n_levels:
            if inj is not None:
                # wavefront-boundary fault consult; a chain dispatches its
                # levels atomically, so a mid-chain target fires at the
                # chain's exit boundary (the next time this line runs)
                inj.check(ex, ex._wavefront_base + li, level=li)
            chain = chain_at.get(li) if chain_at else None
            if (chain is not None and chain.n_levels >= min_chain
                    and chain.fn not in self._no_chain
                    and self._run_chain(ex, ops, plan, chain)):
                spill_dead_buckets(ex)
                li += chain.n_levels
                continue
            lo, hi = levels[li]
            self._run_level(ex, ops, schedule, lo, hi, groups[li])
            spill_dead_buckets(ex)
            li += 1

    # -- per-level fused dispatch ---------------------------------------------
    def _run_level(self, ex, ops, schedule, lo, hi, groups) -> None:
        # stage the level on the main thread, plan order (ships first)
        staged = []
        for idx in range(lo, hi):
            p = schedule[idx]
            if p.ships:
                self._apply_ships(ex, p)
            node = ops[p.op_id]
            staged.append((p, node, gather_args(ex, p, node)))
        results = [_PENDING] * (hi - lo)
        result_nbytes = [None] * (hi - lo)
        for group in groups:
            fn = schedule[group[0]].fn
            if fn in self._no_fuse or not _batchable(fn):
                continue
            buckets: dict[tuple, list[int]] = {}
            for idx in group:
                off = idx - lo
                p, _node, args = staged[off]
                key = _bucket_key(p, args)
                if key is not None:
                    buckets.setdefault(key, []).append(off)
            for members in buckets.values():
                if len(members) >= self.min_batch:
                    self._run_bucket(ex, staged, members, results,
                                     result_nbytes)
        # commit in plan order; non-fused ops execute per-op here.  The
        # dominant simple-write case is inlined over locals (the serial
        # backend's discipline).
        stores, where, key_bytes = ex._stores, ex._where, ex._key_bytes
        lazy_buckets = ex._lazy_buckets
        stats = ex._stats
        live_b, live_c = ex._live_bytes, ex._live_entries
        peak_b, peak_c = stats.peak_live_bytes, stats.peak_live_payloads
        for off, (p, node, args) in enumerate(staged):
            result = results[off]
            if result is _PENDING:
                if any(type(a) is BatchSlice for a in args):
                    args = [materialize(a) for a in args]
                result = resolve_call(ex, p, args)(*args)
            if p.simple_write and not isinstance(result, tuple):
                wk = p.write_keys[0]
                nb = result_nbytes[off]
                if nb is None:
                    nb = _nbytes(result)
                else:               # fused row: register batched residency
                    result.bucket.rows[result.index] = wk
                    lazy_buckets.add(result.bucket)
                key_bytes[wk] = nb
                live_b += nb
                rank = p.exec_ranks[0]
                where[wk] = {rank}
                stores[rank][wk] = result
                live_c += 1
            else:
                # flush locals (incl. peaks — commit() samples against
                # stats, and an earlier same-level peak must not be lost)
                ex._live_bytes, ex._live_entries = live_b, live_c
                stats.peak_live_bytes = peak_b
                stats.peak_live_payloads = peak_c
                commit(ex, p, node, result)
                live_b, live_c = ex._live_bytes, ex._live_entries
                peak_b, peak_c = (stats.peak_live_bytes,
                                  stats.peak_live_payloads)
                continue
            if live_b > peak_b:
                peak_b = live_b
            if live_c > peak_c:
                peak_c = live_c
            if p.gc_keys:
                live_b, live_c = drop_versions(
                    p.gc_keys, stores, where, key_bytes, live_b, live_c)
        ex._live_bytes, ex._live_entries = live_b, live_c
        stats.peak_live_bytes, stats.peak_live_payloads = peak_b, peak_c

    def _materialize_shipped(self, ex, p) -> None:
        """Copy out lazy rows about to travel (boundary: transfers)."""
        for vkey, root, _transfers in p.ships:
            payload = ex._stores[root][vkey]
            if type(payload) is BatchSlice:
                concrete = payload.concrete()
                payload.release()
                for r in ex._where[vkey]:
                    ex._stores[r][vkey] = concrete

    def _run_bucket(self, ex, staged, members, results, result_nbytes) -> None:
        p0, _node0, args0 = staged[members[0]]
        if p0.fn in self._no_fuse:
            # an earlier bucket of this fn (same level) could not be
            # batched — don't pay for it again for the remaining buckets
            return
        n = len(members)
        # flat layout (see ExecutableCache.lookup_vmapped): pass a chained
        # bucket's stacked buffer through whole; otherwise n member payloads
        layout = []
        call_args = []
        sig_args = []
        for i, k in enumerate(p0.arg_keys):
            if k is None:
                layout.append(CONST)
                call_args.append(args0[i])
                sig_args.append(args0[i])
                continue
            column = [staged[m][2][i] for m in members]
            buf = _common_buffer(column)
            if buf is not None:
                layout.append(STACKED)
                call_args.append(buf)
                sig_args.append(buf)
            else:
                column = [materialize(a) for a in column]
                layout.append(FLAT)
                call_args.extend(column)
                sig_args.append(column[0])
        call = ex._exec_cache.lookup_vmapped(
            p0.fn, tuple(layout), n, sig_args)
        try:
            out = call(*call_args)
        except (TypeError, ValueError):
            # vmap could not batch the body (data-dependent control flow,
            # host access): pin this
            # fn to the per-op path for the executor's life — op bodies
            # are pure by the model's contract, so re-execution is safe
            self._no_fuse.add(p0.fn)
            return
        self.batches_dispatched += 1
        self.ops_fused += n
        # batched residency: one stacked buffer, n lazy rows
        elt_aval = (out.shape[1:], out.dtype, out.device)
        nb = _nbytes(out) // n       # one shape/dtype per bucket
        bucket = BatchBucket(out, n)
        for bi, m in enumerate(members):
            results[m] = BatchSlice(out, bi, nb, elt_aval, bucket)
            result_nbytes[m] = nb

    # -- whole-chain fused dispatch -------------------------------------------
    def _stored(self, ex, k):
        """Resolve version ``k``'s payload from whichever rank holds it."""
        if ex.n_nodes == 1:
            return ex._stores[0][k]
        return ex._stores[next(iter(ex._where[k]))][k]

    @staticmethod
    def _uniform_tensor_aval(payloads):
        """The common ``(shape, dtype, device)`` when every payload is a
        tensor (or a :class:`BatchSlice` of one — NumPy et al are never
        promoted) and all agree; None otherwise.  The one eligibility rule
        for batch-stackable payload collections — carry columns, invariant
        exterior columns and varying-exterior xs grids all go through it.
        """
        aval0 = None
        for a in payloads:
            if type(a) is BatchSlice:
                aval = a.aval
            elif isinstance(a, torch.Tensor):
                aval = _aval(a)
            else:
                return None
            if aval0 is None:
                aval0 = aval
            elif aval != aval0:
                return None
        return aval0

    def _payload_column(self, column):
        """``(layout, call_args, sig_arg)`` for a width-column of payloads,
        or None if any member is not a tensor or the avals disagree."""
        if self._uniform_tensor_aval(column) is None:
            return None
        if len(column) == 1:
            a = materialize(column[0])
            return SINGLE, [a], a
        buf = _common_buffer(column)
        if buf is not None:
            return STACKED, [buf], buf
        concrete = [materialize(a) for a in column]
        return FLAT, concrete, concrete[0]

    def _dispatch_chain(self, ex, chain, layout, width, n_levels, carry_pos,
                        call_args, sig_args):
        """Resolve and run one eligible chain; returns the output buffer.

        The single override point for subclasses that run chains another
        way (the mesh backend swaps in the chain kernels for kernel-tagged
        bodies).  A ``TypeError`` / ``ValueError`` from here makes
        :meth:`_run_chain` pin the fn to per-level dispatch; everything
        before (eligibility, staging) and after (ships, virtual commit/GC
        replay) is shared.
        """
        call = ex._exec_cache.lookup_chain(
            chain.fn, layout, width, n_levels, carry_pos, sig_args)
        return call(*call_args)

    def _run_chain(self, ex, ops, plan, chain) -> bool:
        """Dispatch a :class:`~repro_torch.core.plan.ChainSlice` as one call.

        Returns False (with **no state mutated**) when the dynamic half of
        eligibility fails — non-tensor payloads, mismatched member avals,
        unhashable or unhoistable varying constants — or when the chain
        call raises ``TypeError`` / ``ValueError`` (the ``fn`` is then
        pinned to per-level dispatch); the caller falls back to the
        per-level path for these levels.  On success, first-level ships,
        the final level's commits, and every interior op's virtual
        commit/GC accounting are replayed in plan order, so the transfer
        stream and live-set stats are byte-identical to serial replay.
        """
        schedule = plan.schedule
        width = chain.width
        carry_pos = chain.carry_pos
        n_levels = chain.n_levels
        first = chain.members[0]
        # --- dynamic eligibility (pure reads; fall back leaves no trace) ---
        # a wide chain of a body vmap cannot batch never dispatches; a
        # cheap first probe before staging the whole level: a resident
        # non-tensor operand at any payload position can never dispatch
        # (NumPy is never promoted), and the carry must exist by now
        if ((width > 1 and not _batchable(chain.fn))
                or not self._chain_inputs_tensor(ex, plan, chain)
                or self._probe_payload(
                    ex, schedule[first[0]].arg_keys[carry_pos]) is None):
            return False
        staged = []
        for idx in first:
            p = schedule[idx]
            staged.append(gather_args(ex, p, ops[p.op_id]))
        # exterior payload positions: chain-invariant (every level reads the
        # same version per member → one pass-through operand) or varying
        # (gather the whole (level, member) grid for xs stacking)
        exterior: dict[int, tuple] = {}     # pos -> ("inv", col) | ("xs", grid)
        for e in chain.payload_positions:
            if e == carry_pos:
                continue
            keys = [[schedule[m].arg_keys[e] for m in lvl]
                    for lvl in chain.members]
            if all(keys[l][j] == keys[0][j]
                   for l in range(1, n_levels) for j in range(width)):
                exterior[e] = ("inv", [staged[j][e] for j in range(width)])
            else:
                exterior[e] = ("xs", [[self._stored(ex, k) for k in row]
                                      for row in keys])
        # constants: members of one level must agree (they are broadcast,
        # not batched); across levels a position is loop-invariant or — if
        # the values are uniform-typed scalars — hoisted into xs_const.
        # Read from the live ops: plans are cached across constant changes.
        level_consts = []
        for level in chain.members:
            typed0 = None
            for idx in level:
                node = ops[schedule[idx].op_id]
                consts = tuple(a[1] for a in node.args if a[0] is None)
                typed = tuple(_const_key(v) for v in consts)
                if typed0 is None:
                    try:
                        hash(typed)
                    except TypeError:
                        return False
                    typed0 = typed
                    level_consts.append(consts)
                elif typed != typed0:
                    return False
        hoisted: dict[int, tuple] = {}      # const ordinal -> (values, dtype)
        carry_dtype = staged[0][carry_pos].dtype
        for ci in range(len(level_consts[0])):
            v0 = level_consts[0][ci]
            t = type(v0)
            k0 = _const_key(v0)
            if all(_const_key(lc[ci]) == k0 for lc in level_consts[1:]):
                continue                        # loop-invariant: stays CONST
            vals = [lc[ci] for lc in level_consts]
            if not (isinstance(v0, _HOISTABLE)
                    and all(type(v) is t for v in vals)):
                return False
            if (isinstance(v0, (int, np.integer))
                    and not isinstance(v0, (bool, np.bool_))
                    and not all(_I32_MIN <= int(v) <= _I32_MAX
                                for v in vals)):
                return False    # the reference's int32 hoist would wrap
            arr = np.asarray(vals)
            if arr.dtype == object:
                return False
            # a hoist that would change the carry's dtype or round a value
            # serial replay keeps exact is rejected before dispatch: plain
            # per-level fallback, no pin
            dtype = _hoisted_dtype(carry_dtype, vals, arr)
            if dtype is None:
                return False
            hoisted[ci] = (arr.tolist(), dtype)
        # --- resolve + dispatch (state untouched until the call succeeds) ---
        p0 = schedule[first[0]]
        device = staged[0][carry_pos].device
        layout = []
        call_args = []
        sig_args = []
        ci = 0
        for i, k in enumerate(p0.arg_keys):
            if k is None:
                if ci in hoisted:
                    vals, dtype = hoisted[ci]
                    xs = torch.tensor(vals, dtype=dtype, device=device)
                    layout.append(XS_CONST)
                    call_args.append(xs)
                    sig_args.append(xs)
                else:
                    layout.append(CONST)
                    call_args.append(level_consts[0][ci])
                    sig_args.append(level_consts[0][ci])
                ci += 1
            elif i == carry_pos or exterior[i][0] == "inv":
                column = ([staged[j][carry_pos] for j in range(width)]
                          if i == carry_pos else exterior[i][1])
                resolved = self._payload_column(column)
                if resolved is None:
                    return False
                lay, cargs, sig = resolved
                layout.append(lay)
                call_args.extend(cargs)
                sig_args.append(sig)
            else:                               # varying exterior: stack xs
                flat_grid = [a for row in exterior[i][1] for a in row]
                if self._uniform_tensor_aval(flat_grid) is None:
                    return False
                buf = _common_buffer(flat_grid)
                if buf is not None:
                    # pre-stacked passthrough: the exterior rows ARE one
                    # fused bucket's stacked buffer in (level, member)
                    # order — use that buffer directly; the rows stay lazy
                    # (their GC releases them like any bucket rows)
                    stacked = (buf if width == 1 else buf.reshape(
                        (n_levels, width) + tuple(buf.shape[1:])))
                    self.xs_passthrough += 1
                else:
                    stacked = torch.stack([materialize(a) for a in flat_grid])
                    if width > 1:
                        stacked = stacked.reshape(
                            (n_levels, width) + tuple(stacked.shape[1:]))
                layout.append(XS)
                call_args.append(stacked)
                sig_args.append(stacked)
        try:
            out = self._dispatch_chain(
                ex, chain, tuple(layout), width, n_levels, carry_pos,
                call_args, sig_args)
        except (TypeError, ValueError):
            # vmap could not batch the body, or the body does not keep its
            # carry's shape/dtype.  Pin the fn to per-level dispatch — op
            # bodies are pure, re-execution (per level) is safe.
            self._no_chain.add(chain.fn)
            return False
        self.chains_dispatched += 1
        self.ops_chained += width * n_levels
        # --- first-level ships (interior levels are ship-free by plan) ---
        for idx in first:
            p = schedule[idx]
            if p.ships:
                self._apply_ships(ex, p)
        # --- replay commit/GC accounting in plan order -------------------
        # Interior writes never materialise, but their (uniform: the carry
        # keeps its shape and dtype) sizes flow through the same
        # commit-then-GC arithmetic serial replay performs, so peaks and
        # final live totals are byte-identical.
        nb = _nbytes(out) // width
        bucket = BatchBucket(out, width) if width > 1 else None
        elt_aval = (out.shape[1:], out.dtype, out.device)
        last = chain.members[-1]
        row_of = {idx: j for j, idx in enumerate(last)}
        interior = chain.interior_keys
        stores, where, key_bytes = ex._stores, ex._where, ex._key_bytes
        stats = ex._stats
        live_b, live_c = ex._live_bytes, ex._live_entries
        peak_b, peak_c = stats.peak_live_bytes, stats.peak_live_payloads
        first_ord = chain.first_level
        lo = plan.levels[first_ord][0]
        final_lo, hi = plan.levels[first_ord + n_levels - 1]
        for idx in range(lo, hi):
            p = schedule[idx]
            if idx >= final_lo:          # final level: real commit
                wk = p.write_keys[0]
                if bucket is None:
                    payload = out
                else:
                    row = row_of[idx]
                    payload = BatchSlice(out, row, nb, elt_aval, bucket)
                    bucket.rows[row] = wk
                key_bytes[wk] = nb
                rank = p.exec_ranks[0]
                where[wk] = {rank}
                stores[rank][wk] = payload
            live_b += nb
            live_c += 1
            if live_b > peak_b:
                peak_b = live_b
            if live_c > peak_c:
                peak_c = live_c
            if p.gc_keys:
                real = None
                for dk in p.gc_keys:
                    if dk in interior:   # virtual row: lived inside the call
                        live_b -= nb
                        live_c -= 1
                    elif real is None:
                        real = [dk]
                    else:
                        real.append(dk)
                if real:                 # exterior/carry-input: real drop
                    live_b, live_c = drop_versions(
                        real, stores, where, key_bytes, live_b, live_c)
        if bucket is not None:
            ex._lazy_buckets.add(bucket)
        ex._live_bytes, ex._live_entries = live_b, live_c
        stats.peak_live_bytes, stats.peak_live_payloads = peak_b, peak_c
        return True
