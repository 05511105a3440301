"""Executable cache — resolve an op signature once, replay forever.

The dominant pattern in tiled linalg workflows is thousands of ops sharing a
handful of *signatures* ``(fn, abstract shapes, dtypes)``: every leaf GEMM of
a Strassen recursion, every per-tile ``iadd``.  The cache resolves each
signature to the callable that executes it exactly once and memoises the
decision, with hit/miss counters for observability.

PyTorch runs eagerly, so a per-op signature resolves to the op's Python
body: a body called on CUDA tensors launches its kernels as it runs (the
GEMM leaves go through :mod:`repro_torch.kernels.gemm.ops`).  NumPy
payloads never become tensors (which could move them off the host or
change their dtype): a NumPy signature stays a NumPy signature.

The fused backends' entries are built per signature too:

* :meth:`ExecutableCache.lookup_vmapped` — a level's bucket of
  same-signature ops as one ``torch.func.vmap`` call over stacked operands;
* :meth:`ExecutableCache.lookup_chain` — a chain of levels as one call: a
  Python loop over the levels (``torch.func.vmap`` inside when the chain is
  wider than one op), in place of the reference's ``lax.scan``;
* :meth:`ExecutableCache.lookup_chain_pallas` — a width-1 chain of a
  kernel-tagged body as ONE launch of its hand-written chain kernel
  (:mod:`repro_torch.kernels.chain`).

``compiles`` counts those entries whose first call succeeded (the
reference counts its compiled XLA executables there); ``fallbacks`` stays
0, since a per-op body cannot fail to compile.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

# layouts whose argument is shared by every member of a vmapped batch
_UNBATCHED = ("const", "xs_const")

# what a body raises under torch.func.vmap when it cannot be batched: the
# transform's own refusals ("vmap: ..." — data-dependent control flow,
# .item()) and host access to a batched tensor (NumPy conversion of it).
# The reference's jax tracer raises a TypeError for the same bodies.  A
# body that launches a hand-written kernel is marked ``__bind_vmap__ =
# False`` and never gets here (see backends/fused.py).
_VMAP_REFUSALS = ("vmap:",
                  "Cannot access data pointer of Tensor that doesn't have "
                  "storage")


def _vmapped(fn: Callable, in_dims: tuple) -> Callable:
    """``torch.func.vmap(fn)`` whose refusal to batch ``fn`` is a
    ``TypeError`` ("not vmap-traceable", the fused backend's per-op pin);
    every other error propagates unchanged."""
    batched = torch.func.vmap(fn, in_dims=in_dims)

    def call(*args):
        try:
            return batched(*args)
        except RuntimeError as exc:
            if str(exc).startswith(_VMAP_REFUSALS):
                raise TypeError(f"{getattr(fn, '__name__', fn)!r} cannot be "
                                f"batched by torch.func.vmap: {exc}") from exc
            raise

    return call


def _unflatten(layout: tuple, n_batch: int, flat) -> list:
    """One argument per layout position: ``"flat"`` positions stack their
    ``n_batch`` consecutive member payloads, the others pass through."""
    args = []
    pos = 0
    for lay in layout:
        if lay == "flat":
            args.append(torch.stack(flat[pos:pos + n_batch]))
            pos += n_batch
        else:
            args.append(flat[pos])
            pos += 1
    return args


def _first(out):
    """The written payload of a fused op (it writes exactly one)."""
    return out[0] if isinstance(out, tuple) else out


def _abstract(arg: Any):
    """Abstract signature component of one payload.

    A tensor is keyed on ``(shape, dtype, device)``, a NumPy array on
    ``(shape, dtype, None)``, other objects with a shape and dtype (NumPy
    scalars) likewise, and anything else on its type.
    """
    t = type(arg)
    if t is np.ndarray:
        return (arg.shape, arg.dtype, None)
    if isinstance(arg, torch.Tensor):
        return (arg.shape, arg.dtype, arg.device)
    shape = getattr(arg, "shape", None)
    dtype = getattr(arg, "dtype", None)
    if shape is not None and dtype is not None:
        return (shape, dtype, None)
    return t


MAX_ENTRIES = 1024


class ExecutableCache:
    """Signature-keyed executable store with hit/miss counters.

    Bounded: past ``MAX_ENTRIES`` signatures the table is reset (entries pin
    op functions; a reset only costs re-resolution, and hot signatures
    repopulate immediately).
    """

    __slots__ = ("_entries", "hits", "misses", "compiles", "fallbacks")

    def __init__(self):
        self._entries: dict[tuple, Callable] = {}
        self.hits = 0
        self.misses = 0
        self.compiles = 0      # batched / chain entries validated by a call
        self.fallbacks = 0     # always 0: a per-op body cannot fail to build

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self.hits = self.misses = self.compiles = self.fallbacks = 0

    def signature(self, fn: Callable, args) -> tuple:
        return (fn,) + tuple(_abstract(a) for a in args)

    def lookup(self, fn: Callable, args) -> Callable:
        """Resolve ``fn`` for these payloads; O(1) dict hit on replay."""
        key = self.signature(fn, args)
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            return entry
        self.misses += 1
        if len(self._entries) >= MAX_ENTRIES:
            self._entries.clear()
        self._entries[key] = fn
        return fn

    def _resolve(self, key: tuple, build: Callable) -> Callable:
        """Memoise-or-build scaffolding shared by the batched/chain paths.

        On a miss, ``build()`` produces the callable and the entry
        installed is a *first-call validator*: if the first call raises,
        the entry is evicted and the error re-raised (a broken entry is
        never replayed — the caller decides what the error means); on
        success it counts one compile and self-replaces with the callable.
        """
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            return entry
        self.misses += 1
        if len(self._entries) >= MAX_ENTRIES:
            self._entries.clear()
        built = build()
        cache = self

        def first_call(*call_args):
            try:
                out = built(*call_args)
            except BaseException:
                cache._entries.pop(key, None)
                raise
            cache.compiles += 1
            cache._entries[key] = built
            return out

        self._entries[key] = first_call
        return first_call

    def lookup_vmapped(self, fn: Callable, layout: tuple, n_batch: int,
                       sig_args) -> Callable:
        """Resolve the *batched* call for ``n_batch`` fused ops.

        ``layout`` describes each argument position of the flat call list:
        ``"flat"`` — ``n_batch`` consecutive member payloads, stacked inside
        the call; ``"stacked"`` — one pre-stacked buffer passed through
        whole (the fused backend's batched-residency fast path);
        ``"const"`` — one shared constant, broadcast by vmap.  The entry
        runs ``torch.func.vmap(fn)`` over the batch and returns the
        **stacked** result buffer — callers keep per-member rows as lazy
        views, so a fused level costs one call and one result buffer.

        ``sig_args`` holds one representative per position (first member
        payload / buffer / constant); constants stay call arguments, so
        buckets differing only in constant *values* share the entry.

        A body vmap cannot batch raises ``TypeError`` (the caller falls
        back to per-op dispatch and should stop requesting batches for
        that ``fn``); the entry is evicted.
        """
        key = (fn, layout, n_batch) + tuple(_abstract(a) for a in sig_args)
        in_dims = tuple(None if lay == "const" else 0 for lay in layout)

        def build():
            batched = _vmapped(fn, in_dims)

            def stacked_call(*flat):
                return _first(batched(*_unflatten(layout, n_batch, flat)))

            return stacked_call

        return self._resolve(key, build)

    def lookup_chain(self, fn: Callable, layout: tuple, n_batch: int,
                     n_levels: int, carry_pos: int, sig_args) -> Callable:
        """Resolve the *chain* call: ``n_levels`` consecutive applications
        of ``fn`` in one call, as a Python loop over the levels.

        ``carry_pos`` names the payload position threaded through the loop
        as its state; its layout is ``"single"`` (one tensor, ``n_batch ==
        1``), ``"flat"`` (``n_batch`` member payloads stacked inside the
        call) or ``"stacked"`` (one pre-stacked buffer passed through
        whole).  Other positions:

        * ``"single"`` / ``"flat"`` / ``"stacked"`` at a non-carry position
          — a chain-invariant *exterior* payload, the same every level,
          batched by vmap when ``n_batch > 1``;
        * ``"xs"`` — a per-level *varying* exterior payload, pre-stacked to
          ``(n_levels, [n_batch,] ...)``; level ``i`` reads slice ``i``;
        * ``"xs_const"`` — per-level varying constants hoisted into one
          ``(n_levels,)`` tensor (broadcast across the batch);
        * ``"const"`` — one loop-invariant constant, kept a call argument
          so chains differing only in constant *values* share the entry.

        ``n_batch > 1`` runs ``torch.func.vmap(fn)`` at every level.  The
        entry returns the **final** level's (stacked) result; interior
        levels are never stored.

        As ``lax.scan`` requires of the reference's carry, every level must
        return a tensor of the carry's shape, dtype and device: a body that
        changes them raises ``TypeError`` at the level that does (the
        caller falls back to per-level dispatch; bodies are pure, so the
        levels already run are simply run again).
        """
        key = ((fn, "chain", layout, n_batch, n_levels, carry_pos)
               + tuple(_abstract(a) for a in sig_args))
        xs_positions = tuple(i for i, lay in enumerate(layout)
                             if lay in ("xs", "xs_const"))
        in_dims = tuple(None if lay in _UNBATCHED else 0 for lay in layout)

        def build():
            body = fn if n_batch == 1 else _vmapped(fn, in_dims)

            def chain_call(*flat):
                args = _unflatten(layout, n_batch, flat)
                carry = args[carry_pos]
                call_args = list(args)
                for level in range(n_levels):
                    call_args[carry_pos] = carry
                    for p in xs_positions:
                        call_args[p] = args[p][level]
                    out = _first(body(*call_args))
                    if not (isinstance(out, torch.Tensor)
                            and out.shape == carry.shape
                            and out.dtype == carry.dtype
                            and out.device == carry.device):
                        raise TypeError(
                            f"{getattr(fn, '__name__', fn)!r} does not keep "
                            f"its carry's shape, dtype and device at level "
                            f"{level}")
                    carry = out
                return carry

            return chain_call

        return self._resolve(key, build)

    def lookup_chain_pallas(self, fn: Callable, layout: tuple, n_levels: int,
                            carry_pos: int, sig_args, *,
                            interpret: bool = True) -> Callable:
        """Resolve a width-1 chain of a kernel-tagged body to ONE launch of
        its hand-written chain kernel.

        The reference lowers the chain *into* one ``pl.pallas_call``
        traced from ``fn`` (levels as a ``fori_loop`` over refs, the carry
        resident, only the final carry written).  A CUDA kernel cannot
        trace a Python body, so in the port this resolves to the chain
        kernel written for ``fn``
        (:func:`repro_torch.kernels.chain.chain_for`): ``chain_ewise`` for
        ``scan_step``, ``chain_dot`` for ``gemm_tile``, ``chain_attn`` for
        ``attn_step``.  Name and signature are the reference's, so code
        written for it runs unchanged.

        Layout vocabulary is the width-1 subset of :meth:`lookup_chain`:
        ``"single"``, ``"xs"``, ``"xs_const"`` and ``"const"``.  Constants
        are keyed by value, as the reference's static constants are; the
        kernel takes them as scalar arguments.  ``interpret`` is accepted
        and ignored: the operands' device decides the route, as for the
        GEMM (the kernel on CUDA tensors, its plain per-level version on
        CPU tensors).

        A body with no chain kernel raises ``ValueError`` here; operands
        its kernel does not take raise ``ValueError`` at the call.  Ask
        :func:`repro_torch.kernels.chain.problem` first.
        """
        from repro_torch.kernels import chain as chain_kernels

        del interpret
        run = chain_kernels.chain_for(fn)
        if run is None:
            raise ValueError(f"no chain kernel for "
                             f"{getattr(fn, '__name__', fn)!r}")
        key = ((fn, "chain_pallas", layout, n_levels, carry_pos)
               + tuple(("const", a) if lay == "const" else _abstract(a)
                       for lay, a in zip(layout, sig_args)))

        def build():
            def chain_call(*flat):
                return run(layout, carry_pos, n_levels, *flat)

            return chain_call

        return self._resolve(key, build)


# Process-wide cache: signatures are shared across executors and workflows.
EXEC_CACHE = ExecutableCache()


def process_local_cache() -> ExecutableCache:
    """The calling process's executable cache: :data:`EXEC_CACHE`.  In a
    ``procs`` worker the module is imported afresh, so its process-wide
    instance is that worker's own cache, filled on first replay and kept
    for the worker's lifetime."""
    return EXEC_CACHE
