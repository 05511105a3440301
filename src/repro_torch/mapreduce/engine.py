"""A "trivial" MapReduce engine over Bind (paper §IV-B, Listing 2).

The paper's point is that map / combine / **implicit shuffle** / reduce fall
out of the Bind model for free: map and reduce are placed ops; the shuffle is
nothing but the implicit transfers the runtime derives from "reduce of bucket
``b`` runs on ``owner(b)`` but its inputs were produced on mapper nodes".

Data model (columnar, vectorised — the paper's
``std::vector<std::pair<K, V>>`` as arrays): a partition is a NumPy array
or a ``torch.Tensor`` of values; ``map`` emits (keys, values) of the same
kind; the engine groups by key bucket.  A NumPy partition takes NumPy's
steps, bit for bit the reference's; a tensor partition takes torch's on
its own device, so a CUDA partition is mapped, shuffled and reduced on the
card, and :meth:`Reduced.collect` hands back a tensor there.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import core as bind


def _map_partition(values, map_fn):
    keys, vals = map_fn(values)
    # group rows by destination bucket
    if isinstance(keys, torch.Tensor):
        order = torch.argsort(keys, stable=True)
    else:
        order = np.argsort(keys, kind="stable")
    return keys[order], vals[order]


def _extract_bucket(keys, vals, lo, hi):
    if isinstance(keys, torch.Tensor):
        bounds = torch.searchsorted(
            keys, torch.tensor([lo, hi], dtype=keys.dtype, device=keys.device))
        start, end = bounds.tolist()
        return vals[start:end]
    sel = slice(np.searchsorted(keys, lo), np.searchsorted(keys, hi))
    return vals[sel]


def _reduce_bucket(reduce_fn, bucket_id, dtype, *pieces):
    # dtype-stable even for empty buckets: an int64 job must never leak a
    # float64 empty (np.empty(0) defaults to float64 and would poison the
    # dtype promotion in collect()).
    if pieces and isinstance(pieces[0], torch.Tensor):
        merged = torch.cat(pieces)
    elif pieces:
        merged = np.concatenate(pieces)
    elif isinstance(dtype, torch.dtype):
        # no mapper at all, so no partition's device to follow
        merged = torch.empty(0, dtype=dtype)
    else:
        merged = np.empty(0, dtype=np.dtype(dtype) if dtype is not None else None)
    return reduce_fn(bucket_id, merged)


# their outputs' sizes depend on the data (a sort, a searchsorted slice, a
# concatenation): the fused backend runs them per op, never under vmap
for _body in (_map_partition, _extract_bucket, _reduce_bucket):
    _body.__bind_vmap__ = False


class KVPairs:
    """Distributed key/value collection: ``KVPairs(wf, partitions).map(f).reduce(g)``.

    ``partitions`` maps node rank → BindArray of that node's local values
    (the paper's ``local_map`` of documents).
    """

    def __init__(self, wf: bind.Workflow, partitions: dict[int, bind.BindArray]):
        self.wf = wf
        self.partitions = dict(partitions)

    @classmethod
    def from_arrays(cls, wf: bind.Workflow, arrays: Sequence) -> "KVPairs":
        return cls(wf, {
            rank: wf.array(arr, f"part{rank}", rank=rank)
            for rank, arr in enumerate(arrays)
        })

    # -- map ------------------------------------------------------------------
    def map(self, map_fn: Callable) -> "_Mapped":
        """``map_fn(values) -> (keys, values)`` applied on each node's data."""
        mapped = {}
        for rank, part in self.partitions.items():
            with bind.node(rank):
                mapped[rank] = self.wf.apply(
                    _map_partition, (part, map_fn), name="map", n_out=2
                )
        return _Mapped(self.wf, mapped)


class _Mapped:
    def __init__(self, wf: bind.Workflow, mapped: dict[int, tuple]):
        self.wf = wf
        self.mapped = mapped  # rank -> (keys BindArray, vals BindArray)

    def reduce(
        self,
        reduce_fn: Callable,
        n_buckets: int,
        owner: Optional[Callable[[int], int]] = None,
        combine_fn: Optional[Callable] = None,
        dtype=None,
    ) -> "Reduced":
        """Group by key into ``n_buckets``, ship each bucket to its owner node
        (the *implicit shuffle*), then apply ``reduce_fn(bucket_id, values)``.

        ``combine_fn`` (optional, the paper's ``combine``) pre-reduces each
        mapper-local bucket *on the mapper's node* before it travels —
        shrinking shuffle bytes exactly like Hadoop's combiner.  ``dtype``
        (a NumPy or a torch dtype) pins the value dtype of buckets that
        receive no data at all.
        """
        wf = self.wf
        # world size comes from the executor (the authority on how many
        # ranks exist), falling back to the workflow's declared size — not
        # from max(mapped)+1, which miscounts sparse rank dicts (mappers on
        # ranks {0, 5} must still spread reducers over the whole machine).
        executor = wf._executor
        n_nodes = executor.n_nodes if executor is not None else wf.n_nodes
        if owner is None:
            owner = lambda b: b * n_nodes // n_buckets  # contiguous ranges

        # 1. bucket extraction on the mapper's node
        pieces: dict[int, list] = {b: [] for b in range(n_buckets)}
        for rank, (keys, vals) in self.mapped.items():
            for b in range(n_buckets):
                with bind.node(rank):
                    piece = wf.apply(
                        _extract_bucket, (keys, vals, b, b + 1),
                        name=f"extract[{b}]",
                    )
                    if combine_fn is not None:
                        piece = wf.apply(combine_fn, (piece,), name="combine")
                pieces[b].append(piece)

        # 2. implicit shuffle + reduce: placing the reduce op on owner(b)
        #    makes the runtime move every piece there (tree-shipped when a
        #    piece has >1 consumer; plain p2p otherwise).
        buckets = {}
        for b in range(n_buckets):
            with bind.node(owner(b)):
                buckets[b] = wf.apply(
                    _reduce_bucket, (reduce_fn, b, dtype, *pieces[b]),
                    name=f"reduce[{b}]",
                )
        return Reduced(wf, buckets)


class Reduced:
    def __init__(self, wf: bind.Workflow, buckets: dict[int, bind.BindArray]):
        self.wf = wf
        self.buckets = buckets

    def collect(self):
        """Gather buckets in key order (implies sync): a host array for NumPy
        buckets, a tensor on the buckets' device for tensor ones."""
        outs = [self.wf.fetch(self.buckets[b]) for b in sorted(self.buckets)]
        if outs and all(isinstance(o, torch.Tensor) for o in outs):
            filled = [o for o in outs if o.numel()]
            if filled:
                return torch.cat(filled)
            return torch.empty(0, dtype=outs[0].dtype, device=outs[0].device)
        outs = [np.asarray(o) for o in outs]
        filled = [o for o in outs if o.size]
        if filled:
            return np.concatenate(filled)
        # keep the reducers' dtype even when every bucket came back empty
        return np.empty(0, dtype=outs[0].dtype) if outs else np.empty(0)
