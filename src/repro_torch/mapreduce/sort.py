"""Integer sorting with MapReduce (paper Listing 2 + Fig. 5/6).

map: bucket = v >> (31 - LOG_BINS)   (radix prefix of a uniform 31-bit int)
reduce: per-bucket std::sort → globally sorted concatenation.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import core as bind
from .engine import KVPairs


def sort_integers(
    values,
    n_nodes: int,
    log_bins: int | None = None,
    executor: bind.LocalExecutor | None = None,
    backend: str = "serial",
) -> tuple:
    """Sort ``values`` (int32/int64 ≥ 0) across ``n_nodes`` simulated nodes.

    ``values`` is a NumPy array (sorted with NumPy on the host, bit for bit
    the reference) or a tensor (sorted with torch on its device; the result
    is a tensor there).  ``backend`` selects the execution backend
    (``"serial"`` | ``"threads"`` | ``"fused"``) when no ``executor`` is
    supplied.  Returns (sorted array, execution stats of the whole workflow
    — shuffle bytes, rounds, wavefronts — for the Fig. 5/6 scaling
    benchmark).
    """
    if log_bins is None:
        log_bins = max(1, int(np.ceil(np.log2(max(n_nodes, 2)))))
    n_bins = 1 << log_bins
    shift = 31 - log_bins

    def map_fn(vals):
        if isinstance(vals, torch.Tensor):
            return (vals >> shift).to(torch.int64), vals
        return (vals >> shift).astype(np.int64), vals

    def reduce_fn(_bucket, vals):
        if isinstance(vals, torch.Tensor):
            return torch.sort(vals).values
        return np.sort(vals)

    if isinstance(values, torch.Tensor):
        parts = torch.tensor_split(values, n_nodes)
    else:
        parts = np.array_split(values, n_nodes)
    executor = executor or bind.LocalExecutor(
        n_nodes, collective_mode="tree", backend=backend)
    with bind.Workflow(n_nodes=n_nodes, executor=executor) as wf:
        result = (
            KVPairs.from_arrays(wf, parts)
            .map(map_fn)
            .reduce(reduce_fn, n_buckets=n_bins,
                    owner=lambda b: b * n_nodes // n_bins,
                    dtype=values.dtype)
        )
        out = result.collect()
    return out, executor.stats
