"""The port's MapReduce engine against the reference (paper §IV-B).

Every case of ``tests/test_mapreduce.py`` runs on the same NumPy input
through ``repro.mapreduce`` and ``repro_torch.mapreduce``.  NumPy
partitions take NumPy's steps in both, so the outputs are bitwise equal
with the same dtype, and the executors' accounting (ops, messages, bytes,
the transfer stream with its rounds) is identical.  The same cases then
run on CPU tensors in the port: the values equal the reference's on the
NumPy copy, int64, and a tensor comes back (the deliberate divergence:
the reference always returns a host array).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import core as ref_bind
from repro.mapreduce import KVPairs as RefKVPairs
from repro.mapreduce import sort_integers as ref_sort
from repro_torch import core as port_bind
from repro_torch.mapreduce import KVPairs as PortKVPairs
from repro_torch.mapreduce import sort_integers as port_sort

KINDS = ["numpy", "tensor"]


def _port_input(vals, kind):
    return vals.copy() if kind == "numpy" else torch.from_numpy(vals.copy())


def _stats(st):
    return (st.ops_executed, st.message_count, st.bytes_transferred,
            st.wavefronts, st.peak_live_bytes,
            [(t.version_key, t.src, t.dst, t.nbytes, t.round_id,
              t.collective, t.wavefront) for t in st.transfers])


def _same(got, exp, kind):
    """``got`` (the port's) against ``exp`` (the reference's host array)."""
    if kind == "tensor":
        assert isinstance(got, torch.Tensor)
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        got = got.numpy()
    else:
        assert isinstance(got, np.ndarray)
    assert got.dtype == exp.dtype
    np.testing.assert_array_equal(got, exp)


def _sort(v):
    return torch.sort(v).values if isinstance(v, torch.Tensor) else np.sort(v)


def _unique(v):
    return torch.unique(v) if isinstance(v, torch.Tensor) else np.unique(v)


def _keys(v, shift):
    keys = v >> shift
    return (keys.to(torch.int64) if isinstance(keys, torch.Tensor)
            else keys.astype(np.int64)), v


def _both_sorts(vals, kind, **kw):
    exp, ref_st = ref_sort(vals, **kw)
    got, port_st = port_sort(_port_input(vals, kind), **kw)
    _same(got, exp, kind)
    assert _stats(port_st) == _stats(ref_st)
    return exp, port_st


@pytest.mark.parametrize("kind", KINDS)
def test_sort_small(kind, rng):
    vals = rng.integers(0, 2**31 - 1, size=10_000, dtype=np.int64)
    exp, st = _both_sorts(vals, kind, n_nodes=4, log_bins=3)
    np.testing.assert_array_equal(exp, np.sort(vals))
    assert st.ops_executed > 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_nodes", [1, 2, 8])
def test_sort_node_counts(n_nodes, kind, rng):
    vals = rng.integers(0, 2**31 - 1, size=5_000, dtype=np.int64)
    exp, _ = _both_sorts(vals, kind, n_nodes=n_nodes)
    np.testing.assert_array_equal(exp, np.sort(vals))


@pytest.mark.parametrize("backend", ["serial", "threads", "fused"])
def test_sort_backends(backend, rng):
    """Every backend the port has, on both payload kinds."""
    vals = rng.integers(0, 2**31 - 1, size=3_000, dtype=np.int64)
    for kind in KINDS:
        _both_sorts(vals, kind, n_nodes=4, backend=backend)


@given(
    n=st.integers(0, 2_000),
    n_nodes=st.integers(1, 6),
    log_bins=st.integers(1, 6),
    seed=st.integers(0, 2**16),
)
@settings(max_examples=20, deadline=None)
def test_sort_property(n, n_nodes, log_bins, seed):
    """Sorted output is a permutation of the input for any sizing, and the
    port's is the reference's on either payload kind."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2**31 - 1, size=n, dtype=np.int64)
    for kind in KINDS:
        exp, _ = _both_sorts(vals, kind, n_nodes=n_nodes, log_bins=log_bins)
        np.testing.assert_array_equal(exp, np.sort(vals))


@pytest.mark.parametrize("kind", KINDS)
def test_shuffle_is_implicit_and_distributed(kind, rng):
    vals = rng.integers(0, 2**31 - 1, size=8_000, dtype=np.int64)
    ref_ex = ref_bind.LocalExecutor(4, collective_mode="tree")
    exp, ref_st = ref_sort(vals, n_nodes=4, log_bins=2, executor=ref_ex)
    port_ex = port_bind.LocalExecutor(4, collective_mode="tree")
    got, st = port_sort(_port_input(vals, kind), n_nodes=4, log_bins=2,
                        executor=port_ex)
    _same(got, exp, kind)
    assert _stats(st) == _stats(ref_st)
    cross = [t for t in st.transfers if t.src != t.dst]
    assert len(cross) > 0
    assert st.bytes_transferred >= vals.nbytes // 2


def _world_size_run(bind, kv, vals, kind):
    ex = bind.LocalExecutor(4)
    with bind.Workflow(executor=ex) as wf:
        parts = (np.array_split(vals, 4) if kind == "numpy"
                 else torch.tensor_split(torch.from_numpy(vals), 4))
        res = kv.from_arrays(wf, parts).map(lambda v: _keys(v, 29)).reduce(
            lambda _b, v: _sort(v), n_buckets=4,
            dtype=vals.dtype if kind == "numpy" else torch.int64)
        ranks = {op.placement for op in wf.ops
                 if op.name.startswith("reduce[")}
        out = res.collect()
    return out, ranks, ex.stats


@pytest.mark.parametrize("kind", KINDS)
def test_reduce_world_size_comes_from_executor(kind, rng):
    vals = rng.integers(0, 2**31 - 1, size=4_000, dtype=np.int64)
    exp, ref_ranks, ref_st = _world_size_run(ref_bind, RefKVPairs, vals,
                                             "numpy")
    got, ranks, st = _world_size_run(port_bind, PortKVPairs, vals, kind)
    _same(got, exp, kind)
    np.testing.assert_array_equal(exp, np.sort(vals))
    assert ranks == ref_ranks == {0, 1, 2, 3}
    assert _stats(st) == _stats(ref_st)


def _empty_buckets_run(bind, kv, vals, kind):
    ex = bind.LocalExecutor(2)
    with bind.Workflow(executor=ex) as wf:
        parts = (np.array_split(vals, 2) if kind == "numpy"
                 else torch.tensor_split(torch.from_numpy(vals), 2))
        zeros = (np.zeros_like if kind == "numpy" else torch.zeros_like)
        res = kv.from_arrays(wf, parts).map(lambda v: (zeros(v), v)).reduce(
            lambda _b, v: _sort(v), n_buckets=4,
            dtype=vals.dtype if kind == "numpy" else torch.int64)
        fetched = {b: wf.fetch(arr) for b, arr in res.buckets.items()}
        out = res.collect()
    return out, fetched


@pytest.mark.parametrize("kind", KINDS)
def test_empty_buckets_keep_dtype(kind):
    vals = np.arange(32, dtype=np.int64)          # all keys land in bucket 0
    exp, ref_fetched = _empty_buckets_run(ref_bind, RefKVPairs, vals, "numpy")
    got, fetched = _empty_buckets_run(port_bind, PortKVPairs, vals, kind)
    for b, arr in fetched.items():
        _same(arr, np.asarray(ref_fetched[b]), kind)
        assert (arr.dtype == np.int64 if kind == "numpy"
                else arr.dtype == torch.int64), (b, arr.dtype)
    _same(got, exp, kind)
    np.testing.assert_array_equal(exp, vals)


def test_empty_bucket_without_mappers_keeps_torch_dtype():
    """A reduce with no mapper at all: ``dtype`` alone fixes the bucket,
    a torch dtype giving an empty tensor of it."""
    from repro_torch.mapreduce.engine import _reduce_bucket

    out = _reduce_bucket(lambda _b, v: v, 0, torch.int32)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int32
    assert out.numel() == 0
    out = _reduce_bucket(lambda _b, v: v, 0, np.int32)
    assert isinstance(out, np.ndarray) and out.dtype == np.int32


def _combiner_run(bind, kv, vals, kind, combine):
    ex = bind.LocalExecutor(4)
    with bind.Workflow(n_nodes=4, executor=ex) as wf:
        parts = (np.array_split(vals, 4) if kind == "numpy"
                 else torch.tensor_split(torch.from_numpy(vals), 4))
        res = kv.from_arrays(wf, parts).map(lambda v: _keys(v, 4)).reduce(
            lambda _b, v: _unique(v), n_buckets=4,
            combine_fn=_unique if combine else None)
        out = res.collect()
    return out, ex.stats


@pytest.mark.parametrize("kind", KINDS)
def test_combiner_reduces_shuffle_bytes(kind, rng):
    vals = rng.integers(0, 64, size=20_000, dtype=np.int64)  # heavy duplication
    runs = {}
    for combine in (False, True):
        exp, ref_st = _combiner_run(ref_bind, RefKVPairs, vals, "numpy",
                                    combine)
        got, st = _combiner_run(port_bind, PortKVPairs, vals, kind, combine)
        _same(got, exp, kind)
        np.testing.assert_array_equal(exp, np.unique(vals))
        assert _stats(st) == _stats(ref_st)
        runs[combine] = st.bytes_transferred
    assert runs[True] < runs[False] / 10  # 20k rows -> ≤64 uniques per piece
