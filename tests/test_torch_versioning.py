"""``VersionStore`` and ``process_local_cache`` against the reference's.

Both stores are driven through the same random sequence of puts, reads,
readers added and released and pins, drawn from a seed, on versions of a
few refs; after every step the two agree on which versions they hold,
``peak_live`` and ``live_bytes`` (a NumPy payload counted by ``nbytes`` in
both; the port's tensor payload by ``numel × element_size``, the
reference's jax array of the same values by ``nbytes``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executable_cache as ref_cache
from repro.core import versioning as ref_versioning
from repro_torch import core as bind
from repro_torch.core import executable_cache, versioning


def _payloads(rng, i: int):
    """A payload for both stores: NumPy for both, or a tensor for the port
    and a jax array of the same values for the reference."""
    shape = tuple(int(n) for n in rng.integers(1, 9, size=rng.integers(1, 3)))
    dtype = [np.float32, np.float64, np.int32, np.float16][i % 4]
    x = rng.normal(size=shape).astype(dtype)
    # jax keeps float64 only with 64-bit types on: a NumPy payload then
    if rng.random() < 0.5 or dtype == np.float64:
        return x, x
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("seed", range(6))
def test_version_store_holds_parity_with_the_references(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = versioning.VersionStore(), ref_versioning.VersionStore()
    refs = [(versioning.Ref(f"r{i}"), ref_versioning.Ref(f"r{i}"))
            for i in range(4)]
    # ref ids come from process-wide counters, which other tests in the
    # same process advance: the two keys agree up to each side's first id
    base = (refs[0][0].ref_id, refs[0][1].ref_id)
    seen = []                      # (port version, reference version)
    for step in range(200):
        op = rng.choice(["put", "get", "reader", "release", "pin", "new"],
                        p=[0.3, 0.15, 0.2, 0.2, 0.05, 0.1])
        if op == "new" or not seen:
            p_ref, r_ref = refs[rng.integers(len(refs))]
            seen.append((p_ref.new_version(step), r_ref.new_version(step)))
            continue
        pv, rv = seen[rng.integers(len(seen))]
        assert (pv.ref_id - base[0], pv.index) == (rv.ref_id - base[1],
                                                    rv.index)
        if op == "put":
            a, b = _payloads(rng, step)
            ours.put(pv, a)
            theirs.put(rv, b)
        elif op == "get":
            assert ours.has(pv) == theirs.has(rv)
            if ours.has(pv):
                np.testing.assert_array_equal(np.asarray(ours.get(pv)),
                                              np.asarray(theirs.get(rv)))
        elif op == "reader":
            n = int(rng.integers(1, 3))
            ours.add_reader(pv, n)
            theirs.add_reader(rv, n)
        elif op == "release":
            ours.release_reader(pv)
            theirs.release_reader(rv)
        else:
            ours.pin(pv)
            theirs.pin(rv)
        assert [ours.has(p) for p, _ in seen] == [theirs.has(r)
                                                   for _, r in seen]
        assert ours.peak_live == theirs.peak_live
        assert ours.live_bytes == theirs.live_bytes
    assert ours.peak_live > 0


def test_live_bytes_counts_tensors_and_arrays():
    store = bind.VersionStore()
    ref = versioning.Ref("x")
    a, b, c = (ref.new_version(i) for i in range(3))
    store.put(a, torch.zeros(3, 5, dtype=torch.bfloat16))
    store.put(b, np.zeros(7, dtype=np.float64))
    store.put(c, "not an array")
    assert store.live_bytes == 3 * 5 * 2 + 7 * 8
    store.put(a, torch.zeros(4, 4, device="meta"))    # no storage, 64 bytes
    assert store.live_bytes == 64 + 56


def test_process_local_cache_is_the_process_wide_cache():
    assert executable_cache.process_local_cache() is \
        executable_cache.EXEC_CACHE
    assert ref_cache.process_local_cache() is ref_cache.EXEC_CACHE
    assert "VersionStore" in bind.__all__
