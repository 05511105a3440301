"""The port's tiled linear algebra against the reference (paper §IV-A).

At n=64, ib=16 (a 4x4 tile grid) classical tiled GEMM, Strassen and
Listing 1 run through both packages: with float64 NumPy matrices (the same
NumPy tile bodies on both sides, so values are identical) and with float32
CPU tensors in the port against float32 NumPy in the reference (PyTorch's
and NumPy's products sum in different orders: float32 tolerance); Listing
1 also with float16 (float16 tolerance).  The
executors' accounting must be identical in both cases, and the topology
cost model must price the two transfer streams the same.
"""

import numpy as np
import pytest
import torch

from repro import core as ref_bind
from repro.launch.mesh import make_topology as ref_topology
from repro.linalg import Tiled as RefTiled
from repro.linalg import gemm_strassen as ref_strassen
from repro.linalg.distributed import run_distributed_gemm as ref_run
from repro.linalg.tiles import gemm_tiles as ref_gemm_tiles
from repro_torch import core as port_bind
from repro_torch.compat import to_numpy
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.launch.mesh import make_topology as port_topology
from repro_torch.linalg import Tiled as PortTiled
from repro_torch.linalg import gemm_strassen as port_strassen
from repro_torch.linalg.distributed import owner_rank
from repro_torch.linalg.distributed import run_distributed_gemm as port_run
from repro_torch.linalg.strassen import strassen_flops
from repro_torch.linalg.tiles import gemm_tiles as port_gemm_tiles

N, IB = 64, 16
NT = N // IB


def _inputs(kind):
    """``(reference A, B, port A, B, value tolerance)``."""
    rng = np.random.default_rng(11)
    A, B = rng.normal(size=(N, N)), rng.normal(size=(N, N))
    if kind == "float64-numpy":
        return A, B, A.copy(), B.copy(), None
    if kind == "float16-tensor":
        # each tile product is a float32 sum rounded once to float16 on
        # both sides (bit for bit at this size), but NumPy and the port's
        # GEMM need not sum in one order: one float16 ulp of C's largest
        # values (2^-5 at |x| < 64) is allowed, an eighth of bfloat16's
        A16, B16 = A.astype(np.float16), B.astype(np.float16)
        return (A16, B16, torch.from_numpy(A16), torch.from_numpy(B16),
                (0.0, 2.0 ** -5))
    A32, B32 = A.astype(np.float32), B.astype(np.float32)
    return A32, B32, torch.from_numpy(A32), torch.from_numpy(B32), (1e-5, 1e-4)


def _stats_tuple(st):
    return (st.ops_executed, st.copies_elided, st.wavefronts,
            st.wavefront_flops, st.message_count, st.bytes_transferred,
            st.peak_live_bytes, st.peak_live_payloads,
            [(t.version_key, t.src, t.dst, t.nbytes, t.round_id,
              t.collective, t.wavefront) for t in st.transfers])


def _assert_close(got, exp, tol):
    got = to_numpy(got)
    assert got.dtype == np.asarray(exp).dtype
    if tol is None:
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=tol[0], atol=tol[1])


def _tiled_product(bind, Tiled, algo, A, B):
    ex = bind.LocalExecutor(1)
    with bind.Workflow(executor=ex) as wf:
        ta = Tiled.from_array(wf, A, IB, "A")
        tb = Tiled.from_array(wf, B, IB, "B")
        if isinstance(A, torch.Tensor):
            tc = Tiled.zeros(wf, NT, NT, IB, A.dtype, "C", device=A.device)
        else:
            tc = Tiled.zeros(wf, NT, NT, IB, A.dtype, "C")
        algo(ta, tb, tc)
        out = tc.to_array()
    leaves = sum(1 for op in wf.ops if op.name == "gemm")
    return out, ex.stats, leaves


@pytest.fixture(autouse=True)
def _cpu_never_launches():
    gemm_ops.matmul.launches = gemm_ops.matmul_accumulate.launches = 0
    yield
    assert gemm_ops.matmul.launches == 0
    assert gemm_ops.matmul_accumulate.launches == 0


@pytest.mark.parametrize("kind", ["float64-numpy", "float32-tensor"])
@pytest.mark.parametrize("algo,leaves", [("tiles", NT ** 3),
                                         ("strassen", 7 ** 2)])
def test_tiled_products_match_reference(algo, leaves, kind):
    rA, rB, pA, pB, tol = _inputs(kind)
    ref_algo = ref_gemm_tiles if algo == "tiles" else ref_strassen
    port_algo = port_gemm_tiles if algo == "tiles" else port_strassen
    r_out, r_stats, r_leaves = _tiled_product(ref_bind, RefTiled, ref_algo,
                                              rA, rB)
    p_out, p_stats, p_leaves = _tiled_product(port_bind, PortTiled,
                                              port_algo, pA, pB)
    assert p_leaves == r_leaves == leaves
    _assert_close(p_out, r_out, tol)
    assert _stats_tuple(p_stats) == _stats_tuple(r_stats)
    if isinstance(pA, torch.Tensor):
        assert isinstance(p_out, torch.Tensor) and p_out.dtype == pA.dtype
    else:
        assert isinstance(p_out, np.ndarray)


@pytest.mark.parametrize("collective_mode", ["tree", "naive"])
@pytest.mark.parametrize("kind", ["float64-numpy", "float32-tensor",
                                  "float16-tensor"])
def test_listing1_matches_reference(kind, collective_mode):
    rA, rB, pA, pB, tol = _inputs(kind)
    r_out, r_stats, r_est = ref_run(
        rA, rB, ib=IB, NP=2, NQ=2, collective_mode=collective_mode,
        topology=ref_topology("ring", 4, flops_per_s=1e9))
    p_out, p_stats, p_est = port_run(
        pA, pB, ib=IB, NP=2, NQ=2, device="cpu",
        collective_mode=collective_mode,
        topology=port_topology("ring", 4, flops_per_s=1e9))
    # NumPy input moves to the device as a tensor of its own dtype, and
    # its tiles then multiply in PyTorch, not NumPy: float64 tolerance
    assert isinstance(p_out, torch.Tensor) and p_out.device.type == "cpu"
    _assert_close(p_out, r_out, tol or (1e-12, 1e-12))
    assert _stats_tuple(p_stats) == _stats_tuple(r_stats)
    assert p_stats.message_count > 0
    assert p_est == r_est


def test_tiles_keep_kind_dtype_and_device():
    A = torch.arange(64.0, dtype=torch.float32).reshape(8, 8)
    with port_bind.Workflow() as wf:
        t = PortTiled.from_array(wf, A, 4)
        z = PortTiled.zeros(wf, 2, 2, 4, torch.bfloat16, device="cpu")
        n = PortTiled.zeros(wf, 2, 2, 4, np.float32)
        tile = wf.fetch(t.tile(1, 0))
        assert isinstance(tile, torch.Tensor) and tile.is_contiguous()
        torch.testing.assert_close(tile, A[4:, :4])
        assert wf.fetch(z.tile(0, 1)).dtype == torch.bfloat16
        assert isinstance(wf.fetch(n.tile(0, 0)), np.ndarray)
        assert PortTiled.like(t.subset(0, 0, 1, 1)).device == A.device
        torch.testing.assert_close(t.to_array(), A)
        assert isinstance(n.to_array(), np.ndarray)


def test_strassen_flops_and_owner_rank():
    assert strassen_flops(N, IB) == 7 ** 2 * 2 * IB ** 3
    assert owner_rank(3, 5, 2, 4) == (3 % 2) * 4 + 5 % 4


@pytest.mark.parametrize("kind", ["flat", "ring", "fat-tree"])
def test_topology_matches_reference(kind):
    ref_t, port_t = ref_topology(kind, 8), port_topology(kind, 8)
    for s in range(8):
        for d in range(8):
            assert port_t.hops(s, d) == ref_t.hops(s, d)
            assert port_t.transfer_time(s, d, 4096) == \
                ref_t.transfer_time(s, d, 4096)
    assert port_t.diameter == ref_t.diameter
    samples = [{"flops": 2e9, "seconds": 0.5},
               {"nbytes": 1 << 20, "hops": 1, "seconds": 2e-4},
               {"nbytes": 1 << 24, "hops": 2, "seconds": 2e-3}]
    r, p = ref_t.calibrate(samples), port_t.calibrate(samples)
    assert (p.flops_per_s, p.latency_s, p.bandwidth_Bps) == \
        (r.flops_per_s, r.latency_s, r.bandwidth_Bps)
