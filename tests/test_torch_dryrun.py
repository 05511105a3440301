"""The dry run (:mod:`repro_torch.launch.dryrun`), the production mesh and
the ``meta`` paths under it, held to the reference's dry run.

The reference's half runs once, in a subprocess
(``tests/_dryrun_reference.py``: ``repro.launch.dryrun`` sets ``XLA_FLAGS``
to 512 fake devices on import), started when the module's first test
sets up and read by the tests that compare with it, which come last:

* ``parse_collective_bytes`` on ``tests/test_dryrun_tools.py``'s HLO and
  more lines (async ``-start`` / ``-done``, tuple shapes, iota and
  explicit ``replica_groups``, none);
* ``SHAPES``, ``cells_for`` and ``long500k_eligible`` for all ten
  configurations;
* one device's parameter and AdamW-state bytes on both production meshes
  at published size, summed from ``NamedSharding.shard_shape`` (no
  compile), against the shards the port places on ``meta`` ranks;
* the ``meter=True`` step's ``cost_analysis()["flops"]`` of reduced
  cells on one device, against the port's metered FLOPs of the same
  cells, which count matrix products only (XLA also counts element-wise
  work): within [0.90, 1.00].

On the port's side alone: the meta dry run's metered FLOPs, copies and
resident bytes equal the same step run on CPU ranks (what ``chip_smoke.py``'s
``[dryrun]`` holds on the card); copies are the closed forms of
:mod:`repro_torch.launch.meter_gradsync`; the kernels' entry points on
``meta`` return their shapes and count their operations; a ``meter=True``
model calls no kernel entry point and a default one does; the MoE's
``aux`` keeps its values with the count that runs on ``meta``; the CLI
writes a cell.  Every model is a reduced configuration except the
placement checks, which are at published size on ``meta``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.core.spmd import make_mesh
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.meter_gradsync import (fsdp_expected_copies,
                                               serving_expected_copies)
from repro_torch.models import LanguageModel, blocks, moe
from repro_torch.optim import AdamW
from repro_torch.sharding import make_policy
from repro_torch.sharding.placement import place_model, unplace

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

# tests/test_dryrun_tools.py's HLO, and lines it does not have
HLO = """
HloModule test
ENTRY main {
  %p = bf16[16,256]{1,0} parameter(0)
  %ag = bf16[256,256]{1,0} all-gather(%p), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = f32[1024]{0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %rs = f32[64]{0} reduce-scatter(%y), replica_groups=[1,16]<=[16], dimensions={0}
  %a2a = bf16[8,32]{1,0} all-to-all(%z), replica_groups=[2,8]<=[16]
  %cp = f32[128]{0} collective-permute(%w), source_target_pairs={{0,1}}
  %done = f32[1024]{0} all-reduce-done(%ar2)
}
"""
HLO_CASES = {
    "test_dryrun_tools": HLO,
    "async": """
  %ags = (bf16[16,256]{1,0}, bf16[256,256]{1,0}) all-gather-start(%p), replica_groups=[16,16]<=[256], dimensions={0}
  %agd = bf16[256,256]{1,0} all-gather-done(%ags)
  %ars = f32[4096]{0} all-reduce-start(%x), replica_groups={{0,1},{2,3}}, to_apply=%add
  ROOT %ard = f32[4096]{0} all-reduce-done(%ars)
  %cps = (f32[64]{0}, f32[64]{0}, u32[], u32[]) collective-permute-start(%w), source_target_pairs={{0,1},{1,0}}
  %cpd = f32[64]{0} collective-permute-done(%cps)
""",
    "tuples_and_groups": """
  %t = (f32[128,4]{1,0}, bf16[64]{0}) all-reduce(%a, %b), replica_groups=[32,8]<=[256], to_apply=%add
  %e = s8[1024]{0} all-to-all(%c), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %n = f16[2,3,4]{2,1,0} all-gather(%d), dimensions={0}
  %u = pred[16]{0} reduce-scatter(%f), replica_groups={{0,1},{2,3}}, dimensions={0}
""",
    "no_collective": """
  %x = f32[8]{0} add(%a, %b)
  %y = f32[8]{0} custom-call(%x), custom_call_target="all-reduce"
""",
}
REDUCED = ("gemma_7b", "granite_moe_3b_a800m", "recurrentgemma_9b")
KINDS = ("train", "prefill", "decode")
METER_CELLS = [(a, k, 128, 2) for a in REDUCED for k in KINDS]
PLACED = [(a, m) for a in ("gemma_7b", "granite_moe_3b_a800m",
                           "seamless_m4t_medium", "recurrentgemma_9b")
          for m in ("single", "multi")]
# (B, S) of the small cells on (2, 2) ranks
SMALL = (2, 32)


class _Reference:
    """The reference's half, running in a subprocess from construction;
    :meth:`result` waits for it."""

    def __init__(self, tmp_path):
        self.out = tmp_path / "dryrun_reference.json"
        request = {"parse": list(HLO_CASES.values()), "shapes": True,
                   "shards": PLACED, "meter": METER_CELLS}
        # the reduced cells are tiny: a few threads keep the run from
        # crowding the suite's other workers
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_cpu_multi_thread_eigen=false",
                   OMP_NUM_THREADS="2")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_dryrun_reference.py"),
             str(self.out)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)
        self.proc.stdin.write(json.dumps(request))
        self.proc.stdin.close()
        self._got = None

    def result(self) -> dict:
        if self._got is None:
            try:
                self.proc.wait(timeout=600)
            finally:
                if self.proc.poll() is None:
                    self.proc.kill()
                    self.proc.wait()
            err = self.proc.stderr.read()
            self.proc.stdout.close()
            self.proc.stderr.close()
            assert self.proc.returncode == 0, err[-4000:]
            self._got = json.loads(self.out.read_text())
        return self._got


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Meta ops are host work and the CPU runs' ops are tiny: one
    intra-op thread a worker keeps them from contending with the suite's
    other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("dryrun"))
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.wait()


def _meta_mesh(shape=(2, 2)):
    return make_mesh(shape, ("data", "model"), ["meta"] * (shape[0]
                                                           * shape[1]))


# ---------------------------------------------------------------------------
# the production mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi, shape, axes", [
    (False, {"data": 16, "model": 16}, ("data", "model")),
    (True, {"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model")),
])
def test_production_mesh_has_the_references_shape_on_meta_ranks(multi, shape,
                                                                axes):
    mesh = make_production_mesh(multi_pod=multi)
    assert mesh.axis_names == axes and mesh.shape == shape
    assert mesh.size == (512 if multi else 256)
    assert {d.type for d in mesh.rank_devices} == {"meta"}
    # a value placed on it allocates nothing
    policy = make_policy(mesh)
    x = policy.param_sharding((4096, 512)).place(
        torch.empty(4096, 512, device="meta"))
    assert all(t.is_meta for t in x.shards)
    assert mesh.copies == 0 and mesh.splits == mesh.size


def test_production_mesh_takes_the_callers_device():
    mesh = make_production_mesh(device="cpu")
    assert mesh.size == 256 and set(mesh.rank_devices) == {
        torch.device("cpu")}


def test_production_mesh_on_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh(device="cuda")


# ---------------------------------------------------------------------------
# the kernels' entry points on meta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal, window", [(True, None), (True, 48),
                                            (False, None)])
def test_meta_attention_returns_shapes_and_counts_its_operations(causal,
                                                                 window):
    b, hq, hkv, s, d = 2, 8, 2, 128, 64
    q = torch.empty(b, hq, s, d, device="meta", requires_grad=True)
    k, v = (torch.empty(b, hkv, s, d, device="meta", requires_grad=True)
            for _ in range(2))
    fa_ops.flash_attention.meta_flops = 0
    fa_ops.flash_attention_bwd.meta_flops = 0
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 bkv=s)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    out.sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    seen = fa_ops.ref.mask(s, s, causal=causal, window=window,
                           device="cpu")
    pairs = int(seen.sum())
    assert fa_ops.visible_pairs(s, s, causal=causal, window=window) == pairs
    assert fa_ops.flash_attention.meta_flops == 4 * b * hq * d * pairs
    assert fa_ops.flash_attention_bwd.meta_flops == 10 * b * hq * d * pairs
    assert fa_ops.flash_attention.launches == 0


def test_meta_gemm_and_scan_return_shapes():
    a = torch.empty(64, 32, dtype=torch.bfloat16, device="meta")
    b = torch.empty(32, 48, dtype=torch.bfloat16, device="meta")
    c = torch.empty(64, 48, dtype=torch.bfloat16, device="meta")
    gemm_ops.matmul.meta_flops = gemm_ops.matmul_accumulate.meta_flops = 0
    out = gemm_ops.matmul(a, b, out_dtype=torch.float32)
    assert out.is_meta and out.shape == (64, 48) and out.dtype == torch.float32
    acc = gemm_ops.matmul_accumulate(c, a, b)
    assert acc.is_meta and acc.dtype == torch.bfloat16
    assert gemm_ops.matmul.meta_flops == 2 * 64 * 48 * 32
    assert gemm_ops.matmul_accumulate.meta_flops == 2 * 64 * 48 * 32
    x = torch.empty(2, 100, 16, device="meta", requires_grad=True)
    y = ls_ops.linear_scan(torch.empty(2, 100, 16, device="meta"), x)
    assert y.is_meta and y.shape == x.shape
    y.sum().backward()
    assert x.grad.shape == x.shape
    assert gemm_ops.matmul.launches == ls_ops.linear_scan.launches == 0


# ---------------------------------------------------------------------------
# meter mode, the MoE's count
# ---------------------------------------------------------------------------

def _entry_calls(monkeypatch) -> dict:
    """Count calls of the attention and scan kernels' inner entry points
    (on the CPU they compute the plain versions)."""
    calls = {"attention": 0, "scan": 0}
    attend, scan = fa_ops._attend, ls_ops._scan

    def counting_attend(*args, **kw):
        calls["attention"] += 1
        return attend(*args, **kw)

    def counting_scan(*args, **kw):
        calls["scan"] += 1
        return scan(*args, **kw)

    monkeypatch.setattr(fa_ops, "_attend", counting_attend)
    monkeypatch.setattr(ls_ops, "_scan", counting_scan)
    return calls


@pytest.mark.parametrize("meter", [False, True])
def test_meter_mode_calls_no_kernel_and_the_default_does(meter, monkeypatch):
    """A ``meter=True`` model's train step, prefill and decode call no
    kernel entry point (on the CPU, where they would compute the plain
    versions); a default model's call both, as on the card."""
    calls = _entry_calls(monkeypatch)
    cfg = configs.get("recurrentgemma_9b").reduced()
    for kind in KINDS:
        dryrun.trace_step(cfg, kind, 32, 2, make_mesh(
            (1, 1), ("data", "model"), ["cpu"]), meter=meter)
    if meter:
        assert calls == {"attention": 0, "scan": 0}
    else:
        assert calls["attention"] > 0 and calls["scan"] > 0


def test_moe_aux_keeps_its_values_with_a_count_meta_runs():
    """``_route``'s expert counts (``scatter_add_`` of ones, which runs on
    ``meta``) give the ``aux`` that ``torch.bincount``'s counts give."""
    cfg = configs.get("granite_moe_3b_a800m").reduced()
    gen = torch.Generator().manual_seed(3)
    p = {"router": torch.randn(cfg.d_model, cfg.n_experts, generator=gen)}
    x = torch.randn(96, cfg.d_model, generator=gen)
    top_i, _, aux = moe._route(p, x, cfg)
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    frac = torch.bincount(top_i.reshape(-1), minlength=cfg.n_experts
                          ).float() / (x.shape[0] * cfg.n_experts_active)
    assert torch.equal(aux, cfg.n_experts * torch.sum(frac * probs.mean(0)))
    meta = moe._route({"router": p["router"].to("meta")}, x.to("meta"), cfg)
    assert meta[2].is_meta and meta[2].shape == ()


# ---------------------------------------------------------------------------
# the meta dry run against the same step on CPU ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", REDUCED)
@pytest.mark.parametrize("kind", KINDS)
def test_meta_step_counts_what_the_same_step_on_cpu_ranks_counts(arch, kind):
    """On (2, 2) ranks: the metered FLOPs, the copies and cut blocks and
    each rank's resident bytes of the meta dry run equal the same step
    run on CPU ranks (values drawn from a seed), and the copies are the
    closed forms of ``meter_gradsync``."""
    cfg = configs.get(arch).reduced()
    b, s = SMALL
    got = {}
    for dev in ("meta", "cpu"):
        for meter in (False, True):
            mesh = make_mesh((2, 2), ("data", "model"), [dev] * 4)
            got[dev, meter] = dryrun.trace_step(cfg, kind, s, b, mesh,
                                                meter=meter)
    keys = ("copies", "bytes_copied", "splits", "bytes_split", "rank_bytes",
            "argument_size_in_bytes", "output_size_in_bytes")
    for meter in (False, True):
        meta, cpu = got["meta", meter], got["cpu", meter]
        assert {k: meta[k] for k in keys} == {k: cpu[k] for k in keys}
    assert got["meta", True]["flops"] == got["cpu", True]["flops"] > 0
    model = LanguageModel(cfg, device="meta")
    policy = make_policy(_meta_mesh(), batch_sharded=True,
                         seq_sharded=kind != "decode")
    if kind == "train":
        want = fsdp_expected_copies(model, policy, tokens=b * s)
    else:
        want = serving_expected_copies(model, policy, decode=kind == "decode",
                                       tokens=b if kind == "decode"
                                       else b * s)
    meta = got["meta", False]
    assert (meta["copies"], meta["bytes_copied"]) == want


@pytest.mark.parametrize("arch, kind, periods", [
    ("gemma_7b", "train", 4), ("recurrentgemma_9b", "prefill", 3)])
def test_counts_by_depth_are_the_full_depth_counts(arch, kind, periods):
    """``trace_by_depth`` (traces at one and two periods of the block
    pattern, extended in a line) gives every count of the full-depth
    trace, production and metered, on (2, 2) meta ranks; a model with an
    encoder is refused."""
    base = configs.get(arch).reduced()
    cfg = dataclasses.replace(base,
                              n_layers=periods * len(base.block_pattern))
    b, s = SMALL
    for meter in (False, True):
        full = dryrun.trace_step(cfg, kind, s, b, _meta_mesh(), meter=meter)
        line = dryrun.trace_by_depth(cfg, kind, s, b, _meta_mesh,
                                     meter=meter)
        assert {k: line[k] for k in dryrun._AFFINE} == {
            k: full[k] for k in dryrun._AFFINE}
        assert full["flops"] > 0 and full["copies"] > 0
    with pytest.raises(ValueError, match="periods"):
        dryrun.trace_by_depth(configs.get("seamless_m4t_medium").reduced(),
                              kind, s, b, _meta_mesh)


def test_slstm_recurrence_is_counted_step_by_step(monkeypatch):
    """The sLSTM's per-token recurrent products are ops the FLOP counter
    sees (the reference adds them analytically): every step of xLSTM's
    metered prefill is counted inside the step's total, and the count is
    the CPU run's."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import xlstm

    cfg = configs.get("xlstm_350m").reduced()
    s = 16
    steps = {"n": 0, "flops": 0}
    step = xlstm._slstm_step

    def counted(*args, **kw):
        with FlopCounterMode(display=False) as inner:
            out = step(*args, **kw)
        steps["n"] += 1
        steps["flops"] += inner.get_total_flops()
        return out

    monkeypatch.setattr(xlstm, "_slstm_step", counted)
    total = {dev: dryrun.trace_step(cfg, "prefill", s, 1, make_mesh(
        (1, 1), ("data", "model"), [dev]), meter=True)["flops"]
        for dev in ("meta", "cpu")}
    n_slstm = sum(k == "slstm" for k in cfg.block_pattern) * cfg.n_groups
    assert n_slstm > 0 and steps["n"] == 2 * s * n_slstm
    assert steps["flops"] > 0
    assert total["meta"] == total["cpu"] >= steps["flops"] // 2


def test_meta_attention_operations_are_the_closed_form_per_call(monkeypatch):
    """The production step's attention operations on ``meta`` are the
    closed form of one call times the calls the same step makes on CPU
    ranks: 4 a layer forward (again in the recompute), 10 in the
    backward."""
    calls = {"fwd": 0, "bwd": 0}
    attend, bwd = fa_ops._attend, fa_ops.ref.attention_grad

    def counting(*args, **kw):
        calls["fwd"] += 1
        return attend(*args, **kw)

    def counting_bwd(*args, **kw):
        calls["bwd"] += 1
        return bwd(*args, **kw)

    cfg = dataclasses.replace(configs.get("h2o_danube_1_8b").reduced(),
                              dtype="float32")
    b, s = SMALL
    meta = dryrun.trace_step(cfg, "train", s, b, _meta_mesh())
    monkeypatch.setattr(fa_ops, "_attend", counting)
    # float32 on the CPU: the backward's plain version is attention_grad
    monkeypatch.setattr(fa_ops.ref, "attention_grad", counting_bwd)
    dryrun.trace_step(cfg, "train", s, b, make_mesh((2, 2), ("data", "model"),
                                                    ["cpu"] * 4))
    q = torch.empty(b, cfg.n_heads, s, cfg.head_dim_, device="meta")
    (kind,) = set(cfg.block_pattern)
    one = fa_ops.attention_flops(q, q, causal=True,
                                 window=blocks._window_of(kind, cfg))
    assert calls["fwd"] == 2 * cfg.n_layers and calls["bwd"] == cfg.n_layers
    assert meta["kernel_flops"]["flash_attention"] == one * calls["fwd"]
    assert meta["kernel_flops"]["flash_attention_bwd"] == (
        one // 4 * 10 * calls["bwd"])


def test_cli_writes_a_cell_and_skips_it_after(tmp_path, capsys):
    argv = ["--arch", "xlstm_350m", "--shape", "decode_32k", "--mesh",
            "single", "--out-dir", str(tmp_path)]
    assert dryrun.main(argv) == 0
    cell = json.loads((tmp_path / "single_xlstm_350m_decode_32k.json"
                       ).read_text())
    assert cell["ok"] and cell["ranks"] == 256 and cell["kind"] == "decode"
    assert cell["not_counted"] == list(dryrun.NOT_COUNTED)
    # per device: the global count over the ranks; collectives: copies
    assert cell["flops_per_device"] == cell["meter_flops"] / 256 > 0
    assert cell["collectives"]["wire_model"] is False
    assert cell["production"]["argument_size_in_bytes"] > cell[
        "production"]["rank_bytes"] > 0
    assert dryrun.main(argv) == 0
    assert "skipping" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# against the reference's dry run
# ---------------------------------------------------------------------------

_META_MODELS: dict = {}


@pytest.mark.parametrize("arch, mesh_kind", PLACED)
def test_rank_bytes_match_the_references_shard_shapes(arch, mesh_kind,
                                                      reference):
    """One rank's parameter bytes and AdamW-state bytes (float32 master
    and moments) of the full-size model placed on the production mesh's
    ``meta`` ranks equal the reference's ``shard_shape`` sums.  One meta
    model an architecture, placed on the single-pod mesh, then given its
    whole parameters back and placed on the multi-pod one; the state of
    :meth:`AdamW.init` is read on the single-pod mesh, where its shards
    are those of the parameters in float32 (which the multi-pod case
    counts)."""
    model = _META_MODELS.get(arch)
    if model is None:
        model = _META_MODELS[arch] = LanguageModel(configs.get(arch),
                                                   device="meta")
    if model.placement is not None:
        unplace(model)
    placement = place_model(model, make_policy(make_production_mesh(
        multi_pod=mesh_kind == "multi")))
    if mesh_kind == "single":
        state = AdamW(learning_rate=1e-4).init(model)
        shards = [t.shards[0] for tree in (state.master, state.m, state.v)
                  for t in tree.values()]
        assert all(t.dtype == torch.float32 for t in shards)
        state_bytes = sum(t.numel() * 4 for t in shards)
    else:
        state_bytes = 12 * sum(v.shards[0].numel()
                               for v in placement.params.values())
    want = reference.result()["shards"][PLACED.index((arch, mesh_kind))]
    assert placement.rank_bytes()[0] == want["params"]
    assert state_bytes == want["state"]
    if arch == "gemma_7b":
        assert want["params"] == 67_049_472


@pytest.mark.parametrize("name", list(HLO_CASES))
def test_parse_collective_bytes_matches_the_references(name, reference):
    got = dryrun.parse_collective_bytes(HLO_CASES[name])
    assert got == reference.result()["parse"][list(HLO_CASES).index(name)]


@pytest.mark.parametrize("name", configs.all_names())
def test_shapes_and_cells_match_the_references(name, reference):
    want = reference.result()["shapes"]
    assert {k: list(v) for k, v in dryrun.SHAPES.items()} == want["SHAPES"]
    cfg = configs.get(name)
    assert dryrun.cells_for(cfg) == want["cells"][name]
    assert dryrun.long500k_eligible(cfg) == want["long500k"][name]


@pytest.mark.parametrize("cell", METER_CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_metered_flops_lie_near_the_references_cost_analysis(cell, reference):
    """The port counts matrix products only; XLA's cost analysis also
    counts element-wise work, so the port's metered FLOPs lie a few per
    cent under the reference's on these reduced cells (0.93-0.98)."""
    arch, kind, s, b = cell
    got = dryrun.trace_step(configs.get(arch).reduced(), kind, s, b,
                            _meta_mesh((1, 1)), meter=True, remat=False)
    want = reference.result()["meter"][METER_CELLS.index(cell)]
    assert 0.90 <= got["flops"] / want <= 1.00
