"""The trainer on rank meshes, the elastic checkpoint and the Slice 3b
self-tests, against the JAX package.

* ``repro_torch.launch.train --fake-devices 8 --grad-sync tree`` and
  ``hierarchical`` on gemma reduced, and ``--fake-devices 4 --mesh-model
  2`` (a sharding policy: the MoE layers per rank) on moonshot reduced,
  each with ``--cpu`` and the weights the reference's run starts from:
  every ``[train]`` line within 1e-4 of the reference's trainer under the
  same flags (section ``train`` of ``tests/_multidevice_reference.py``,
  one subprocess each, run side by side);
* a crash and resume under ``--fake-devices`` (the manual step) ends with
  the uninterrupted run's loss bit for bit;
* ``selftest_elastic --device cpu`` prints ``OK``, and each package
  restores the other's sharded checkpoint onto 4 ranks bit for bit;
* ``selftest_train_dp`` and ``meter_gradsync`` with ``--device cpu``, and
  the new entry points' refusal of the card's default without one.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from _multidevice_reference import elastic_tree, run

from repro_torch.ckpt import CheckpointManager
from repro_torch.compat import to_torch
from repro_torch.core.spmd import NamedSharding, P, assemble, make_mesh
from repro_torch.launch import meter_gradsync, selftest_elastic
from repro_torch.launch import selftest_train_dp
from repro_torch.launch import train as launch_train
from repro_torch.models import LanguageModel

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
CPU = (torch.device("cpu"),) * 8
RUNS = {
    "tree": ["--arch", "gemma_7b", "--reduced", "--steps", "3",
             "--fake-devices", "8", "--grad-sync", "tree"],
    "hierarchical": ["--arch", "gemma_7b", "--reduced", "--steps", "3",
                     "--fake-devices", "8", "--grad-sync", "hierarchical"],
    "policy": ["--arch", "moonshot_v1_16b_a3b", "--reduced", "--steps", "3",
               "--fake-devices", "4", "--mesh-model", "2"],
}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Each run's reference ``[train]`` lines and starting weights, and the
    elastic section (after the port's sharded checkpoint is written)."""
    root = tmp_path_factory.mktemp("dp_train")
    port_ckpt = CheckpointManager(str(root / "port"), async_save=False)
    mesh8 = make_mesh((8,), ("data",), CPU)
    port_ckpt.save(0, {k: NamedSharding(mesh8, P("data", None)).place(
        to_torch(v, "cpu")) for k, v in elastic_tree().items()})
    for name in RUNS:
        os.makedirs(root / name)
    with ThreadPoolExecutor(len(RUNS) + 1) as pool:
        jobs = {name: pool.submit(run, "train", root / name, *argv)
                for name, argv in RUNS.items()}
        jobs["elastic"] = pool.submit(run, "elastic", root, str(root))
        out = {name: job.result() for name, job in jobs.items()}
    out["root"] = root
    return out


def _lines(text: str) -> list:
    return [json.loads(line[len("[train] "):]) for line in text.splitlines()
            if line.startswith("[train] {")]


def _carry(monkeypatch, params0: dict):
    """The port's trainer starts from the reference's weights."""
    def init(self, generator):
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(torch.from_numpy(params0[name]))
        return self

    monkeypatch.setattr(LanguageModel, "init", init)


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_on_a_rank_mesh_matches_the_references(name, ref,
                                                       monkeypatch):
    want = json.loads(str(ref[name]["lines"]))
    _carry(monkeypatch, {k[len("params0/"):]: v
                         for k, v in ref[name].items()
                         if k.startswith("params0/")})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert launch_train.main([*RUNS[name], "--cpu"]) == 0
    got = _lines(buf.getvalue())
    assert [g["step"] for g in got] == [w["step"] for w in want] == [0, 2]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name} step {w['step']} "
                                               f"{k}")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _train(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=600, env=_env())


def test_crash_and_resume_on_a_rank_mesh(tmp_path):
    """The manual step's placed optimizer state is saved as its global
    arrays and placed again on resume: the same bits as without the
    crash."""
    base = ["--arch", "gemma_7b", "--fake-devices", "4", "--grad-sync",
            "ring", "--reduced", "--steps", "6", "--batch", "4", "--seq",
            "32", "--lr", "1e-3", "--ckpt-every", "2", "--cpu"]
    ck, m1, m2 = (str(tmp_path / n) for n in ("ck", "m1.json", "m2.json"))
    with ThreadPoolExecutor(2) as pool:
        crash = pool.submit(_train, *base, "--ckpt-dir", ck,
                            "--crash-at-step", "5")
        whole = pool.submit(_train, *base, "--metrics-out", m1)
        crash, whole = crash.result(), whole.result()
    assert crash.returncode == 42, crash.stderr
    assert whole.returncode == 0, whole.stderr
    out = _train(*base, "--ckpt-dir", ck, "--metrics-out", m2)
    assert out.returncode == 0, out.stderr
    assert "[train] resumed from step 3" in out.stdout
    with open(m1) as f1, open(m2) as f2:
        assert json.load(f2)["final"] == json.load(f1)["final"]


def test_trainer_on_a_rank_mesh_refuses_without_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launch_train.main(["--arch", "gemma_7b", "--reduced",
                              "--fake-devices", "4"]) == 1
    assert "--cpu" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# elastic checkpoints, the self-tests and the meter
# ---------------------------------------------------------------------------

def test_selftest_elastic_prints_ok(capsys):
    assert selftest_elastic.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "OK"


def test_the_reference_restores_the_ports_sharded_checkpoint(ref):
    got = ref["elastic"]
    for k, v in elastic_tree().items():
        np.testing.assert_array_equal(got[f"elastic/{k}"],
                                      v.astype(np.float32))
        assert int(got[f"elastic/{k}.mesh"]) == 4
        assert str(got[f"elastic/{k}.dtype"]) == str(v.dtype)


def test_the_port_restores_the_references_sharded_checkpoint(ref):
    tree = {k: to_torch(v, "cpu") for k, v in elastic_tree().items()}
    mesh4 = make_mesh((4,), ("data",), CPU[:4])
    sh4 = {k: NamedSharding(mesh4, P("data", None)) for k in tree}
    out, extra = CheckpointManager(str(ref["root"] / "ref")).restore(
        tree, shardings=sh4)
    assert extra == {"mesh": [8]}
    for k, t in tree.items():
        assert out[k].sharding == sh4[k]
        assert len(out[k].shards) == 4 and out[k].dtype == t.dtype
        got = assemble(out[k])
        assert torch.equal(got.view(torch.int16) if t.dtype is
                           torch.bfloat16 else got,
                           t.view(torch.int16) if t.dtype is torch.bfloat16
                           else t), k


def test_selftest_train_dp_prints_ok(capsys):
    assert selftest_train_dp.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "OK"
    assert [line.split()[0] for line in lines[:-1]] == [
        "schedule=tree", "schedule=ring", "schedule=hierarchical",
        "schedule=compressed"]


def test_meter_gradsync_counts_what_the_schedules_copy(capsys):
    assert meter_gradsync.main(["--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["schedule"] for r in rows] == [
        "tree", "ring", "hierarchical", "hierarchical+int8"]
    for r in rows:
        assert set(r) == {"schedule", "params", "grad_fp32_bytes",
                          "collectives"}
        c = r["collectives"]
        assert c["ppermute"]["count"] == c["copies_expected"]
        assert c["ppermute"]["bytes"] == c["bytes_expected"]
        assert r["grad_fp32_bytes"] == 4 * r["params"]
    by = {r["schedule"]: r["collectives"] for r in rows}
    # the ring's bytes a rank are XLA's all-reduce wire model
    assert by["ring"]["ppermute"]["bytes"] == pytest.approx(
        by["ring"]["reference_wire_model"]["total_bytes"])


@pytest.mark.parametrize("module", [selftest_train_dp, selftest_elastic,
                                    meter_gradsync])
def test_new_entry_points_refuse_the_card_without_one(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        module.main([])
    assert exc.value.code != 0
