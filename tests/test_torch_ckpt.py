"""The port's checkpoints, supervisor and trainer restarts against the
reference.

* ``CheckpointManager``: the cases of ``tests/test_data_ckpt.py`` and the
  stale-``.tmp`` cases of ``tests/test_recovery.py`` through both
  packages; the on-disk format is the reference's, so a checkpoint written
  by either package restores in the other bit for bit, bfloat16 included,
  with leaves in ``jax.tree_util``'s order; an async save snapshots copies,
  so an in-place update after ``save`` returns does not reach the disk.
* The trainer (``repro_torch.launch.train``) crashes at step 25 with exit
  code 42 and resumes from the step-19 checkpoint to the same final loss as
  an uninterrupted run, in subprocesses on the CPU, directly and under the
  port's ``Supervisor`` (``tests/test_fault_tolerance.py``'s arguments).
"""

import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
from typing import NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as RefManager
from repro_torch.ckpt import CheckpointManager as PortManager
from repro_torch.ckpt.manager import flatten

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


class State(NamedTuple):
    m: dict
    count: object


def _ref_tree(rng):
    return {"a": jnp.asarray(rng.normal(size=(4, 4)), jnp.float32),
            "b": [jnp.arange(3), jnp.asarray(rng.normal(size=(2,)),
                                             jnp.bfloat16)]}


def _port_tree(rng):
    a = rng.normal(size=(4, 4)).astype(np.float32)
    b1 = rng.normal(size=(2,)).astype(ml_dtypes.bfloat16)
    return {"a": torch.from_numpy(a),
            "b": [torch.arange(3, dtype=torch.int32),
                  torch.from_numpy(b1.view(np.uint16).view(np.int16)).view(
                      torch.bfloat16)]}


def _bits(x):
    """A leaf's dtype name and raw bits, from either package."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        if x.dtype == torch.bfloat16:
            return name, x.view(torch.int16).numpy().view(np.uint16).tobytes()
        return name, x.numpy().tobytes()
    arr = np.asarray(x)
    return str(arr.dtype), arr.tobytes()


SIDES = {"ref": (RefManager, _ref_tree, jax.tree_util.tree_leaves),
         "port": (PortManager, _port_tree, flatten)}


# ---------------------------------------------------------------------------
# the cases of tests/test_data_ckpt.py, through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", SIDES)
def test_roundtrip(tmp_path, rng, pkg):
    manager, tree_of, leaves = SIDES[pkg]
    mgr = manager(str(tmp_path), async_save=False)
    tree = tree_of(rng)
    mgr.save(3, tree, extra={"step": 3})
    out, extra = mgr.restore(tree)
    assert extra["step"] == 3
    for a, b in zip(leaves(tree), leaves(out)):
        assert _bits(a) == _bits(b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("pkg", SIDES)
def test_latest_and_gc(tmp_path, rng, pkg):
    manager, tree_of, _ = SIDES[pkg]
    mgr = manager(str(tmp_path), keep_n=2, async_save=False)
    tree = tree_of(rng)
    for s in (1, 5, 9):
        mgr.save(s, tree, extra={"step": s})
    assert mgr.latest_step() == 9
    assert len([n for n in os.listdir(tmp_path)
                if n.startswith("step_")]) == 2


@pytest.mark.parametrize("pkg", SIDES)
def test_async_save_then_wait(tmp_path, rng, pkg):
    manager, tree_of, _ = SIDES[pkg]
    mgr = manager(str(tmp_path), async_save=True)
    mgr.save(1, tree_of(rng), extra={"step": 1})
    mgr.wait()
    assert mgr.latest_step() == 1


@pytest.mark.parametrize("pkg", SIDES)
def test_atomicity_no_partial_dirs(tmp_path, rng, pkg):
    manager, tree_of, leaves = SIDES[pkg]
    mgr = manager(str(tmp_path), async_save=False)
    tree = tree_of(rng)
    mgr.save(2, tree, extra={"step": 2})
    mgr.save(2, tree, extra={"step": 2})
    assert mgr.latest_step() == 2
    assert len(leaves(mgr.restore(tree)[0])) == 3
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_structure_mismatch_raises(tmp_path, rng):
    mgr = PortManager(str(tmp_path), async_save=False)
    mgr.save(0, _port_tree(rng), extra={})
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore({"only": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"a": torch.zeros(4, 5), "b": [torch.zeros(3),
                                                   torch.zeros(2)]})


@pytest.mark.parametrize("pkg", SIDES)
def test_restore_ignores_and_gcs_stale_tmp(tmp_path, rng, pkg):
    manager, tree_of, leaves = SIDES[pkg]
    d = str(tmp_path / "ck")
    mgr = manager(d, async_save=False)
    tree = tree_of(rng)
    mgr.save(3, tree, block=True)
    stale = mgr._step_dir(7) + ".tmp"
    os.makedirs(stale)
    np.save(os.path.join(stale, "leaf_00000.npy"), np.zeros(4))
    with open(os.path.join(stale, "manifest.json"), "w") as f:
        f.write('{"step": 7, "treedef":')        # truncated mid-write
    mgr2 = manager(d, async_save=False)
    assert mgr2.latest_step() == 3
    restored, _extra = mgr2.restore(tree)
    assert [_bits(x) for x in leaves(restored)] == [_bits(x)
                                                    for x in leaves(tree)]
    assert not os.path.exists(stale)


@pytest.mark.parametrize("pkg", SIDES)
def test_save_gcs_stale_tmp_from_crashed_run(tmp_path, pkg):
    manager = SIDES[pkg][0]
    mgr = manager(str(tmp_path / "ck"), async_save=False)
    stale = mgr._step_dir(5) + ".tmp"
    os.makedirs(stale)
    mgr.save(6, [np.arange(3.0)], block=True)
    assert not os.path.exists(stale)
    assert mgr.latest_step() == 6


# ---------------------------------------------------------------------------
# one format: each package restores the other's checkpoints
# ---------------------------------------------------------------------------

def _nested(side, rng):
    """The same nested dict / tuple / NamedTuple / None structure in both
    packages' leaves (dict keys deliberately out of order)."""
    vals = {"w": rng.normal(size=(3, 2)).astype(np.float32),
            "e": rng.normal(size=(5,)).astype(np.float32),
            "h": rng.normal(size=(2, 2)).astype(ml_dtypes.bfloat16),
            "i": np.arange(4, dtype=np.int32)}
    if side == "ref":
        leaf = {k: jnp.asarray(v) for k, v in vals.items()}
        count = jnp.asarray(7, jnp.int32)
    else:
        leaf = {k: (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                    if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v))
                for k, v in vals.items()}
        count = torch.tensor(7, dtype=torch.int32)
    return {"zeta": leaf["w"], "alpha": (leaf["e"], None, leaf["h"]),
            "state": State(m={"q": leaf["i"], "b": leaf["w"]}, count=count)}


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_checkpoints_restore_across_packages(tmp_path, rng, writer, reader):
    tree_w = _nested(writer, rng)
    tree_r = _nested(reader, np.random.default_rng(99))   # other values
    SIDES[writer][0](str(tmp_path), async_save=False).save(
        4, tree_w, extra={"step": 4})
    out, extra = SIDES[reader][0](str(tmp_path)).restore(tree_r)
    assert extra == {"step": 4}
    got = [_bits(x) for x in SIDES[reader][2](out)]
    want = [_bits(x) for x in SIDES[writer][2](tree_w)]
    assert got == want
    assert any(name == "bfloat16" for name, _ in got)


def test_leaves_follow_jax_tree_order(rng):
    port = [_bits(x) for x in flatten(_nested("port", rng))]
    ref = [_bits(x) for x in jax.tree_util.tree_leaves(
        _nested("ref", np.random.default_rng(0)))]
    assert port == ref


def test_async_save_is_a_snapshot_of_the_step(tmp_path):
    """The optimizer updates its state in place: a save that returned must
    have copied every leaf, CPU tensors included."""
    state = {"m": torch.arange(6.0), "p": torch.ones(3, dtype=torch.bfloat16)}
    want = {k: v.clone() for k, v in state.items()}
    mgr = PortManager(str(tmp_path), async_save=True)
    mgr.save(0, state, extra={"step": 0})
    state["m"].add_(100.0)
    state["p"].mul_(3)
    mgr.wait()
    out, _ = mgr.restore(state)
    for k in state:
        assert torch.equal(out[k], want[k]), k
        assert out[k].data_ptr() != state[k].data_ptr()


def test_restore_takes_the_likes_dtype_and_numbers(tmp_path):
    mgr = PortManager(str(tmp_path), async_save=False)
    mgr.save(1, {"x": torch.arange(4.0), "n": 3, "a": np.arange(2.0)})
    out, _ = mgr.restore({"x": torch.zeros(4, dtype=torch.float64), "n": 0,
                          "a": np.zeros(2, np.float32)})
    assert out["x"].dtype == torch.float64 and out["n"] == 3
    assert type(out["n"]) is int
    assert out["a"].dtype == np.float32 and type(out["a"]) is np.ndarray


# ---------------------------------------------------------------------------
# the trainer crashes and resumes (tests/test_fault_tolerance.py:33-72)
# ---------------------------------------------------------------------------

BASE = ["--arch", "gemma_7b", "--reduced", "--steps", "30", "--batch", "4",
        "--seq", "32", "--lr", "1e-3", "--ckpt-every", "10", "--cpu"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _argv(*args):
    return [sys.executable, "-m", "repro_torch.launch.train", *BASE, *args]


def _train(*args):
    return subprocess.run(_argv(*args), capture_output=True, text=True,
                          timeout=600, env=_env())


def _final_loss(path):
    with open(path) as f:
        return json.load(f)["final"]["loss"]


@functools.lru_cache(maxsize=None)
def _uninterrupted_loss() -> float:
    """The final loss of the same 30 steps without a crash, in process."""
    from repro_torch.launch import train as launch_train

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "ref.json")
        with contextlib.redirect_stdout(io.StringIO()):
            assert launch_train.main([*BASE, "--metrics-out", out]) == 0
        return _final_loss(out)


def test_crash_resume_bit_identical_loss(tmp_path):
    ck = str(tmp_path / "ck")
    out = _train("--ckpt-dir", ck, "--crash-at-step", "25")
    assert out.returncode == 42, out.stderr
    assert "injected crash at step 25" in out.stdout
    m2 = str(tmp_path / "resumed.json")
    out = _train("--ckpt-dir", ck, "--metrics-out", m2)
    assert out.returncode == 0, out.stderr
    assert "[train] resumed from step 19" in out.stdout
    assert _final_loss(m2) == _uninterrupted_loss()     # bit for bit


def test_supervisor_respawns_until_clean_exit(tmp_path):
    from repro_torch.runtime import Supervisor

    ck, hb = str(tmp_path / "ck2"), str(tmp_path / "hb")
    open(hb, "w").close()
    argv = _argv("--ckpt-dir", ck, "--heartbeat", hb, "--crash-at-step",
                 "25")
    sup = Supervisor(argv, heartbeat_file=hb, heartbeat_timeout=600,
                     max_restarts=0, env=_env())
    with pytest.raises(RuntimeError, match="gave up after 0 restarts "
                                           r"\(last exit 42"):
        sup.run(poll=0.2)
    m = str(tmp_path / "m.json")
    argv_clean = [a for a in argv if a not in ("--crash-at-step", "25")]
    sup2 = Supervisor(argv_clean + ["--metrics-out", m], heartbeat_file=hb,
                      heartbeat_timeout=600, max_restarts=2, env=_env())
    assert sup2.run(poll=0.2) == 0
    assert sup2.restarts == 0
    assert sorted(n for n in os.listdir(ck) if n.startswith("step_")) == [
        "step_0000000009", "step_0000000019", "step_0000000029"]
    assert _final_loss(m) == _uninterrupted_loss()
