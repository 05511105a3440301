"""The port's examples (``examples/torch_*.py``) run in-process on the host.

Each runs through its ``main`` with ``--cpu`` at a small size and must
print ``OK`` (the quickstart after its fault-tolerance, process-pool
and rank-mesh sections, the Listing 1 example after its ``shard_map``
half, the training example after saving a checkpoint) (the serving example also on the families with an encoder, a
vision front end, experts or xLSTM blocks) (the training example only once its loss has dropped);
without ``--cpu`` on a host with no GPU each must stop with a non-zero
code rather than fall back to the CPU.  The Listing 1 example
prints the reference example's accounting, line for line.
"""

import importlib.util
import os

import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
SCRIPTS = {"torch_quickstart": ["--cpu"],
           "torch_mapreduce_sort": ["--cpu", "--n", "20000",
                                    "--backend", "fused"],
           "torch_distributed_gemm": ["--cpu"],
           "torch_serve_lm": ["--cpu", "--batch", "2", "--tokens", "8"],
           # ROADMAP's acceptance line for the training half: 50 tiny
           # steps, the loss drops (the example checks it before "OK")
           "torch_train_lm": ["--cpu", "--preset", "tiny", "--steps", "50"]}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_example_runs_on_the_host(name, capsys, tmp_path):
    args = SCRIPTS[name]
    if name == "torch_train_lm":
        args = [*args, "--out", str(tmp_path)]
    assert _load(name).main(args) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "OK", out
    if name == "torch_quickstart":      # sections 8-9: recovery, procs
        assert "1 recovery" in out and "C bit for bit the fault-free" in out
        assert "procs backend: Listing 1 in 1 plan(s) on 4 worker" in out
        assert "SIGKILLed worker 1 mid-plan: 1 recovery" in out
        # section 12: the rank mesh lowers the ships, the chain is a kernel
        assert ("mesh backend on 4 ranks sharing cpu: collectives ACTIVE"
                in out) and "/ 0 simulated" in out
    if name == "torch_distributed_gemm":    # the shard_map half
        for schedule in ("tree", "ring"):
            assert (f"[mesh lowering] (2,4) mesh on cpu, schedule="
                    f"{schedule}: OK") in out
    if name == "torch_train_lm":        # a checkpoint the next run restores
        from repro_torch.ckpt import CheckpointManager

        assert "checkpoint: step 49" in out
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        assert mgr.latest_step() == 49
        manifest = mgr._manifest(49)
        assert manifest["extra"] == {"step": 49}
        assert all(leaf["dtype"] == "float32" or leaf["shape"] == []
                   for leaf in manifest["leaves"])


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_example_refuses_without_a_gpu(name, capsys, monkeypatch):
    module = _load(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert module.main([]) == 1
    captured = capsys.readouterr()
    assert "--cpu" in captured.err
    assert "OK" not in captured.out


@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "phi_3_vision_4_2b",
                                  "granite_moe_3b_a800m", "xlstm_350m"])
def test_serve_lm_example_serves_every_family(arch, capsys):
    """The serving example takes any of the ten configurations, handing the
    encoder's frames or the image patches to the prefill step."""
    assert _load("torch_serve_lm").main(["--cpu", "--arch", arch, "--batch",
                                         "2", "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "OK", out
    if arch == "seamless_m4t_medium":
        assert "frames (2, 4, 64)" in out
    if arch == "phi_3_vision_4_2b":
        assert "pixels (2, 8, 64)" in out


def test_distributed_gemm_example_prints_the_reference_accounting(capsys):
    _load("torch_distributed_gemm").bind_version(torch.device("cpu"))
    port = capsys.readouterr().out.replace(" on cpu", "").splitlines()
    _load("distributed_gemm").bind_version()
    ref = capsys.readouterr().out.splitlines()
    assert port == ref and len(port) == 3
