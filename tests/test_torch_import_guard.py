"""The port stands alone: importing every ``repro_torch`` module loads no
``jax`` and no module of the reference package ``repro``."""

import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# "repro_torch" shares a prefix with "repro": match "repro" and "repro.*"
# exactly, never a bare startswith("repro")
_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "repro")
             or k.startswith(("jax.", "jaxlib.", "repro.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import json

    got = json.loads(out.stdout.strip().splitlines()[-1])
    # the walk reached every layer of the package
    for mod in ("repro_torch.core.scheduler", "repro_torch.core.backends.serial",
                "repro_torch.core.backends.fused",
                "repro_torch.core.backends.mesh",
                "repro_torch.core.backends.threadpool",
                "repro_torch.core.executable_cache",
                "repro_torch.kernels._build",
                "repro_torch.kernels.gemm.ops",
                "repro_torch.kernels.chain.kernel",
                "repro_torch.kernels.chain.ops",
                "repro_torch.kernels.chain.ref",
                "repro_torch.kernels.linear_scan.ops",
                "repro_torch.kernels.linear_scan.kernel",
                "repro_torch.kernels.linear_scan.ref",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.kernels.flash_attention.kernel",
                "repro_torch.kernels.flash_attention.ref",
                "repro_torch.linalg.distributed",
                "repro_torch.mapreduce.engine", "repro_torch.mapreduce.sort",
                "repro_torch.serve.runtime", "repro_torch.serve.session",
                "repro_torch.serve.metrics",
                "repro_torch.launch.mesh", "repro_torch.compat",
                "repro_torch.configs", "repro_torch.configs.recurrentgemma_9b",
                "repro_torch.models.config", "repro_torch.models.layers",
                "repro_torch.models.attention_xla",
                "repro_torch.models.recurrent", "repro_torch.models.blocks",
                "repro_torch.models.model", "repro_torch.models.weights",
                "repro_torch.sharding.constraints",
                "repro_torch.train.serve", "repro_torch.train.step",
                "repro_torch.optim.adamw", "repro_torch.optim.schedule",
                "repro_torch.optim.compression",
                "repro_torch.data.pipeline", "repro_torch.launch.train",
                "repro_torch.core.backends.procs",
                "repro_torch.core.shm_store", "repro_torch.core.recovery",
                "repro_torch.ckpt.manager",
                "repro_torch.runtime.supervisor",
                "repro_torch.core.spmd", "repro_torch.core.lowering",
                "repro_torch.launch.selftest_collectives",
                "repro_torch.launch.selftest_mesh",
                "repro_torch.launch.selftest_distgemm"):
        assert mod in got["modules"], mod
    assert got["bad"] == [], f"repro_torch pulled in: {got['bad']}"
