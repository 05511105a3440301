"""The reference's policy step with its parameters and AdamW state placed
at rest (flat FSDP), its policy's prefill and decode under ``params_tp``,
and its side of the FSDP checkpoints, on 8 fake CPU devices, written to
an .npz.

Run as a subprocess (it sets ``XLA_FLAGS`` before importing jax, as
``tests/_multidevice_reference.py`` does, whose ``Auto``-axes shim and
``_port_names`` it reuses)::

    python tests/_fsdp_reference.py ARCH OUT.npz CKPT_ROOT

For ``ARCH`` reduced on a (4, 2) ``("data", "model")`` mesh under
``make_policy`` with ``min_shard_elems`` :data:`MIN_SHARD` (the reduced
models' leaves are all under the default 65,536 elements, which would
replicate every one):

* ``make_train_step(model, opt, policy).jit_with(...)`` from the weights
  of ``PRNGKey(0)`` (``params0/<port name>``) for :data:`STEPS` AdamW
  steps on :func:`batches`: each step's loss (``f32/losses``), the final
  parameters (``f32/<port name>``), and the per-rank block of every
  parameter, master and moment leaf as the jitted step leaves them
  (``index/{params,master,m,v}/<port name>``: (rank, dim, start / stop)
  from ``devices_indices_map``, a pattern group's leaf without its group
  entry); with ``grad_reduce_dtype="bfloat16"`` too (``bf16/...``,
  dense models);
* the prefill of :func:`prompt` and :data:`DECODE` decode steps under
  ``make_policy(..., params_tp=True, seq_sharded=False)`` with the
  parameters placed by its shardings (``tp/prefill``, ``tp/decode<i>``,
  ``index/tp/<port name>``; dense models);
* the final parameters saved, one leaf a port name, each still placed,
  into ``CKPT_ROOT/ref_<ARCH>``; and the port's FSDP checkpoint in
  ``CKPT_ROOT/port_<ARCH>`` (written by the test first, with its specs in
  ``specs.json`` there) restored onto this mesh by those specs
  (``restored/<port name>`` and ``restored.index/<port name>``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

N = 8
MESH = (4, 2)
MIN_SHARD = 1024
STEPS = 3
BATCH, SEQ = 8, 32
PROMPT, DECODE = 32, 2
DENSE = ("gemma_7b",)


def batches(vocab: int) -> list:
    """The training batches, from a seeded NumPy generator."""
    rng = np.random.default_rng(26)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, vocab, size=(BATCH, SEQ + 1))
        out.append({"tokens": t[:, :-1].astype(np.int32),
                    "labels": t[:, 1:].astype(np.int32)})
    return out


def prompt(vocab: int) -> np.ndarray:
    return np.random.default_rng(27).integers(
        0, vocab, size=(2, PROMPT)).astype(np.int32)


def run(arch: str, directory, ckpt_root) -> dict:
    """Run the reference half for ``arch`` in a subprocess and return its
    arrays; raises with its output when it fails."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(str(directory), f"fsdp_{arch}.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(here, "..", "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    # the reduced models are tiny: two threads a run keep the module's
    # runs side by side from crowding the workers beside them
    env["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false"
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run(
        [sys.executable, os.path.join(here, "_fsdp_reference.py"), arch,
         path, str(ckpt_root)],
        capture_output=True, text=True, timeout=600, env=env)
    if out.returncode:
        raise RuntimeError(f"reference FSDP run of {arch} failed:\n"
                           f"{out.stdout}\n{out.stderr[-4000:]}")
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _indices(arr, mesh, stacked: bool) -> np.ndarray:
    """(rank, dim, start / stop) of ``arr``'s per-device blocks, ranks in
    the mesh's row-major order; a stacked leaf without its group entry,
    repeated for every group (so ``_port_names`` unstacks it)."""
    blocks = arr.sharding.devices_indices_map(arr.shape)
    out = np.zeros((mesh.devices.size, arr.ndim, 2), dtype=np.int64)
    for r, dev in enumerate(mesh.devices.flat):
        for d, sl in enumerate(blocks[dev]):
            start, stop, _ = sl.indices(arr.shape[d])
            out[r, d] = (start, stop)
    if stacked:
        out = np.broadcast_to(out[:, 1:][None],
                              (arr.shape[0],) + out[:, 1:].shape)
    return out


def _index_tree(tree, mesh):
    import jax

    def one(path, leaf):
        keys = [getattr(k, "key", None) for k in path]
        return _indices(leaf, mesh, "groups" in keys)

    return jax.tree_util.tree_map_with_path(one, tree)


def main(arch: str, path: str, ckpt_root: str) -> None:
    import jax
    import jax.numpy as jnp
    from _multidevice_reference import _auto_axes, _port_names
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import configs
    from repro.ckpt import CheckpointManager
    from repro.launch.mesh import make_host_mesh
    from repro.models import LanguageModel
    from repro.optim import AdamW
    from repro.sharding import make_policy, use_policy
    from repro.train.step import make_train_step
    from repro_torch.models.weights import leaves

    _auto_axes()
    assert len(jax.devices()) == N, jax.devices()
    out: dict = {}
    cfg = configs.get(arch).reduced()
    model = LanguageModel(cfg)
    opt = AdamW(learning_rate=1e-3)
    params0 = model.init(jax.random.PRNGKey(0))
    for k, v in _port_names(params0).items():
        out[f"params0/{k}"] = v
    mesh = make_host_mesh(*MESH)
    policy = dataclasses.replace(make_policy(mesh), min_shard_elems=MIN_SHARD)
    data = [{k: jnp.asarray(v) for k, v in b.items()}
            for b in batches(cfg.vocab_size)]
    variants = {"f32": None, "bf16": "bfloat16"} if arch in DENSE else {
        "f32": None}
    for name, gdt in variants.items():
        step = make_train_step(model, opt, policy, donate=False,
                               grad_reduce_dtype=gdt)
        jitted = step.jit_with(params0, opt.init(params0), data[0])
        p, os_ = params0, opt.init(params0)
        losses = []
        for b in data:
            p, os_, m = jitted(p, os_, b)
            losses.append(float(m["loss"]))
        out[f"{name}/losses"] = np.array(losses)
        for k, v in _port_names(p).items():
            out[f"{name}/{k}"] = v
        if name == "f32":
            final = p
            for tree_name, tree in (("params", p), ("master", os_.master),
                                    ("m", os_.m), ("v", os_.v)):
                for k, v in _port_names(_index_tree(tree, mesh)).items():
                    out[f"index/{tree_name}/{k}"] = v

    if arch in DENSE:
        tp = dataclasses.replace(
            make_policy(mesh, params_tp=True, seq_sharded=False),
            min_shard_elems=MIN_SHARD)
        placed = jax.device_put(params0, tp.tree_param_shardings(params0))
        for k, v in _port_names(_index_tree(placed, mesh)).items():
            out[f"index/tp/{k}"] = v

        @jax.jit
        def prefill(p, tokens):
            with use_policy(tp):
                return model.prefill(p, tokens, s_max=PROMPT + DECODE)

        @jax.jit
        def decode(p, states, token, pos):
            with use_policy(tp):
                return model.decode_step(p, states, token, pos)

        logits, states = prefill(placed, jnp.asarray(prompt(cfg.vocab_size)))
        out["tp/prefill"] = np.asarray(logits)
        token = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        for i in range(DECODE):
            logits, states = decode(placed, states, token,
                                    jnp.int32(PROMPT + i))
            out[f"tp/decode{i}"] = np.asarray(logits)
            token = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)

    # the final parameters, one placed leaf a port name
    flat = {}
    for key, leaf in leaves(final).items():
        parts = key.split(".")
        if "groups" in parts:
            for g in range(leaf.shape[0]):
                i = parts.index("groups")
                flat[".".join(parts[:i + 1] + [str(g)] + parts[i + 1:])] = \
                    leaf[g]
        else:
            flat[key] = leaf
    CheckpointManager(os.path.join(ckpt_root, f"ref_{arch}"),
                      async_save=False).save(0, flat, extra={"arch": arch})
    port_dir = os.path.join(ckpt_root, f"port_{arch}")
    with open(os.path.join(port_dir, "specs.json")) as f:
        specs = json.load(f)
    like = {k: np.zeros(s["shape"], np.float32) for k, s in specs.items()}
    shardings = {k: NamedSharding(mesh, P(*[
        tuple(e) if isinstance(e, list) else e for e in s["spec"]]))
        for k, s in specs.items()}
    got, _ = CheckpointManager(port_dir).restore(like, shardings=shardings)
    for k, v in got.items():
        out[f"restored/{k}"] = np.asarray(v)
        out[f"restored.index/{k}"] = _indices(v, mesh, False)
    np.savez(path, **out)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={N} "
                               + os.environ.get("XLA_FLAGS", ""))
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "..", "src"))
    sys.path.insert(0, here)
    main(*sys.argv[1:])
