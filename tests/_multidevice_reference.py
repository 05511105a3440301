"""The reference's LM-side multi-device paths on 8 fake CPU devices,
written to an .npz.

Run as a subprocess (it sets ``XLA_FLAGS`` before importing jax, so the
test process, which imports this module for its inputs, keeps its one
device)::

    python tests/_multidevice_reference.py SECTION OUT.npz [ARG]

Sections (each the reference half of one test file):

* ``dp`` — ``make_manual_dp_train_step`` on gemma reduced (8 × 32 tokens,
  3 AdamW steps at lr 1e-3) for every variant of :data:`DP_VARIANTS`, and
  the single-stream ``make_train_step``: every step's loss, the final
  parameters (``<variant>/<port name>``) and the compressed run's error
  state after the first step (``<variant>.err1/<port name>``) and the
  last (``<variant>.err/<port name>``); the initial parameters as
  ``params0/<port name>``;
* ``collectives`` — ``lax.all_to_all`` / ``lax.pmean`` / the stacked
  ``lax.all_gather`` and ``compressed_allreduce`` under ``shard_map`` on
  the inputs of :func:`collective_inputs`;
* ``moe`` — moonshot reduced on a (2, 4) ``("data", "model")`` mesh under
  ``make_policy``: for every case of :data:`MOE_CASES` the MoE layer's
  output and ``aux`` on :func:`moe_inputs`, and the model's loss and every
  gradient from ``jax.value_and_grad``;
* ``elastic`` — a checkpoint saved from the (8,) mesh sharded
  ``P("data", None)`` into ``ARG/ref`` and the port's checkpoint in
  ``ARG/port`` restored onto 4 devices (``elastic/<leaf>``, and the
  restored mesh's size as ``elastic/<leaf>.mesh``);
* ``train`` — ``repro.launch.train.main`` on the arguments after ``OUT``
  (with as many fake devices as its ``--fake-devices`` asks): its
  ``[train]`` lines (``lines``, one JSON string) and the parameters its
  model starts from (``params0/<port name>``).

jax 0.7 and later make a mesh's axes ``Explicit`` by default, where
``with_sharding_constraint`` (every ``shard_act`` under a policy) refuses
them; the reference was written for jax 0.4.37, whose axes are all
``Auto``.  :func:`_auto_axes` gives ``jax.make_mesh`` that default back in
this process.
"""

from __future__ import annotations

import os
import sys

import numpy as np

N = 8
SEED = 25
DP_STEPS = 3
# variant -> (mesh shape, axis names, schedule, compress_outer)
DP_VARIANTS = {
    "tree": ((8,), ("data",), "tree", False),
    "ring": ((8,), ("data",), "ring", False),
    "hierarchical": ((2, 4), ("pod", "data"), "hierarchical", False),
    "compressed": ((2, 4), ("pod", "data"), "hierarchical", True),
}
# case -> (moe_mode, capacity_factor or None for the reduced config's)
MOE_CASES = {"ep": ("ep", None), "replicated": ("replicated", None),
             "ep-drops": ("ep", 1.0)}
MOE_BATCH, MOE_SEQ = 2, 64


def collective_inputs() -> dict:
    """Global inputs of the ``collectives`` section, from :data:`SEED`."""
    rng = np.random.default_rng(SEED)
    f32 = np.float32
    return {"a2a": rng.normal(size=(8, 8, 4)).astype(f32),
            "mean": rng.normal(size=(8, 5)).astype(f32),
            "gather": rng.integers(-127, 128, size=(8, 6)).astype(np.int8),
            "cx": rng.normal(size=(8, 700)).astype(f32),
            "cerr": (rng.normal(size=(8, 700)) * 1e-3).astype(f32)}


def moe_inputs(d_model: int, vocab: int) -> dict:
    """The MoE layer's input and the model's batch, from :data:`SEED`."""
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, vocab, size=(MOE_BATCH, MOE_SEQ + 1))
    return {"x": rng.normal(size=(MOE_BATCH, MOE_SEQ, d_model)).astype(
                np.float32),
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32)}


def elastic_tree() -> dict:
    """The elastic self-test's tree, as NumPy (``e`` is bfloat16)."""
    import ml_dtypes
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(16, 8)).astype(np.float32),
            "e": rng.normal(size=(8, 4)).astype(np.float32).astype(
                ml_dtypes.bfloat16)}


def run(section: str, directory, *args) -> dict:
    """Run ``section`` in a subprocess (``args`` after the output path)
    and return its arrays; raises with its output when it fails."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(str(directory), f"{section}.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(here, "..", "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.join(here, "_multidevice_reference.py"),
         section, path, *map(str, args)],
        capture_output=True, text=True, timeout=600, env=env)
    if out.returncode:
        raise RuntimeError(f"reference section {section} failed:\n"
                           f"{out.stdout}\n{out.stderr[-4000:]}")
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _port_names(tree) -> dict:
    from repro_torch.models.weights import leaves, port_tree
    return {k: np.asarray(v) for k, v in leaves(port_tree(tree)).items()}


def dp(out: dict) -> None:
    import jax

    from repro import configs
    from repro.data import SyntheticLMDataset
    from repro.models import LanguageModel
    from repro.optim import AdamW
    from repro.train.step import (init_error_state, make_manual_dp_train_step,
                                  make_train_step)

    cfg = configs.get("gemma_7b").reduced()
    model = LanguageModel(cfg)
    opt = AdamW(learning_rate=1e-3)
    data = SyntheticLMDataset(cfg.vocab_size, seq_len=32, global_batch=8)
    params0 = model.init(jax.random.PRNGKey(0))
    for k, v in _port_names(params0).items():
        out[f"params0/{k}"] = v
    step = make_train_step(model, opt, None, donate=False)
    p, os_ = params0, opt.init(params0)
    losses = []
    for s in range(DP_STEPS):
        p, os_, m = step(p, os_, data.batch_at(s))
        losses.append(float(m["loss"]))
    out["single/losses"] = np.array(losses)
    for k, v in _port_names(p).items():
        out[f"single/{k}"] = v
    for name, (shape, axes, schedule, compress) in DP_VARIANTS.items():
        mesh = jax.make_mesh(shape, axes)
        step = make_manual_dp_train_step(
            model, opt, mesh, schedule=schedule, data_axes=axes,
            compress_outer=compress)
        p, os_, err = params0, opt.init(params0), init_error_state(params0)
        losses = []
        for s in range(DP_STEPS):
            p, os_, loss, err = step(p, os_, data.batch_at(s), err)
            losses.append(float(loss))
            if compress and s == 0:
                for k, v in _port_names(err).items():
                    out[f"{name}.err1/{k}"] = v
        out[f"{name}/losses"] = np.array(losses)
        for k, v in _port_names(p).items():
            out[f"{name}/{k}"] = v
        if compress:
            for k, v in _port_names(err).items():
                out[f"{name}.err/{k}"] = v


def collectives(out: dict) -> None:
    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.optim.compression import compressed_allreduce, quantize_int8

    x = collective_inputs()
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    both = ("data", "model")

    def run(body, arg, in_spec, out_spec):
        f = shard_map(body, mesh=mesh, in_specs=in_spec, out_specs=out_spec,
                      check_vma=False)
        return jax.jit(f)(arg)

    out["a2a"] = np.asarray(run(
        lambda v: lax.all_to_all(v[0], "model", 0, 1, tiled=True)[None],
        x["a2a"], P(both), P(both)))
    out["a2a_back"] = np.asarray(run(
        lambda v: lax.all_to_all(v[0], "model", 1, 0, tiled=True)[None],
        x["a2a"], P(both), P(both)))
    for name, axes in (("mean_model", "model"), ("mean_both", both)):
        out[name] = np.asarray(run(lambda v, a=axes: lax.pmean(v, a),
                                   x["mean"], P(both), P(both)))
    out["gather"] = np.asarray(run(
        lambda v: lax.all_gather(v, "data")[None], x["gather"], P(both),
        P(both)))
    for name, m, axis in (("c8", jax.make_mesh((8,), ("i",)), "i"),
                          ("c24", jax.make_mesh((2, 4), ("pod", "data")),
                           "pod")):
        spec = P(m.axis_names)

        def body(v, e, axis=axis):
            mean, res = compressed_allreduce(v[0], axis, error=e[0])
            codes, _ = quantize_int8(v[0] + e[0])
            return mean[None], res[None], codes[None]

        f = shard_map(body, mesh=m, in_specs=(spec, spec),
                      out_specs=(spec, spec, spec), check_vma=False)
        mean, res, codes = jax.jit(f)(x["cx"], x["cerr"])
        out[f"{name}.mean"] = np.asarray(mean)
        out[f"{name}.res"] = np.asarray(res)
        out[f"{name}.codes"] = np.asarray(codes)


def moe(out: dict) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.launch.mesh import make_host_mesh
    from repro.models import LanguageModel
    from repro.models import moe as ref_moe
    from repro.sharding import make_policy, use_policy

    base = configs.get("moonshot_v1_16b_a3b").reduced()
    policy = make_policy(make_host_mesh(2, 4))
    x = moe_inputs(base.d_model, base.vocab_size)
    params = None
    for case, (mode, factor) in MOE_CASES.items():
        cfg = dataclasses.replace(base, moe_mode=mode)
        if factor is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=factor)
        model = LanguageModel(cfg)
        if params is None:
            params = model.init(jax.random.PRNGKey(0))
            for k, v in _port_names(params).items():
                out[f"params0/{k}"] = v
        p = jax.tree_util.tree_map(lambda a: a[0],
                                   params["groups"]["b0"]["moe"])
        with use_policy(policy):
            y, aux = jax.jit(lambda pp, xx: ref_moe.moe_layer(pp, xx, cfg))(
                p, jnp.asarray(x["x"]))
        y0, aux0 = ref_moe.moe_layer(p, jnp.asarray(x["x"]), cfg)
        out[f"{case}/y"] = np.asarray(y)
        out[f"{case}/aux"] = np.asarray(aux)
        out[f"{case}/aux_unsharded"] = np.asarray(aux0)
        batch = {"tokens": jnp.asarray(x["tokens"]),
                 "labels": jnp.asarray(x["labels"])}

        def loss_fn(pp):
            with use_policy(policy):
                return model.loss(pp, batch, remat=False)[0]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        out[f"{case}/loss"] = np.asarray(loss)
        for k, v in _port_names(grads).items():
            out[f"{case}/grad/{k}"] = v


def elastic(out: dict, root: str) -> None:
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.ckpt import CheckpointManager

    tree = elastic_tree()
    mesh8 = jax.make_mesh((8,), ("data",))
    sh8 = {k: NamedSharding(mesh8, P("data", None)) for k in tree}
    placed = {k: jax.device_put(v, sh8[k]) for k, v in tree.items()}
    CheckpointManager(os.path.join(root, "ref"), async_save=False).save(
        0, placed, extra={"mesh": [8]})
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("data",))
    sh4 = {k: NamedSharding(mesh4, P("data", None)) for k in tree}
    got, _ = CheckpointManager(os.path.join(root, "port")).restore(
        tree, shardings=sh4)
    for k, v in got.items():
        out[f"elastic/{k}"] = np.asarray(v.astype(np.float32))
        out[f"elastic/{k}.mesh"] = np.array(v.sharding.mesh.shape["data"])
        out[f"elastic/{k}.dtype"] = np.array(str(v.dtype))


def train(out: dict, argv: list) -> None:
    import contextlib
    import io
    import json

    import jax

    from repro import configs
    from repro.launch import train as ref_train
    from repro.models import LanguageModel

    args = ref_train.parse_args(argv)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = LanguageModel(cfg).init(jax.random.PRNGKey(args.seed))
    for k, v in _port_names(params).items():
        out[f"params0/{k}"] = v
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_train.main(argv)
    lines = [json.loads(line[len("[train] "):])
             for line in buf.getvalue().splitlines()
             if line.startswith("[train] {")]
    out["lines"] = np.array(json.dumps(lines))


def _auto_axes() -> None:
    import jax
    from jax.sharding import AxisType

    make = jax.make_mesh

    def make_mesh(shape, names, *args, **kwargs):
        kwargs.setdefault("axis_types", (AxisType.Auto,) * len(names))
        return make(shape, names, *args, **kwargs)

    jax.make_mesh = make_mesh


def main(section: str, path: str, *rest) -> None:
    import jax

    _auto_axes()
    out: dict = {}
    if section == "train":
        train(out, list(rest))
    else:
        assert len(jax.devices()) == N, jax.devices()
        if section == "elastic":
            elastic(out, rest[0])
        else:
            {"dp": dp, "collectives": collectives, "moe": moe}[section](out)
    np.savez(path, **out)


def _devices(argv: list) -> int:
    """The fake devices a section needs: ``--fake-devices`` of a
    ``train`` section's arguments, else :data:`N`."""
    if argv[0] == "train" and "--fake-devices" in argv:
        return int(argv[argv.index("--fake-devices") + 1])
    return N


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={_devices(sys.argv[1:])} "
        + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(*sys.argv[1:])
