"""The dry run: every (arch × shape × mesh) cell traced on ``meta`` ranks.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma_7b --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference (``repro/launch/dryrun.py``) lowers and compiles each cell's
step against its production mesh with ShapeDtypeStructs and reads XLA's
analyses.  The port has no compiler to ask, so it runs the step instead,
once, on tensors that have shapes and no storage: the full published
config built on ``meta``, placed at rest on :func:`make_production_mesh`'s
256 or 512 ``meta`` ranks by the cell's policy
(:mod:`repro_torch.sharding.placement`), and the policy's step from
:func:`~repro_torch.train.step.make_train_step`,
:func:`~repro_torch.train.serve.make_prefill_step` or
:func:`~repro_torch.train.serve.make_decode_step` run under
``torch.utils.flop_counter.FlopCounterMode``.  Nothing is allocated and no
card is needed, so it runs on any host.  Each cell records the reference's
keys where the port can count them:

* ``production``: the step's FLOPs (the counter's total, plus the
  operations the kernels' entry points stand for on ``meta``, their
  ``meta_flops``; the FLOP counter cannot see inside a kernel),
  ``argument_size_in_bytes`` and ``output_size_in_bytes`` a rank (the
  parameters, float32 masters and moments rank 0 holds at rest, and the
  batch's shard by the reference's specs; the logits' and decode states'
  shards by ``state_spec``), and ``collectives``: the copies the rank mesh
  made (``Mesh.copies`` / ``bytes_copied``) and the blocks it cut
  (``splits`` / ``bytes_split``);
* ``flops_per_device`` and ``collectives`` from a ``meter=True`` model of
  the same cell (the materialised oracle in place of the kernels), counted
  at full depth (the port has no loop over layers to extrapolate), the
  global count over the ranks; ``run_cell(by_depth=True)`` takes the same
  counts from traces at one and two periods of the block pattern
  (:func:`trace_by_depth`);
* ``not_counted``: what only XLA's analyses give (``bytes accessed``,
  ``temp_size_in_bytes``, ``generated_code_size_in_bytes``).  The
  reference's ``lower_s`` and ``compile_s`` become ``trace_s``.

The reference's analytic sLSTM correction is not added: the recurrence's
products are ops the FLOP counter sees.  Results go to
``results_torch/dryrun/<mesh>_<arch>_<shape>.json`` at the repository's
root, one file a cell, skipped when present unless ``--force``.

:func:`parse_collective_bytes` is the reference's reader of post-SPMD HLO
text, kept as the pure text function it is, with the wire formulas
:mod:`repro_torch.launch.meter_gradsync` also prices its schedules by.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import time
import traceback
from pathlib import Path
from typing import Any, Callable

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results_torch" / "dryrun"

SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

NOT_COUNTED = ("bytes accessed", "temp_size_in_bytes",
               "generated_code_size_in_bytes")

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "c64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1, "s8": 1, "u8": 1, "pred": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(
    r"replica_groups=(?:\[(\d+),(\d+)\]|\{\{([\d,]*)\})")


def _shape_bytes(shape_str: str) -> int:
    """Bytes of one HLO shape string or tuple-of-shapes string."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        total += math.prod(int(d) for d in dims.split(",") if d) \
            * _DTYPE_BYTES[dtype]
    return total


def _group_size(rhs: str) -> int:
    """Participant count of a collective from its replica_groups attr (2
    when it has none)."""
    m = _GROUPS_RE.search(rhs)
    if not m:
        return 2
    if m.group(2) is not None:
        return max(int(m.group(2)), 1)       # iota form [n_groups, size]
    return max(len([x for x in m.group(3).split(",") if x != ""]), 1)


def wire_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Per-device wire bytes of one collective of ``kind`` whose output is
    ``out_bytes`` among ``group`` participants: all-gather and all-to-all
    ``O (g-1)/g``, all-reduce ``2 O (g-1)/g`` (a reduce-scatter and an
    all-gather), reduce-scatter ``O (g-1)`` (its output is the 1/g
    shard), collective-permute ``O``."""
    if kind in ("all-gather", "all-to-all"):
        return out_bytes * (group - 1) / group
    if kind == "all-reduce":
        return 2 * out_bytes * (group - 1) / group
    if kind == "reduce-scatter":
        return out_bytes * (group - 1)
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective {kind!r}")


def parse_collective_bytes(hlo_text: str) -> dict:
    """Per-device wire bytes (:func:`wire_bytes`) and count of every
    collective in post-SPMD HLO text, by kind, with ``total_bytes``; an
    async ``-start`` form is counted once and its ``-done`` skipped."""
    out = {k: {"bytes": 0, "count": 0} for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        m = re.match(r"(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(.+)$", line.strip())
        if not m:
            continue
        rhs = m.group(1)
        for kind in _COLLECTIVES:
            mm = re.match(rf"(\(.*?\)|\S+)\s+{kind}(?:-start)?\(", rhs)
            if mm and f"{kind}-done" not in rhs:
                out[kind]["bytes"] += int(wire_bytes(
                    kind, _shape_bytes(mm.group(1)), _group_size(rhs)))
                out[kind]["count"] += 1
                break
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    out["wire_model"] = True
    return out


def long500k_eligible(cfg) -> bool:
    """Sub-quadratic archs only (full-attention archs skip)."""
    return all(b in ("rglru", "mlstm", "slstm", "swa", "local_attn")
               for b in cfg.block_pattern)


def cells_for(cfg) -> list[str]:
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if long500k_eligible(cfg):
        cells.append("long_500k")
    return cells


# ---------------------------------------------------------------------------
# one step, counted
# ---------------------------------------------------------------------------

def _kernel_entry_points() -> tuple:
    """The kernels' entry points that count ``meta_flops``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.gemm import ops as gemm_ops

    return (fa_ops.flash_attention, fa_ops.flash_attention_bwd,
            gemm_ops.matmul, gemm_ops.matmul_accumulate)


def _block_bytes(sharding, shape, itemsize: int, rank: int = 0) -> int:
    """Bytes of ``rank``'s block of a global ``shape`` placed by
    ``sharding``."""
    return math.prod(len(range(*s.indices(n))) for s, n in zip(
        sharding.index(shape, rank), shape)) * itemsize


def _tree_bytes(tree, shardings) -> int:
    """Rank 0's bytes of a decode-state tree (or a tensor) by its
    shardings (:func:`repro_torch.train.serve.tree_state_shardings`)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(tree[k], shardings[k]) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(t, s) for t, s in zip(tree, shardings))
    if tree is None:
        return 0
    return _block_bytes(shardings, tuple(tree.shape), tree.element_size())


def _batch(cfg, seq_len: int, global_batch: int, device, generator):
    """``(specs, batch)``: the model inputs of a cell
    (:func:`repro_torch.data.make_batch_specs`) and tensors of them, empty
    on ``meta``, drawn from ``generator`` elsewhere (tokens uniform over
    the vocabulary, front-end inputs normal)."""
    import torch

    from repro_torch.data import make_batch_specs

    specs = make_batch_specs(cfg, seq_len, global_batch)
    out = {}
    for name, spec in specs.items():
        if device.type == "meta":
            out[name] = torch.empty(spec.shape, dtype=spec.dtype,
                                    device=device)
        elif spec.dtype.is_floating_point:
            out[name] = torch.randn(spec.shape, generator=generator,
                                    device=device).to(spec.dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=generator, device=device,
                                      dtype=spec.dtype)
    return specs, out


@dataclasses.dataclass
class Lowered:
    """A cell's step ready to run once: what the reference's ``lower_*``
    hand to XLA, for a port that runs instead of compiling.  ``run()``
    runs the step; ``argument_bytes`` is rank 0's bytes of its inputs
    besides the placed parameters (the batch's shard by the reference's
    specs, a decode step's states by ``state_spec``); ``opt_state`` the
    train step's placed AdamW state (else None); ``output_bytes(out)``
    rank 0's bytes of the step's outputs."""
    run: Callable
    argument_bytes: int
    opt_state: Any
    output_bytes: Callable


def _inputs_bytes(policy, specs, spec_of) -> int:
    """Rank 0's bytes of the inputs ``specs`` (:class:`BatchSpec` by name)
    placed by the specs ``spec_of(name, spec)`` gives."""
    from repro_torch.core.spmd import NamedSharding

    return sum(_block_bytes(NamedSharding(policy.mesh, spec_of(k, v)),
                            v.shape, v.dtype.itemsize)
               for k, v in specs.items())


def _generator(model, seed: int):
    import torch

    device = model.device
    return (None if device.type == "meta"
            else torch.Generator(device=device).manual_seed(seed))


def lower_train(model, cfg, policy, seq_len, global_batch, *, remat=True,
                n_loss_chunks=16, seed: int = 0) -> Lowered:
    """``make_train_step`` under ``policy`` on ``model`` (placed at rest by
    it), its AdamW state placed likewise, and a batch of the cell's
    specs, sharded as the reference's ``jit_with`` shards it."""
    from repro_torch.optim import AdamW
    from repro_torch.train.step import make_train_step

    optimizer = AdamW(learning_rate=1e-4)
    step = make_train_step(model, optimizer, policy, remat=remat,
                           n_loss_chunks=n_loss_chunks)
    state = optimizer.init(model)
    specs, batch = _batch(cfg, seq_len, global_batch, model.device,
                          _generator(model, seed))

    def output_bytes(metrics):
        return _resident(model, state)[0] + sum(
            v.numel() * v.element_size() for v in metrics.values()
            if hasattr(v, "element_size"))

    return Lowered(
        run=lambda: step(state, batch)[1],
        argument_bytes=_inputs_bytes(
            policy, specs, lambda k, v: policy.activation_spec(
                "tokens" if v.ndim == 2 else "residual", v.ndim)),
        opt_state=state, output_bytes=output_bytes)


def lower_prefill(model, cfg, policy, seq_len, global_batch, *,
                  seed: int = 0) -> Lowered:
    """``make_prefill_step`` under ``policy``: the prompt and the front
    ends' inputs sharded as the reference's ``lower_prefill`` shards them,
    the logits and the decode states as its outputs are."""
    from repro_torch.train.serve import (make_prefill_step,
                                         tree_state_shardings)

    step = make_prefill_step(model, policy, s_max=seq_len)
    specs, batch = _batch(cfg, seq_len, global_batch, model.device,
                          _generator(model, seed))
    dp = policy.dp_axes if policy.batch_sharded else None
    sp = policy.model_axis if policy.seq_sharded else None
    spec_of = {"tokens": (dp, sp), "frames": (dp, sp, None),
               "pixels": (dp, None, None)}
    specs.pop("labels")

    def output_bytes(out):
        logits, states = out
        return _logits_bytes(policy, logits) + _tree_bytes(
            states, tree_state_shardings(policy, states))

    return Lowered(
        run=lambda: step(batch["tokens"], frames=batch.get("frames"),
                         pixels=batch.get("pixels")),
        argument_bytes=_inputs_bytes(policy, specs,
                                     lambda k, v: spec_of[k]),
        opt_state=None, output_bytes=output_bytes)


def lower_decode(model, cfg, policy, seq_len, global_batch, *,
                 seed: int = 0) -> Lowered:
    """``make_decode_step`` under ``policy`` at the last position of a
    cache of ``seq_len``: the states sharded by ``state_spec`` and
    updated in place (the reference donates them), one token a
    sequence."""
    from repro_torch.core.spmd import NamedSharding
    from repro_torch.train.serve import (make_decode_step,
                                         tree_state_shardings)

    enc_len = seq_len // cfg.encoder_ratio if cfg.encoder_layers else 0
    states = model.init_states(global_batch, seq_len, enc_len=enc_len)
    step = make_decode_step(model, policy)
    _, batch = _batch(cfg, seq_len, global_batch, model.device,
                      _generator(model, seed))
    token = batch["tokens"][:, :1]
    dp = policy.dp_axes if policy.batch_sharded else None

    def output_bytes(out):
        logits, new_states = out
        return _logits_bytes(policy, logits) + _tree_bytes(
            new_states, tree_state_shardings(policy, new_states))

    return Lowered(
        run=lambda: step(states, token, seq_len - 1),
        argument_bytes=_block_bytes(
            NamedSharding(policy.mesh, (dp, None)), tuple(token.shape),
            token.element_size()) + _tree_bytes(
                states, tree_state_shardings(policy, states)),
        opt_state=None, output_bytes=output_bytes)


def _lower_for(model, cfg, policy, kind, seq_len, global_batch, remat,
               seed: int = 0) -> Lowered:
    if kind == "train":
        return lower_train(model, cfg, policy, seq_len, global_batch,
                           remat=remat, seed=seed)
    if kind == "prefill":
        return lower_prefill(model, cfg, policy, seq_len, global_batch,
                             seed=seed)
    if kind == "decode":
        return lower_decode(model, cfg, policy, seq_len, global_batch,
                            seed=seed)
    raise ValueError(f"unknown step kind {kind!r}")


def _logits_bytes(policy, logits) -> int:
    """Rank 0's bytes of (B, 1, V) logits, batch-sharded as the
    reference's outputs are."""
    from repro_torch.core.spmd import NamedSharding

    dp = policy.dp_axes if policy.batch_sharded else None
    return _block_bytes(NamedSharding(policy.mesh, (dp, None, None)),
                        tuple(logits.shape), logits.element_size())


def _resident(model, state=None) -> list:
    """Each rank's bytes of the placed parameters, and with ``state`` (an
    AdamW state) of their float32 masters and moments."""
    out = list(model.placement.rank_bytes())
    trees = (state.master, state.m, state.v) if state is not None else ()
    for tree in trees:
        for v in tree.values():
            for r, t in enumerate(v.shards):
                out[r] += t.numel() * t.element_size()
    return out


def trace_step(cfg, kind: str, seq_len: int, global_batch: int, mesh, *,
               meter: bool = False, remat: bool = True,
               params_tp: bool = False, seed: int = 0) -> dict:
    """Build ``cfg``'s model on the mesh's first device (on ``meta``
    without values; elsewhere drawn from ``seed``), place it by the
    cell's policy, lower the policy's ``kind`` step (``train``,
    ``prefill`` or ``decode``) and run it once under ``FlopCounterMode``.

    Returns the counts: ``flops`` (the counter's total), ``kernel_flops``
    (each kernel entry point's ``meta_flops``), ``launches`` (each entry
    point's launches), ``copies`` / ``bytes_copied`` / ``splits`` /
    ``bytes_split`` (the mesh's, over the step), ``rank_bytes`` (the
    parameters, and for a train step their masters and moments, each
    rank holds), ``argument_size_in_bytes`` / ``output_size_in_bytes``
    (rank 0's) and ``trace_s``; ``outputs``: the step's outputs (the
    logits, or the train step's metrics)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import LanguageModel
    from repro_torch.sharding import make_policy

    device = mesh.rank_devices[0]
    model = LanguageModel(cfg, device=device, meter=meter)
    if device.type != "meta":
        model.init(_generator(model, seed))
    policy = make_policy(mesh, batch_sharded=global_batch > 1,
                         seq_sharded=kind != "decode",
                         params_tp=params_tp and kind == "decode")
    lowered = _lower_for(model, cfg, policy, kind, seq_len, global_batch,
                         remat, seed=seed)
    rank_bytes = _resident(model, lowered.opt_state)

    entry = _kernel_entry_points()
    for fn in entry:
        fn.meta_flops = 0
    launches0 = [fn.launches for fn in entry]
    counted0 = (mesh.copies, mesh.bytes_copied, mesh.splits,
                mesh.bytes_split)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as counter:
        out = lowered.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    trace_s = time.perf_counter() - t0
    return {
        "flops": counter.get_total_flops(),
        "kernel_flops": {fn.__name__: fn.meta_flops for fn in entry},
        "launches": {fn.__name__: fn.launches - n
                     for fn, n in zip(entry, launches0)},
        "copies": mesh.copies - counted0[0],
        "bytes_copied": mesh.bytes_copied - counted0[1],
        "splits": mesh.splits - counted0[2],
        "bytes_split": mesh.bytes_split - counted0[3],
        "rank_bytes": rank_bytes,
        "argument_size_in_bytes": rank_bytes[0] + lowered.argument_bytes,
        "output_size_in_bytes": int(lowered.output_bytes(out)),
        "trace_s": trace_s,
        "outputs": out if kind == "train" else out[0],
    }


_AFFINE = ("flops", "kernel_flops", "launches", "copies", "bytes_copied",
           "splits", "bytes_split", "rank_bytes", "argument_size_in_bytes",
           "output_size_in_bytes")


def trace_by_depth(cfg, kind: str, seq_len: int, global_batch: int,
                   mesh_fn: Callable, **kw) -> dict:
    """``trace_step``'s counts for ``cfg``, from traces at one and two
    periods of its block pattern, extended in a line to its depth.

    Every count is affine in the number of periods (each period the same
    layers, the same ops, copies and bytes), so the line is exact; a step
    then costs two short traces instead of the full one.  ``mesh_fn``
    makes a fresh mesh for each trace.  ``trace_s`` is the two traces'
    time; ``outputs`` is ``None``."""
    period = len(cfg.block_pattern)
    if cfg.n_layers % period or cfg.encoder_layers:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"periods of {cfg.block_pattern} alone")
    one, two = (trace_step(dataclasses.replace(cfg, n_layers=n * period),
                           kind, seq_len, global_batch, mesh_fn(), **kw)
                for n in (1, 2))
    k = cfg.n_layers // period - 1

    def line(lo, hi):
        if isinstance(lo, dict):
            return {key: line(lo[key], hi[key]) for key in lo}
        if isinstance(lo, list):
            return [line(x, y) for x, y in zip(lo, hi)]
        return lo + k * (hi - lo)

    out = {key: line(one[key], two[key]) for key in _AFFINE}
    out["trace_s"] = one["trace_s"] + two["trace_s"]
    out["outputs"] = None
    return out


def _collectives(counts: dict, ranks: int) -> dict:
    """The rank mesh's copies and cut blocks over a step, in all and a
    rank."""
    return {
        "copies": counts["copies"], "bytes_copied": counts["bytes_copied"],
        "splits": counts["splits"], "bytes_split": counts["bytes_split"],
        "total_bytes": counts["bytes_copied"] + counts["bytes_split"],
        "bytes_per_device": (counts["bytes_copied"]
                             + counts["bytes_split"]) / ranks,
        "wire_model": False,
    }


def run_cell(arch: str, shape: str, mesh_kind: str, *, remat=True,
             meter: bool = True, params_tp: bool = False,
             ring_cache: bool = False, by_depth: bool = False) -> dict:
    """One cell: the production step on the production mesh's ``meta``
    ranks, and with ``meter`` the same step of a ``meter=True`` model.
    With ``by_depth`` each step is counted by :func:`trace_by_depth`
    rather than traced at full depth (the same counts, in a fraction of
    the time)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_production_mesh

    cfg = configs.get(arch)
    if ring_cache:
        cfg = dataclasses.replace(cfg, ring_cache=True)
    seq_len, global_batch, kind = SHAPES[shape]

    def mesh():
        return make_production_mesh(multi_pod=mesh_kind == "multi")

    def trace(**kw):
        if by_depth:
            return trace_by_depth(cfg, kind, seq_len, global_batch, mesh,
                                  params_tp=params_tp, **kw)
        return trace_step(cfg, kind, seq_len, global_batch, mesh(),
                          params_tp=params_tp, **kw)

    prod = trace(remat=remat)
    ranks = mesh().size
    result = {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "seq_len": seq_len, "global_batch": global_batch, "kind": kind,
        "ok": True, "device": "meta", "by_depth": by_depth,
        "ranks": ranks, "trace_s": round(prod["trace_s"], 1),
        "production": {
            "flops": prod["flops"] + sum(prod["kernel_flops"].values()),
            "flops_counted": prod["flops"],
            "kernel_flops": prod["kernel_flops"],
            "argument_size_in_bytes": prod["argument_size_in_bytes"],
            "output_size_in_bytes": prod["output_size_in_bytes"],
            "rank_bytes": prod["rank_bytes"][0],
            "collectives": _collectives(prod, ranks),
        },
        "params": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "not_counted": list(NOT_COUNTED),
    }
    del prod
    if meter:
        m = trace(meter=True, remat=False)
        result["meter_flops"] = m["flops"]
        result["flops_per_device"] = m["flops"] / ranks
        result["collectives"] = _collectives(m, ranks)
        result["meter_trace_s"] = round(m["trace_s"], 1)
    else:
        result["flops_per_device"] = result["production"]["flops"] / ranks
        result["collectives"] = result["production"]["collectives"]
    return result


def main(argv=None) -> int:
    from repro_torch import configs

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--decode-tp", action="store_true",
                    help="TP-sharded weights for decode cells")
    ap.add_argument("--ring-cache", action="store_true",
                    help="windowed ring KV cache for SWA decode")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(configs.all_names())
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        cfg = configs.get(arch)
        shapes = [args.shape] if args.shape else cells_for(cfg)
        for shape in shapes:
            if shape == "long_500k" and not long500k_eligible(cfg):
                print(f"SKIP {arch} long_500k (full attention)")
                continue
            for mesh_kind in meshes:
                tag = f"{args.tag}_" if args.tag else ""
                fname = out_dir / f"{tag}{mesh_kind}_{arch}_{shape}.json"
                if fname.exists() and not args.force:
                    print(f"have {fname}, skipping")
                    continue
                label = f"{arch} × {shape} × {mesh_kind}"
                print(f"=== {label} ...", flush=True)
                try:
                    res = run_cell(arch, shape, mesh_kind,
                                   remat=not args.no_remat,
                                   params_tp=args.decode_tp,
                                   ring_cache=args.ring_cache)
                    fname.write_text(json.dumps(res, indent=1))
                    print(f"    ok: trace {res['trace_s']}s (meter "
                          f"{res['meter_trace_s']}s), flops/dev "
                          f"{res['flops_per_device']:.3e}, args/rank "
                          f"{res['production']['argument_size_in_bytes']:,}"
                          f" B, coll "
                          f"{res['collectives']['total_bytes'] / 2**20:.0f}"
                          f" MiB", flush=True)
                except Exception as e:  # noqa: BLE001 - one cell's failure
                    failures.append((label, repr(e)))
                    fname.with_name(fname.name + ".fail").write_text(
                        traceback.format_exc())
                    print(f"    FAIL: {e!r}", flush=True)
    if failures:
        print(f"\n{len(failures)} failures:")
        for label, err in failures:
            print(f"  {label}: {err[:200]}")
        return 1
    print("\nALL CELLS OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
