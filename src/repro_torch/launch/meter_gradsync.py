"""Meter the gradient-sync schedules' collective traffic.

    python -m repro_torch.launch.meter_gradsync [--device cpu]

Runs one step of the explicit data-parallel trainer
(:func:`repro_torch.train.step.make_manual_dp_train_step`) on a (2, 4)
``("pod", "data")`` rank mesh (8 ranks sharing the card; ``--device cpu``:
the host) for each schedule, gemma reduced with a batch of 8 × 64 tokens,
and prints one JSON line per schedule with the reference's keys
(``schedule``, ``params``, ``grad_fp32_bytes``, ``collectives``).

The reference parses its bytes from the compiled step's HLO.  The port's
come from the mesh's counters over the step: ``collectives.ppermute``
holds the copies and bytes per rank.  Beside them stand
:func:`expected_copies` (the port's schedules counted in closed form:
``copies_expected`` / ``bytes_expected``, per rank) and
:func:`wire_model` (the reference's per-device wire bytes of the
collectives it emits for the same schedule, by the formulas of
``repro/launch/dryrun.py``'s ``parse_collective_bytes``:
``reference_wire_model``).  Both count the loss's ``pmean`` besides the
gradients.  Exits non-zero when a measured count differs from
:func:`expected_copies`.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

SCHEDULES = (("tree", False), ("ring", False), ("hierarchical", False),
             ("hierarchical", True))


def _ring(n: int, nbytes: int) -> tuple:
    """Copies and bytes of one ring all-reduce (reduce-scatter and
    all-gather, ``n - 1`` rounds each) of ``nbytes`` in one group."""
    return 2 * n * (n - 1), 2 * (n - 1) * nbytes


def _gather(n: int, nbytes: int) -> tuple:
    """Copies and bytes of one ring all-gather of ``nbytes`` a rank."""
    return n * (n - 1), n * (n - 1) * nbytes


def gradient_leaves(model) -> list:
    """``(shape, element size)`` of every leaf the manual DP step
    synchronises: the reference's, the pattern groups stacked
    (:func:`repro_torch.train.step.stacked_leaves`)."""
    from repro_torch.train.step import stacked_leaves

    params = dict(model.named_parameters())
    out = []
    for stack in stacked_leaves(params):
        p = params[stack[0]]
        shape = tuple(p.shape) if len(stack) == 1 else (len(stack),
                                                        *p.shape)
        out.append((shape, p.element_size()))
    return out


def expected_copies(schedule: str, compress: bool, axes: dict, leaves,
                    loss_bytes: int = 4) -> tuple:
    """``(copies, bytes)`` of one manual-DP step over all ranks, in closed
    form: ``axes`` is ``{data axis: size}`` outermost first (the mesh's
    only axes), ``leaves`` the gradients' ``(shape, element size)``
    (:func:`gradient_leaves`).  The
    loss's ``pmean`` is a ring all-reduce of one float32 over every rank
    (one element: ``loss_bytes`` move in each round)."""
    names = list(axes)
    size = math.prod(axes.values())
    copies = nbytes = 0

    def add(groups, cb):
        nonlocal copies, nbytes
        copies += groups * cb[0]
        nbytes += groups * cb[1]

    for shape, item in leaves:
        b = math.prod(shape) * item
        if compress and len(names) > 1:
            o, i = axes[names[0]], axes[names[-1]]
            add(size // i, _ring(i, b))                # pmean over inner
            nb = -(-math.prod(shape) // 256)
            add(size // o, _gather(o, nb * 256))       # int8 codes
            add(size // o, _gather(o, nb * 4))         # float32 scales
        elif schedule == "tree":
            for ax in names:
                n = axes[ax]
                add(size // n, (2 * (n - 1), 2 * (n - 1) * b))
        elif schedule == "ring" or len(names) == 1:
            add(1, _ring(size, b))
        elif schedule == "hierarchical":
            o, i = axes[names[0]], axes[names[-1]]
            if not any(d % i == 0 for d in shape):
                add(1, _ring(size, b))
                continue
            add(o, (i * (i - 1), (i - 1) * b))          # reduce-scatter
            add(i, _ring(o, b // i))                     # across pods
            add(o, (i * (i - 1), (i - 1) * b))          # all-gather
        else:
            raise ValueError(f"unknown schedule {schedule!r}")
    add(1, (2 * size * (size - 1), 2 * (size - 1) * loss_bytes))
    return copies, nbytes


def wire_model(schedule: str, compress: bool, axes: dict, leaves,
               loss_bytes: int = 4) -> dict:
    """The reference's per-device wire bytes for the same step, by kind,
    from the collectives its step emits (``lax.ppermute`` rounds for the
    tree, ``psum`` / ``psum_scatter`` / ``all_gather`` otherwise) and the
    formulas of ``parse_collective_bytes``: all-reduce ``2 O (g-1)/g``,
    reduce-scatter ``O_out (g-1)``, all-gather ``O (g-1)/g``,
    collective-permute ``O``."""
    names = list(axes)
    size = math.prod(axes.values())
    out = {"all-reduce": 0.0, "reduce-scatter": 0.0, "all-gather": 0.0,
           "collective-permute": 0.0}

    def ar(o, g):
        out["all-reduce"] += 2 * o * (g - 1) / g

    for shape, item in leaves:
        b = math.prod(shape) * item
        if compress and len(names) > 1:
            o, i = axes[names[0]], axes[names[-1]]
            ar(b, i)
            nb = -(-math.prod(shape) // 256)
            out["all-gather"] += (o * nb * 256 + o * nb * 4) * (o - 1) / o
        elif schedule == "tree":
            for ax in names:
                rounds = math.ceil(math.log2(axes[ax])) if axes[ax] > 1 else 0
                out["collective-permute"] += 2 * rounds * b
        elif schedule == "ring" or len(names) == 1:
            ar(b, size)
        else:
            o, i = axes[names[0]], axes[names[-1]]
            if not any(d % i == 0 for d in shape):
                ar(b, size)
                continue
            out["reduce-scatter"] += (b / i) * (i - 1)
            ar(b / i, o)
            out["all-gather"] += b * (i - 1) / i
    ar(loss_bytes, size)
    out["total_bytes"] = sum(out.values())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="the device every rank shares (cuda, cpu)")
    args = parser.parse_args(argv)

    import torch

    from repro_torch import configs
    from repro_torch.core.spmd import make_mesh
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW
    from repro_torch.train.step import (init_error_state,
                                        make_manual_dp_train_step)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no GPU (torch.cuda.is_available() is false); pass "
                     "--device cpu to run on the host")
    cfg = configs.get("gemma_7b").reduced()
    data = SyntheticLMDataset(cfg.vocab_size, seq_len=64, global_batch=8,
                              device=device)
    opt = AdamW(learning_rate=1e-3)
    axes = {"pod": 2, "data": 4}
    batch = data.batch_at(0)
    ok = True
    for schedule, compress in SCHEDULES:
        mesh = make_mesh(tuple(axes.values()), tuple(axes), (device,) * 8)
        model = LanguageModel(cfg, device=device).init(
            torch.Generator(device=device).manual_seed(0))
        leaves = gradient_leaves(model)
        step = make_manual_dp_train_step(
            model, opt, mesh, schedule=schedule, data_axes=tuple(axes),
            compress_outer=compress)
        step(opt.init(model), batch, init_error_state(model))
        copies, nbytes = expected_copies(schedule, compress, axes, leaves)
        ok &= (mesh.copies, mesh.bytes_copied) == (copies, nbytes)
        print(json.dumps({
            "schedule": schedule + ("+int8" if compress else ""),
            "params": model.param_count(),
            "grad_fp32_bytes": 4 * model.param_count(),
            "collectives": {
                "ppermute": {"bytes": mesh.bytes_copied / mesh.size,
                             "count": mesh.copies / mesh.size},
                "copies_expected": copies / mesh.size,
                "bytes_expected": nbytes / mesh.size,
                "reference_wire_model": wire_model(schedule, compress, axes,
                                                   leaves),
            },
        }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
