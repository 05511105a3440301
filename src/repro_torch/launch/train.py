"""End-to-end training launcher — ``repro/launch/train.py`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma_9b --reduced --steps 200 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_7b \
        --reduced --steps 3 --cpu

The reference's flags, on the card unless ``--cpu`` asks for the host
(with no card and no ``--cpu`` it stops with exit code 1 and a message).
The model draws its weights from a ``torch.Generator`` seeded with
``--seed``; AdamW with ``warmup_cosine``; batches from
``SyntheticLMDataset``, with the encoder's frames (``--seq`` /
``encoder_ratio`` of them) or the image patches where the model takes
them; every 10th step and the last print ``[train] {json}`` (appended to
``--log-file`` as a JSON line), and ``--metrics-out`` gets ``{"final":
...}``.

With ``--ckpt-dir`` the parameters and the optimizer state are saved
through :class:`repro_torch.ckpt.CheckpointManager` after every
``--ckpt-every``-th step (asynchronously) and after the last (blocking);
with ``--resume auto`` (the default) a run that finds a checkpoint there
restores it, prints ``[train] resumed from step N`` and goes on from step
N + 1.  ``--heartbeat`` names a file touched after every step (the
:class:`repro_torch.runtime.Supervisor`'s liveness signal), and
``--crash-at-step N`` ends the process with exit code 42 when step N is
reached (the fault-injection hook; a checkpoint still being written is
finished first, so the crash always follows the last save's step).  The
parameters are restored into the model in place and the optimizer state
replaced, so a resumed run takes the same steps as an uninterrupted one.

``--fake-devices N`` (2 or more) trains on N ranks that share the card
(the host with ``--cpu``), as the reference's N fake CPU devices share
one host.  ``--grad-sync tree|ring|hierarchical`` takes the explicit
data-parallel step on a ``("data",)`` mesh of N ranks
(:func:`repro_torch.train.step.make_manual_dp_train_step`); ``implicit``
(the default) takes :func:`repro_torch.sharding.make_policy` of
``make_host_mesh(N // --mesh-model, --mesh-model)`` and the policy's
step: the parameters, the AdamW masters and both moments rest as per-rank
shards (flat FSDP, the experts on the model axis), each layer group's
weights are gathered whole as it runs, the activations stay whole on the
first rank's device, and the mixture-of-experts layers run per rank.
Checkpoints hold the global arrays either way (placed state is assembled
on save and placed again on resume).  With one device the reference reads
neither ``--mesh-model`` nor ``--grad-sync`` (it builds a mesh or a
manual gradient sync only when ``len(jax.devices()) > 1``), and neither
does the port: it trains as without them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host instead of the GPU")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", choices=("auto", "never"), default="auto")
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="N ranks sharing the card (the host with --cpu); "
                         "under --grad-sync implicit the parameters and "
                         "the optimizer state rest as per-rank shards, the "
                         "activations whole on the first rank")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model-axis size when fake devices are used")
    ap.add_argument("--grad-sync", default="implicit",
                    choices=("implicit", "tree", "ring", "hierarchical"))
    ap.add_argument("--crash-at-step", type=int, default=None,
                    help="fault-injection hook for the integration test")
    ap.add_argument("--metrics-out", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from repro_torch import configs
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.supervisor import touch_heartbeat
    from repro_torch.sharding import make_policy
    from repro_torch.train.step import (init_error_state,
                                        make_manual_dp_train_step,
                                        make_train_step)

    if not args.cpu and not torch.cuda.is_available():
        print("repro_torch.launch.train: no GPU (torch.cuda.is_available() "
              "is false); pass --cpu to run on the host", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if args.cpu else "cuda")

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(args.seed))
    optimizer = AdamW(
        learning_rate=warmup_cosine(args.lr, args.warmup, args.steps))
    data = SyntheticLMDataset(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        enc_len=(args.seq // cfg.encoder_ratio if cfg.encoder_layers else 0),
        d_model=cfg.d_model if (cfg.encoder_layers or cfg.frontend) else 0,
        vision_tokens=cfg.vision_tokens if cfg.frontend == "vision" else 0,
        device=dev)
    n_dev = max(args.fake_devices, 1)
    policy = manual_step = err = None
    if args.grad_sync != "implicit" and n_dev > 1:
        manual_step = make_manual_dp_train_step(
            model, optimizer, make_host_mesh(n_dev, device=dev),
            schedule=args.grad_sync)
        err = init_error_state(model)
    elif n_dev > 1:
        policy = make_policy(make_host_mesh(
            n_dev // args.mesh_model, args.mesh_model, device=dev))
    step_fn = make_train_step(model, optimizer, policy) \
        if manual_step is None else None
    # under a policy the model is placed now: its state is placed with it
    opt_state = optimizer.init(model)
    placement = model.placement
    params = (placement.params if placement is not None
              else dict(model.named_parameters()))

    start_step = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume == "auto" and ckpt.latest_step() is not None:
        if placement is not None:
            sh = placement.shardings
            (saved, opt_state), extra = ckpt.restore(
                (params, opt_state),
                shardings=(sh, type(opt_state)(sh, sh, sh,
                                               policy.replicated())))
            placement.load(saved)
        else:
            (saved, opt_state), extra = ckpt.restore((params, opt_state))
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(saved[name])
        del saved
        start_step = int(extra["step"]) + 1
        print(f"[train] resumed from step {start_step - 1}", flush=True)

    log_f = open(args.log_file, "a") if args.log_file else None
    final_metrics = {}
    try:
        for step in range(start_step, args.steps):
            if args.crash_at_step is not None and step == args.crash_at_step:
                print(f"[train] injected crash at step {step}", flush=True)
                if ckpt:
                    # the hook crashes between steps, after the writes of
                    # the steps before it: on a fast card an async save
                    # a few steps back would still be in flight
                    ckpt.wait()
                os._exit(42)
            batch = data.batch_at(step)
            if manual_step is not None:
                opt_state, loss, err = manual_step(opt_state, batch, err)
                metrics = {"loss": loss}
            else:
                opt_state, metrics = step_fn(opt_state, batch)
            if args.heartbeat:
                touch_heartbeat(args.heartbeat)
            if ckpt and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step, (params, opt_state), extra={"step": step})
            if step % 10 == 0 or step == args.steps - 1:
                final_metrics = {k: float(v) for k, v in metrics.items()}
                line = json.dumps({"step": step, **final_metrics})
                print(f"[train] {line}", flush=True)
                if log_f:
                    log_f.write(line + "\n")
                    log_f.flush()
    finally:
        if log_f:
            log_f.close()
    if ckpt:
        ckpt.save(args.steps - 1, (params, opt_state),
                  extra={"step": args.steps - 1}, block=True)
        ckpt.wait()
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"final": final_metrics}, f)
    print("[train] done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
