"""Training example on PyTorch: a small LM for a few hundred steps
(``examples/train_lm.py``'s counterpart).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --cpu --preset tiny --steps 50

The port's stack end to end: config -> model (weights from a seeded
``torch.Generator``) -> AdamW with float32 masters -> the deterministic data
pipeline -> ``make_train_step`` (attention and its backward through the
hand-written kernels on the card).  The loss must fall visibly (the
synthetic corpus has learnable bigram structure); the run writes its loss
curve as JSON to ``--out`` and checkpoints (parameters and optimizer
state) to ``--out``/ckpt every 100 steps and after the last, through
``repro_torch.ckpt.CheckpointManager`` (the reference's format).  Runs on
the GPU; without one, and without ``--cpu``, it stops with a message.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

PRESETS = {
    # ~100M params: 12L d=640 ff=2560 vocab=50304 -> 0.5*emb tied
    "100m": dict(n_layers=12, d_model=640, n_heads=10, n_kv_heads=5,
                 d_ff=2560, vocab_size=50304, head_dim=64),
    "25m": dict(n_layers=8, d_model=320, n_heads=8, n_kv_heads=4,
                d_ff=1280, vocab_size=32000, head_dim=40),
    "tiny": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                 d_ff=256, vocab_size=512, head_dim=16),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host instead of the GPU")
    ap.add_argument("--preset", default="25m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "torch_train_lm_run"))
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("torch_train_lm: no GPU (torch.cuda.is_available() is false); "
              "pass --cpu to run on the host", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if args.cpu else "cuda")

    base = configs.get("h2o_danube_1_8b")      # llama-family base
    cfg = dataclasses.replace(
        base, name=f"example-{args.preset}", window=None,
        block_pattern=("attn",), dtype="float32", tie_embeddings=True,
        **PRESETS[args.preset])
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    print(f"model: {cfg.param_count() / 1e6:.1f}M params on {dev}")

    opt = AdamW(learning_rate=warmup_cosine(args.lr, 20, args.steps))
    data = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch,
                              device=dev)
    opt_state = opt.init(model)
    step_fn = make_train_step(model, opt)
    params = dict(model.named_parameters())
    ckpt = CheckpointManager(os.path.join(args.out, "ckpt"))

    curve = []
    t0 = time.time()
    for step in range(args.steps):
        opt_state, metrics = step_fn(opt_state, data.batch_at(step))
        if step % 10 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            curve.append({"step": step, "loss": loss})
            print(f"step {step:4d} loss {loss:.4f} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)",
                  flush=True)
        if (step + 1) % 100 == 0:
            ckpt.save(step, (params, opt_state), extra={"step": step})
    ckpt.save(args.steps - 1, (params, opt_state),
              extra={"step": args.steps - 1}, block=True)
    print(f"checkpoint: step {ckpt.latest_step()} -> {ckpt.dir}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "loss_curve.json"), "w") as f:
        json.dump(curve, f, indent=1)
    drop = curve[0]["loss"] - curve[-1]["loss"]
    print(f"loss {curve[0]['loss']:.3f} -> {curve[-1]['loss']:.3f} "
          f"(drop {drop:.3f}); curve -> {args.out}/loss_curve.json")
    if not drop > 0.3:
        print("torch_train_lm: the synthetic-corpus loss should fall "
              "measurably", file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
