"""Serving example on PyTorch: batched prefill + KV-cache decode with the
port's LM stack (``examples/serve_lm.py``'s counterpart).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch recurrentgemma_9b
    PYTHONPATH=src python examples/torch_serve_lm.py --cpu --arch gemma_7b
    PYTHONPATH=src python examples/torch_serve_lm.py --cpu \
        --arch seamless_m4t_medium

Builds the reduced configuration of any of the ten architectures (as the
reference's example does) from a seeded ``torch.Generator``, prefills a
random prompt batch through ``make_prefill_step`` (attention and the
RG-LRU scan through the hand-written kernels on the card), handing it the
encoder's frames or the image patches where the model takes them (shaped
by ``data.pipeline``'s batch specs, drawn from a seed), then decodes
greedily through ``make_decode_step``.  Without a GPU, and without
``--cpu``, it stops with a message.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.data import make_batch_specs  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.train import make_decode_step, make_prefill_step  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host instead of the GPU")
    parser.add_argument("--arch", default="recurrentgemma_9b")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--prompt-len", type=int, default=16)
    parser.add_argument("--tokens", type=int, default=32)
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("torch_serve_lm: no GPU (torch.cuda.is_available() is false); "
              "pass --cpu to run on the host", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if args.cpu else "cuda")

    cfg = configs.get(args.arch).reduced()
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    # the specs' sequence counts the image patches, which come first
    n_img = cfg.vision_tokens if cfg.frontend == "vision" else 0
    specs = make_batch_specs(cfg, n_img + args.prompt_len, args.batch)
    s_max = n_img + args.prompt_len + args.tokens
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, specs["tokens"].shape)).to(dev)
    extras = {name: torch.from_numpy(rng.normal(size=spec.shape).astype(
        np.float32)).to(dev, spec.dtype)
        for name, spec in specs.items() if name in ("frames", "pixels")}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    logits, states = make_prefill_step(model, s_max=s_max)(prompt, **extras)
    sync()
    t_prefill = time.perf_counter() - t0

    step = make_decode_step(model)
    token = logits[:, -1, :].argmax(dim=-1, keepdim=True)
    out_tokens = [token]
    t0 = time.perf_counter()
    for t in range(args.tokens - 1):
        logits, states = step(states, token, n_img + args.prompt_len + t)
        token = logits[:, -1, :].argmax(dim=-1, keepdim=True)
        out_tokens.append(token)
    sync()
    t_decode = time.perf_counter() - t0

    gen = torch.cat(out_tokens, dim=1).cpu()
    tput = args.batch * (args.tokens - 1) / max(t_decode, 1e-9)
    front = ", ".join(f"{k} {tuple(v.shape)}" for k, v in extras.items())
    print(f"arch={cfg.name} on {dev}: prefill {args.prompt_len} toks"
          f"{f' with {front}' if front else ''} in {t_prefill * 1e3:.0f} "
          f"ms; decoded {args.tokens} toks/seq at {tput:.1f} tok/s (batch "
          f"{args.batch})")
    print("sample:", gen[0, :16].tolist())
    assert gen.shape == (args.batch, args.tokens)
    assert bool(torch.isfinite(logits).all())
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
