"""Serving example on PyTorch: batched prefill + KV-cache decode with the
port's LM stack (``examples/serve_lm.py``'s counterpart).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch recurrentgemma_9b
    PYTHONPATH=src python examples/torch_serve_lm.py --cpu --arch gemma_7b

Builds the reduced configuration (as the reference's example does) from a
seeded ``torch.Generator``, prefills a random prompt batch through
``make_prefill_step`` (attention and the RG-LRU scan through the
hand-written kernels on the card), then decodes greedily through
``make_decode_step``.  Without a GPU, and without ``--cpu``, it stops with
a message.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import configs  # noqa: E402
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
    s_max = args.prompt_len + args.tokens
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    logits, states = make_prefill_step(model, s_max=s_max)(prompt)
    sync()
    t_prefill = time.perf_counter() - t0

    step = make_decode_step(model)
    token = logits[:, -1, :].argmax(dim=-1, keepdim=True)
    out_tokens = [token]
    t0 = time.perf_counter()
    for t in range(args.tokens - 1):
        logits, states = step(states, token, args.prompt_len + t)
        token = logits[:, -1, :].argmax(dim=-1, keepdim=True)
        out_tokens.append(token)
    sync()
    t_decode = time.perf_counter() - t0

    gen = torch.cat(out_tokens, dim=1).cpu()
    tput = args.batch * (args.tokens - 1) / max(t_decode, 1e-9)
    print(f"arch={cfg.name} on {dev}: prefill {args.prompt_len} toks in "
          f"{t_prefill * 1e3:.0f} ms; decoded {args.tokens} toks/seq at "
          f"{tput:.1f} tok/s (batch {args.batch})")
    print("sample:", gen[0, :16].tolist())
    assert gen.shape == (args.batch, args.tokens)
    assert bool(torch.isfinite(logits).all())
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
