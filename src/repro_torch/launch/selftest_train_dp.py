"""Multi-rank self-test: explicit-DP training (tree / ring / hierarchical
grad-sync schedules, and hierarchical with the pod hop int8-compressed) is
numerically equivalent to single-stream training.

    python -m repro_torch.launch.selftest_train_dp [--device cpu]

8 ranks share the card (``--device cpu``: the host); gemma reduced; 8 × 32
tokens; 3 AdamW steps.  The paper's binary tree, the ring and the
pod-aware hierarchical schedule must each give the parameters of running
the whole batch on one stream within the reference's bounds (2e-4; the
compressed run 5e-2 relative / 5e-3 absolute, its error-feedback
residual below 1), and every rank's replica must be rank 0's bit for bit.
Prints ``OK``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.spmd import make_mesh
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.selftest_collectives import rank_devices
from repro_torch.models import LanguageModel
from repro_torch.optim import AdamW
from repro_torch.train.step import (init_error_state,
                                    make_manual_dp_train_step,
                                    make_train_step)

STEPS = 3
RUNS = (("tree", (8,), ("data",), False),
        ("ring", (8,), ("data",), False),
        ("hierarchical", (2, 4), ("pod", "data"), False),
        ("compressed", (2, 4), ("pod", "data"), True))


def tree_allclose(got: dict, want: dict, rtol, atol, msg) -> None:
    for name, p in got.items():
        np.testing.assert_allclose(
            p.detach().float().cpu().numpy(),
            want[name].detach().float().cpu().numpy(),
            rtol=rtol, atol=atol, err_msg=f"{msg}: {name}")


def main(argv=None) -> int:
    devices = rank_devices(argv, __doc__)
    dev = devices[0]
    cfg = configs.get("gemma_7b").reduced()
    opt = AdamW(learning_rate=1e-3)
    data = SyntheticLMDataset(cfg.vocab_size, seq_len=32, global_batch=8,
                              device=dev)

    def fresh():
        return LanguageModel(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))

    # reference: the whole batch on one stream
    ref = fresh()
    step = make_train_step(ref, opt)
    state = opt.init(ref)
    for s in range(STEPS):
        state, _ = step(state, data.batch_at(s))
    want = dict(ref.named_parameters())

    for name, shape, axes, compress in RUNS:
        model = fresh()
        mesh = make_mesh(shape, axes, devices)
        step = make_manual_dp_train_step(
            model, opt, mesh, schedule="hierarchical" if compress else name,
            data_axes=axes, compress_outer=compress)
        state, err = opt.init(model), init_error_state(model)
        for s in range(STEPS):
            state, loss, err = step(state, data.batch_at(s), err)
            for p in step.params.values():
                assert all(torch.equal(t, p.shards[0]) for t in p.shards), \
                    f"{name}: ranks differ after step {s}"
        got = dict(model.named_parameters())
        if compress:
            # int8 compression is approximate: a looser bound
            tree_allclose(got, want, 5e-2, 5e-3, "compressed")
            for e in err.values():
                assert float(e.shards[0].abs().max()) < 1.0
        else:
            tree_allclose(got, want, 2e-4, 2e-4, f"schedule={name}")
        print(f"schedule={name} OK loss={float(loss):.4f}", flush=True)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
