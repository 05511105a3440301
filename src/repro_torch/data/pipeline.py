"""Deterministic, skip-ahead data pipeline — ``repro/data/pipeline.py`` in
PyTorch.

``batch_at(step)`` is a pure function of (seed, step): the reference's
NumPy generator makes the same Zipf-weighted token stream with its learnable
bigram structure, bit for bit, and the batch is handed over as tensors on
the dataset's device (the card unless the caller names another; with no
card and no such request it raises).  Tokens and labels are int32, as the
reference's are; the stub front ends' frames and pixels are float32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("SyntheticLMDataset: no CUDA device "
                           "(torch.cuda.is_available() is false); pass "
                           "device='cpu' to make batches on the host")
    return dev


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # stub-frontend extras
    enc_len: int = 0
    d_model: int = 0
    vision_tokens: int = 0
    device: Optional[str | torch.device] = None

    def _tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        # Zipf unigram base
        base = rng.zipf(1.3, size=(b, s + 1)) % v
        # deterministic bigram structure: t+1 = (t*7 + 13) % v with
        # probability ~0.7 -> learnable signal
        follow = (base * 7 + 13) % v
        use = rng.random((b, s + 1)) < 0.7
        toks = base.copy()
        toks[:, 1:] = np.where(use[:, 1:], follow[:, :-1], base[:, 1:])
        return toks.astype(np.int32)

    def batch_at(self, step: int) -> dict:
        """``{"tokens", "labels"}`` (B, S) int32 (labels are the tokens one
        step ahead), plus ``"frames"`` / ``"pixels"`` (float32) when the
        stub front ends ask for them, on the dataset's device."""
        dev = _device(self.device)
        toks = self._tokens(step)
        batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
        rng = np.random.default_rng((self.seed + 1, step))
        if self.enc_len:
            batch["frames"] = torch.from_numpy(
                rng.normal(size=(self.global_batch, self.enc_len,
                                 self.d_model)).astype(np.float32)).to(dev)
        if self.vision_tokens:
            batch["pixels"] = torch.from_numpy(
                rng.normal(size=(self.global_batch, self.vision_tokens,
                                 self.d_model)).astype(np.float32)).to(dev)
        return batch


class BatchSpec(NamedTuple):
    """The shape and dtype of one model input: what the reference's
    ``jax.ShapeDtypeStruct`` says, without jax."""
    shape: tuple
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def make_batch_specs(cfg, seq_len: int, global_batch: int) -> dict:
    """:class:`BatchSpec` for every model input at a given cell shape (the
    reference's allocation-free stand-ins)."""
    fdt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    specs = {
        "tokens": BatchSpec((global_batch, seq_len), torch.int32),
        "labels": BatchSpec((global_batch, seq_len), torch.int32),
    }
    if cfg.encoder_layers:
        specs["frames"] = BatchSpec(
            (global_batch, max(seq_len // cfg.encoder_ratio, 1), cfg.d_model),
            fdt)
    if cfg.frontend == "vision":
        # seq budget includes the image tokens: text = seq_len - vision
        text = (global_batch, seq_len - cfg.vision_tokens)
        specs["tokens"] = BatchSpec(text, torch.int32)
        specs["labels"] = BatchSpec(text, torch.int32)
        specs["pixels"] = BatchSpec(
            (global_batch, cfg.vision_tokens, cfg.d_model), fdt)
    return specs
