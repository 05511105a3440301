"""LanguageModel — ``repro/models/model.py`` in PyTorch: one substrate for
all ten architectures (decoder-only, encoder-decoder, and the stub front
ends: audio frames into the encoder, vision patch embeddings prepended to
the token sequence).

The model is an ``nn.Module`` that holds its parameters under the
reference's dict paths: ``emb``, ``ln_f``, ``lm_head`` (untied heads),
``groups.<g>.b<i>.<sublayer>.<name>`` for the ``g``-th repeat of the block
pattern (the reference stacks these along a leading axis and scans over
them; the port loops over the groups), ``tail.<i>...`` for the remainder
layers, and for an encoder-decoder ``enc.groups...``, ``enc.tail...`` and
``enc.ln_f``.  Construction allocates uninitialised storage on its device
(the card unless the caller asks for another; ``"meta"`` allocates
nothing); :meth:`init` draws every parameter from a ``torch.Generator``
on that device, one sublayer at a time;
:func:`repro_torch.models.weights.carry_params` loads the reference's
parameters instead.

Training: :meth:`forward` runs under autograd (the parameters take a
gradient once a trainer calls ``requires_grad_(True)``), each pattern
group under ``torch.utils.checkpoint`` with ``remat`` (the reference's
``jax.checkpoint(..., nothing_saveable)``); :meth:`loss` is the
reference's cross-entropy over full float32 logits plus 0.01 times the
mixture-of-experts balance loss summed over the decoder's blocks.
Attention and the RG-LRU scan go through the kernels' entry points, whose
backwards are the backward kernel and one more scan-kernel launch on the
card.

Serving: :meth:`prefill` runs the prompt (and the encoder's frames, or the
image patches before it) through every block (attention through the
flash-attention entry point, the RG-LRU scan through the linear-scan entry
point) and returns the last token's logits and the decode states;
:meth:`decode_step` advances one token against them in plain PyTorch.
Both run under ``torch.no_grad()``.  States are nested like the
reference's, with the groups as a list: ``{"groups": [{"b0": state, ...},
...] or None, "tail": [...]}``, a decoder block's state a ``{"self",
"cross"}`` pair in an encoder-decoder.

A model placed at rest under a sharding policy
(:func:`repro_torch.sharding.placement.place_model`, ``model.placement``)
holds ``meta`` placeholders: every pass gathers the embedding, final norm
and head for its length, and each pattern group's (or tail block's)
weights just before the group runs, inside the checkpointed group under
remat.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.constraints import (current_policy, shard_act,
                                              use_policy)
from repro_torch.sharding.placement import placement_of

from . import blocks
from .layers import Params, dense_init, init_rmsnorm, rmsnorm


def _dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _stack(cfg, dt, device, n_layers: int, *, cross: bool):
    """The pattern groups (a list of ``{"b<i>": Block}``) and the tail
    blocks of a stack of ``n_layers``."""
    period = cfg.pattern_period
    groups = nn.ModuleList(
        nn.ModuleDict({f"b{i}": blocks.Block(kind, cfg, dt, device,
                                             cross=cross)
                       for i, kind in enumerate(cfg.block_pattern)})
        for _ in range(n_layers // period))
    tail = nn.ModuleList(blocks.Block(kind, cfg, dt, device, cross=cross)
                         for kind in cfg.block_pattern[:n_layers % period])
    return groups, tail


class LanguageModel(Params):
    """The stack of ``cfg``, for training and serving.

    ``device`` defaults to the card; with no CUDA device that raises
    rather than falling back to the CPU.

    ``meter=True`` is the reference's meter mode, for the dry run's
    counts (:mod:`repro_torch.launch.dryrun`): every full-sequence
    attention (training, prefill, the encoder, cross-attention) computes
    the materialised oracle ``kernels.flash_attention.ref.attention``, the
    RG-LRU scan its plain chunked version, and prefill leaves the chunked
    path, so the step launches no kernel on any device and a FLOP counter
    sees every product as an op.  The reference's meter mode also unrolls
    its scans over the layer groups (``unroll=``); the port's layers are
    modules that a Python loop runs one by one, so it has nothing to
    unroll.  A default model launches the kernels as ever.
    """

    def __init__(self, cfg, *, device=None, meter: bool = False):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LanguageModel: no CUDA device "
                               "(torch.cuda.is_available() is false); pass "
                               "device='cpu' to run on the host")
        dt = _dtype_of(cfg)

        def init(generator, dev):
            emb = torch.randn((cfg.vocab_size, cfg.d_model),
                              generator=generator, device=dev)
            p = {"emb": emb.mul_(0.02).to(dt),
                 "ln_f": init_rmsnorm(cfg.d_model, dt, dev)}
            del emb
            if not cfg.tie_embeddings:
                p["lm_head"] = dense_init(generator, cfg.d_model,
                                          cfg.vocab_size, dt, device=dev)
            return p

        super().__init__(init, device)
        self.cfg = cfg
        self.dtype = dt
        self.meter = meter
        self.placement = None
        self.groups, self.tail = _stack(cfg, dt, device, cfg.n_layers,
                                        cross=cfg.encoder_layers > 0)
        if cfg.encoder_layers:
            self.enc = Params(lambda g, dev: {
                "ln_f": init_rmsnorm(cfg.d_model, dt, dev)}, device)
            self.enc.groups, self.enc.tail = _stack(
                cfg, dt, device, cfg.encoder_layers, cross=False)

    @property
    def device(self) -> torch.device:
        placement = placement_of(self)
        if placement is not None:
            return placement.device
        return self._parameters["emb"].device

    def _gathered(self, module, *, recurse: bool = True):
        """Within the block, a placed model's ``module`` holds its
        gathered parameters (:meth:`repro_torch.sharding.placement.
        Placement.installed`); a model holding them whole runs as it
        is."""
        placement = placement_of(self)
        if placement is None:
            return contextlib.nullcontext()
        return placement.installed(module, recurse=recurse)

    def _own(self):
        """The embedding, final norm and head (and an encoder's final
        norm) gathered for the block."""
        stack = contextlib.ExitStack()
        stack.enter_context(self._gathered(self, recurse=False))
        if self.cfg.encoder_layers:
            stack.enter_context(self._gathered(self.enc, recurse=False))
        return stack

    def init(self, generator: torch.Generator) -> "LanguageModel":
        """Draw every parameter from ``generator`` (on the model's
        device); returns the model."""
        return self.reset(generator)

    def param_count(self) -> int:
        """The elements of every weight matrix: what
        ``ModelConfig.param_count()`` counts analytically (it leaves out
        the norm scales, biases, the RG-LRU's ``lam`` and ``conv_b`` and
        the xLSTM blocks' ``skip`` and ``b_gates``)."""
        return sum(p.numel() for p in self.parameters() if p.dim() >= 2)

    def layers(self):
        """(block, kind) for every layer of the decoder, in depth order."""
        pattern = self.cfg.block_pattern
        for group in self.groups:
            for i, kind in enumerate(pattern):
                yield group[f"b{i}"], kind
        for i, blk in enumerate(self.tail):
            yield blk, pattern[i]

    # ------------------------------------------------------------------
    # embedding, stacks, head
    # ------------------------------------------------------------------
    def embed(self, tokens: torch.Tensor,
              extra_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """Token embeddings, with ``extra_embeds`` (vision patches)
        prepended along the sequence."""
        x = self["emb"][tokens]
        if self.cfg.emb_scale:
            # a Python float keeps the embeddings' dtype, as jax's weak
            # typing does
            x = x * math.sqrt(self.cfg.d_model)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        return shard_act(x, "residual")

    def _group(self, group: nn.ModuleDict, x: torch.Tensor, memory_h,
               causal: bool, chunked: bool):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        with self._gathered(group):
            for i, kind in enumerate(self.cfg.block_pattern):
                x, a = blocks.apply_block(group[f"b{i}"], x, kind, self.cfg,
                                          causal=causal, memory_h=memory_h,
                                          chunked=chunked, meter=self.meter)
                aux = aux + a
        return x, aux

    def _group_under(self, policy, group, x, memory_h, causal, chunked):
        # the recomputation of a checkpointed group runs in the backward,
        # on the autograd engine's thread for a card: it takes the policy
        # the forward ran under, as the reference's remat replays the
        # code it traced (and, on a placed model, gathers the group's
        # weights again)
        with use_policy(policy):
            return self._group(group, x, memory_h, causal, chunked)

    def _run_stack(self, stack, x: torch.Tensor, *, causal: bool = True,
                   memory_h=None, remat: bool = True, chunked: bool = False):
        """``(x, aux summed over the stack's blocks)``.  With ``remat`` and
        grad mode on, each pattern group runs under
        ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
        group's inputs and runs the group again in the backward, as the
        reference's ``jax.checkpoint`` with ``nothing_saveable`` does; the
        tail layers are not checkpointed, as in the reference."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for group in stack.groups:
            if remat and torch.is_grad_enabled():
                x, a = checkpoint(self._group_under, current_policy(), group,
                                  x, memory_h, causal, chunked,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = self._group(group, x, memory_h, causal, chunked)
            aux = aux + a
        pattern = self.cfg.block_pattern
        for i, blk in enumerate(stack.tail):
            with self._gathered(blk):
                x, a = blocks.apply_block(blk, x, pattern[i], self.cfg,
                                          causal=causal, memory_h=memory_h,
                                          chunked=chunked, meter=self.meter)
            aux = aux + a
        return x, aux

    def _encode(self, frames: torch.Tensor, *, remat: bool,
                chunked: bool = False) -> torch.Tensor:
        """The encoder's final-norm hidden states of ``frames`` (B, S_enc,
        d), non-causal; its blocks' aux is dropped, as the reference's
        forward drops it."""
        enc_x = shard_act(frames.to(self.dtype), "residual")
        enc_x, _ = self._run_stack(self.enc, enc_x, causal=False,
                                   remat=remat, chunked=chunked)
        return rmsnorm(enc_x, self.enc["ln_f"], self.cfg.norm_eps)

    def hidden_and_aux(self, tokens: torch.Tensor, *, frames=None,
                       pixels=None, remat: bool = True):
        """``(final-norm hidden states (B, S, d), MoE aux loss)``: the
        reference's ``forward``.  ``frames``: the encoder's input
        embeddings (encoder-decoder); ``pixels``: patch embeddings
        prepended to the tokens (vision), so S counts them."""
        with self._own():
            memory_h = None
            if self.cfg.encoder_layers:
                memory_h = self._encode(frames, remat=remat)
            x = self.embed(tokens, pixels)
            x, aux = self._run_stack(self, x, causal=True,
                                     memory_h=memory_h, remat=remat)
            return rmsnorm(x, self["ln_f"], self.cfg.norm_eps), aux

    def forward(self, tokens: torch.Tensor, *, frames=None, pixels=None,
                remat: bool = True) -> torch.Tensor:
        """Final-norm hidden states (B, S, d) of ``tokens`` (B, S): the
        first of the reference's ``(hidden, aux)``
        (:meth:`hidden_and_aux` gives both).

        Runs under autograd when grad mode is on, each pattern group under
        ``torch.utils.checkpoint`` with ``remat``."""
        return self.hidden_and_aux(tokens, frames=frames, pixels=pixels,
                                   remat=remat)[0]

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        with self._own():
            head = (self["emb"].T if self.cfg.tie_embeddings
                    else self["lm_head"])
            return hidden @ head

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------
    def loss(self, batch: dict, *, n_chunks: int = 8, remat: bool = True):
        """The reference's LM cross-entropy: ``batch`` holds ``tokens`` and
        ``labels`` (B, S), label -1 masked, and ``frames`` / ``pixels``
        where the model takes them (the image positions carry no loss).
        Returns ``(loss, {"nll", "aux", "tokens"})`` with ``loss = nll +
        0.01 aux``, ``aux`` the MoE balance loss summed over the decoder's
        blocks (0 without experts).

        The logits are the full (B, S, V) product cast to float32, as the
        reference's are; ``n_chunks`` is kept for the reference's signature
        and ignored, as it is there."""
        del n_chunks
        pixels = batch.get("pixels")
        with self._own():
            hidden, aux = self.hidden_and_aux(
                batch["tokens"], frames=batch.get("frames"), pixels=pixels,
                remat=remat)
            logits = self.logits(hidden).float()
        labels = batch["labels"]
        if pixels is not None:
            pad = torch.full(pixels.shape[:2], -1, dtype=labels.dtype,
                             device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        mask = labels >= 0
        y_safe = torch.where(mask, labels, 0).long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y_safe[..., None])[..., 0]
        nll_sum = torch.where(mask, logz - gold, 0.0).sum()
        n_tok = mask.sum()
        nll = nll_sum / torch.clamp(n_tok, min=1)
        total = nll + 0.01 * aux
        return total, {"nll": nll, "aux": aux, "tokens": n_tok}

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def init_states(self, batch: int, s_max: int, *,
                    enc_len: int = 0) -> dict:
        """Zero decode states laid out like :meth:`prefill`'s (with
        ``enc_len``, each block's encoder cache beside its own state)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device

        def state(kind):
            return blocks.init_block_state(kind, cfg, batch, s_max, dt, dev,
                                           enc_len=enc_len)

        return {
            "groups": ([{f"b{i}": state(kind)
                         for i, kind in enumerate(cfg.block_pattern)}
                        for _ in range(cfg.n_groups)]
                       if cfg.n_groups else None),
            "tail": [state(kind) for kind in cfg.tail_pattern],
        }

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, s_max: int, frames=None,
                pixels=None):
        """Run the prompt ``tokens`` (B, S) (after the image patches
        ``pixels``; against the encoder's ``frames``), returning (the last
        token's logits (B, 1, V), decode states with room for ``s_max``
        positions, patches included).  Attention takes the chunked path,
        whose chunk check (S % min(512, S) == 0 and S % min(1024, S) == 0)
        is the reference's, in the encoder too."""
        cfg = self.cfg
        pattern = cfg.block_pattern
        with self._own():
            memory_h = None
            if cfg.encoder_layers:
                memory_h = self._encode(frames, remat=False,
                                        chunked=not self.meter)
            x = self.embed(tokens, pixels)
            states = {"groups": [] if cfg.n_groups else None, "tail": []}
            kw = dict(memory_h=memory_h, return_state=True, s_max=s_max,
                      chunked=not self.meter, meter=self.meter)
            for group in self.groups:
                st = {}
                with self._gathered(group):
                    for i, kind in enumerate(pattern):
                        x, _, st[f"b{i}"] = blocks.apply_block(
                            group[f"b{i}"], x, kind, cfg, **kw)
                states["groups"].append(st)
            for i, blk in enumerate(self.tail):
                with self._gathered(blk):
                    x, _, st = blocks.apply_block(blk, x, pattern[i], cfg,
                                                  **kw)
                states["tail"].append(st)
            # the norm is per position: normalising the last one alone
            # gives the reference's values without the full (B, S, d) pass
            x = rmsnorm(x[:, -1:, :], self["ln_f"], cfg.norm_eps)
            return self.logits(x), states

    @torch.no_grad()
    def decode_step(self, states: dict, token: torch.Tensor, pos: int):
        """token: (B, 1) integers; pos: the position it takes.  Returns
        (logits (B, 1, V), states); the KV caches are written in place."""
        cfg = self.cfg
        pattern = cfg.block_pattern
        with self._own():
            x = self["emb"][token]
            if cfg.emb_scale:
                x = x * math.sqrt(cfg.d_model)
            new_groups = [] if states.get("groups") is not None else None
            for group, st in zip(self.groups, states.get("groups") or ()):
                new_st = {}
                with self._gathered(group):
                    for i, kind in enumerate(pattern):
                        x, new_st[f"b{i}"] = blocks.apply_block_decode(
                            group[f"b{i}"], x, st[f"b{i}"], kind, pos, cfg)
                new_groups.append(new_st)
            new_tail = []
            for i, blk in enumerate(self.tail):
                with self._gathered(blk):
                    x, s2 = blocks.apply_block_decode(
                        blk, x, states["tail"][i], pattern[i], pos, cfg)
                new_tail.append(s2)
            x = rmsnorm(x, self["ln_f"], cfg.norm_eps)
            return self.logits(x), {"groups": new_groups, "tail": new_tail}
