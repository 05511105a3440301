"""Mixture-of-Experts layer: sort-based token dispatch into a fixed-capacity
(E, C, d) buffer — ``repro/models/moe.py`` in PyTorch.

Each token's router picks its top-k experts; the (token, slot) pairs are
sorted by expert id (a *stable* sort, so within an expert the earlier
token comes first), each expert takes its first C pairs and the rest drop
(Switch-style), and the k expert outputs of a token are summed back with
their router weights.  Capacity ``C = ceil(T k / E * capacity_factor)``
(at least 4) for a full sequence and ``C = T`` for a decode step, so no
token drops mid-generation.

With no policy (or one without a model axis) the layer runs
:func:`_moe_tokens_local` on every token.  Under a
:class:`~repro_torch.sharding.policy.ShardingPolicy` it runs a
``shard_map`` over the policy's rank mesh, each rank on its shard of the
tokens (batch over the data axes, sequence over the model axis), with the
capacity of its ``t_loc`` tokens, so a shard drops the tokens the
reference's shard drops.  Expert parallelism (``moe_mode="ep"``, the
experts dividing over the model axis): each rank holds ``E / n`` experts,
and an ``all_to_all`` before the expert FFN and one after it exchange the
token buffers; otherwise every rank holds every expert.  The balance loss
is the ``pmean`` of the ranks'.

On a model placed at rest (:mod:`repro_torch.sharding.placement`) the
expert weights stay placed by their leaf spec, the expert dim on the model
axis: expert parallelism takes them on its in-spec without a split (a
gather over the other axes where the spec names one of more than one
rank), every other path gathers them whole.

The expert FFN is three batched products, which the reference leaves to
XLA's ``einsum`` outside any kernel: here ``torch.bmm``.  The combine is
deterministic: the reference's ``.at[token_idx].add`` would be a
scatter-add with float atomics on the card, so two served runs could
differ in their bits; the port gathers each token's k weighted expert
outputs into (T, k, d) and sums over k in a fixed order (ROADMAP Queue 3).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import spmd
from repro_torch.core.spmd import P
from repro_torch.sharding.constraints import current_policy
from repro_torch.sharding.placement import Resting


def init_router(generator, cfg, device) -> dict:
    """The router, (d, E), float32 in every model dtype (the reference's
    ``init_moe`` casts it so)."""
    w = torch.randn((cfg.d_model, cfg.n_experts), generator=generator,
                    device=device)
    return {"router": w.mul_(1.0 / math.sqrt(cfg.d_model))}


def init_experts(generator, cfg, dtype, device) -> dict:
    """The experts' stacked SwiGLU weights: ``w_gate``, ``w_up`` (E, d,
    ff) and ``w_down`` (E, ff, d)."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff

    def draw(shape, scale):
        w = torch.randn(shape, generator=generator, device=device)
        return w.mul_(scale).to(dtype)

    return {"w_gate": draw((E, d, ff), 1.0 / math.sqrt(d)),
            "w_up": draw((E, d, ff), 1.0 / math.sqrt(d)),
            "w_down": draw((E, ff, d), 1.0 / math.sqrt(ff))}


def init_moe(generator, cfg, dtype, device) -> dict:
    """The reference's parameter tree: ``{"router", "experts": {...}}``."""
    return {**init_router(generator, cfg, device),
            "experts": init_experts(generator, cfg, dtype, device)}


def _capacity(t_local: int, cfg) -> int:
    c = math.ceil(t_local * cfg.n_experts_active / cfg.n_experts
                  * cfg.capacity_factor)
    return max(4, c)


def _dispatch(x: torch.Tensor, top_i: torch.Tensor, top_w: torch.Tensor,
              E: int, C: int):
    """Build the (E, C, d) buffer and the combine metadata ``(slot,
    token_idx, w, valid)`` from local tokens ``x`` (T, d)."""
    T, d = x.shape
    k = top_i.shape[1]
    flat_e = top_i.reshape(-1)                          # (T*k,)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=x.device,
                                                      dtype=sorted_e.dtype))
    pos = torch.arange(T * k, device=x.device) - first[sorted_e]
    valid = pos < C
    slot = torch.where(valid, sorted_e * C + pos, E * C)  # E*C: trash row
    token_idx = sort_idx // k
    # the token each buffer row holds, T for an empty row (a zero row
    # appended to x); the trash row E*C takes every dropped pair, in no
    # defined order, and is cut off, so no value depends on that order.
    # One gather fills the buffer: the reference's scatter of x[token_idx]
    # times valid, value for value, in fewer passes over it
    src = torch.full((E * C + 1,), T, dtype=token_idx.dtype,
                     device=x.device)
    src[slot] = token_idx
    buf = torch.cat([x, x.new_zeros((1, d))])[src[:E * C]]
    meta = (slot, token_idx, top_w.reshape(-1)[sort_idx], valid)
    return buf.reshape(E, C, d), meta


def _combine(expert_out: torch.Tensor, meta, T: int) -> torch.Tensor:
    """Each token's k expert outputs, weighted and summed: the reference's
    scatter-add without atomics.  A stable sort on the token index puts
    each token's k pairs side by side in the order the reference's
    scatter adds them (its experts' ids ascending); the sum over them runs
    in that fixed order, so the bits do not depend on scheduling."""
    E, C, d = expert_out.shape
    slot, token_idx, w, valid = meta
    order = torch.argsort(token_idx, stable=True)
    flat = torch.cat([expert_out.reshape(E * C, d),
                      expert_out.new_zeros((1, d))])
    vals = flat[slot[order]] * (w * valid).to(expert_out.dtype)[order, None]
    return vals.reshape(T, -1, d).sum(dim=1)


def _expert_ffn(experts, buf: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    """(E, C, d) × expert weights -> (E, C, d)."""
    gate = torch.bmm(buf, experts["w_gate"])
    act = F.silu(gate) if mlp_kind == "swiglu" else F.gelu(
        gate, approximate="tanh")
    h = act * torch.bmm(buf, experts["w_up"])
    return torch.bmm(h, experts["w_down"])


def _route(p, x: torch.Tensor, cfg):
    """``(top_i, top_w, aux)``: each token's top-k experts and their
    renormalised weights, and the Switch-style load-balance loss.

    ``lax.top_k`` breaks ties toward the lower index, ``torch.topk`` in no
    stated order; a float32 router makes ties between experts' probabilities
    vanishingly rare, so the port does not sort to force the order.  The
    order of a token's k slots does not decide which tokens drop (the
    dispatch sort is stable on (token, slot) and a token's experts are
    distinct)."""
    logits = x.float() @ p["router"]                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, cfg.n_experts_active, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # the share of (token, slot) pairs each expert receives is a count,
    # with no gradient; the mean router probability carries the gradient
    # (an exact integer count that also runs on meta tensors, which
    # bincount does not)
    flat = top_i.reshape(-1)
    counts = torch.zeros(cfg.n_experts, dtype=torch.int64,
                         device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    dispatch_frac = counts.float() / (x.shape[0] * cfg.n_experts_active)
    mean_prob = probs.mean(dim=0)
    aux = cfg.n_experts * torch.sum(dispatch_frac * mean_prob)
    return top_i, top_w, aux


def _moe_tokens_local(p, x: torch.Tensor, cfg, C: int):
    """Every expert applied to the local tokens ``x`` (T, d)."""
    top_i, top_w, aux = _route(p, x, cfg)
    buf, meta = _dispatch(x, top_i, top_w, cfg.n_experts, C)
    out = _expert_ffn(p["experts"], buf, cfg.mlp)
    return _combine(out, meta, x.shape[0]), aux


def _moe_tokens_ep(p, x: torch.Tensor, cfg, C: int, axis: str):
    """Expert parallel, inside ``shard_map``: ``p``'s experts are this
    rank's ``E / n``; the token buffers go to their experts' ranks and
    back through :func:`repro_torch.core.spmd.all_to_all`."""
    routed = x.map(lambda xx, pp: _route(pp, xx, cfg), p)
    aux = routed.map(lambda r: r[2])
    disp = x.map(lambda xx, r: _dispatch(xx, r[0], r[1], cfg.n_experts, C),
                 routed)
    # send each expert group to its owner; receive the peers' tokens
    buf = spmd.all_to_all(disp.map(lambda dd: dd[0]), axis, split_axis=0,
                          concat_axis=1)                     # (E/n, n C, d)
    out = buf.map(lambda bb, pp: _expert_ffn(pp["experts"], bb, cfg.mlp), p)
    out = spmd.all_to_all(out, axis, split_axis=1, concat_axis=0)
    y = out.map(lambda oo, dd, xx: _combine(oo, dd[1], xx.shape[0]), disp, x)
    return y, aux


def _params_tree(p, spec=None, mesh=None) -> dict:
    """A MoE sublayer's parameters as the reference's dict.  Expert
    weights at rest (:class:`~repro_torch.sharding.placement.Resting`, a
    placed model's) are taken on ``spec`` over ``mesh`` (expert
    parallelism: the placement at rest itself where it has the same
    blocks), else gathered whole."""
    def take(w):
        if not isinstance(w, Resting):
            return w
        return w.whole() if spec is None else w.on(spec, mesh)

    return {"router": p["router"],
            "experts": {k: take(p["experts"][k])
                        for k in ("w_gate", "w_up", "w_down")}}


def uses_ep(cfg, policy) -> bool:
    """Whether the layer runs expert-parallel under ``policy``: experts
    split evenly over a model axis of more than one rank."""
    if policy is None or policy.model_axis is None:
        return False
    n = policy.model_size
    return cfg.moe_mode == "ep" and cfg.n_experts % n == 0 and n > 1


def moe_layer(p, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, d) -> ((B, S, d), aux loss).  Capacity ``T`` for a decode
    step (S == 1), :func:`_capacity` else, of the local ``T`` under a
    policy."""
    b, s, d = x.shape
    pol = current_policy()
    if pol is None or pol.model_axis is None:
        t = b * s
        C = t if s == 1 else _capacity(t, cfg)
        y, aux = _moe_tokens_local(_params_tree(p), x.reshape(t, d), cfg, C)
        return y.reshape(b, s, d), aux

    mesh = pol.mesh
    dp = pol.dp_axes if pol.batch_sharded else None
    sp = pol.model_axis if pol.seq_sharded else None
    x_spec = P(dp, sp, None)
    n_model = pol.model_size
    b_loc = b // pol.dp_size if pol.batch_sharded else b
    s_loc = s // n_model if pol.seq_sharded else s
    t_loc = b_loc * s_loc
    C = t_loc if s == 1 else _capacity(t_loc, cfg)
    ep = uses_ep(cfg, pol)
    all_axes = tuple(mesh.axis_names)
    e_one = P(pol.model_axis, None, None)

    if ep:
        # experts at rest are taken on the in-spec: shard_map passes a
        # value placed under it through without a split
        tree = _params_tree(p, e_one, mesh)
        e_spec = {k: e_one for k in tree["experts"]}
        p_spec = {"router": P(None, None), "experts": e_spec}

        def run(pp, xx):
            y, aux = _moe_tokens_ep(spmd.per_rank(pp, mesh),
                                    xx.map(lambda v: v.reshape(t_loc, d)),
                                    cfg, C, pol.model_axis)
            return (y.map(lambda v, v0: v.reshape(v0.shape), xx),
                    spmd.pmean(aux, all_axes))
    else:
        tree = _params_tree(p)
        p_spec = {"router": P(), "experts": {k: P() for k in tree["experts"]}}

        def run(pp, xx):
            out = xx.map(lambda v, pr: _moe_tokens_local(
                pr, v.reshape(t_loc, d), cfg, C), spmd.per_rank(pp, mesh))
            y = out.map(lambda o, v: o[0].reshape(v.shape), xx)
            return y, spmd.pmean(out.map(lambda o: o[1]), all_axes)

    return spmd.shard_map(run, mesh=mesh, in_specs=(p_spec, x_spec),
                          out_specs=(x_spec, P()))(tree, x)

