"""Sharding policy: how every tensor maps onto the rank mesh —
``repro/sharding/policy.py`` over :mod:`repro_torch.core.spmd`'s
:class:`~repro_torch.core.spmd.Mesh` and :class:`~repro_torch.core.spmd.P`.

The scheme and its spec arithmetic are the reference's, line for line:

* **Parameters** — flat FSDP (ZeRO-3): each tensor's largest eligible dim
  is sharded over ``fsdp_axes`` = ("data", "model"), replicated across
  pods; tensors under ``min_shard_elems`` elements and 1-D tensors
  replicate.
* **Activations** — batch over ``dp_axes`` = ("pod", "data"), sequence
  over "model".
* **MoE** — expert dim over "model" when it divides (the expert-parallel
  ``all_to_all`` inside a ``shard_map``), else experts replicated.

The reference's partitioner (GSPMD) places parameters, optimizer state and
activations at rest by these specs.  The port has no partitioner: under a
policy the specs are real where the reference acts explicitly (its
``shard_map`` regions, the decode-state and checkpoint layouts), and
placement at rest stays whole on the mesh's first device.

The port's parameters are per layer (``groups.<g>.b<i>...``) where the
reference stacks the groups on a leading axis.
:meth:`ShardingPolicy.tree_param_shardings` decides each such leaf on its
stacked shape (the element count, divisibility) and drops the leading
entry, so a leaf gets the reference's spec of its layer.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Optional

from repro_torch.core.spmd import Mesh, NamedSharding, P

_GROUP = re.compile(r"^(.*?)groups\.(\d+)\.")


@dataclasses.dataclass
class ShardingPolicy:
    mesh: Mesh
    dp_axes: tuple              # batch axes, outermost first
    model_axis: Optional[str]   # tensor/sequence axis (None -> off)
    fsdp_axes: tuple            # parameter flat-sharding axes
    batch_sharded: bool = True  # False for global_batch=1 (long_500k)
    seq_sharded: bool = True
    # params_tp (decode serving): weights TP-sharded over the model axis
    # (column-parallel in / row-parallel out) + FSDP over data only
    params_tp: bool = False
    # tensors below this many elements replicate
    min_shard_elems: int = 65536

    # -- sizes ------------------------------------------------------------
    @property
    def fsdp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.fsdp_axes)

    @property
    def model_size(self) -> int:
        return self.mesh.shape[self.model_axis] if self.model_axis else 1

    @property
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    # -- activations --------------------------------------------------------
    def activation_spec(self, tag: str, ndim: int) -> Optional[P]:
        dp = self.dp_axes if self.batch_sharded else None
        sp = self.model_axis if self.seq_sharded else None
        if tag == "residual":        # (B, S, d)
            return P(dp, sp, None)
        if tag == "tokens":          # (B, S)
            return P(dp, sp)
        if tag == "kv_gathered":     # (B, KV, S, hd) — gather seq over model
            return P(dp, None, None, None)
        if tag == "seq_gathered":    # (B, S, d) — sLSTM: the whole sequence
            return P(dp, None, None)
        if tag == "ffn_hidden":      # (B, S, ff)
            return P(dp, sp, None)
        if tag == "logits_vp":       # (B, S_chunk, V) vocab-parallel
            return P(dp, None, sp)
        if tag == "logits_seq":      # (B, S, V) seq-sharded, full vocab
            return P(dp, sp, None)
        if tag == "kv_cache":        # (B, KV, S_max, hd) — seq-sharded cache
            return P(dp, None, sp, None)
        if tag == "recurrent_state":  # (B, width) / (B, H, dk, dv)
            return (P(dp, sp) if ndim == 2
                    else P(dp, None, sp, None) if ndim == 4
                    else P(dp, None, sp))
        if tag == "expert_buffer":   # (E, C, d) — EP
            return P(sp, None, None)
        return None

    def activation_sharding(self, tag: str, ndim: int) -> NamedSharding:
        spec = self.activation_spec(tag, ndim)
        return NamedSharding(self.mesh, spec if spec is not None else P())

    # -- parameters -----------------------------------------------------------
    def param_spec(self, shape: tuple, *, stacked: bool = False,
                   expert_dim: Optional[int] = None) -> P:
        """Flat-FSDP: shard the largest dim divisible by the axis product.

        ``stacked`` marks a leading (layer-group) dim that stays
        unsharded; ``expert_dim`` pins MoE expert weights' expert axis to
        the model axis (EP) with FSDP falling back to the remaining axes.
        """
        start = 1 if stacked else 0
        dims = list(range(start, len(shape)))
        spec: list[Any] = [None] * len(shape)
        n_elems = math.prod(shape) if shape else 0
        if len(shape) - start < 2 or n_elems < self.min_shard_elems:
            return P(*spec)          # tiny / 1-D tensors replicate
        if expert_dim is not None and self.model_axis:
            spec[expert_dim] = self.model_axis
            dims.remove(expert_dim)
            axes = tuple(a for a in self.fsdp_axes if a != self.model_axis)
        else:
            axes = self.fsdp_axes
        if axes:
            size = math.prod(self.mesh.shape[a] for a in axes)
            cands = [d for d in dims
                     if shape[d] % size == 0 and shape[d] >= size]
            if cands:
                d = max(cands, key=lambda i: shape[i])
                spec[d] = axes if len(axes) > 1 else axes[0]
            else:
                # fall back to the single largest axis that divides
                for ax in sorted(axes, key=lambda a: -self.mesh.shape[a]):
                    n = self.mesh.shape[ax]
                    cands = [d for d in dims
                             if shape[d] % n == 0 and shape[d] >= n]
                    if cands:
                        d = max(cands, key=lambda i: shape[i])
                        spec[d] = ax
                        break
        return P(*spec)

    def param_sharding(self, shape, **kw) -> NamedSharding:
        return NamedSharding(self.mesh, self.param_spec(shape, **kw))

    # TP placement by weight role: column-parallel projections shard their
    # output dim, row-parallel ones their input dim (Megatron convention)
    _TP_COL = ("wq", "wk", "wv", "w_gate", "w_up", "ffn_up", "w_x", "w_y",
               "w_gates", "w_if", "lm_head")
    _TP_ROW = ("wo", "w_down", "ffn_down", "w_out")

    def _tp_spec(self, keys, shape, stacked: bool):
        """TP serving placement: weights shard over the model axis only
        and stay resident (replicated over data)."""
        last = keys[-1] if keys else ""
        m, n_m = self.model_axis, self.model_size
        o = 1 if stacked else 0
        if len(shape) - o != 2 or m is None:
            return None
        spec: list[Any] = [None] * len(shape)
        if last in self._TP_COL and shape[o + 1] % n_m == 0:
            spec[o + 1] = m
            return P(*spec)
        if last in self._TP_ROW and shape[o] % n_m == 0:
            spec[o] = m
            return P(*spec)
        if last == "emb" and shape[o + 1] % n_m == 0:
            spec[o + 1] = m        # d_model-sharded
            return P(*spec)
        return None

    def leaf_spec(self, keys, shape: tuple, *, stacked: bool) -> P:
        """The reference's spec of one parameter leaf of ``shape`` (the
        stacked shape when ``stacked``) under the path ``keys``."""
        if self.params_tp:
            tp = self._tp_spec(keys, shape, stacked)
            if tp is not None:
                return tp
        expert_dim = None
        if "experts" in keys:
            # expert weights: (..., E, d_in, d_out); expert dim is 0 (or 1
            # when stacked)
            e_ax = 1 if stacked else 0
            if (len(shape) > e_ax
                    and shape[e_ax] % max(self.model_size, 1) == 0
                    and self.model_size > 1):
                expert_dim = e_ax
        return self.param_spec(shape, stacked=stacked, expert_dim=expert_dim)

    def tree_param_shardings(self, tree) -> dict:
        """``{name: NamedSharding}`` for the port's parameters (a module or
        ``{dotted name: tensor}``).  A leaf under ``groups.<g>.`` is decided
        on the shape the reference stacks it to, ``(number of groups,
        *shape)``, and its spec loses that leading entry."""
        named = (dict(tree.named_parameters()) if hasattr(
            tree, "named_parameters") else dict(tree))
        n_groups: dict = {}
        for name in named:
            m = _GROUP.match(name)
            if m:
                n_groups[m.group(1)] = max(n_groups.get(m.group(1), 0),
                                           int(m.group(2)) + 1)
        out = {}
        for name, leaf in named.items():
            keys = name.split(".")
            shape = tuple(leaf.shape)
            m = _GROUP.match(name)
            if m:
                stacked = (n_groups[m.group(1)],) + shape
                spec = P(*self.leaf_spec(keys, stacked, stacked=True)[1:])
            else:
                spec = self.leaf_spec(keys, shape, stacked=False)
            out[name] = NamedSharding(self.mesh, spec)
        return out

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())


def make_policy(mesh: Mesh, *, batch_sharded: bool = True,
                seq_sharded: bool = True, fsdp: bool = True,
                params_tp: bool = False) -> ShardingPolicy:
    """Derive the standard policy from a mesh's axis names."""
    names = mesh.axis_names
    model_axis = "model" if "model" in names else None
    dp = tuple(a for a in names if a in ("pod", "data"))
    fsdp_axes = tuple(a for a in names if a in ("data", "model")) \
        if fsdp else ()
    return ShardingPolicy(mesh=mesh, dp_axes=dp, model_axis=model_axis,
                          fsdp_axes=fsdp_axes, batch_sharded=batch_sharded,
                          seq_sharded=seq_sharded, params_tp=params_tp)
