"""AdamW with float32 master weights — ``repro/optim/adamw.py`` in PyTorch.

State = ``OptState(master, m, v, count)``: float32 copies of the
parameters and the two moments, one tensor per parameter name, and the
step count; the parameters handed to the forward keep their own dtype
(bfloat16 for a bf16 model), so the forward reads half the bytes.

The update runs **in place**: the reference's train step donates the
parameters and the optimizer state (``src/repro/train/step.py:68``), so
XLA updates them in their buffers; here the moments, the master weights
and the parameters are written where they lie, and :meth:`AdamW.update`
returns the same tensors (and a new :class:`OptState` tuple holding them,
with the count advanced).  A caller that keeps an old state must copy it
first.  The gradients are read, never written.

A model placed at rest under a sharding policy
(:mod:`repro_torch.sharding.placement`) gets its state placed the same
way: :meth:`AdamW.init` of it gives each master and moment as a
:class:`~repro_torch.core.spmd.Sharded` value with its parameter's spec,
one float32 shard per rank, and the policy's train step updates them
shard by shard (:meth:`AdamW.update` with the global ``grad_norm`` it
computed on the whole gradients).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.spmd import Sharded


class OptState(NamedTuple):
    master: dict     # name -> float32 copy of the parameter
    m: dict          # name -> float32 first moment
    v: dict          # name -> float32 second moment
    count: int       # updates taken


def named(params) -> dict:
    """``{name: tensor}`` of ``params``: a module's named parameters (a
    placed model's: ``{name: Sharded}``, its shards), or a mapping as it
    is."""
    if isinstance(params, torch.nn.Module):
        placement = getattr(params, "placement", None)
        if placement is not None:
            return dict(placement.params)
        return dict(params.named_parameters())
    return dict(params)


def _each(p, fn):
    """``fn`` of a tensor, or of each shard of a placed value (the result
    placed by the same spec)."""
    if isinstance(p, Sharded):
        return Sharded(p.mesh, [fn(t) for t in p.shards], p.spec)
    return fn(p)


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[int], float] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0

    def init(self, params) -> OptState:
        """Float32 masters (copies, never aliases of the parameters) and
        zero moments on each parameter's device; count 0."""
        ps = named(params)

        def zeros(t):
            return torch.zeros(t.shape, dtype=torch.float32, device=t.device)

        return OptState(
            master={n: _each(p, lambda t: t.detach().to(torch.float32,
                                                         copy=True))
                    for n, p in ps.items()},
            m={n: _each(p, zeros) for n, p in ps.items()},
            v={n: _each(p, zeros) for n, p in ps.items()},
            count=0)

    def _lr(self, count: int) -> float:
        if callable(self.learning_rate):
            return float(self.learning_rate(count))
        return float(np.float32(self.learning_rate))

    @torch.no_grad()
    def update(self, grads, state: OptState, params, *, grad_norm=None):
        """One step on ``grads`` (``{name: tensor}``, any float dtype) for
        ``params`` (a module or ``{name: tensor}``), in place.  Returns
        ``(params, state, {"grad_norm", "lr"})`` as the reference does:
        the global norm of the float32 gradients (a tensor on their
        device) and the step's learning rate (a float).

        As in the reference: the global norm over every gradient in
        float32, clipping to ``grad_clip``, bias correction from the
        count, weight decay on tensors of two or more dimensions only, and
        the parameters cast back from the masters.  ``grad_norm`` gives
        the global norm instead (the shards of a placed model are one
        rank's blocks of the gradients)."""
        ps = named(params)
        gnorm = grad_norm
        if gnorm is None:
            # each gradient cast to float32 one at a time: at most one
            # float32 copy is alive
            norms = [torch.linalg.vector_norm(grads[n], dtype=torch.float32)
                     for n in ps]
            gnorm = torch.linalg.vector_norm(torch.stack(norms))
        scale = None
        if self.grad_clip is not None:
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        count = state.count + 1
        f32 = np.float32
        c1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        c2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        lr = self._lr(count)
        if any(p.is_meta for p in ps.values()):
            # a dry run (repro_torch.launch.dryrun): storage-less tensors
            # have no values to update, and their shapes stay as they are
            return params, state._replace(count=count), {"grad_norm": gnorm,
                                                          "lr": lr}
        for n, p in ps.items():
            g = grads[n].float()
            if scale is not None:
                g = g * scale.to(g.device)
            m, v, master = state.m[n], state.v[n], state.master[n]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            del g
            step = m / c1
            step.div_((v / c2).sqrt_().add_(self.eps))
            if self.weight_decay and master.dim() >= 2:
                step.add_(master, alpha=self.weight_decay)
            master.add_(step, alpha=-lr)
            del step
            p.copy_(master)
        return params, state._replace(count=count), {"grad_norm": gnorm,
                                                      "lr": lr}
