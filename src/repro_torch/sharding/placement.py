"""Placement at rest: a model's parameters as per-rank shards under a
sharding policy — what the reference's partitioner does when its
``make_train_step(policy)``, ``lower_prefill`` and ``lower_decode`` pin
the parameters to ``policy.tree_param_shardings`` (``repro/train/step.py``
``jit_with``, ``repro/launch/dryrun.py``).

:func:`place_model` splits every parameter of a
:class:`~repro_torch.models.model.LanguageModel` by its
:class:`~repro_torch.core.spmd.NamedSharding` (one allocation per rank,
:meth:`NamedSharding.place`) and frees the whole storage: the module keeps
a ``meta`` placeholder of each parameter's shape and dtype, and
``model.placement`` (a :class:`Placement`) holds the shards, ``{name:
Sharded}``.  A leaf the policy replicates (under ``min_shard_elems``
elements, or 1-D) has a copy on every rank, as the reference's has.

The model's activations stay whole on the mesh's first device: the ranks
share one card, so a sequence or batch split would cut every op into
per-rank launches and change no value.  So a layer group's weights are
gathered whole just before the group runs (:meth:`Placement.installed`,
one counted copy a distinct block, :func:`repro_torch.core.spmd.gather`)
and dropped after it; under remat the gather sits inside the checkpointed
group, so the backward's recompute gathers again, as the reference's
remat'd body does.  The gather is a ``torch.autograd.Function``: its
backward casts the whole gradient to the step's ``grad_dtype`` (the
reference's ``grad_reduce_dtype``), records the leaf's norm on that
whole gradient (:attr:`Placement.norms`, so the global norm of AdamW's
clip is summed in the policy-free order) and hands each rank its block,
a counted copy: the reduce-scatter into the shards, a split because the
gradient that reaches the whole tensor is already the full sum.

A mixture of experts' weights are not gathered whole: the layer gets a
:class:`Resting` leaf and takes it on its ``shard_map``'s in-spec
(:meth:`Resting.on`, the expert dim on the model axis), which is the
placement at rest itself where the at-rest spec names no other axis of
more than one rank (no copy), else a gather over those axes.

Every copy goes through the mesh, so it counts in ``Mesh.copies`` /
``bytes_copied``; placing splits count in ``Mesh.splits``.  Nothing falls
back: a placement that does not fit raises, and a placed parameter read
outside a gather is a ``meta`` tensor, which no kernel takes.

A model rests by one placement, chosen in one place: :func:`place_model`
places an unplaced model and raises for one placed otherwise, so placing
it again is always the caller's :func:`unplace` first.  The steps built
on a placement check at every call that the model still rests by it
(:func:`check_placement`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from repro_torch.core import spmd
from repro_torch.core.spmd import NamedSharding, Sharded


def _is_resting(name: str) -> bool:
    """A mixture of experts' weights stay placed when the layer uses them
    (the layer takes them on its own spec)."""
    return "experts" in name.split(".")


def _site(model: nn.Module, name: str):
    *path, key = name.split(".")
    module = model
    for part in path:
        module = module._modules[part]
    return module, key


def same_blocks(a: NamedSharding, b: NamedSharding, shape) -> bool:
    """Whether every rank holds the same block of a global ``shape`` under
    ``a`` as under ``b`` (an axis of one rank splits nothing)."""
    def blocks(sharding, r):
        return [sl.indices(d)[:2]
                for sl, d in zip(sharding.index(shape, r), shape)]

    return all(blocks(a, r) == blocks(b, r) for r in range(a.mesh.size))


def same_place(a: NamedSharding, b: NamedSharding, shape) -> bool:
    """Whether ``a`` and ``b`` lay a global ``shape`` out alike: ranks on
    the same devices, each holding the same block (two meshes built alike
    are one layout)."""
    return (tuple(a.mesh.rank_devices) == tuple(b.mesh.rank_devices)
            and same_blocks(a, b, shape))


class Resting:
    """A placed leaf handed to the layer that takes it per rank."""

    __slots__ = ("placement", "name")

    def __init__(self, placement: "Placement", name: str):
        self.placement = placement
        self.name = name

    def whole(self) -> torch.Tensor:
        """The global tensor on the mesh's first device (a gather)."""
        return self.placement.whole(self.name)

    def on(self, spec, mesh) -> Sharded:
        """The leaf placed by ``spec`` on ``mesh`` (the placement's, or
        one of the same devices)."""
        return self.placement.on(self.name, spec, mesh)


class _Gather(torch.autograd.Function):
    """Forward: the whole leaf from its shards.  Backward: the
    gradient's blocks to the shards (:meth:`Placement.scatter`)."""

    @staticmethod
    def forward(ctx, placement, name, *shards):
        ctx.placement, ctx.name = placement, name
        return spmd.gather(placement.params[name])

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *ctx.placement.scatter(ctx.name, grad))


class _Reshard(torch.autograd.Function):
    """Forward: the leaf's per-rank blocks under another spec.  Backward:
    every rank's block gradient summed into the whole gradient (ranks in
    order), then :meth:`Placement.scatter`."""

    @staticmethod
    def forward(ctx, placement, name, target, *shards):
        ctx.placement, ctx.name, ctx.target = placement, name, target
        return tuple(placement._reshard(name, target).shards)

    @staticmethod
    def backward(ctx, *grads):
        placement, name = ctx.placement, ctx.name
        value = placement.params[name]
        mesh = value.mesh
        dtype = next(g.dtype for g in grads if g is not None)
        whole = torch.zeros(value.global_shape, dtype=dtype,
                            device=mesh.rank_devices[0])
        for r, g in enumerate(grads):
            if g is not None:
                mesh.copy_into(whole[ctx.target.index(whole.shape, r)], g,
                               add=True)
        return (None, None, None, *placement.scatter(name, whole))


class Placement:
    """A model's parameters at rest: :attr:`params` ``{name: Sharded}``
    placed by :attr:`shardings` ``{name: NamedSharding}`` on one mesh.

    :attr:`grad_dtype` (``None``: the parameters' own) is the dtype a
    gradient is cast to before its scatter; :attr:`norms` holds each
    leaf's float32 gradient norm taken on the whole gradient by the last
    backward (cleared by :meth:`zero_grad`)."""

    def __init__(self, model: nn.Module, shardings: dict):
        meshes = {id(s.mesh): s.mesh for s in shardings.values()}
        if len(meshes) != 1:
            raise ValueError(f"placement over {len(meshes)} meshes; a "
                             f"model is placed on one")
        self.mesh = next(iter(meshes.values()))
        self.shardings = dict(shardings)
        self.params: dict = {}
        self.grad_dtype = None
        self.norms: dict = {}
        self._sites: dict = {}
        self._holes: dict = {}
        self._names: dict = {}
        named = dict(model.named_parameters())
        missing = set(named) ^ set(self.shardings)
        if missing:
            raise ValueError(f"no sharding for, or no parameter of, "
                             f"{sorted(missing)[:4]}")
        for name in list(named):
            # one whole leaf alive beside the shards at a time
            p = named.pop(name)
            module, key = _site(model, name)
            placed = self.shardings[name].place(p.detach())
            for t in placed.shards:
                t.requires_grad_(p.requires_grad)
            self.params[name] = placed
            hole = nn.Parameter(torch.empty(p.shape, dtype=p.dtype,
                                            device="meta"),
                                requires_grad=False)
            module._parameters[key] = hole
            self._sites[name] = (module, key)
            self._holes[name] = hole
            del p, placed

    # -- what rests where -----------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.mesh.rank_devices[0]

    def requires_grad_(self, flag: bool = True) -> "Placement":
        for value in self.params.values():
            for t in value.shards:
                t.requires_grad_(flag)
        return self

    def rank_bytes(self) -> list:
        """Each rank's resident bytes of the placed parameters."""
        out = [0] * self.mesh.size
        for value in self.params.values():
            for r, t in enumerate(value.shards):
                out[r] += t.numel() * t.element_size()
        return out

    @torch.no_grad()
    def assembled(self) -> dict:
        """``{name: the global tensor}`` on the mesh's first device."""
        return {n: spmd.assemble(v) for n, v in self.params.items()}

    @torch.no_grad()
    def load(self, tree: dict) -> None:
        """Copy ``tree`` (``{name: global tensor or placed value}``) into
        the shards where they lie."""
        for name, value in self.params.items():
            new = self.shardings[name].place(tree[name])
            for t, s in zip(value.shards, new.shards):
                t.copy_(s)

    # -- gathers --------------------------------------------------------------
    def whole(self, name: str) -> torch.Tensor:
        """Leaf ``name`` gathered whole on the mesh's first device; under
        autograd its gradient reaches the shards (:class:`_Gather`)."""
        value = self.params[name]
        if torch.is_grad_enabled() and value.shards[0].requires_grad:
            return _Gather.apply(self, name, *value.shards)
        return spmd.gather(value)

    def _reshard(self, name: str, target: NamedSharding) -> Sharded:
        value = self.params[name]
        if same_blocks(self.shardings[name], target, value.global_shape):
            return Sharded(target.mesh, value.shards, target.spec)
        whole = spmd.gather(value)
        shape = whole.shape
        return Sharded(target.mesh, [
            self.mesh.copy_to(whole[target.index(shape, r)], r)
            for r in range(self.mesh.size)], target.spec)

    def on(self, name: str, spec, mesh) -> Sharded:
        """Leaf ``name`` placed by ``spec`` on ``mesh`` (the placement's,
        or one whose ranks lie on the same devices): its shards
        themselves where the blocks are the same (no copy), else gathered
        and handed out (counted copies); under autograd the gradient
        reaches the shards (:class:`_Reshard`)."""
        if tuple(mesh.rank_devices) != tuple(self.mesh.rank_devices):
            raise ValueError(f"{name}: rests on {self.mesh!r}, asked for on "
                             f"{mesh!r}, whose ranks lie elsewhere")
        target = NamedSharding(mesh, spec)
        value = self.params[name]
        if torch.is_grad_enabled() and value.shards[0].requires_grad:
            shards = _Reshard.apply(self, name, target, *value.shards)
            return Sharded(mesh, shards, target.spec)
        return self._reshard(name, target)

    def scatter(self, name: str, grad: torch.Tensor) -> list:
        """Each rank's block of ``grad`` (leaf ``name``'s whole gradient,
        cast to :attr:`grad_dtype`), a counted copy each; records the
        leaf's norm on the cast whole gradient."""
        if self.grad_dtype is not None:
            grad = grad.to(self.grad_dtype)
        norm = torch.linalg.vector_norm(grad, dtype=torch.float32)
        # a leaf reached twice in one backward has no one whole gradient
        self.norms[name] = None if name in self.norms else norm
        sharding = self.shardings[name]
        return [self.mesh.copy_to(grad[sharding.index(grad.shape, r)], r)
                for r in range(self.mesh.size)]

    def rests_by(self, shardings: dict) -> bool:
        """Whether every leaf rests as ``shardings`` (``{name:
        NamedSharding}``) would place it (:func:`same_place`)."""
        return set(shardings) == set(self.shardings) and all(
            same_place(self.shardings[n], s, self.params[n].global_shape)
            for n, s in shardings.items())

    def zero_grad(self) -> None:
        self.norms = {}
        for value in self.params.values():
            for t in value.shards:
                t.grad = None

    def grad_norms(self) -> list:
        """Each leaf's float32 gradient norm, in parameter order: the
        whole gradient's where one backward recorded it, else over its
        distinct blocks' gradients (zero for a leaf without one)."""
        out = []
        for name, value in self.params.items():
            norm = self.norms.get(name)
            if norm is None:
                blocks = [value.shards[r].grad for r in
                          spmd.block_ranks(self.mesh, value.spec)]
                parts = [torch.linalg.vector_norm(
                    g if self.grad_dtype is None else g.to(self.grad_dtype),
                    dtype=torch.float32) for g in blocks if g is not None]
                norm = (torch.linalg.vector_norm(torch.stack(parts)) if parts
                        else torch.zeros((), dtype=torch.float32,
                                         device=self.device))
            out.append(norm)
        return out

    # -- installing the gathered leaves --------------------------------------
    def _module_names(self, module: nn.Module, recurse: bool) -> list:
        key = (id(module), recurse)
        got = self._names.get(key)
        if got is None:
            mods = set(map(id, module.modules() if recurse else (module,)))
            got = self._names[key] = [n for n, (m, _) in self._sites.items()
                                      if id(m) in mods]
        return got

    @contextlib.contextmanager
    def installed(self, module: nn.Module, *, recurse: bool = True):
        """Within the block, ``module``'s parameters (its own only without
        ``recurse``) are their gathered whole tensors (a mixture of
        experts' weights: :class:`Resting` leaves); after it, the
        placeholders again.  A leaf installed by an enclosing block is
        left as it is."""
        done = []
        try:
            for name in self._module_names(module, recurse):
                mod, key = self._sites[name]
                if mod._parameters[key] is not self._holes[name]:
                    continue
                mod._parameters[key] = (Resting(self, name)
                                        if _is_resting(name)
                                        else self.whole(name))
                done.append(name)
            yield self
        finally:
            for name in done:
                mod, key = self._sites[name]
                mod._parameters[key] = self._holes[name]


def placement_of(model):
    """``model``'s :class:`Placement`, or ``None`` when it holds its
    parameters whole."""
    return getattr(model, "placement", None)


def place_model(model: nn.Module, shardings) -> Placement:
    """Place ``model``'s parameters at rest by ``shardings`` (``{name:
    NamedSharding}``, or a policy, whose ``tree_param_shardings`` gives
    them); returns ``model.placement``.

    A model rests by one placement.  One placed alike already
    (:meth:`Placement.rests_by`) is left as it is; one placed otherwise
    raises: placing it again is the caller's :func:`unplace` and then
    this, a whole copy of the weights on the way, and every step built on
    the old placement refuses to run after it."""
    if hasattr(shardings, "tree_param_shardings"):
        shardings = shardings.tree_param_shardings(model)
    current = placement_of(model)
    if current is not None:
        if current.rests_by(shardings):
            return current
        raise ValueError("place_model: the model rests by other shardings; "
                         "unplace(model) first to place it again")
    placement = Placement(model, shardings)
    model.placement = placement
    return placement


def check_placement(model: nn.Module, placement) -> None:
    """Raise unless ``model`` rests by ``placement`` (``None``: whole), the
    placement a step was built on."""
    if placement_of(model) is not placement:
        raise RuntimeError("the model was placed or unplaced since this "
                           "step was built; build the step again")


@torch.no_grad()
def unplace(model: nn.Module) -> None:
    """Give a placed ``model`` its whole parameters back (assembled on the
    mesh's first device) and drop its placement."""
    placement = placement_of(model)
    if placement is None:
        return
    for name, value in placement.params.items():
        mod, key = placement._sites[name]
        mod._parameters[key] = nn.Parameter(
            spmd.assemble(value),
            requires_grad=value.shards[0].requires_grad)
    model.placement = None


__all__ = ["Placement", "Resting", "check_placement", "place_model",
           "placement_of", "same_blocks", "same_place", "unplace"]
