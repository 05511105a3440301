"""Single-controller SPMD over a rank mesh: the port's ``shard_map``.

The reference runs its collectives inside ``jax.shard_map``: one process
holds every rank's shard on that rank's device, and ``lax.ppermute`` moves
bytes between them.  This module is the port's counterpart, with no
process, thread or communicator per rank:

* a :class:`Mesh` is a grid of torch devices with named axes.  A device
  may repeat, so 4 or 8 ranks can share one card (or the host), as the
  reference's fake CPU devices share one host;
* a :class:`Sharded` value holds one shard per mesh position, each a
  tensor of its own on its rank's device.  Arithmetic on it is per-rank
  local work: a map over the ranks;
* :func:`ppermute` is the one primitive that moves bytes: each ``(src,
  dst)`` pair copies the source shard into a new allocation on the
  destination's device (a device-to-device copy on one card, a peer copy
  between cards).  A rank that no pair reaches has no value (``None``):
  the reference's ``jnp.where(is_receiver, y, x)`` becomes :func:`where`,
  a per-rank choice that refuses to pick a value that never arrived;
* :func:`shard_map` splits global tensors by :class:`P` specs, calls the
  body once on the sharded values inside the mesh's axis context (for
  :func:`axis_size` / :func:`axis_index`), and assembles the result by
  spec.  An argument already *placed* on the mesh under its spec (a
  :class:`Sharded` that carries that spec, as :class:`NamedSharding`'s
  :meth:`~NamedSharding.place` returns it) passes through without a new
  split, as a ``jax.Array`` already laid out by its sharding does;
* the collectives the model code calls directly (:func:`all_to_all`,
  :func:`psum`, :func:`pmean`, :func:`all_gather`) are built from
  :func:`ppermute`, so the mesh counts their copies too.

A collective acts on every group along its named axis independently: on a
``(p, q)`` mesh a reduction over ``q`` runs once for every ``p``.  An axis
argument may be one name or a tuple of names, taken together in row-major
order, as in jax.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import operator

import numpy as np
import torch

_MESH: contextvars.ContextVar = contextvars.ContextVar("spmd_mesh",
                                                       default=None)


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry per
    tensor dimension, each ``None`` (not split), an axis name, or a tuple
    of axis names (split over their product, row-major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def as_device(device) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA device without an index
    taking the current one (so it compares equal to a tensor's)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A grid of torch devices with one name per grid axis.

    ``devices`` is a nested sequence (or array) of devices or device
    strings whose shape is the mesh's; a device may repeat.  The mesh
    counts what :func:`ppermute` and :func:`gather` copy onto it
    (``copies``, ``bytes_copied``), and apart from those the blocks a
    split by spec allocates (``splits``, ``bytes_split``: what
    :func:`shard_map` and :meth:`NamedSharding.place` cut from a global
    tensor).
    """

    def __init__(self, devices, axis_names):
        grid = np.empty(np.shape(np.array(devices, dtype=object)),
                        dtype=object)
        for pos, dev in np.ndenumerate(np.array(devices, dtype=object)):
            grid[pos] = as_device(dev)
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names) or not grid.size:
            raise ValueError(f"a mesh of shape {grid.shape} needs one name "
                             f"per axis, got {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        self.devices = grid
        self.rank_devices = tuple(grid.flat)    # row-major positions
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.size = grid.size
        self.copies = 0
        self.bytes_copied = 0
        self.splits = 0
        self.bytes_split = 0
        self._groups: dict = {}
        self._index: dict = {}
        self._coords = np.indices(grid.shape).reshape(grid.ndim, -1)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {len(set(self.rank_devices))} device(s))"

    def _axes(self, axis_name) -> tuple:
        axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
        for ax in axes:
            if ax not in self.shape:
                raise NameError(f"unknown axis {ax!r}; the mesh has "
                                f"{self.axis_names}")
        return axes

    def axis_size(self, axis_name) -> int:
        return math.prod(self.shape[ax] for ax in self._axes(axis_name))

    def axis_index(self, axis_name) -> list:
        """Each position's index along ``axis_name`` (row-major over a
        tuple of names)."""
        axes = self._axes(axis_name)
        got = self._index.get(axes)
        if got is None:
            out = np.zeros(self.size, dtype=np.int64)
            for ax in axes:
                d = self.axis_names.index(ax)
                out = out * self.shape[ax] + self._coords[d]
            got = self._index[axes] = out.tolist()
        return got

    def groups(self, axis_name) -> list:
        """The positions of every group along ``axis_name``: one list per
        setting of the other axes, in axis-index order."""
        axes = self._axes(axis_name)
        got = self._groups.get(axes)
        if got is None:
            dims = [self.axis_names.index(ax) for ax in axes]
            flat = np.arange(self.size).reshape(self.devices.shape)
            rest = [d for d in range(flat.ndim) if d not in dims]
            flat = flat.transpose(rest + dims).reshape(
                -1, math.prod(flat.shape[d] for d in dims))
            got = self._groups[axes] = flat.tolist()
        return got

    def copy_to(self, tensor: torch.Tensor, rank: int) -> torch.Tensor:
        """``tensor`` copied into a new allocation on ``rank``'s device
        (never ``tensor`` itself, even on the same device)."""
        out = torch.empty_like(tensor, device=self.rank_devices[rank])
        out.copy_(tensor)
        self.copies += 1
        self.bytes_copied += tensor.numel() * tensor.element_size()
        return out

    def copy_into(self, out: torch.Tensor, tensor: torch.Tensor, *,
                  add: bool = False) -> None:
        """``tensor`` copied (``add``: added) into the view ``out``, which
        lies on another rank's device (or the same card), counted as one
        copy."""
        if add:
            out.add_(tensor)
        else:
            out.copy_(tensor)
        self.copies += 1
        self.bytes_copied += tensor.numel() * tensor.element_size()


def make_mesh(axis_shapes, axis_names, devices) -> Mesh:
    """``jax.make_mesh``: the flat ``devices`` (``prod(axis_shapes)`` of
    them, repeats allowed) laid out row-major on a grid of
    ``axis_shapes``."""
    flat = np.empty(len(devices), dtype=object)
    flat[:] = list(devices)
    if flat.size != math.prod(axis_shapes):
        raise ValueError(f"{flat.size} devices for a mesh of {axis_shapes}")
    return Mesh(flat.reshape(tuple(axis_shapes)), axis_names)


@contextlib.contextmanager
def in_mesh(mesh: Mesh):
    """Make ``mesh`` the one :func:`axis_size` and :func:`axis_index` read
    (:func:`shard_map` does this around its body)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> Mesh:
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("no mesh: call inside shard_map or spmd.in_mesh")
    return mesh


def axis_size(axis_name) -> int:
    """The size of ``axis_name`` (a name or a tuple of names) in the
    current mesh."""
    return current_mesh().axis_size(axis_name)


def axis_index(axis_name) -> "Sharded":
    """Each rank's index along ``axis_name`` in the current mesh."""
    mesh = current_mesh()
    return Sharded(mesh, mesh.axis_index(axis_name))


def _lift(op):
    def method(self, other):
        return self.map(op, other)
    return method


class Sharded:
    """One value per mesh position (``shards``, row-major), each a tensor
    on its rank's device, a per-rank Python value (an index, a flag), or
    ``None`` where a :func:`ppermute` round delivered nothing.

    Operators map over the ranks; a rank where an operand is ``None``
    gets ``None``.
    """

    __slots__ = ("mesh", "shards", "spec")
    __hash__ = None

    def __init__(self, mesh: Mesh, shards, spec: "P | None" = None):
        shards = list(shards)
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{mesh.size} positions")
        self.mesh = mesh
        self.shards = shards
        # the spec of a global value this one is placed as (None: the
        # per-rank values of a body, no global value)
        self.spec = spec

    @property
    def sharding(self) -> "NamedSharding":
        """The :class:`NamedSharding` of a placed value."""
        if self.spec is None:
            raise AttributeError("a per-rank value has no sharding; "
                                 "place it with NamedSharding.place")
        return NamedSharding(self.mesh, self.spec)

    @property
    def global_shape(self) -> tuple:
        """The shape of the global value a placed one holds."""
        shape = list(self.shape)
        for dim, entry in enumerate(self.sharding.spec):
            if entry is not None:
                shape[dim] *= self.mesh.axis_size(entry)
        return tuple(shape)

    def map(self, fn, *others) -> "Sharded":
        """``fn`` on each rank's shard (and the same rank's shard of every
        :class:`Sharded` in ``others``; other values as they are)."""
        columns = [o.shards if isinstance(o, Sharded) else [o] * self.mesh.size
                   for o in others]
        out = [None if any(a is None for a in args) else fn(*args)
               for args in zip(self.shards, *columns)]
        return Sharded(self.mesh, out)

    def _first(self):
        return next(s for s in self.shards if s is not None)

    @property
    def shape(self) -> tuple:
        """The local shape (of the first rank holding a value)."""
        return tuple(self._first().shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self):
        return self._first().dtype

    # what the schedules and the shard_map GEMM write, per rank
    __add__ = _lift(operator.add)
    __sub__ = _lift(operator.sub)
    __truediv__ = _lift(operator.truediv)
    __matmul__ = _lift(operator.matmul)
    __mod__ = _lift(operator.mod)
    __floordiv__ = _lift(operator.floordiv)
    __and__ = _lift(operator.and_)
    __eq__ = _lift(operator.eq)
    __lt__ = _lift(operator.lt)


def per_rank(tree, mesh: Mesh) -> Sharded:
    """A dict / list / tuple of :class:`Sharded` leaves as one
    :class:`Sharded` whose shard on each rank is the tree of that rank's
    shards (what a body hands to a per-rank function of a whole tree)."""
    def at(t, r):
        if isinstance(t, dict):
            return {k: at(v, r) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(at(v, r) for v in t)
        return t.shards[r]

    return Sharded(mesh, [at(tree, r) for r in range(mesh.size)])


def where(cond: Sharded, a: Sharded, b: Sharded) -> Sharded:
    """Per rank, ``a``'s shard where ``cond`` holds, else ``b``'s; raises
    if the chosen shard is ``None`` (a value that never arrived)."""
    out = []
    for r, c in enumerate(cond.shards):
        pick = (a if c else b).shards[r]
        if pick is None:
            raise RuntimeError(f"rank {r} chose a value no round delivered")
        out.append(pick)
    return Sharded(cond.mesh, out)


def ppermute(x: Sharded, axis_name, perm) -> Sharded:
    """Within every group along ``axis_name``, copy the shard of each
    pair's source into a new allocation on its destination's device; the
    other ranks of the result hold ``None``.  ``perm`` is ``lax.ppermute``'s:
    ``(src, dst)`` axis indices, no source and no destination twice."""
    mesh = x.mesh
    n = mesh.axis_size(axis_name)
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= i < n for i in srcs + dsts)):
        raise ValueError(f"ppermute: {perm} is not a permutation of "
                         f"indices of an axis of {n}")
    out = [None] * mesh.size
    for group in mesh.groups(axis_name):
        for s, d in perm:
            shard = x.shards[group[s]]
            if shard is None:
                raise RuntimeError(f"ppermute: rank {group[s]} has no value "
                                   f"to send")
            out[group[d]] = mesh.copy_to(shard, group[d])
    return Sharded(mesh, out)


# -- shard_map ----------------------------------------------------------------

def _spec_slices(mesh: Mesh, spec: P, shape, rank: int) -> tuple:
    """The index of ``rank``'s block of a global ``shape`` under ``spec``."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the rank of "
                         f"shape {tuple(shape)}")
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            out.append(slice(None))
            continue
        n = mesh.axis_size(entry)
        if shape[dim] % n:
            raise ValueError(f"dimension {dim} of shape {tuple(shape)} does "
                             f"not split over {entry!r} ({n} ways)")
        size = shape[dim] // n
        i = mesh.axis_index(entry)[rank]
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def _split(mesh: Mesh, spec: P, value) -> Sharded:
    """``value`` split by ``spec``: a new allocation per rank on its
    device (not a :func:`ppermute`: counted in ``mesh.splits``, not in
    ``mesh.copies``).  A value already placed on ``mesh`` under ``spec``
    passes through as it is; one placed otherwise is assembled and split
    again."""
    if isinstance(value, Sharded):
        if value.mesh is mesh and value.spec == spec:
            return value
        value = _assemble(value.mesh, value.sharding.spec, value)
    shards = []
    for r, dev in enumerate(mesh.rank_devices):
        block = value[_spec_slices(mesh, spec, value.shape, r)]
        shard = torch.empty(block.shape, dtype=block.dtype, device=dev)
        shards.append(shard.copy_(block))
        mesh.splits += 1
        mesh.bytes_split += block.numel() * block.element_size()
    return Sharded(mesh, shards, spec)


def block_ranks(mesh: Mesh, spec: P) -> list:
    """The ranks that hold the distinct blocks of a value placed under
    ``spec``: those at index 0 along every axis the spec leaves unnamed
    (the others hold replicas of their blocks)."""
    named = set()
    for entry in spec:
        if entry is not None:
            named.update(entry if isinstance(entry, tuple) else (entry,))
    unnamed = [d for d, ax in enumerate(mesh.axis_names) if ax not in named]
    return [r for r in range(mesh.size)
            if not any(mesh._coords[d][r] for d in unnamed)]


def _assemble(mesh: Mesh, spec: P, value: Sharded, *,
              counted: bool = False) -> torch.Tensor:
    """The global tensor whose blocks are ``value``'s shards; along axes
    ``spec`` does not name, the shard at index 0 (the value is taken to be
    replicated there, as ``check_vma=False`` takes it).  ``counted``: each
    block's copy counts in ``mesh.copies``."""
    shape = list(value.shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            shape[dim] *= mesh.axis_size(entry)
    out = torch.empty(shape, dtype=value.dtype, device=mesh.rank_devices[0])
    for r in block_ranks(mesh, spec):
        shard = value.shards[r]
        if shard is None:
            raise RuntimeError(f"shard_map: rank {r} has no output")
        view = out[_spec_slices(mesh, spec, shape, r)]
        if counted:
            mesh.copy_into(view, shard)
        else:
            view.copy_(shard)
    return out


def _tree_map(fn, spec, value):
    """``fn(spec leaf, value leaf)`` over a spec tree of dicts, lists and
    tuples with :class:`P` leaves and the value tree it mirrors."""
    if isinstance(spec, P):
        return fn(spec, value)
    if isinstance(spec, dict):
        return {k: _tree_map(fn, spec[k], value[k]) for k in value}
    if isinstance(spec, (list, tuple)):
        if len(spec) != len(value):
            raise ValueError(f"{len(spec)} specs for {len(value)} values")
        return type(value)(_tree_map(fn, s, v) for s, v in zip(spec, value))
    raise TypeError(f"not a partition spec: {spec!r}")


def shard_map(f, *, mesh: Mesh, in_specs, out_specs,
              check_vma: bool | None = None, check_rep: bool | None = None):
    """``jax.shard_map`` on a :class:`Mesh`: the returned function splits
    each global tensor argument by its spec in ``in_specs`` (one spec for
    all arguments, or one spec tree per argument), calls ``f`` once on the
    :class:`Sharded` values inside the mesh's axis context, and assembles
    ``f``'s result by ``out_specs`` onto the mesh's first device.

    An argument placed on ``mesh`` under its spec passes through without
    a copy.  ``check_vma`` / ``check_rep`` are accepted and ignored (no
    check)."""
    del check_vma, check_rep

    def call(*args):
        specs = ((in_specs,) * len(args) if isinstance(in_specs, P)
                 else tuple(in_specs))
        sharded = _tree_map(lambda s, v: _split(mesh, s, v), specs,
                            tuple(args))
        with in_mesh(mesh):
            out = f(*sharded)
        return _tree_map(lambda s, v: _assemble(mesh, s, v), out_specs, out)

    return call


class NamedSharding:
    """``jax.sharding.NamedSharding``: a :class:`Mesh` and a :class:`P`.
    :meth:`place` lays a global tensor out by it (one new allocation per
    rank, on the rank's device), :meth:`assemble` gathers a placed value
    back into one tensor on the mesh's first device."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    __hash__ = None

    def place(self, value) -> Sharded:
        """``value`` (a tensor, or a value placed elsewhere) placed by
        this sharding; a value placed by it already is returned as it
        is."""
        return _split(self.mesh, self.spec, value)

    def assemble(self, value: Sharded) -> torch.Tensor:
        """The global tensor of a value placed by this sharding."""
        return _assemble(self.mesh, self.spec, value)

    def index(self, shape, rank: int) -> tuple:
        """The slices of ``rank``'s block of a global ``shape`` (one
        entry of ``jax.sharding.Sharding.devices_indices_map``)."""
        return _spec_slices(self.mesh, self.spec, tuple(shape), rank)


def assemble(value):
    """The global tensor of a placed :class:`Sharded` (anything else as it
    is): ``np.asarray`` of a sharded ``jax.Array``, on the mesh's first
    device."""
    if isinstance(value, Sharded):
        return value.sharding.assemble(value)
    return value


def gather(value: Sharded) -> torch.Tensor:
    """:func:`assemble` with each distinct block's copy counted in
    ``mesh.copies`` (:func:`block_ranks`: one copy a block)."""
    return _assemble(value.mesh, value.sharding.spec, value, counted=True)


# -- the collectives the model code calls directly ---------------------------

def all_to_all(x: Sharded, axis_name, split_axis: int, concat_axis: int,
               *, tiled: bool = True) -> Sharded:
    """``lax.all_to_all(..., tiled=True)``: within every group along
    ``axis_name`` (``n`` ranks), rank ``i`` cuts its shard into ``n``
    blocks along ``split_axis`` and sends block ``j`` to rank ``j``; rank
    ``j`` concatenates the blocks it receives along ``concat_axis`` in the
    senders' order.  ``n - 1`` :func:`ppermute` rounds (round ``t``: every
    rank to the rank ``t`` ahead), so ``n (n - 1)`` copies a group; a
    rank's own block is not copied.  The copies carry gradients."""
    if not tiled:
        raise NotImplementedError("all_to_all: only the tiled form")
    mesh = x.mesh
    n = mesh.axis_size(axis_name)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dimension {split_axis} of {x.shape} "
                         f"does not split {n} ways")
    idx = mesh.axis_index(axis_name)
    blocks = x.map(lambda t: torch.tensor_split(t, n, split_axis))
    got = [[None] * n for _ in range(mesh.size)]
    for r in range(mesh.size):
        got[r][idx[r]] = blocks.shards[r][idx[r]]
    for t in range(1, n):
        send = Sharded(mesh, [b[(i + t) % n]
                              for b, i in zip(blocks.shards, idx)])
        recv = ppermute(send, axis_name, [(i, (i + t) % n) for i in range(n)])
        for r in range(mesh.size):
            got[r][(idx[r] - t) % n] = recv.shards[r]
    return Sharded(mesh, [torch.cat(g, concat_axis) for g in got])


def psum(x: Sharded, axis_name) -> Sharded:
    """``lax.psum`` over ``axis_name`` (a name or a tuple of names): the
    ring all-reduce of :func:`repro_torch.core.lowering.ring_allreduce`
    (a reduce-scatter and an all-gather, as XLA lowers ``psum``), so every
    rank ends with the same bits."""
    from .lowering import ring_allreduce
    return ring_allreduce(x, axis_name)


def pmean(x: Sharded, axis_name) -> Sharded:
    """``lax.pmean``: :func:`psum` over the axes' ranks."""
    n = x.mesh.axis_size(axis_name)
    return psum(x, axis_name) / n


def all_gather(x: Sharded, axis_name, *, axis: int = 0,
               tiled: bool = False) -> Sharded:
    """``lax.all_gather``: every rank of a group gets every rank's shard
    in axis-index order, stacked on a new dimension ``axis`` (``tiled``:
    concatenated along ``axis``), over ``n - 1`` ring rounds; the dtype
    is the shard's, so int8 codes travel as int8."""
    from .lowering import _ring_all_gather
    join = torch.cat if tiled else torch.stack
    return _ring_all_gather(x, axis_name).map(lambda ch: join(ch, axis))


__all__ = ["Mesh", "NamedSharding", "P", "Sharded", "all_gather",
           "all_to_all", "as_device", "assemble", "axis_index", "axis_size",
           "block_ranks", "current_mesh", "gather", "in_mesh", "make_mesh",
           "per_rank", "pmean",
           "ppermute",
           "psum", "shard_map", "where"]
