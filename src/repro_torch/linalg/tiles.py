"""Tiled matrices over Bind — the paper's ``tiles<matrix, IB>`` container.

A :class:`Tiled` stores a matrix as an ``mt × nt`` grid of square tiles, each
tile a versioned :class:`~repro_torch.core.trace.BindArray` holding a
contiguous ``IB × IB`` block.  ``subset`` returns a zero-copy *view* (shares
the tile handles), mirroring the paper's ``a.subset(i, j, mt, nt)``;
arithmetic between tile grids records per-tile Bind ops, so a whole Strassen
recursion becomes one transactional DAG.

Tiles keep their matrix's kind: a ``torch.Tensor`` matrix is cut into
tensor tiles on the tensor's device (so a CUDA matrix's workflow runs on the
card, its leaf GEMMs through the hand-written kernel), and a NumPy matrix
into NumPy tiles that stay on the host.  The reference turns every matrix
into NumPy tiles (``np.ascontiguousarray`` in ``from_array``), which would
keep the port's workloads off the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import core as bind
from repro_torch.kernels.gemm import ops as gemm_ops


# -- tile-level ops (the leaves of the DAG) -----------------------------------

def _t_add(a, b):
    return a + b


def _t_sub(a, b):
    return a - b


def _t_copy(a):
    return a + 0  # materialises a new version (assignment semantics)


def _t_gemm_acc(c, a, b):
    # the GEMM kernel where it takes the tiles, else the reference's c + a @ b
    return gemm_ops.gemm_tile(c, a, b)


_t_gemm_acc.__bind_intents__ = (bind.InOut, bind.In, bind.In)
_t_gemm_acc.__bind_vmap__ = False     # launches the GEMM kernel: per op


def _t_iadd(c, x):
    return c + x


_t_iadd.__bind_intents__ = (bind.InOut, bind.In)


def _t_isub(c, x):
    return c - x


_t_isub.__bind_intents__ = (bind.InOut, bind.In)


def _zeros(shape, dtype, device):
    """A zero block: a tensor when ``dtype`` is a torch dtype, else NumPy."""
    if isinstance(dtype, torch.dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    return np.zeros(shape, dtype)


class TileView:
    """A rectangular window onto another Tiled's tile grid (zero-copy)."""

    def __init__(self, base: "Tiled", i0: int, j0: int, mt: int, nt: int):
        self.base = base
        self.i0, self.j0, self.mt, self.nt = i0, j0, mt, nt

    # grid access ------------------------------------------------------------
    def tile(self, i: int, j: int) -> bind.BindArray:
        return self.base.tile(self.i0 + i, self.j0 + j)

    def set_tile(self, i: int, j: int, arr: bind.BindArray) -> None:
        self.base.set_tile(self.i0 + i, self.j0 + j, arr)

    def subset(self, i0: int, j0: int, mt: int, nt: int) -> "TileView":
        return TileView(self.base, self.i0 + i0, self.j0 + j0, mt, nt)

    @property
    def wf(self):
        return self.base.wf

    # elementwise -------------------------------------------------------------
    def _pairwise(self, other: "TileView", fn, name: str) -> None:
        assert (self.mt, self.nt) == (other.mt, other.nt), "shape mismatch"
        for i in range(self.mt):
            for j in range(self.nt):
                self.wf.call(fn, (self.tile(i, j), other.tile(i, j)), name=name)

    def __iadd__(self, other: "TileView"):
        self._pairwise(other, _t_iadd, "iadd")
        return self

    def __isub__(self, other: "TileView"):
        self._pairwise(other, _t_isub, "isub")
        return self

    def assign(self, other: "TileView") -> None:
        """``self = other`` — each tile becomes a fresh version copy."""
        assert (self.mt, self.nt) == (other.mt, other.nt)
        for i in range(self.mt):
            for j in range(self.nt):
                self.set_tile(i, j, self.wf.apply(
                    _t_copy, (other.tile(i, j),), name="copy"))

    def add(self, other: "TileView", name: str = "add") -> "Tiled":
        """Fresh tiled temp ``self + other`` (op-created, zero prealloc)."""
        out = Tiled.like(self)
        for i in range(self.mt):
            for j in range(self.nt):
                out.set_tile(i, j, self.wf.apply(
                    _t_add, (self.tile(i, j), other.tile(i, j)), name=name))
        return out

    def sub(self, other: "TileView", name: str = "sub") -> "Tiled":
        out = Tiled.like(self)
        for i in range(self.mt):
            for j in range(self.nt):
                out.set_tile(i, j, self.wf.apply(
                    _t_sub, (self.tile(i, j), other.tile(i, j)), name=name))
        return out


class Tiled(TileView):
    """An owning tile grid. ``Tiled.from_array`` splits a dense matrix.

    ``dtype`` is a NumPy dtype (NumPy tiles on the host) or a torch dtype
    (tensor tiles on ``device``).
    """

    def __init__(self, wf: bind.Workflow, mt: int, nt: int, ib: int,
                 dtype=np.float64, materialise: bool = True, name: str = "T",
                 device=None):
        self._wf = wf
        self.ib = ib
        self.dtype = dtype
        self.device = device
        self.name = name
        if materialise:
            self._tiles = [
                [wf.array(_zeros((ib, ib), dtype, device), f"{name}[{i},{j}]")
                 for j in range(nt)]
                for i in range(mt)
            ]
        else:
            self._tiles = [[None] * nt for _ in range(mt)]
        # the grid is its own window; ``base`` is a property rather than a
        # stored self-reference (the reference's ``TileView.__init__(self,
        # self, ...)``), so a finished workflow and its payloads are freed
        # by reference counting: a self-cycle would hold every tile's
        # device memory until Python's cyclic collector happened to run
        self.i0 = self.j0 = 0
        self.mt, self.nt = mt, nt

    @property
    def base(self) -> "Tiled":
        return self

    # -- constructors -----------------------------------------------------------
    @classmethod
    def from_array(cls, wf: bind.Workflow, a, ib: int,
                   name: str = "T", rank_of=None) -> "Tiled":
        """Split ``a`` (a NumPy array or a tensor) into contiguous tiles of
        its own kind, dtype and device."""
        m, n = a.shape
        assert m % ib == 0 and n % ib == 0, (tuple(a.shape), ib)
        mt, nt = m // ib, n // ib
        is_tensor = isinstance(a, torch.Tensor)
        t = cls(wf, mt, nt, ib, a.dtype, materialise=False, name=name,
                device=a.device if is_tensor else None)
        for i in range(mt):
            for j in range(nt):
                block = a[i * ib:(i + 1) * ib, j * ib:(j + 1) * ib]
                block = (block.contiguous() if is_tensor
                         else np.ascontiguousarray(block))
                rank = rank_of(i, j) if rank_of is not None else 0
                t._tiles[i][j] = wf.array(block, f"{name}[{i},{j}]", rank=rank)
        return t

    @classmethod
    def zeros(cls, wf: bind.Workflow, mt: int, nt: int, ib: int,
              dtype=np.float64, name: str = "T", rank_of=None,
              device=None) -> "Tiled":
        t = cls(wf, mt, nt, ib, dtype, materialise=False, name=name,
                device=device)
        for i in range(mt):
            for j in range(nt):
                rank = rank_of(i, j) if rank_of is not None else 0
                t._tiles[i][j] = wf.array(
                    _zeros((ib, ib), dtype, device), f"{name}[{i},{j}]",
                    rank=rank)
        return t

    @classmethod
    def like(cls, view: TileView, name: str = "tmp") -> "Tiled":
        base = view.base
        return cls(base.wf, view.mt, view.nt, base.ib, base.dtype,
                   materialise=False, name=name, device=base.device)

    # -- grid access ------------------------------------------------------------
    @property
    def wf(self):
        return self._wf

    def tile(self, i: int, j: int) -> bind.BindArray:
        t = self._tiles[i][j]
        assert t is not None, f"tile ({i},{j}) of {self.name} not materialised"
        return t

    def set_tile(self, i: int, j: int, arr: bind.BindArray) -> None:
        self._tiles[i][j] = arr

    # -- read back ---------------------------------------------------------------
    def to_array(self):
        """The dense matrix: a tensor on the tiles' device for tensor
        tiles, a NumPy array for NumPy tiles."""
        rows = [[self.wf.fetch(self.tile(i, j)) for j in range(self.nt)]
                for i in range(self.mt)]
        if isinstance(rows[0][0], torch.Tensor):
            return torch.cat([torch.cat(row, dim=1) for row in rows], dim=0)
        return np.concatenate(
            [np.concatenate([np.asarray(t) for t in row], axis=1)
             for row in rows], axis=0)


def gemm_tiles(a: TileView, b: TileView, c: TileView) -> None:
    """Classical tiled GEMM: ``c += a @ b`` recorded as per-tile transactions."""
    assert a.nt == b.mt and a.mt == c.mt and b.nt == c.nt
    wf = a.wf
    for i in range(c.mt):
        for k in range(c.nt):
            for j in range(a.nt):
                wf.call(
                    _t_gemm_acc,
                    (c.tile(i, k), a.tile(i, j), b.tile(j, k)),
                    name="gemm",
                )
