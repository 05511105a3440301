"""Checkpointing: atomic, async, elastic — ``repro/ckpt/manager.py`` on
tensors.

* **Atomic** — writes land in ``step_N.tmp`` and are ``rename``d only after
  every leaf + manifest is fsync'd; a crash mid-save can never corrupt the
  restore point (the stale ``.tmp`` is GC'd on the next save or restore).
* **Async** — ``save()`` snapshots every leaf to host memory and hands
  serialisation to a background thread; the train step never blocks on
  disk.  The snapshot is always a *copy*: the port's optimizer updates the
  parameters and its moments in place (``repro_torch.optim.adamw``), and
  ``t.cpu()`` of a CPU tensor is the tensor itself, which the next step
  would overwrite while the thread writes it.
* **The reference's format** — ``step_N/manifest.json`` holds ``step``,
  ``extra`` and ``leaves`` (``path``, ``shape``, ``dtype``), one
  ``leaf_00000.npy`` per leaf (the reference also writes a ``treedef``
  string, which neither package reads).  bfloat16 (and
  the float8 types) are stored as raw unsigned bits with the logical dtype
  in the manifest.  Leaves are ordered as ``jax.tree_util`` orders the same
  nested dict / list / tuple / NamedTuple structure (dict keys sorted,
  ``None`` a subtree without leaves), so a checkpoint written by either
  package restores in the other.

* **Elastic** — a leaf placed on a rank mesh (a
  :class:`~repro_torch.core.spmd.Sharded` value with its spec, as
  ``NamedSharding.place`` returns it) is saved as its *global* array; ``restore(like, shardings=...)``
  places each leaf by its :class:`~repro_torch.core.spmd.NamedSharding`
  on whatever mesh the new job brings up (8 ranks to 4 and back to 8 in
  ``launch/selftest_elastic.py``).

:meth:`CheckpointManager.restore` rebuilds the structure of ``like``: a
tensor leaf comes back as a tensor on ``like``'s device and in its dtype
(placed by its sharding when ``shardings`` gives one), a NumPy leaf as
NumPy, a Python number as that number.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.spmd import Sharded, assemble

# dtypes NumPy cannot hold: stored as raw bits, the logical dtype in the
# manifest (the reference's _BITCAST)
_BITCAST = {
    "bfloat16": (torch.bfloat16, np.uint16, torch.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8),
}
_TORCH_LOGICAL = {v[0]: k for k, v in _BITCAST.items()}


# ---------------------------------------------------------------------------
# trees, in jax.tree_util's order
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(tree):
    """``(kind, keys, children)`` of a container node, or ``None`` for a
    leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "dict", keys, [tree[k] for k in keys]
    if _is_namedtuple(tree):
        return "namedtuple", None, list(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree).__name__, None, list(tree)
    return None


def flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    if tree is None:
        return []
    node = _children(tree)
    if node is None:
        return [tree]
    out = []
    for child in node[2]:
        out.extend(flatten(child))
    return out


def unflatten(like, leaves):
    """``like``'s structure with its leaves replaced by ``leaves`` in
    order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        kind, keys, children = kids
        built = [build(c) for c in children]
        if kind == "dict":
            return type(node)(zip(keys, built))
        if kind == "namedtuple":
            return type(node)(*built)
        return type(node)(built)

    return build(like)


# ---------------------------------------------------------------------------
# leaves on disk
# ---------------------------------------------------------------------------

def _snapshot(leaf, copy: bool):
    """A host snapshot of one leaf: ``(storage ndarray, logical dtype)``.
    ``copy`` makes it independent of the leaf's memory."""
    if isinstance(leaf, Sharded):
        leaf, copy = assemble(leaf), False      # a new global tensor
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu" or copy:
            t = t.to("cpu", copy=True)
        t = t.contiguous()
        logical = _TORCH_LOGICAL.get(t.dtype)
        if logical is not None:
            return t.view(_BITCAST[logical][2]).numpy().view(
                _BITCAST[logical][1]), logical
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=copy) if copy else np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_storage(arr: np.ndarray, logical: str):
    """A stored leaf as an ndarray, or a CPU tensor for a dtype NumPy
    lacks."""
    if logical in _BITCAST:
        dtype, _np, bits = _BITCAST[logical]
        return torch.from_numpy(np.ascontiguousarray(arr)).view(
            bits).view(dtype)
    return arr


def _like(stored, ref):
    """A stored leaf in the form of ``ref``: a tensor on its device and in
    its dtype (a placed ``ref``: on its mesh's first device), NumPy in its
    dtype, or a Python number."""
    if isinstance(ref, Sharded):
        ref = ref.shards[0]
    if isinstance(ref, torch.Tensor):
        t = stored if isinstance(stored, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(stored))
        return t.to(device=ref.device, dtype=ref.dtype, copy=True)
    if isinstance(stored, torch.Tensor):
        raise TypeError(f"a {stored.dtype} leaf cannot be restored into "
                        f"{type(ref).__name__}")
    if isinstance(ref, np.ndarray) or isinstance(ref, np.generic):
        return np.asarray(stored).astype(ref.dtype)
    if isinstance(ref, (bool, int, float, complex)):
        return type(ref)(np.asarray(stored).item())
    return np.asarray(stored)


class CheckpointManager:
    """Atomic, async checkpoints of a tree of tensors under ``directory``
    (see the module doc); keeps the newest ``keep_n`` steps."""

    def __init__(self, directory: str, keep_n: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def __getstate__(self):
        # a worker process of the procs backend receives a pickled copy
        # (a checkpoint barrier's body): no thread crosses the pipe
        return {"dir": self.dir, "keep_n": self.keep_n,
                "async_save": self.async_save}

    def __setstate__(self, state):
        self.__dict__.update(state, _thread=None, _error=None)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None,
             block: bool = False) -> None:
        """Write ``tree`` as step ``step``.  Returns once every leaf is
        snapshotted to host memory; with ``async_save`` and not ``block``
        the files are written by a background thread (:meth:`wait`)."""
        self.wait()
        background = self.async_save and not block
        leaves = flatten(tree)
        host = [_snapshot(leaf, copy=background) for leaf in leaves]

        def _write():
            tmp = self._step_dir(step) + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "extra": extra or {}, "leaves": []}
            for i, (arr, logical) in enumerate(host):
                path = f"leaf_{i:05d}.npy"
                with open(os.path.join(tmp, path), "wb") as f:
                    np.save(f, arr)
                    f.flush()
                    os.fsync(f.fileno())
                manifest["leaves"].append(
                    {"path": path, "shape": list(arr.shape),
                     "dtype": logical})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if background:
            def _run():
                try:
                    _write()
                except BaseException as e:     # re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        """Wait for a background save; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.dir, n, "manifest.json")))
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        self._gc_tmp()

    def _gc_tmp(self) -> None:
        """Remove orphaned ``.tmp`` step dirs (crash-mid-save leftovers),
        on save and at the top of :meth:`restore`, so a restore can never
        take a partial save for a committed step."""
        for n in os.listdir(self.dir):
            if n.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, n), ignore_errors=True)

    # ------------------------------------------------------------------
    def _manifest(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    def _load(self, step: int, meta: dict):
        arr = np.load(os.path.join(self._step_dir(step), meta["path"]))
        return _from_storage(arr, meta["dtype"])

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Restore step ``step`` (default: the latest) into the structure
        of ``like``; with ``shardings`` (the structure of ``like`` with a
        :class:`~repro_torch.core.spmd.NamedSharding` for each leaf) each
        tensor leaf is placed on its sharding's mesh, whatever mesh saved
        it (a number stays a number).  Returns ``(tree, extra)``."""
        self.wait()
        self._gc_tmp()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        manifest = self._manifest(step)
        refs = flatten(like)
        if len(refs) != len(manifest["leaves"]):
            raise ValueError(
                "checkpoint/model structure mismatch "
                f"({len(manifest['leaves'])} vs {len(refs)} leaves)")
        places = ([None] * len(refs) if shardings is None
                  else flatten(shardings))
        if len(places) != len(refs):
            raise ValueError(f"{len(places)} shardings for {len(refs)} "
                             f"leaves")
        out = []
        for meta, ref, place in zip(manifest["leaves"], refs, places):
            stored = self._load(step, meta)
            shape = (ref.global_shape if isinstance(ref, Sharded)
                     else np.shape(ref))
            if list(stored.shape) != list(shape):
                raise ValueError(f"shape mismatch {tuple(stored.shape)} vs "
                                 f"{tuple(shape)}")
            leaf = _like(stored, ref)
            # a number (the optimizer's count) is the same on every rank:
            # its replicated sharding leaves it as it is
            out.append(leaf if place is None
                       or not isinstance(leaf, torch.Tensor)
                       else place.place(leaf))
        return unflatten(like, out), manifest["extra"]

    def load_leaf(self, step: int, i: int):
        """Leaf ``i`` of step ``step`` in the container its save recorded
        in ``extra["containers"]`` (a checkpoint barrier's): NumPy, or a
        tensor on the recorded device; else as stored."""
        manifest = self._manifest(step)
        stored = self._load(step, manifest["leaves"][i])
        containers = manifest["extra"].get("containers")
        if not containers or containers[i] == "numpy":
            return stored
        device = torch.device(containers[i].split(":", 1)[1])
        t = stored if isinstance(stored, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(stored))
        return t.to(device)
