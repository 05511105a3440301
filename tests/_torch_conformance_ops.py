"""The port's op pools for its ``procs`` tests, in one jax-free module.

The ``procs`` backend pickles op bodies *by reference* into its worker
processes: a worker re-imports the module that defines a body.  The port's
test modules import ``jax`` and the reference package, and their pools are
closures, so the bodies the port's workers run live here, at module level,
importing only NumPy, ``torch`` and ``repro_torch`` (a worker that imported
a test module would load ``jax``).

* :data:`POOL` — the conformance op pool of ``tests/test_torch_conformance.py``
  (``make_pool`` with the port's intents, operand mixing, host reads and
  ``@``), with the port's kernel-tagged bodies;
* ``step`` / ``mix`` / ``hang_step`` — the scale chains of
  ``tests/test_procs_backend.py`` and ``tests/test_recovery.py``;
* ``decay`` / ``bomb`` — the serving tests' steps (``tests/_serve_ops.py``);
* :func:`worker_facts` — a probe op: the process it ran in.
"""

import os
import sys
import time
import types

import numpy as np
import torch

from repro_torch import core as bind
from repro_torch.compat import jax_matmul, jax_operands, to_numpy
from repro_torch.core.backends import procs as procs_mod
from repro_torch.kernels.flash_attention.ops import attn_step
from repro_torch.kernels.gemm.ops import gemm_tile
from repro_torch.kernels.linear_scan.ops import scan_step

In, InOut = bind.In, bind.InOut


# -- the conformance pool ------------------------------------------------------

def _operands(*xs):
    """jax's mixing: once a tensor is among a body's operands, NumPy ones
    become tensors as jax makes arrays of them."""
    if any(isinstance(x, torch.Tensor) for x in xs) and any(
            isinstance(x, np.ndarray) for x in xs):
        return jax_operands(*xs)
    return xs


def _scale(a, s):
    return a * s


def _shift(a, s):
    return a + s


def _branchy(a, s):
    if float(to_numpy(a).sum()) >= 0:
        return a * s
    return a + s


def _add(a, b):
    a, b = _operands(a, b)
    return a + b


def _mix(a, b):
    a, b = _operands(a, b)
    return a * 0.5 + b


def _mm(a, b):
    a, b = _operands(a, b)
    return jax_matmul(a, b) if isinstance(a, torch.Tensor) else a @ b


def _combine(a, b):
    a, b = _operands(a, b)
    return a + b


def _addr(x, y):
    x, y = _operands(x, y)
    return x + y


def _mixr(x, y):
    x, y = _operands(x, y)
    return x * 0.5 + y


def _bsel(a, b):
    a, b = _operands(a, b)
    if float(to_numpy(a).sum()) >= 0:
        return a + b
    return a * 0.5 + b


def _axpy(y, x, s):
    y, x = _operands(y, x)
    return y + x * s


for _fn in (_scale, _shift, _branchy, _add, _mix, _mm, _bsel):
    _fn.__bind_intents__ = (InOut, In)
for _fn in (_addr, _mixr):
    _fn.__bind_intents__ = (In, InOut)
_axpy.__bind_intents__ = (InOut, In, In)

POOL = types.SimpleNamespace(
    bind=bind,
    UNARY=(_scale, _shift, _branchy),
    BINARY=(_add, _mix, _mm),
    BIN_CARRY0=(_add, _mix, _bsel),
    BIN_CARRY1=(_addr, _mixr),
    axpy=_axpy, combine=_combine, scan_step=scan_step,
    gemm_tile=gemm_tile, attn_step=attn_step)


# -- scale chains (tests/test_procs_backend.py, tests/test_recovery.py) -------

@bind.op
def step(c: bind.InOut, s: bind.In):
    return c * 1.01 + s


@bind.op
def mix(c: bind.InOut, o: bind.In):
    return c + 0.5 * o


@bind.op
def hang_step(c: bind.InOut, s: bind.In):
    # sleeps only inside the rank-1 pool worker: the op body stops touching
    # the heartbeat file, which is exactly what a wedged worker looks like
    if procs_mod._CURRENT_RANK == 1:
        time.sleep(60.0)
    return c * 1.01 + s


def chains(wf, arrs, depth, mix_at=(), body=step, const=None):
    """``len(arrs)`` per-rank scale chains of ``depth`` levels (constant
    ``const``, or the level's index when ``None``); at each level in
    ``mix_at`` every chain also reads its neighbour."""
    n = len(arrs)
    for lv in range(depth):
        for r, a in enumerate(arrs):
            with bind.node(r):
                body(a, float(lv) if const is None else const)
        if lv in mix_at:
            for r, a in enumerate(arrs):
                with bind.node(r):
                    mix(a, arrs[(r + 1) % n])


# -- serving steps (tests/_serve_ops.py) ---------------------------------------

@bind.op
def decay(c: bind.InOut, s: bind.In):
    return c * 0.99 + s


@bind.op
def bomb(c: bind.InOut, s: bind.In):
    raise ValueError("bomb: injected op failure")


# -- a probe -------------------------------------------------------------------

def worker_facts(x):
    """The process this op ran in: its pid, the worker rank the ``procs``
    backend gave it (``None`` outside a worker), whether it has CUDA, and
    the ``jax`` / reference modules it has loaded."""
    loaded = sorted(k for k in sys.modules
                    if k in ("jax", "jaxlib", "repro")
                    or k.startswith(("jax.", "jaxlib.", "repro.")))
    return {"pid": os.getpid(), "rank": procs_mod._CURRENT_RANK,
            "cuda": torch.cuda.is_available(), "loaded": loaded}


