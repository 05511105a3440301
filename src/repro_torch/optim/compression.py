"""Gradient compression for scarce cross-pod links: int8 block
quantisation with error feedback — ``repro/optim/compression.py`` in
PyTorch.

Block-wise symmetric int8 codes with a float32 scale per block of
:data:`BLOCK` values, round half to even as ``jnp.round``.
:func:`compressed_allreduce` moves those codes across a mesh axis (inside
``shard_map``): all-gather of the int8 codes and the float32 scales, then
a local dequantise-and-sum, with the quantisation residual fed back into
the next step's gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import spmd
from repro_torch.core.spmd import Sharded

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> tuple:
    """``x`` (any shape, float) -> (int8 codes (nb, BLOCK), float32 scales
    (nb,)), the flat values zero-padded to whole blocks."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale == 0, 1.0, scale)
    codes = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return codes, scale[:, 0]


def dequantize_int8(codes: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    """The values of ``codes`` and ``scale``, cut to ``shape``, in
    ``dtype``."""
    flat = (codes.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def compressed_allreduce(x: Sharded, axis_name, *,
                         error: Sharded | None = None) -> tuple:
    """All-reduce ``x`` over ``axis_name`` moving int8 on the wire, with
    error feedback; returns ``(mean float32, residual)``, both per rank.

    Per rank: add the carried ``error``, quantise, and keep what the
    quantisation lost as the new residual.  The int8 codes and the float32
    scales are all-gathered (:func:`repro_torch.core.spmd.all_gather`,
    stacked, so the copies carry int8), and each rank dequantises every
    rank's blocks and sums them in rank order, so every rank ends with the
    same bits."""
    xf = x.map(lambda t: t.float())
    if error is not None:
        xf = xf + error
    quant = xf.map(quantize_int8)
    codes = quant.map(lambda q: q[0])                 # (nb, BLOCK) int8
    scale = quant.map(lambda q: q[1])                 # (nb,) float32
    new_error = xf.map(lambda t, q: t - dequantize_int8(q[0], q[1], t.shape),
                       quant)
    n = x.mesh.axis_size(axis_name)
    all_codes = spmd.all_gather(codes, axis_name)     # (n, nb, BLOCK) int8
    all_scales = spmd.all_gather(scale, axis_name)    # (n, nb) float32

    def mean(t, c, s):
        acc = c[0].float() * s[0][:, None]
        for j in range(1, n):
            acc = acc + c[j].float() * s[j][:, None]
        return acc.reshape(-1)[:t.numel()].reshape(t.shape) / n

    return xf.map(mean, all_codes, all_scales), new_error
