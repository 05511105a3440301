"""Int8 block quantisation — the two quantisers of
``repro/optim/compression.py`` in PyTorch.

Block-wise symmetric int8 codes with a float32 scale per block of
:data:`BLOCK` values, round half to even as ``jnp.round``.  The
all-reduce that moves these codes across devices
(:func:`compressed_allreduce`) is a collective and comes with the
multi-device slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def compressed_allreduce(x, axis_name, *, error=None):
    """The reference's int8 all-reduce with error feedback across a mesh
    axis: a collective, which the port does not run yet."""
    raise ValueError(
        "compressed_allreduce is a collective across devices: it comes "
        "with Slice 3 (multi-device, ROADMAP Queue 1); the port trains on "
        "one device")
