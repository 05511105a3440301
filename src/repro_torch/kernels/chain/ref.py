"""Plain PyTorch versions of the chain kernels: a per-level loop of the
op body's arithmetic.

``chain_ewise`` calls ``scan_step`` (``a * y + x``, plain PyTorch) on each
level's operands, exactly as per-level serial replay does.  ``chain_dot``
calls the GEMM's plain version (``gemm.ref.matmul_accumulate``: ``c + a @
b`` in the accumulator type) per level: on the CPU that is what
``gemm_tile`` computes, on the card it is PyTorch's own product, not the
port's GEMM kernel.  :func:`run_levels` replays any body level by level
(``chip_smoke.py`` uses it to replay ``gemm_tile`` as serial does).  The
tests use this module, ``chip_smoke.py`` holds the kernels against it on
the card, and :mod:`.ops` uses it for CPU tensors only.
"""

from __future__ import annotations

from ..flash_attention import ref as attn_ref
from ..gemm import ref as gemm_ref
from ..linear_scan.ops import scan_step


def run_levels(body, layout: tuple, carry_pos: int, n_levels: int, args):
    """``n_levels`` applications of ``body``: the carry threads through
    position ``carry_pos``; ``"xs"`` / ``"xs_const"`` operands give each
    level its own slice, the others are the same every level."""
    call_args = list(args)
    carry = args[carry_pos]
    varying = [p for p, lay in enumerate(layout)
               if p != carry_pos and lay in ("xs", "xs_const")]
    for level in range(n_levels):
        call_args[carry_pos] = carry
        for p in varying:
            call_args[p] = args[p][level]
        carry = body(*call_args)
    return carry


def chain_ewise(layout: tuple, carry_pos: int, n_levels: int, *args):
    return run_levels(scan_step, layout, carry_pos, n_levels, args)


def chain_dot(layout: tuple, carry_pos: int, n_levels: int, *args):
    return run_levels(gemm_ref.matmul_accumulate, layout, carry_pos,
                      n_levels, args)


def chain_attn(layout: tuple, carry_pos: int, n_levels: int, *args):
    return run_levels(attn_ref.attn_step, layout, carry_pos, n_levels, args)
