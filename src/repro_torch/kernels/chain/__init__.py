"""Chain kernels: a whole fused chain of one tagged op body in one launch.

``chain_ewise`` runs a chain of ``linear_scan.ops.scan_step`` levels,
``chain_dot`` a chain of ``gemm.ops.gemm_tile`` levels and ``chain_attn`` a
chain of ``flash_attention.ops.attn_step`` levels.  The executable
cache's ``lookup_chain_pallas`` resolves a chain to them; ``chain_for`` and
``problem`` say which body has a kernel and whether a chain's operands are
ones it takes.
"""

from .ops import chain_attn, chain_dot, chain_ewise, chain_for, problem

__all__ = ["chain_attn", "chain_dot", "chain_ewise", "chain_for", "problem"]
