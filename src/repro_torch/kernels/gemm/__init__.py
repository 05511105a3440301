"""Tiled GEMM: the leaf of every tiled linear-algebra workflow."""

from .ops import matmul, matmul_accumulate

__all__ = ["matmul", "matmul_accumulate"]
