"""Paper's Linear Algebra applications over the Bind model (§IV-A)."""

from .tiles import Tiled, TileView
from .strassen import gemm_strassen
from .distributed import distributed_gemm_listing1

__all__ = ["Tiled", "TileView", "gemm_strassen", "distributed_gemm_listing1"]
