"""Shared-memory tiled Strassen over Bind (paper §IV-A, Fig. 2 + appendix).

The recursion mirrors the paper's appendix listing: quadrant views of the
tiled operands, ± pre-combinations into temporaries, seven recursive
multiplications, and quadrant post-combinations — all recorded as one
transactional DAG whose leaves are single-tile ``gemm`` calls: on CUDA tiles
each one launches the hand-written GEMM kernel
(:mod:`repro_torch.kernels.gemm`), on NumPy tiles it is a BLAS call, exactly
like the paper dispatches to MKL's DGEMM.

The DAG exposes the 7^d leaf multiplications of depth-``d`` recursion as
independent wavefronts — that (not the operation count alone) is what beats
a flat parallel DGEMM in the paper's Fig. 2.
"""

from __future__ import annotations

from .tiles import Tiled, TileView, gemm_tiles


def gemm_strassen(a: TileView, b: TileView, c: TileView, leaf_nt: int = 1) -> None:
    """``c += a @ b`` by Strassen recursion on tile quadrants.

    Recurses while the tile grid halves evenly and is larger than
    ``leaf_nt``; below that dispatches to the classical tiled GEMM (the
    paper recurses "until the size of a submatrix hits a single tile; then
    the operation would be dispatched to the sequential MKL DGEMM call").
    """
    assert a.mt == a.nt == b.mt == b.nt == c.mt == c.nt, "square grids only"
    nt = c.nt
    if nt <= leaf_nt or nt % 2 != 0:
        gemm_tiles(a, b, c)
        return
    h = nt // 2
    A11, A12 = a.subset(0, 0, h, h), a.subset(0, h, h, h)
    A21, A22 = a.subset(h, 0, h, h), a.subset(h, h, h, h)
    B11, B12 = b.subset(0, 0, h, h), b.subset(0, h, h, h)
    B21, B22 = b.subset(h, 0, h, h), b.subset(h, h, h, h)
    C11, C12 = c.subset(0, 0, h, h), c.subset(0, h, h, h)
    C21, C22 = c.subset(h, 0, h, h), c.subset(h, h, h, h)

    # Pre-combinations: fresh temporaries born from ops (zero-copy temps).
    S1 = A11.add(A22, "s1")      # M1 = (A11+A22)(B11+B22)
    T1 = B11.add(B22, "t1")
    S2 = A21.add(A22, "s2")      # M2 = (A21+A22) B11
    T3 = B12.sub(B22, "t3")      # M3 = A11 (B12-B22)
    T4 = B21.sub(B11, "t4")      # M4 = A22 (B21-B11)
    S5 = A11.add(A12, "s5")      # M5 = (A11+A12) B22
    S6 = A21.sub(A11, "s6")      # M6 = (A21-A11)(B11+B12)
    T6 = B11.add(B12, "t6")
    S7 = A12.sub(A22, "s7")      # M7 = (A12-A22)(B21+B22)
    T7 = B21.add(B22, "t7")

    wf = c.wf
    M = [Tiled.zeros(wf, h, h, c.base.ib, c.base.dtype, name=f"m{i+1}",
                     device=c.base.device)
         for i in range(7)]

    gemm_strassen(S1, T1, M[0], leaf_nt)
    gemm_strassen(S2, B11, M[1], leaf_nt)
    gemm_strassen(A11, T3, M[2], leaf_nt)
    gemm_strassen(A22, T4, M[3], leaf_nt)
    gemm_strassen(S5, B22, M[4], leaf_nt)
    gemm_strassen(S6, T6, M[5], leaf_nt)
    gemm_strassen(S7, T7, M[6], leaf_nt)

    # Post-combinations (accumulate into c's quadrants).
    C11 += M[0]; C11 += M[3]; C11 -= M[4]; C11 += M[6]
    C12 += M[2]; C12 += M[4]
    C21 += M[1]; C21 += M[3]
    C22 += M[0]; C22 -= M[1]; C22 += M[2]; C22 += M[5]


def strassen_flops(n: int, ib: int, leaf_nt: int = 1) -> int:
    """Exact leaf-GEMM flop count of the recursion (for the Fig. 2 bench)."""
    nt = n // ib
    def rec(nt_):
        if nt_ <= leaf_nt or nt_ % 2 != 0:
            return nt_ ** 3 * (2 * ib ** 3)
        return 7 * rec(nt_ // 2)
    return rec(nt)
