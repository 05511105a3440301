"""Multi-rank self-test for the shard_map distributed GEMM.

Validates the mesh lowering of Listing 1 on a (2, 4) rank mesh for both
reduction schedules, against the dense NumPy product, on 8 ranks that
share the card (TF32 off; ``--device cpu``: 8 ranks that share the host).

    python -m repro_torch.launch.selftest_distgemm [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.core.spmd import make_mesh
from repro_torch.launch.selftest_collectives import rank_devices
from repro_torch.linalg.distributed import (distributed_gemm_shardmap,
                                            tf32_off)


def main(argv=None) -> int:
    devices = rank_devices(argv, __doc__)
    rng = np.random.default_rng(0)
    mesh = make_mesh((2, 4), ("p", "q"), devices)
    for m, k, n in ((8, 8, 8), (16, 32, 8), (64, 16, 24)):
        A = rng.normal(size=(m, k)).astype(np.float32)
        B = rng.normal(size=(k, n)).astype(np.float32)
        for schedule in ("tree", "ring"):
            fn = distributed_gemm_shardmap(mesh, schedule=schedule)
            with tf32_off():
                out = fn(torch.from_numpy(A).to(devices[0]),
                         torch.from_numpy(B).to(devices[0])).cpu().numpy()
            np.testing.assert_allclose(
                out, A @ B, rtol=2e-4, atol=2e-4,
                err_msg=f"schedule={schedule} shape={(m, k, n)}",
            )
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
