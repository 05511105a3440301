"""Paper Listing 1 on PyTorch, both ways:

1. the Bind-model version on simulated nodes (implicit transfers, explicit
   log-reduction tree, execution stats), the tiles on the GPU, and
2. the mesh lowering via ``shard_map`` on a (2, 4) rank mesh whose 8 ranks
   share the GPU (or the host), tree vs ring reduction schedules.

    PYTHONPATH=src python examples/torch_distributed_gemm.py
    PYTHONPATH=src python examples/torch_distributed_gemm.py --cpu

Without a GPU, and without ``--cpu``, it stops with a message.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.spmd import make_mesh  # noqa: E402
from repro_torch.launch.mesh import make_topology  # noqa: E402
from repro_torch.linalg.distributed import (  # noqa: E402
    distributed_gemm_shardmap, run_distributed_gemm, tf32_off)


def bind_version(dev: torch.device) -> None:
    rng = np.random.default_rng(0)
    NP = NQ = 2
    A = rng.normal(size=(128, 128))
    B = rng.normal(size=(128, 128))
    topo = make_topology("ring", NP * NQ)
    for backend in ("serial", "threads", "fused"):
        out, stats, est = run_distributed_gemm(
            A, B, ib=32, NP=NP, NQ=NQ, device=dev, backend=backend,
            topology=topo)
        np.testing.assert_allclose(out.cpu().numpy(), A @ B, rtol=1e-9)
        print(f"[bind]  4 nodes on {dev}, backend={backend:7s}: "
              f"{stats.message_count} implicit transfers, "
              f"{stats.bytes_transferred/1e6:.2f} MB, "
              f"critical path {stats.critical_path}, "
              f"est. comm makespan {est*1e6:.1f} us on a ring")


def shardmap_version(dev: torch.device) -> None:
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 32)).astype(np.float32)
    B = rng.normal(size=(32, 48)).astype(np.float32)
    mesh = make_mesh((2, 4), ("p", "q"), (dev,) * 8)
    for schedule in ("tree", "ring"):
        fn = distributed_gemm_shardmap(mesh, schedule=schedule)
        with tf32_off():
            out = fn(torch.from_numpy(A).to(dev), torch.from_numpy(B).to(dev))
        np.testing.assert_allclose(out.cpu().numpy(), A @ B, rtol=2e-4,
                                   atol=2e-4)
        print(f"[mesh lowering] (2,4) mesh on {dev}, schedule={schedule}: "
              f"OK ({mesh.copies} copies so far)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host instead of the GPU")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("torch_distributed_gemm: no GPU (torch.cuda.is_available() is "
              "false); pass --cpu to run on the host", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if args.cpu else "cuda")
    bind_version(dev)
    shardmap_version(dev)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
