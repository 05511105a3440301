"""Paper Listing 1 on PyTorch: the Bind-model version on simulated nodes
(implicit transfers, explicit log-reduction tree, execution stats), the
tiles on the GPU.  The ``shard_map`` lowering of
``examples/distributed_gemm.py`` waits for the port's multi-device slice.

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

from repro_torch.launch.mesh import make_topology  # noqa: E402
from repro_torch.linalg.distributed import run_distributed_gemm  # noqa: E402


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host instead of the GPU")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("torch_distributed_gemm: no GPU (torch.cuda.is_available() is "
              "false); pass --cpu to run on the host", file=sys.stderr)
        return 1
    bind_version(torch.device("cpu" if args.cpu else "cuda"))
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
