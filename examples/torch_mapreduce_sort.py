"""Paper Listing 2 on PyTorch — sorting integers with Bind's MapReduce
engine, the values held as one tensor on the GPU.

    PYTHONPATH=src python examples/torch_mapreduce_sort.py [--backend fused]
    PYTHONPATH=src python examples/torch_mapreduce_sort.py --cpu

Without a GPU, and without ``--cpu``, it stops with a message.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import core as bind  # noqa: E402
from repro_torch.mapreduce import sort_integers  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host instead of the GPU")
    parser.add_argument("--backend", default="serial",
                        choices=("serial", "threads", "fused"))
    parser.add_argument("--n", type=int, default=2_000_000,
                        help="how many values to sort")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("torch_mapreduce_sort: no GPU (torch.cuda.is_available() is "
              "false); pass --cpu to run on the host", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if args.cpu else "cuda")
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(
        rng.integers(0, 2**31 - 1, size=args.n, dtype=np.int64)).to(dev)
    want = torch.sort(vals).values

    print(f"sorting {args.n / 1e6:.3g}M uniform 31-bit ints on {dev} "
          f"(paper: 1B on 64 nodes) [backend={args.backend}]")
    for nodes in (1, 4, 8):
        ex = bind.LocalExecutor(nodes, collective_mode="tree",
                                backend=args.backend)
        t0 = time.perf_counter()
        out, stats = sort_integers(vals, n_nodes=nodes, executor=ex)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        assert out.device == vals.device and torch.equal(out, want)
        print(f"  {nodes:2d} nodes: {dt*1e3:7.1f} ms, shuffle "
              f"{stats.bytes_transferred/1e6:7.1f} MB "
              f"in {stats.message_count} implicit transfers")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
