"""The topology cost model, the small rank mesh of the tests and the
trainer (:func:`make_host_mesh`), and the dry run's production mesh
(:func:`make_production_mesh`).

The :class:`Topology` cost model prices the LocalExecutor's simulated
transfers in *time* (per-hop latency + per-byte bandwidth over a
configurable interconnect shape), which is what makes collective ablations
("tree" vs "naive") and execution-backend ablations comparable beyond raw
message counts: ``stats.estimated_makespan(make_topology("ring", 8))``
charges each concurrent transfer round the maximum of its hops.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Topology:
    """Interconnect cost model: hop distance × latency + bytes / bandwidth.

    ``kind``:
      * ``"flat"``     — full crossbar, every pair 1 hop (the paper's
        idealised machine; message counts *are* the cost);
      * ``"ring"``     — 1-D torus, hop count is the shorter arc (a
        neighbour fabric);
      * ``"fat-tree"`` — ``arity``-ary switch tree over the ranks; a hop
        count of ``2·h`` reaches the lowest common switch at height ``h``
        (the classic datacenter fabric — uniform bandwidth, non-uniform
        latency).

    ``latency_s`` is charged per hop, ``bandwidth_Bps`` per byte end-to-end
    (links are full-duplex and non-blocking; contention is modelled only
    through the round structure of the transfer stream).  ``flops_per_s``
    is each rank's compute rate: when positive,
    ``ExecutionStats.estimated_makespan`` prices every wavefront level's
    critical-path ``OpNode.flops`` in seconds alongside the communication
    rounds; the default 0 keeps makespans communication-only.
    """

    kind: str
    n_nodes: int
    latency_s: float = 1e-6
    bandwidth_Bps: float = 10e9
    arity: int = 4
    flops_per_s: float = 0.0

    def __post_init__(self):
        assert self.kind in ("flat", "ring", "fat-tree"), self.kind
        assert self.n_nodes >= 1 and self.arity >= 2

    def hops(self, src: int, dst: int) -> int:
        """Link hops between two ranks under this topology."""
        if src == dst:
            return 0
        if self.kind == "flat":
            return 1
        if self.kind == "ring":
            d = abs(src - dst)
            return min(d, self.n_nodes - d)
        # fat-tree: climb to the lowest common switch, then descend
        h = 1
        span = self.arity
        while src // span != dst // span:
            span *= self.arity
            h += 1
        return 2 * h

    @property
    def diameter(self) -> int:
        """Worst-case hop count between any two ranks."""
        if self.n_nodes == 1:
            return 0
        if self.kind == "flat":
            return 1
        if self.kind == "ring":
            return self.n_nodes // 2
        return 2 * max(1, math.ceil(math.log(self.n_nodes, self.arity)))

    def transfer_time(self, src: int, dst: int, nbytes: int) -> float:
        """Seconds to move ``nbytes`` from ``src`` to ``dst`` (α–β model)."""
        h = self.hops(src, dst)
        if h == 0:
            return 0.0
        return h * self.latency_s + nbytes / self.bandwidth_Bps

    def calibrate(self, samples) -> "Topology":
        """Fit this topology's constants to *measured* samples.

        ``samples`` is an iterable of dicts of two shapes, freely mixed:

        * compute — ``{"flops": F, "seconds": s}``: one op body (or level)
          that retired ``F`` flops in ``s`` seconds; fitted as
          ``flops_per_s = ΣF / Σs`` (rate of the pooled sample, so long
          runs weigh more than noisy short ones);
        * transfer — ``{"nbytes": B, "hops": h, "seconds": s}``: one
          measured ship of ``B`` bytes over ``h`` link hops (``hops``
          defaults to 1); fitted by least squares to the α–β model
          ``s = h·α + B·β``, clamped to non-negative α and positive β.

        Returns a new frozen :class:`Topology` (constants not covered by
        the samples keep their current values) — the bridge from measured
        wall-clock to the simulated makespan model, closing the loop
        between estimated and real time.
        """
        comp_f = comp_s = 0.0
        xfer = []
        for s in samples:
            if "flops" in s:
                comp_f += float(s["flops"])
                comp_s += float(s["seconds"])
            elif "nbytes" in s:
                xfer.append((float(s.get("hops", 1)), float(s["nbytes"]),
                             float(s["seconds"])))
        changes = {}
        if comp_f > 0.0 and comp_s > 0.0:
            changes["flops_per_s"] = comp_f / comp_s
        if xfer:
            if len(xfer) == 1 or len({(h, b) for h, b, _ in xfer}) == 1:
                # one distinct (hops, nbytes) point cannot split α from β:
                # attribute the mean to bandwidth, keep the current latency
                h, b, t = xfer[0]
                ts = [t for _h, _b, t in xfer]
                residual = max(1e-12,
                               sum(ts) / len(ts) - h * self.latency_s)
                if b > 0.0:
                    changes["bandwidth_Bps"] = b / residual
            else:
                # least squares for s = h·α + b·β over all samples
                shh = sum(h * h for h, _b, _t in xfer)
                sbb = sum(b * b for _h, b, _t in xfer)
                shb = sum(h * b for h, b, _t in xfer)
                sht = sum(h * t for h, _b, t in xfer)
                sbt = sum(b * t for _h, b, t in xfer)
                det = shh * sbb - shb * shb
                if det > 0.0:
                    alpha = (sht * sbb - sbt * shb) / det
                    beta = (sbt * shh - sht * shb) / det
                    changes["latency_s"] = max(0.0, alpha)
                    if beta > 0.0:
                        changes["bandwidth_Bps"] = 1.0 / beta
        return dataclasses.replace(self, **changes) if changes else self


def make_topology(kind: str = "flat", n_nodes: int = 1, *,
                  latency_s: float = 1e-6, bandwidth_Bps: float = 10e9,
                  arity: int = 4, flops_per_s: float = 0.0) -> Topology:
    """Build a :class:`Topology` cost model (see class docstring for kinds)."""
    return Topology(kind=kind, n_nodes=n_nodes, latency_s=latency_s,
                    bandwidth_Bps=bandwidth_Bps, arity=arity,
                    flops_per_s=flops_per_s)


def make_production_mesh(*, multi_pod: bool = False, device="meta"):
    """The reference's production mesh: ``(16, 16)`` over ``("data",
    "model")``, or with ``multi_pod`` ``(2, 16, 16)`` over ``("pod",
    "data", "model")``.

    Its only user is the dry run (:mod:`repro_torch.launch.dryrun`), which
    allocates nothing, as the reference's traces shapes only; so the 256
    or 512 ranks are ``meta`` devices unless the caller gives another
    ``device``, on which they all lie (``"cuda"``: they share the card, as
    :func:`make_host_mesh`'s ``n_data`` ranks do).  The reference's ranks
    are 256 or 512 chips (ROADMAP Queue 3)."""
    from repro_torch.core.spmd import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_production_mesh: no CUDA device "
                           "(torch.cuda.is_available() is false)")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, [dev] * math.prod(shape))


def make_host_mesh(n_data: int | None = None, n_model: int = 1,
                   device="cuda"):
    """A small rank mesh (tests, self-tests, the trainer's
    ``--fake-devices``): ``(n_data,)`` over ``("data",)``, or ``(n_data,
    n_model)`` over ``("data", "model")`` when ``n_model > 1``.

    Without ``n_data`` the mesh takes every device of ``device``'s type,
    one rank each, as the reference's takes ``len(jax.devices())``:
    ``torch.cuda.device_count() // n_model`` cards, or the one host.
    With ``n_data`` every rank lies on ``device`` (the card unless the
    caller asks for another), so ranks may repeat a device, as the
    reference's fake CPU devices share one host.  Without a card ``cuda``
    raises rather than moving to the host."""
    from repro_torch.core.spmd import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA device "
                           "(torch.cuda.is_available() is false); pass "
                           "device='cpu' to share the host")
    if n_data is None:
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        n_data = n // n_model
        if n_data < 1:
            raise ValueError(f"make_host_mesh: {n} {dev.type} device(s) "
                             f"cannot hold a model axis of {n_model}")
        devices = ([torch.device("cuda", i) for i in range(n_data * n_model)]
                   if dev.type == "cuda" else [dev])
    else:
        devices = [dev] * (n_data * n_model)
    if n_model > 1:
        return make_mesh((n_data, n_model), ("data", "model"), devices)
    return make_mesh((n_data,), ("data",), devices)
