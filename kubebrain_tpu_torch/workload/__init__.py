"""Cluster-scale workload replay harness (ROADMAP "realistic workload
replay" item).

A deterministic, seeded kube-apiserver traffic generator plus a replay
engine that drives an N-node simulated cluster through a transport: by
default **the real gRPC front** of a spawned ``kubebrain_tpu_torch.cli``
(the port's client, never backend calls); ``chip_smoke.py`` phase (k)
hands the runner an in-process transport that enters where the etcd
services do (the card's machine has no ``grpcio``):

- pod churn with realistic ``/registry/pods/<ns>/<name>`` key shapes and
  object-size distributions (FOCUS, arxiv 2505.24221: kube keyspaces are
  hierarchically structured — prefix-scan and watch-fanout numbers only
  mean something under that distribution);
- per-controller list+watch loops (initial List, Watch from the returned
  revision, periodic paged lists and unpaged relist storms);
- node Lease keepalives at node scale on the real lease RPCs (SYSTEM lane
  server-side);
- compaction on a configurable cadence.

Everything is driven off ONE seeded PRNG and a simulated-time event wheel
(clock.EventWheel), so the same seed replays the byte-identical op
sequence — kblint KB110 keeps unseeded randomness and wall-clock reads out
of this package. The runner executes the schedule with bounded open-loop
concurrency and emits a machine-readable SLO report (slo.py) reconciled
against the server's /metrics counters.

Counterpart of ``kubebrain_tpu/workload``: the generator gives the JAX
package's trace byte for byte. See docs/workloads.md for the generator model and the report schema.
"""

from .generator import Op, Schedule, generate
from .slo import validate_report
from .spec import SLOBounds, WorkloadSpec

__all__ = [
    "Op",
    "Schedule",
    "SLOBounds",
    "WorkloadSpec",
    "generate",
    "validate_report",
]
