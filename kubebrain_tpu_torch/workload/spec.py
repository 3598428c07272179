"""Workload specification: the full parameterization of one simulated
cluster, plus the SLO bounds its replay report is judged against.

Everything that shapes the generated op trace lives here so that
``generate(spec)`` is a pure function of (spec, spec.seed) — the
determinism contract the replay harness is built on. Runtime-only knobs
(shard counts, stream counts) also live here so a report's ``spec`` echo
fully describes how the numbers were produced.

Counterpart of ``kubebrain_tpu/workload/spec.py``: the traffic fields and
the factories are the same (so ``generate`` gives the same trace), the
storage names are the port CLI's (``cuda`` where the JAX package says
``tpu``), and the mesh knobs are checked as the port's CLI checks
``--mesh-part``, ``--scan-partitions`` and ``--mesh-wat``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, replace
from typing import Any

#: the engines the port's CLI serves a spawned replay from (``--storage``);
#: ``cuda`` mirrors ``inner_storage`` on the device
STORAGES = ("memkv", "native", "cuda")


@dataclass(frozen=True)
class SLOBounds:
    """Declared service-level bounds the replay report is evaluated
    against (slo.evaluate). Defaults are deliberately loose — they must
    hold on a 2-vCPU CI box while the REST of the test suite hammers the
    same cores (measured: a ~20ms standalone system p99 stretches past
    1.5s under full-suite load); the defaults catch harness breakage, and
    tighter per-deployment bounds are a spec override, not an edit here."""

    write_p99_ms: float = 5000.0
    normal_p99_ms: float = 5000.0
    system_p99_ms: float = 5000.0
    background_p99_ms: float = 10000.0
    max_shed_rate: float = 0.05
    max_error_rate: float = 0.01
    watch_wire_lag_p99_s: float = 10.0  # the lag histogram's top finite bucket
    max_lease_expiries: int = 0
    max_watch_cancels: int = 0
    min_compactions: int = 1
    #: total Range/Count requests that must have ridden a query-batched
    #: dispatch (kb_sched_batch_size sum). 0 = don't require batching —
    #: small-N smokes can't guarantee concurrent distinct ranges queue up.
    min_batched_requests: int = 0
    #: total write ops that must have ridden a group commit
    #: (kb_sched_write_batch_size sum; docs/writes.md). 0 = don't require
    #: group formation; the churn_heavy scenario sets it > 0 and the
    #: reconcile section re-asserts the histogram moved.
    min_write_batched_ops: int = 0
    #: chaos mode (docs/faults.md): p99 bound on ops completed INSIDE an
    #: active fault window (the degraded-window bound the CHAOS report
    #: asserts). Loose by default for the same 2-vCPU-CI reason as above.
    degraded_p99_ms: float = 20000.0


@dataclass(frozen=True)
class WorkloadSpec:
    """One simulated cluster. Times suffixed ``_s`` are SIMULATED seconds
    unless noted; ``time_scale`` maps them to real time at replay
    (sim seconds per real second). ``lease_ttl_s`` is REAL seconds — the
    server's lease clock runs in real time regardless of replay speed."""

    nodes: int = 100
    namespaces: int = 20
    pods_per_node: int = 4
    duration_s: float = 30.0
    time_scale: float = 5.0
    seed: int = 0

    # traffic shape
    churn_interval_s: float = 2.0        # mean per-node pod churn period
    keepalive_interval_s: float = 10.0   # per-node Lease keepalive cadence
    #: REAL seconds (server clock) — kube's node-lease TTL. Generous vs the
    #: nominal keepalive cadence on purpose: on a loaded box the open-loop
    #: replay can run behind schedule, and a too-tight TTL then reports
    #: scheduler lag as lease expiries
    lease_ttl_s: int = 40
    list_interval_s: float = 7.0         # per-controller paged list (NORMAL)
    list_limit: int = 200
    #: controllers per node — the multi-controller fan-in knob
    #: (docs/watch.md): every controller is an informer (List then Watch on
    #: its namespace prefix), so raising this multiplies WATCHERS PER
    #: PREFIX without adding writes. 1 = the historical one-controller-
    #: per-node shape (trace-identical to specs predating the field).
    controllers_per_node: int = 1
    relist_interval_s: float = 12.0      # aligned relist storms (BACKGROUND)
    lease_list_interval_s: float = 5.0   # node-controller lease sweeps (SYSTEM)
    lease_listers: int = 2
    compact_interval_s: float = 12.0
    grant_spread_s: float = 4.0          # lease grants staggered over this
    watch_spread_s: float = 5.0          # controller starts staggered over this
    value_min: int = 256                 # pod object size distribution bounds
    value_max: int = 4096

    # replay-engine knobs (runtime only; do not affect the generated trace)
    storage: str = "memkv"
    #: the host engine under the ``cuda`` mirror (``--inner-storage``)
    inner_storage: str = "memkv"
    #: read scale-out (docs/replication.md): spawn this many follower
    #: replicas next to the leader; controller list+watch traffic then
    #: routes to the followers (bounded-staleness serializable reads +
    #: local watch serving) while writes/leases round-robin over every
    #: endpoint and forward. Runtime only — the generated op trace is
    #: identical with or without replicas.
    replicas: int = 0
    #: follower bounded-staleness bounds forwarded to --max-staleness-*
    #: (0 rev = unbounded; ms bound keeps refusals honest under chaos)
    max_staleness_rev: int = 0
    max_staleness_ms: float = 15000.0
    #: multichip sharded serving (docs/multichip.md): slots on the scan
    #: mesh's `part` axis / mirror partition count, forwarded as
    #: --mesh-part/--scan-partitions. 0 = server defaults. Only meaningful
    #: with storage="cuda".
    mesh_part: int = 0
    scan_partitions: int = 0
    #: watch fan-out offload (docs/watch.md): spawn every server (leader
    #: AND followers — fan-out capacity scales with replica count) with
    #: --tpu-fanout, i.e. the block-batched device matcher (K4); mesh_wat
    #: > 0 additionally shards the watcher table over that many slots
    #: (forwarded as --mesh-wat). Runtime only — the generated op trace is
    #: identical either way.
    tpu_fanout: bool = False
    mesh_wat: int = 0
    write_shards: int = 8
    range_shards: int = 8
    watch_streams: int = 4
    lease_streams: int = 4
    shard_queue: int = 512               # bounded open-loop backpressure depth
    #: chaos mode (docs/faults.md): fault-schedule preset armed on the
    #: spawned server ("none" = no fault plane — provably inert). Runtime
    #: only: the generated OP trace is untouched; the fault schedule has
    #: its own deterministic trace + sha, echoed in the report.
    faults: str = "none"
    fault_seed: int = 0

    bounds: SLOBounds = field(default_factory=SLOBounds)

    # ------------------------------------------------------------- validity
    def validate(self) -> None:
        if self.nodes < 1 or self.namespaces < 1 or self.pods_per_node < 0:
            raise ValueError("nodes/namespaces/pods_per_node must be positive")
        if self.duration_s <= 0 or self.time_scale <= 0:
            raise ValueError("duration_s and time_scale must be > 0")
        if self.seed < 0:
            raise ValueError("seed must be >= 0")
        # a keepalive cadence slower (in real time) than half the lease TTL
        # guarantees expiries — that is a misconfigured spec, not a finding
        real_keepalive = self.keepalive_interval_s / self.time_scale
        if real_keepalive * 2.0 > self.lease_ttl_s:
            raise ValueError(
                f"keepalive every {real_keepalive:.1f}s real vs TTL "
                f"{self.lease_ttl_s}s: leases would expire by construction")
        if min(self.write_shards, self.range_shards,
               self.watch_streams, self.lease_streams) < 1:
            raise ValueError("shard/stream counts must be >= 1")
        if self.controllers_per_node < 1:
            raise ValueError("controllers_per_node must be >= 1")
        # the mesh knobs mirror the port's cli.validate_args: fail here
        # instead of spawning a server that boot-rejects them
        if self.mesh_wat < 0:
            raise ValueError("mesh_wat must be >= 0")
        if self.mesh_wat and not self.tpu_fanout:
            raise ValueError("mesh_wat requires tpu_fanout=True")
        if self.mesh_part < 0 or self.scan_partitions < 0:
            raise ValueError("mesh_part/scan_partitions must be >= 0")
        if (self.mesh_part or self.scan_partitions) \
                and self.storage != "cuda":
            raise ValueError(
                "mesh_part/scan_partitions require storage='cuda' (the mesh "
                "shards the cuda engine's scan mirror)")
        if self.mesh_part and self.scan_partitions % self.mesh_part:
            raise ValueError(
                f"scan_partitions={self.scan_partitions} must be a multiple "
                f"of mesh_part={self.mesh_part}")
        if self.storage not in STORAGES:
            hint = (" ('tpu' is the JAX package's engine; the port's device "
                    "engine is 'cuda')" if self.storage == "tpu" else "")
            raise ValueError(
                f"storage={self.storage!r} unknown; the port's CLI serves "
                f"{STORAGES}{hint}")
        if self.inner_storage not in ("memkv", "native"):
            raise ValueError(f"inner_storage={self.inner_storage!r} must be "
                             "'memkv' or 'native'")
        if self.replicas < 0 or self.max_staleness_rev < 0 \
                or self.max_staleness_ms < 0:
            raise ValueError("replicas/max_staleness_* must be >= 0")
        from ..faults.schedule import PRESETS

        if self.faults not in PRESETS:
            raise ValueError(
                f"faults={self.faults!r} unknown; presets: {PRESETS}")

    # ------------------------------------------------------------ factories
    @classmethod
    def for_cluster(cls, nodes: int, **overrides: Any) -> "WorkloadSpec":
        """The ``make bench-cluster N=...`` shape: namespaces scale with the
        node count, and at >= 100 nodes the relist storms are expected to
        form query batches (kb_sched_batch_size must move)."""
        namespaces = max(4, min(100, nodes // 10))
        bounds = overrides.pop(
            "bounds",
            SLOBounds(min_batched_requests=2 if nodes >= 100 else 0))
        return cls(nodes=nodes, namespaces=namespaces, bounds=bounds,
                   **overrides)

    @classmethod
    def for_churn_heavy(cls, nodes: int, **overrides: Any) -> "WorkloadSpec":
        """Write-storm scenario (docs/writes.md): pod churn ~4x the
        cluster shape plus a node-lease keepalive storm (tight cadence,
        every node), with the list/relist load thinned so the traffic
        skews hard toward create/update/delete — the shape that exercises
        the scheduler's write-group formation and the device mirror's
        incremental delta merge. The SLO bounds REQUIRE group commits to
        have formed (``min_write_batched_ops``), and the reconcile
        section re-asserts the ``kb_sched_write_batch_size`` histogram
        moved."""
        namespaces = max(4, min(100, nodes // 10))
        bounds = overrides.pop(
            "bounds",
            SLOBounds(min_write_batched_ops=2,
                      min_batched_requests=0))
        defaults = dict(
            nodes=nodes, namespaces=namespaces, bounds=bounds,
            pods_per_node=6,
            churn_interval_s=0.5,       # ~4x the cluster churn rate
            keepalive_interval_s=4.0,   # keepalive storm (real: .8s @ x5)
            lease_ttl_s=40,
            list_interval_s=20.0,       # thin the read load
            relist_interval_s=25.0,
            lease_list_interval_s=10.0,
            lease_listers=1,
            grant_spread_s=2.0,
        )
        defaults.update(overrides)
        return cls(**defaults)

    @classmethod
    def for_watch_heavy(cls, nodes: int, **overrides: Any) -> "WorkloadSpec":
        """Watch fan-out scenario (docs/watch.md): multi-controller fan-in
        — several informer controllers per node, so each namespace prefix
        carries MANY overlapping watchers — over deliberately thin writes
        (slow churn, no keepalive storm). The traffic is then dominated by
        the (events x watchers) fan-out product rather than by write or
        list volume: the shape that exercises the block-batched device
        matcher and the follower watch offload (`REPLICAS=2` pins the
        whole watcher population to the followers). Servers spawn with
        the device matcher armed (``tpu_fanout``); the SLO keeps the
        queue->wire watch lag bound meaningful instead of the loose
        default."""
        namespaces = max(4, min(100, nodes // 10))
        bounds = overrides.pop(
            "bounds",
            SLOBounds(watch_wire_lag_p99_s=5.0,
                      min_batched_requests=0))
        defaults = dict(
            nodes=nodes, namespaces=namespaces, bounds=bounds,
            controllers_per_node=4,      # ~4x watchers per prefix
            pods_per_node=4,
            churn_interval_s=4.0,        # thin writes: ~half cluster churn
            keepalive_interval_s=10.0,
            lease_ttl_s=40,
            list_interval_s=12.0,        # thin the list load too: the watch
            relist_interval_s=30.0,      # product, not list rows, is the work
            lease_list_interval_s=10.0,
            lease_listers=1,
            watch_spread_s=6.0,
            tpu_fanout=True,
        )
        defaults.update(overrides)
        return cls(**defaults)

    @classmethod
    def for_chaos(cls, nodes: int, preset: str = "smoke",
                  **overrides: Any) -> "WorkloadSpec":
        """Chaos-mode replay (docs/faults.md): the churn_heavy traffic
        shape under an armed fault schedule. Latency/shed/error bounds are
        deliberately loose — the chaos gate is the KEYSTONE consistency
        check (no acked write lost, no definite-error ghost) plus the
        per-kind injected-fault reconcile, not happy-path p99s; lease
        expiries are legal (keepalives legitimately fail inside conn-drop
        windows) and the replay owns no compaction guarantee under
        injected storage errors."""
        namespaces = max(4, min(100, nodes // 10))
        bounds = overrides.pop("bounds", SLOBounds(
            max_shed_rate=0.5,
            max_error_rate=0.5,
            watch_wire_lag_p99_s=30.0,
            max_lease_expiries=10_000,
            max_watch_cancels=10_000,
            min_compactions=0,
            min_write_batched_ops=0,
        ))
        defaults = dict(
            nodes=nodes, namespaces=namespaces, bounds=bounds,
            faults=preset,
            pods_per_node=6,
            churn_interval_s=0.5,
            keepalive_interval_s=4.0,
            lease_ttl_s=40,
            list_interval_s=10.0,
            relist_interval_s=12.0,
            lease_list_interval_s=10.0,
            lease_listers=1,
            grant_spread_s=2.0,
        )
        defaults.update(overrides)
        return cls(**defaults)

    @classmethod
    def for_smoke(cls, nodes: int = 10, **overrides: Any) -> "WorkloadSpec":
        """Small-N CI smoke: short replay, every traffic shape still
        present (several churn ticks, >= 1 relist storm, >= 1 compaction,
        >= 1 keepalive per node)."""
        defaults = dict(
            nodes=nodes, namespaces=max(2, nodes // 3), pods_per_node=3,
            duration_s=10.0, time_scale=5.0,
            churn_interval_s=1.5, keepalive_interval_s=4.0, lease_ttl_s=15,
            list_interval_s=3.0, relist_interval_s=4.0,
            lease_list_interval_s=3.0, lease_listers=1,
            compact_interval_s=4.0, grant_spread_s=1.0, watch_spread_s=2.0,
            write_shards=4, range_shards=4, watch_streams=2, lease_streams=2,
        )
        defaults.update(overrides)
        return cls(**defaults)

    def with_(self, **overrides: Any) -> "WorkloadSpec":
        return replace(self, **overrides)

    def to_dict(self) -> dict:
        return asdict(self)
