"""Deterministic kube-apiserver traffic generator.

``generate(spec)`` is a pure function of the spec: one seeded
``random.Random`` walks a simulated-time event wheel and emits the full op
schedule as a list of :class:`Op` records plus a canonical byte trace
(one line per op) whose sha256 is the replay's identity. Two calls with
the same spec produce byte-identical traces — the property the
determinism test and the runner's self-check both assert, and the reason
kblint KB110 bans unseeded randomness and wall-clock reads from this
package.

Traffic model (one simulated N-node cluster):

- **preload**: ``pods_per_node`` pods per node exist before the clock
  starts (bulk-created by the runner, not paced);
- **pod churn**: each node schedules its next churn tick from an
  exponential with mean ``churn_interval_s``; the tick creates, updates,
  or deletes one of the node's pods under
  ``/registry/pods/<ns>/<name>`` with a bounded log-normal object size;
- **controllers**: ``controllers_per_node`` per node (default 1 — the
  historical one-per-node shape; watch-heavy specs raise it so each
  namespace prefix carries many overlapping watchers, the fan-out
  product the device matcher is built for). CTRL_START = initial List
  then Watch
  from the returned revision (the informer bootstrap); CTRL_LIST = a
  periodic paged List (NORMAL lane); CTRL_RELIST = an unpaged List
  (BACKGROUND lane) fired on an *aligned* cadence so relists arrive as
  storms of distinct ranges — the shape that exercises query-batched
  scan formation;
- **node leases**: one Lease per node, granted staggered over
  ``grant_spread_s`` with an attach key under
  ``/registry/leases/kube-node-lease/``; keepalives every
  ``keepalive_interval_s`` (SYSTEM lane server-side);
- **lease sweeps**: ``lease_listers`` node-controller loops listing the
  lease prefix (SYSTEM lane Range traffic);
- **compaction**: a COMPACT op every ``compact_interval_s``.
"""

from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass
from typing import Any

from .clock import EventWheel
from .spec import WorkloadSpec

PODS_PREFIX = b"/registry/pods/"
LEASE_PREFIX = b"/registry/leases/kube-node-lease/"

# op kinds, also the trace vocabulary (docs/workloads.md)
PRELOAD_CREATE = "PRELOAD_CREATE"
LEASE_GRANT = "LEASE_GRANT"
LEASE_KEEPALIVE = "LEASE_KEEPALIVE"
POD_CREATE = "POD_CREATE"
POD_UPDATE = "POD_UPDATE"
POD_DELETE = "POD_DELETE"
CTRL_START = "CTRL_START"
CTRL_LIST = "CTRL_LIST"
CTRL_RELIST = "CTRL_RELIST"
LEASE_LIST = "LEASE_LIST"
COMPACT = "COMPACT"

ALL_KINDS = (
    PRELOAD_CREATE, LEASE_GRANT, LEASE_KEEPALIVE, POD_CREATE, POD_UPDATE,
    POD_DELETE, CTRL_START, CTRL_LIST, CTRL_RELIST, LEASE_LIST, COMPACT,
)


@dataclass(frozen=True)
class Op:
    """One scheduled operation. ``phase`` is "P" (preload, executed as a
    bulk burst before the pacer starts) or "R" (replay, dispatched at
    ``t_ms`` simulated time)."""

    phase: str
    t_ms: int
    seq: int
    kind: str
    key: bytes = b""
    node: int = -1
    ns: int = -1
    watcher: int = -1
    size: int = 0

    def to_line(self) -> bytes:
        parts = [
            self.phase.encode(), b"%09d" % self.t_ms, b"%07d" % self.seq,
            self.kind.encode(),
        ]
        if self.key:
            parts.append(b"key=" + self.key)
        if self.node >= 0:
            parts.append(b"node=%d" % self.node)
        if self.ns >= 0:
            parts.append(b"ns=%d" % self.ns)
        if self.watcher >= 0:
            parts.append(b"watcher=%d" % self.watcher)
        if self.size:
            parts.append(b"size=%d" % self.size)
        return b" ".join(parts)


@dataclass(frozen=True)
class Schedule:
    spec: WorkloadSpec
    ops: tuple[Op, ...]

    @property
    def preload(self) -> tuple[Op, ...]:
        return tuple(op for op in self.ops if op.phase == "P")

    @property
    def replay(self) -> tuple[Op, ...]:
        return tuple(op for op in self.ops if op.phase == "R")

    def trace_bytes(self) -> bytes:
        return b"\n".join(op.to_line() for op in self.ops) + b"\n"

    def sha256(self) -> str:
        return hashlib.sha256(self.trace_bytes()).hexdigest()

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for op in self.ops:
            out[op.kind] = out.get(op.kind, 0) + 1
        return out


def ns_name(ns: int) -> bytes:
    return b"ns-%04d" % ns


def pod_key(ns: int, node: int, pod_seq: int, tag: int) -> bytes:
    # /registry/pods/<ns>/<name>: hierarchical, shared-prefix-heavy (FOCUS)
    return PODS_PREFIX + ns_name(ns) + b"/pod-%05d-%06d-%08x" % (node, pod_seq, tag)


def node_lease_key(node: int) -> bytes:
    return LEASE_PREFIX + b"node-%05d" % node


def _pod_size(rng: random.Random, spec: WorkloadSpec) -> int:
    # bounded log-normal around ~1KiB: most pod objects are small, a tail
    # is several KiB (status + managedFields bloat)
    size = int(rng.lognormvariate(math.log(1024.0), 0.5))
    return max(spec.value_min, min(spec.value_max, size))


def generate(spec: WorkloadSpec) -> Schedule:
    """Build the full deterministic schedule for ``spec``."""
    spec.validate()
    rng = random.Random(spec.seed)
    wheel = EventWheel()
    duration_ms = int(spec.duration_s * 1000)
    ops: list[Op] = []
    seq = 0

    def emit(phase: str, t_ms: int, kind: str, **kw: Any) -> None:
        nonlocal seq
        ops.append(Op(phase=phase, t_ms=t_ms, seq=seq, kind=kind, **kw))
        seq += 1

    # ------------------------------------------------------------- preload
    # node i's pods land in deterministic namespaces; per-node pod seq
    # numbers keep names unique without global coordination
    node_pods: list[list[tuple[bytes, int]]] = [[] for _ in range(spec.nodes)]
    pod_seqs = [0] * spec.nodes

    def new_pod(node: int) -> tuple[bytes, int, int]:
        ns = rng.randrange(spec.namespaces)
        key = pod_key(ns, node, pod_seqs[node], rng.getrandbits(32))
        pod_seqs[node] += 1
        node_pods[node].append((key, ns))
        return key, ns, _pod_size(rng, spec)

    for node in range(spec.nodes):
        for _ in range(spec.pods_per_node):
            key, ns, size = new_pod(node)
            emit("P", 0, PRELOAD_CREATE, key=key, node=node, ns=ns, size=size)

    # ------------------------------------------------- seed the event wheel
    grant_spread_ms = max(1, int(spec.grant_spread_s * 1000))
    watch_spread_ms = max(1, int(spec.watch_spread_s * 1000))
    ka_ms = max(1, int(spec.keepalive_interval_s * 1000))
    churn_ms = max(1, int(spec.churn_interval_s * 1000))
    list_ms = max(1, int(spec.list_interval_s * 1000))
    relist_ms = max(1, int(spec.relist_interval_s * 1000))
    lease_list_ms = max(1, int(spec.lease_list_interval_s * 1000))
    compact_ms = max(1, int(spec.compact_interval_s * 1000))

    for node in range(spec.nodes):
        grant_t = (node * grant_spread_ms) // spec.nodes
        wheel.push(grant_t, LEASE_GRANT, node)
        wheel.push(grant_t + ka_ms, LEASE_KEEPALIVE, node)
        wheel.push(int(rng.expovariate(1.0 / churn_ms)), "CHURN", node)
    # controller scheduling is pure arithmetic (no rng draw), so raising
    # controllers_per_node never perturbs the churn/lease streams — specs
    # with the default of 1 keep their historical trace hash
    n_controllers = spec.nodes * spec.controllers_per_node
    for w in range(n_controllers):
        start_t = (w * watch_spread_ms) // n_controllers
        wheel.push(start_t, CTRL_START, w)
        wheel.push(start_t + list_ms, CTRL_LIST, w)
    # aligned relist storms: every controller relists at the SAME tick —
    # the distinct-range burst that exercises query-batched scan formation
    for w in range(n_controllers):
        wheel.push(relist_ms, CTRL_RELIST, w)
    for lister in range(spec.lease_listers):
        wheel.push(lease_list_ms + lister * 97, LEASE_LIST, lister)
    wheel.push(compact_ms, COMPACT, 0)

    # ------------------------------------------------------ walk the wheel
    for t_ms, kind, ident in wheel.drain_until(duration_ms):
        if kind == LEASE_GRANT:
            emit("R", t_ms, LEASE_GRANT, key=node_lease_key(ident), node=ident)
        elif kind == LEASE_KEEPALIVE:
            emit("R", t_ms, LEASE_KEEPALIVE, node=ident)
            wheel.push(t_ms + ka_ms, LEASE_KEEPALIVE, ident)
        elif kind == "CHURN":
            pods = node_pods[ident]
            roll = rng.random()
            if not pods or (roll < 0.35 and len(pods) < 2 * spec.pods_per_node):
                key, ns, size = new_pod(ident)
                emit("R", t_ms, POD_CREATE, key=key, node=ident, ns=ns, size=size)
            elif roll < 0.80:
                key, ns = pods[rng.randrange(len(pods))]
                emit("R", t_ms, POD_UPDATE, key=key, node=ident, ns=ns,
                     size=_pod_size(rng, spec))
            else:
                key, ns = pods.pop(rng.randrange(len(pods)))
                emit("R", t_ms, POD_DELETE, key=key, node=ident, ns=ns)
            wheel.push(t_ms + 1 + int(rng.expovariate(1.0 / churn_ms)),
                       "CHURN", ident)
        elif kind == CTRL_START:
            emit("R", t_ms, CTRL_START, watcher=ident, ns=ident % spec.namespaces)
        elif kind == CTRL_LIST:
            emit("R", t_ms, CTRL_LIST, watcher=ident, ns=ident % spec.namespaces)
            wheel.push(t_ms + list_ms, CTRL_LIST, ident)
        elif kind == CTRL_RELIST:
            emit("R", t_ms, CTRL_RELIST, watcher=ident, ns=ident % spec.namespaces)
            wheel.push(t_ms + relist_ms, CTRL_RELIST, ident)
        elif kind == LEASE_LIST:
            emit("R", t_ms, LEASE_LIST, watcher=ident)
            wheel.push(t_ms + lease_list_ms, LEASE_LIST, ident)
        elif kind == COMPACT:
            emit("R", t_ms, COMPACT)
            wheel.push(t_ms + compact_ms, COMPACT, 0)
        else:  # pragma: no cover - the wheel only holds the kinds above
            raise AssertionError(f"unknown wheel event {kind!r}")

    return Schedule(spec=spec, ops=tuple(ops))
