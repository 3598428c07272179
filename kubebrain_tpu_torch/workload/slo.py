"""SLO report: schema, /metrics reconciliation helpers, and bounds
evaluation for the workload replay harness.

The report is machine-readable JSON (``WORKLOAD_rNN.json``) with a fixed
schema (:data:`SCHEMA_ID`, checked by :func:`validate_report`) so later
perf PRs can diff replays mechanically. The prometheus text parser here
is deliberately tiny — it reads the server's own /metrics exposition, the
same bytes an operator's scrape sees, which is the whole point of
reconciling client-side op counts against it.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any

SCHEMA_ID = "kubebrain-workload-slo/v1"

# ------------------------------------------------------------ prom parsing

_SERIES_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+([^\s]+)\s*$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

#: parsed exposition: name -> list of (labels dict, value)
PromSnapshot = dict


def parse_prom(text: str) -> PromSnapshot:
    out: dict[str, list[tuple[dict, float]]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if not m:
            continue
        name, raw_labels, raw_value = m.groups()
        try:
            value = float(raw_value)
        except ValueError:
            continue
        labels = dict(_LABEL_RE.findall(raw_labels)) if raw_labels else {}
        out.setdefault(name, []).append((labels, value))
    return out


def _matches(labels: dict, want: dict) -> bool:
    return all(labels.get(k) == v for k, v in want.items())


def merge_snapshots(snaps: list) -> PromSnapshot:
    """Sum several servers' expositions into one (the multi-replica
    topology's reconcile view): series with identical (name, labels) add —
    correct for counters and histogram buckets/sums, which is all the
    merged view is used for. Per-server gauges (watermarks, backlog
    series) must be read from the individual snapshots instead."""
    acc: dict[str, dict[tuple, float]] = {}
    for snap in snaps:
        for name, series in snap.items():
            bucket = acc.setdefault(name, {})
            for labels, value in series:
                key = tuple(sorted(labels.items()))
                bucket[key] = bucket.get(key, 0.0) + value
    return {
        name: [(dict(key), value) for key, value in bucket.items()]
        for name, bucket in acc.items()
    }


def series_sum(snap: PromSnapshot, name: str, **want: str) -> float:
    """Sum of all series under ``name`` whose labels match ``want``.
    Counters are tried under both ``name`` and ``name_total`` (the
    prometheus_client text-exposition suffix)."""
    total, found = 0.0, False
    for candidate in (name, name + "_total"):
        for labels, value in snap.get(candidate, ()):
            if _matches(labels, want):
                total += value
                found = True
        if found:
            break
    return total


def series_count(snap: PromSnapshot, name: str, **want: str) -> int:
    """Number of distinct series under ``name`` matching ``want`` (e.g.
    one ``kb_watch_backlog`` series per live watcher)."""
    return sum(1 for labels, _v in snap.get(name, ()) if _matches(labels, want))


def delta(after: PromSnapshot, before: PromSnapshot, name: str, **want: str) -> float:
    return series_sum(after, name, **want) - series_sum(before, name, **want)


def hist_quantile(snap: PromSnapshot, name: str, q: float, **want: str) -> float | None:
    """Quantile from a cumulative-bucket histogram, linearly interpolated
    within the landing bucket. Returns None when the histogram is empty;
    observations in the +Inf bucket report the top finite bound (a
    conservative floor, not a fabricated tail)."""
    buckets: list[tuple[float, float]] = []
    for labels, value in snap.get(name + "_bucket", ()):
        if "le" not in labels:
            continue
        rest = {k: v for k, v in labels.items() if k != "le"}
        if not _matches(rest, want):
            continue
        le = float("inf") if labels["le"] in ("+Inf", "inf") else float(labels["le"])
        buckets.append((le, value))
    if not buckets:
        return None
    buckets.sort(key=lambda b: b[0])
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in buckets:
        if cum >= rank:
            if math.isinf(bound):
                return prev_bound
            if cum == prev_cum:
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = bound, cum
    return prev_bound


def hist_count_sum(snap: PromSnapshot, name: str, **want: str) -> tuple[float, float]:
    return (series_sum(snap, name + "_count", **want),
            series_sum(snap, name + "_sum", **want))


# ------------------------------------------------------------ report schema

#: required top-level fields and the required keys inside each (one level
#: deep is enough for mechanical diffing; values are free-form beyond it)
_REQUIRED: dict[str, tuple[str, ...]] = {
    "schema": (),
    "spec": ("nodes", "seed", "duration_s", "time_scale"),
    "platform": ("platform", "device"),
    "trace": ("sha256", "ops", "preload_ops", "replay_ops"),
    "replay": ("wall_s", "ops_per_sec", "max_dispatch_lag_s", "drained"),
    "lanes": ("system", "normal", "background", "write"),
    "op_kinds": (),
    "watch": ("watchers", "events", "cancelled",
              "lag_wire_p99_s", "lag_queue_p99_s"),
    "leases": ("granted", "keepalives_sent", "keepalives_acked",
               "expired_acks", "metrics"),
    "sched": ("batched_launches", "batched_requests", "shed_total",
              "coalesced_total", "write_batched_groups",
              "write_batched_ops"),
    "compact": ("completed", "skipped", "phases", "victims",
                "escalations", "full_rebuilds"),
    "reconcile": ("ok", "checks"),
    "slo": ("pass", "violations", "bounds"),
    "errors": (),
    "faults": ("armed",),
}

_LANE_FIELDS = ("count", "p50_ms", "p99_ms", "shed", "errors")

#: required inside report["faults"] when the fault plane was ARMED (chaos
#: run): the schedule echo (identity), the per-kind injected/observed
#: reconcile, the keystone consistency check, and the degraded-window stats
_FAULTS_ARMED_FIELDS = ("schedule", "injected", "reconcile", "consistency",
                        "degraded")
_CONSISTENCY_FIELDS = ("ok", "checked_keys", "acked_live", "acked_deleted",
                       "ambiguous", "losses", "ghosts", "rev_mismatches")

#: required inside report["replica"] when the topology ran followers
#: (docs/replication.md): per-replica served/forwarded/lag accounting,
#: the fence probes, and the revision-consistency reconcile
_REPLICA_FIELDS = ("replicas", "endpoints", "per_replica", "fence_probes",
                   "endpoint_failovers", "rows_per_sec", "reconcile")
_PER_REPLICA_FIELDS = ("target", "applied_revision", "lag_revisions",
                       "served", "forwarded", "refused",
                       "fence_wait_p99_s", "max_client_revision",
                       "revision_bound_ok")


def validate_report(report: dict) -> None:
    """Raise ValueError naming every schema problem at once."""
    problems: list[str] = []
    if report.get("schema") != SCHEMA_ID:
        problems.append(f"schema must be {SCHEMA_ID!r}, got {report.get('schema')!r}")
    for field, subkeys in _REQUIRED.items():
        if field not in report:
            problems.append(f"missing field {field!r}")
            continue
        for sub in subkeys:
            if sub not in report[field]:
                problems.append(f"missing field {field!r}.{sub!r}")
    for lane, stats in report.get("lanes", {}).items():
        for f in _LANE_FIELDS:
            if f not in stats:
                problems.append(f"lane {lane!r} missing {f!r}")
    faults = report.get("faults", {})
    if faults.get("armed"):
        for sub in _FAULTS_ARMED_FIELDS:
            if sub not in faults:
                problems.append(f"missing field 'faults'.{sub!r}")
        for sub in _CONSISTENCY_FIELDS:
            if sub not in faults.get("consistency", {}):
                problems.append(f"missing field 'faults'.'consistency'.{sub!r}")
    replica = report.get("replica")
    if replica is not None and replica.get("replicas", 0) > 0:
        for sub in _REPLICA_FIELDS:
            if sub not in replica:
                problems.append(f"missing field 'replica'.{sub!r}")
        for i, pr in enumerate(replica.get("per_replica", ())):
            for sub in _PER_REPLICA_FIELDS:
                if sub not in pr:
                    problems.append(
                        f"missing field 'replica'.'per_replica'[{i}].{sub!r}")
    if problems:
        raise ValueError("invalid SLO report: " + "; ".join(problems))


# --------------------------------------------------------------- evaluation

def percentile(samples: list[float], q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(math.ceil(q * len(s))) - 1))
    return s[idx]


def evaluate(report: dict, bounds: Any) -> tuple[bool, list[str]]:
    """Judge a report against declared bounds; returns (passed, violations).
    ``bounds`` is a spec.SLOBounds (or anything with its attributes)."""
    v: list[str] = []
    if not report["replay"].get("drained", True):
        # name the drain timeout explicitly: with ops still in flight at
        # scrape time, the reconcile deltas below race the workers — a
        # reconcile mismatch here would otherwise read as a counting bug
        v.append("drain/flush timed out with ops still in flight "
                 "(reconciliation below is unreliable)")
    lane_bounds = {
        "write": bounds.write_p99_ms,
        "normal": bounds.normal_p99_ms,
        "system": bounds.system_p99_ms,
        "background": bounds.background_p99_ms,
    }
    total = shed = errors = 0
    for lane, stats in report["lanes"].items():
        total += stats["count"]
        shed += stats["shed"]
        errors += stats["errors"]
        bound = lane_bounds.get(lane)
        if bound is not None and stats["count"] and stats["p99_ms"] > bound:
            v.append(f"lane {lane}: p99 {stats['p99_ms']:.1f}ms > {bound:.1f}ms")
    if total:
        if shed / total > bounds.max_shed_rate:
            v.append(f"shed rate {shed}/{total} > {bounds.max_shed_rate:.2%}")
        if errors / total > bounds.max_error_rate:
            v.append(f"error rate {errors}/{total} > {bounds.max_error_rate:.2%}")
    wire_p99 = report["watch"]["lag_wire_p99_s"]
    if report["watch"]["events"] and wire_p99 is not None \
            and wire_p99 > bounds.watch_wire_lag_p99_s:
        v.append(f"watch wire lag p99 {wire_p99:.3f}s > "
                 f"{bounds.watch_wire_lag_p99_s}s")
    if report["watch"]["cancelled"] > bounds.max_watch_cancels:
        v.append(f"{report['watch']['cancelled']} watch cancels > "
                 f"{bounds.max_watch_cancels}")
    expiries = report["leases"]["metrics"].get("expired_delta", 0)
    if expiries > bounds.max_lease_expiries:
        v.append(f"{expiries} lease expiries > {bounds.max_lease_expiries}")
    # completed compactions only — "count" also tallies skip/shed/error
    if report["op_kinds"].get("COMPACT", {}).get("ok", 0) < bounds.min_compactions:
        v.append(f"fewer than {bounds.min_compactions} compactions completed")
    if report["sched"]["batched_requests"] < bounds.min_batched_requests:
        v.append(f"batched requests {report['sched']['batched_requests']} < "
                 f"{bounds.min_batched_requests}")
    min_wb = getattr(bounds, "min_write_batched_ops", 0)
    if report["sched"].get("write_batched_ops", 0) < min_wb:
        v.append(f"write ops in commit groups "
                 f"{report['sched'].get('write_batched_ops', 0)} < {min_wb} "
                 "(group commit never formed — docs/writes.md)")
    if not report["reconcile"]["ok"]:
        bad = [c for c, r in report["reconcile"]["checks"].items() if not r["ok"]]
        v.append(f"client/server reconciliation failed: {', '.join(bad)}")
    faults = report.get("faults", {})
    if faults.get("armed"):
        # the chaos gates (docs/faults.md): keystone consistency first
        cons = faults["consistency"]
        if not cons["ok"]:
            v.append(
                f"acknowledged-write consistency FAILED: "
                f"{len(cons['losses'])} acked writes lost, "
                f"{len(cons['ghosts'])} definite-error/unissued ghosts, "
                f"{len(cons['rev_mismatches'])} revision mismatches")
        bad_kinds = [k for k, r in faults["reconcile"].items() if not r["ok"]]
        if bad_kinds:
            v.append("fault injection reconcile failed (scheduled kind "
                     f"never observed injecting): {', '.join(bad_kinds)}")
        deg_p99 = faults["degraded"].get("p99_ms")
        bound = getattr(bounds, "degraded_p99_ms", 0.0)
        if deg_p99 is not None and bound and deg_p99 > bound:
            v.append(f"degraded-window p99 {deg_p99:.1f}ms > {bound:.1f}ms")
    replica = report.get("replica")
    if replica is not None and replica.get("replicas", 0) > 0:
        # revision consistency (docs/replication.md): no response revision
        # may exceed the serving replica's applied watermark, and fenced
        # reads must come back at or above their fence
        rec = replica.get("reconcile", {})
        if not rec.get("ok", False):
            bad = [c for c, r in rec.get("checks", {}).items()
                   if not r.get("ok", True)]
            v.append("replica revision-consistency reconcile failed: "
                     + ", ".join(bad))
        fp = replica.get("fence_probes", {})
        if fp.get("violations", 0):
            v.append(f"{fp['violations']} fence probe(s) answered BELOW "
                     "their fence revision (stale linearizable read)")
    return (not v), v


# ----------------------------------------------------------------- file IO

_REPORT_RE = re.compile(r"^WORKLOAD_r(\d+)\.json$")
_CHAOS_RE = re.compile(r"^CHAOS_r(\d+)\.json$")
_REPLICA_RE = re.compile(r"^REPLICA_r(\d+)\.json$")


def next_report_path(root: str, chaos: bool = False,
                     replica: bool = False) -> str:
    """``WORKLOAD_rNN.json`` (``CHAOS_rNN.json`` for fault-armed runs,
    ``REPLICA_rNN.json`` for fault-free multi-replica topologies) with the
    next free round number under root."""
    if chaos:
        pat, stem = _CHAOS_RE, "CHAOS"
    elif replica:
        pat, stem = _REPLICA_RE, "REPLICA"
    else:
        pat, stem = _REPORT_RE, "WORKLOAD"
    rounds = [int(m.group(1)) for f in os.listdir(root)
              if (m := pat.match(f))]
    return os.path.join(
        root, "%s_r%02d.json" % (stem, max(rounds, default=0) + 1))


def write_report(report: dict, path: str) -> str:
    validate_report(report)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path
