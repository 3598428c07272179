"""The port's workload replay harness (``kubebrain_tpu_torch.workload``)
held against the JAX package's (``kubebrain_tpu.workload``): counterparts
of the 16 cases of ``tests/test_workload.py`` (the served ones through the
port's CLI on the CPU, ``--device cpu``, and the port's client), plus

- the generator's trace and sha256 equal to the JAX generator's for every
  factory;
- ``slo.parse_prom``, ``percentile`` and ``evaluate`` equal to the JAX
  module's on the same inputs;
- ``for_smoke`` replayed by both runners (the JAX CLI and the port's, both
  on the CPU): equal sha256, equal counts per op kind, both reports green;
- ``spec.validate`` taking the mesh knobs over ``cuda`` only, as the
  port's CLI does, and refusing the JAX engine's name ``tpu``.
"""

import copy
import json
import os
import random
import time

import numpy as np
import pytest

from kubebrain_tpu.workload import generator as jgenerator
from kubebrain_tpu.workload import slo as jslo
from kubebrain_tpu.workload.spec import SLOBounds as JSLOBounds
from kubebrain_tpu.workload.spec import WorkloadSpec as JWorkloadSpec
from kubebrain_tpu_torch.cli import build_endpoint, build_parser
from kubebrain_tpu_torch.workload import generator, slo
from kubebrain_tpu_torch.workload.clock import EventWheel
from kubebrain_tpu_torch.workload.spec import SLOBounds, WorkloadSpec

from test_etcd_server import free_port


# --------------------------------------------------------------- generator
def test_trace_determinism_byte_identical():
    """Same seed + N => byte-identical generated op trace, twice."""
    spec = WorkloadSpec.for_smoke(16, seed=7)
    a = generator.generate(spec)
    b = generator.generate(spec)
    assert a.trace_bytes() == b.trace_bytes()
    assert a.sha256() == b.sha256()
    # the schedule is derived only from the spec: a third run after
    # unrelated RNG use must agree
    random.random()
    assert generator.generate(spec).sha256() == a.sha256()


def test_trace_seed_and_shape_sensitivity():
    base = WorkloadSpec.for_smoke(16, seed=7)
    assert generator.generate(base.with_(seed=8)).sha256() != \
        generator.generate(base).sha256()
    assert generator.generate(base.with_(nodes=17)).sha256() != \
        generator.generate(base).sha256()


def test_trace_covers_every_traffic_shape():
    spec = WorkloadSpec.for_smoke(12, seed=3)
    sched = generator.generate(spec)
    counts = sched.counts()
    for kind in generator.ALL_KINDS:
        assert counts.get(kind, 0) > 0, f"no {kind} ops generated"
    assert counts[generator.LEASE_GRANT] == spec.nodes
    assert counts[generator.CTRL_START] == spec.nodes
    assert counts[generator.LEASE_KEEPALIVE] >= spec.nodes
    assert counts[generator.PRELOAD_CREATE] == spec.nodes * spec.pods_per_node
    replay = sched.replay
    assert all(a.t_ms <= b.t_ms for a, b in zip(replay, replay[1:]))
    assert all(a.seq < b.seq for a, b in zip(replay, replay[1:]))
    for op in sched.ops:
        if op.kind.startswith("POD") or op.kind == generator.PRELOAD_CREATE:
            assert op.key.startswith(generator.PODS_PREFIX)
            assert op.key.count(b"/") == 4  # /registry/pods/<ns>/<name>
        if op.kind == generator.LEASE_GRANT:
            assert op.key.startswith(generator.LEASE_PREFIX)


def test_generator_never_updates_deleted_pods():
    sched = generator.generate(WorkloadSpec.for_smoke(10, seed=11))
    dead: set = set()
    for op in sched.replay:
        if op.kind == generator.POD_DELETE:
            dead.add(op.key)
        elif op.kind in (generator.POD_UPDATE, generator.POD_CREATE):
            assert op.key not in dead, f"{op.kind} on deleted key {op.key!r}"


def test_event_wheel_deterministic_tiebreak():
    w = EventWheel()
    w.push(5, "b", 1)
    w.push(5, "a", 2)
    w.push(1, "c", 3)
    assert [w.pop() for _ in range(3)] == [
        (1, "c", 3), (5, "b", 1), (5, "a", 2)]
    with pytest.raises(ValueError):
        w.push(-1, "x")


def test_spec_validation_rejects_expiring_keepalives():
    with pytest.raises(ValueError):
        WorkloadSpec(keepalive_interval_s=60.0, time_scale=1.0,
                     lease_ttl_s=5).validate()


FACTORIES = {
    "for_smoke": (), "for_cluster": (1000,), "for_churn_heavy": (1000,),
    "for_watch_heavy": (1000,), "for_chaos": (1000,),
}


@pytest.mark.parametrize("factory", sorted(FACTORIES))
def test_trace_equals_the_jax_generator(factory):
    """Byte for byte the JAX generator's trace, for every factory at its
    ``make bench-cluster`` size (``for_smoke`` at its default)."""
    args = FACTORIES[factory]
    ours = generator.generate(getattr(WorkloadSpec, factory)(*args, seed=3))
    theirs = jgenerator.generate(
        getattr(JWorkloadSpec, factory)(*args, seed=3))
    assert ours.trace_bytes() == theirs.trace_bytes()
    assert ours.sha256() == theirs.sha256()
    assert ours.counts() == theirs.counts()


def test_cluster_trace_is_the_known_one():
    """``for_cluster(1000)``'s identity, as the JAX package gives it."""
    sched = generator.generate(WorkloadSpec.for_cluster(1000))
    assert sched.sha256() == jgenerator.generate(
        JWorkloadSpec.for_cluster(1000)).sha256()
    assert sched.sha256().startswith("fec5a2a2")
    assert (len(sched.preload), len(sched.replay)) == (4000, 24454)


@pytest.mark.parametrize("override", [
    {"mesh_part": 2}, {"mesh_wat": 2, "tpu_fanout": True},
    {"scan_partitions": 4}, {"storage": "tpu"},
], ids=["mesh_part", "mesh_wat", "scan_partitions", "storage_tpu"])
def test_spec_refuses_what_the_port_cannot_serve(override):
    """The JAX engine's name is refused; ``mesh_part`` and
    ``scan_partitions`` are refused on an engine without a mirror
    (``memkv``, the smoke default) and taken over ``cuda``; ``mesh_wat`` is
    refused without ``tpu_fanout``. A mesh knob changes no op of the
    generated trace."""
    spec = WorkloadSpec.for_smoke(4, **override)
    if "mesh_wat" in override:
        spec.validate()  # any engine: the watcher table is the matcher's
        bad = WorkloadSpec.for_smoke(4, mesh_wat=2)
        with pytest.raises(ValueError, match="tpu_fanout"):
            bad.validate()
    else:
        with pytest.raises(ValueError, match="'cuda'"):
            spec.validate()
        bad = spec
    with pytest.raises(ValueError):
        generator.generate(bad)
    if "storage" not in override:
        on_cuda = WorkloadSpec.for_smoke(4, **{"storage": "cuda", **override})
        on_cuda.validate()
        assert generator.generate(on_cuda).sha256() == generator.generate(
            WorkloadSpec.for_smoke(4, storage="cuda")).sha256()


# ------------------------------------------------------------- SLO helpers
_PROM = """\
# HELP rpc_server_count_total rpc_server_count_total
rpc_server_count_total{method="/etcdserverpb.KV/Txn",success="true"} 40
rpc_server_count_total{method="/etcdserverpb.KV/Txn",success="false"} 2
rpc_server_count_total{method="/etcdserverpb.KV/Range",success="true"} 17
kb_lease_granted_total 8
kb_watch_backlog{watcher="3"} 0
kb_watch_backlog{watcher="9"} 2
kb_watch_lag_seconds_bucket{point="wire",le="0.01"} 90
kb_watch_lag_seconds_bucket{point="wire",le="0.1"} 99
kb_watch_lag_seconds_bucket{point="wire",le="+Inf"} 100
kb_watch_lag_seconds_count{point="wire"} 100
kb_watch_lag_seconds_sum{point="wire"} 0.5
"""


def test_prom_parse_and_lookups():
    snap = slo.parse_prom(_PROM)
    assert slo.series_sum(snap, "rpc_server_count",
                          method="/etcdserverpb.KV/Txn") == 42
    assert slo.series_sum(snap, "kb_lease_granted_total") == 8
    assert slo.series_count(snap, "kb_watch_backlog") == 2
    count, total = slo.hist_count_sum(snap, "kb_watch_lag_seconds",
                                      point="wire")
    assert (count, total) == (100, 0.5)
    p50 = slo.hist_quantile(snap, "kb_watch_lag_seconds", 0.5, point="wire")
    p99 = slo.hist_quantile(snap, "kb_watch_lag_seconds", 0.99, point="wire")
    assert 0.0 < p50 <= 0.01
    assert 0.01 < p99 <= 0.1
    assert slo.hist_quantile(snap, "kb_watch_lag_seconds", 1.0,
                             point="wire") == 0.1
    assert slo.hist_quantile(snap, "nope", 0.5) is None


def _seeded_exposition(seed: int) -> str:
    """A Prometheus text of counters, labelled gauges and histograms drawn
    from a numpy seed, with the comment and malformed lines a scrape may
    carry."""
    rng = np.random.RandomState(seed)
    lines = ["# HELP x x", "# TYPE x counter", "not a series line",
             'broken{le="1"} nan-ish']
    for i in range(rng.randint(3, 8)):
        lines.append(f"kb_c{i}_total {rng.randint(0, 10**6)}")
        lines.append(f'kb_g{i}{{lane="l{rng.randint(0, 3)}",watcher="{i}"}} '
                     f"{rng.rand() * 100:.6g}")
    bounds = sorted(set(np.round(rng.rand(6), 4).tolist()))
    cum = 0
    for le in bounds:
        cum += int(rng.randint(0, 50))
        lines.append(f'kb_h_bucket{{point="queue",le="{le}"}} {cum}')
    cum += int(rng.randint(0, 5))
    lines.append(f'kb_h_bucket{{point="queue",le="+Inf"}} {cum}')
    lines.append(f'kb_h_count{{point="queue"}} {cum}')
    lines.append(f'kb_h_sum{{point="queue"}} {rng.rand() * cum:.6g}')
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(4))
def test_prom_helpers_equal_the_jax_module(seed):
    text = _seeded_exposition(seed)
    ours, theirs = slo.parse_prom(text), jslo.parse_prom(text)
    assert ours == theirs
    for name in ("kb_c0", "kb_g0", "kb_h_count"):
        assert slo.series_sum(ours, name) == jslo.series_sum(theirs, name)
    for q in (0.5, 0.9, 0.99, 1.0):
        assert slo.hist_quantile(ours, "kb_h", q, point="queue") == \
            jslo.hist_quantile(theirs, "kb_h", q, point="queue")
    merged = slo.merge_snapshots([ours, ours])
    assert merged == jslo.merge_snapshots([theirs, theirs])
    rng = np.random.RandomState(seed)
    samples = rng.lognormal(0.0, 1.0, rng.randint(0, 300)).tolist()
    for q in (0.0, 0.5, 0.99, 1.0):
        assert slo.percentile(samples, q) == jslo.percentile(samples, q)


def _minimal_report(**overrides) -> dict:
    lane = {"count": 10, "ok": 10, "shed": 0, "errors": 0,
            "p50_ms": 1.0, "p99_ms": 2.0}
    report = {
        "schema": slo.SCHEMA_ID,
        "spec": {"nodes": 4, "seed": 0, "duration_s": 5.0, "time_scale": 5.0},
        "platform": {"platform": "cpu", "device": "test"},
        "trace": {"sha256": "x", "ops": 40, "preload_ops": 8,
                  "replay_ops": 32},
        "replay": {"wall_s": 1.0, "ops_per_sec": 32.0,
                   "max_dispatch_lag_s": 0.0, "drained": True},
        "lanes": {"system": dict(lane), "normal": dict(lane),
                  "background": dict(lane), "write": dict(lane)},
        "op_kinds": {"COMPACT": {"count": 1, "ok": 1}},
        "watch": {"watchers": 4, "events": 12, "cancelled": 0,
                  "lag_wire_p99_s": 0.01, "lag_queue_p99_s": 0.01},
        "leases": {"granted": 4, "keepalives_sent": 8,
                   "keepalives_acked": 8, "expired_acks": 0,
                   "metrics": {"expired_delta": 0}},
        "sched": {"batched_launches": 0, "batched_requests": 0,
                  "write_batched_groups": 0, "write_batched_ops": 0,
                  "shed_total": 0, "coalesced_total": 0},
        "compact": {"completed": 1, "skipped": 0, "phases": {},
                    "victims": {}, "errors": 0, "retries": 0,
                    "escalations": 0, "full_rebuilds": 0},
        "reconcile": {"ok": True, "checks": {}},
        "slo": {"pass": True, "violations": [], "bounds": {}},
        "errors": [],
        "faults": {"armed": False},
    }
    report.update(overrides)
    return report


def test_report_schema_validation():
    slo.validate_report(_minimal_report())  # must not raise
    with pytest.raises(ValueError, match="watch"):
        slo.validate_report(_minimal_report(watch={"watchers": 1}))
    bad = _minimal_report()
    del bad["reconcile"]
    with pytest.raises(ValueError, match="reconcile"):
        slo.validate_report(bad)
    with pytest.raises(ValueError, match="schema"):
        slo.validate_report(_minimal_report(schema="nope/v0"))
    broken_lane = _minimal_report()
    del broken_lane["lanes"]["write"]["p99_ms"]
    with pytest.raises(ValueError, match="write"):
        slo.validate_report(broken_lane)


def test_slo_evaluation_bounds():
    bounds = SLOBounds()
    ok, v = slo.evaluate(_minimal_report(), bounds)
    assert ok and v == []
    r = _minimal_report()
    r["leases"]["metrics"]["expired_delta"] = 3
    ok, v = slo.evaluate(r, bounds)
    assert not ok and any("expir" in x for x in v)
    r = _minimal_report(reconcile={"ok": False, "checks": {
        "txn_rpcs": {"client": 5, "server": 4, "ok": False}}})
    ok, v = slo.evaluate(r, bounds)
    assert not ok and any("txn_rpcs" in x for x in v)
    r = _minimal_report()
    r["lanes"]["system"]["p99_ms"] = bounds.system_p99_ms + 1
    ok, v = slo.evaluate(r, bounds)
    assert not ok and any("lane system" in x for x in v)
    r = _minimal_report(op_kinds={})
    ok, v = slo.evaluate(r, bounds)
    assert not ok and any("compaction" in x for x in v)
    r = _minimal_report(op_kinds={"COMPACT": {"count": 3, "ok": 0}})
    ok, v = slo.evaluate(r, bounds)
    assert not ok and any("compaction" in x for x in v)
    r = _minimal_report()
    r["replay"]["drained"] = False
    ok, v = slo.evaluate(r, bounds)
    assert not ok and any("drain" in x for x in v)


def _mutate(report: dict, what: str) -> dict:
    r = copy.deepcopy(report)
    if what == "lane_p99":
        r["lanes"]["background"]["p99_ms"] = 1e6
    elif what == "shed":
        r["lanes"]["normal"]["shed"] = 9
    elif what == "errors":
        r["lanes"]["write"]["errors"] = 5
    elif what == "wire_lag":
        r["watch"]["lag_wire_p99_s"] = 99.0
    elif what == "cancels":
        r["watch"]["cancelled"] = 2
    elif what == "batched":
        r["sched"]["batched_requests"] = 1
    elif what == "write_groups":
        r["sched"]["write_batched_ops"] = 1
    elif what == "chaos":
        r["faults"] = {"armed": True, "consistency": {
            "ok": False, "losses": ["a"], "ghosts": [], "rev_mismatches": []},
            "reconcile": {"storage_error": {"ok": False}},
            "degraded": {"p99_ms": 1e9}}
    elif what == "replica":
        r["replica"] = {"replicas": 1, "reconcile": {"ok": False, "checks": {
            "revision_bound[x]": {"ok": False}}},
            "fence_probes": {"violations": 2}}
    return r


@pytest.mark.parametrize("what", [
    "none", "lane_p99", "shed", "errors", "wire_lag", "cancels", "batched",
    "write_groups", "chaos", "replica"])
def test_evaluate_equals_the_jax_module(what):
    report = _mutate(_minimal_report(), what)
    kw = dict(min_batched_requests=2, min_write_batched_ops=2)
    ours = slo.evaluate(report, SLOBounds(**kw))
    theirs = jslo.evaluate(copy.deepcopy(report), JSLOBounds(**kw))
    assert ours == theirs
    # the minimal report forms no batch and no group: two violations at least
    assert not ours[0] and len(ours[1]) >= 2


def test_next_report_path(tmp_path):
    assert slo.next_report_path(str(tmp_path)).endswith("WORKLOAD_r01.json")
    (tmp_path / "WORKLOAD_r07.json").write_text("{}")
    assert slo.next_report_path(str(tmp_path)).endswith("WORKLOAD_r08.json")


# -------------------------------------------------- client-side mux helpers
@pytest.fixture(scope="module")
def served():
    """The port's front over ``cuda`` on memkv, on the CPU."""
    port = free_port()
    peer = free_port()
    args = build_parser().parse_args([
        "--single-node", "--storage", "cuda", "--inner-storage", "memkv",
        "--device", "cpu", "--host", "127.0.0.1",
        "--identity", f"127.0.0.1:{peer}", "--client-port", str(port),
        "--peer-port", str(peer), "--info-port", str(free_port())])
    endpoint, backend, store = build_endpoint(args)
    endpoint.run()
    yield f"127.0.0.1:{port}", backend
    endpoint.close()
    backend.close()
    store.close()


def test_create_bulk_pipelined(served):
    from kubebrain_tpu_torch.client import EtcdCompatClient

    target, _backend = served
    c = EtcdCompatClient(target)
    try:
        items = [(b"/registry/bulk/k-%04d" % i, b"v%d" % i)
                 for i in range(300)]
        results = c.create_bulk(items, window=32)
        assert len(results) == 300
        assert all(ok for ok, _rev in results)
        revs = [rev for _ok, rev in results]
        for (key, _v), rev in zip(items[:10], revs[:10]):
            got = c.get(key)
            assert got is not None and got.mod_revision == rev
        dup = c.create_bulk(items[:5], window=4)
        assert [ok for ok, _ in dup] == [False] * 5
        assert [rev for _, rev in dup] == revs[:5]
        kvs, _rev = c.list_unpaged(b"/registry/bulk/", b"/registry/bulk0")
        assert len(kvs) == 300
    finally:
        c.close()


def test_watch_mux_many_watches_few_streams(served):
    from kubebrain_tpu_torch.client import EtcdCompatClient, WatchMux

    target, _backend = served
    c = EtcdCompatClient(target)
    mux = WatchMux(c, streams=2)
    try:
        watches = []
        for ns in range(6):
            prefix = b"/registry/muxwatch/ns-%d/" % ns
            w = mux.add(prefix, prefix + b"\xff", shard=ns)
            assert w.watch_id >= 0
            watches.append(w)
        assert len({id(s) for s in mux._streams}) == 2
        for ns in range(6):
            ok, _ = c.create(b"/registry/muxwatch/ns-%d/pod-a" % ns, b"x")
            assert ok
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and mux.total_events() < 6:
            time.sleep(0.05)
        assert mux.total_events() == 6
        assert all(w.events == 1 for w in watches)
        assert mux.cancelled_count() == 0
    finally:
        mux.close()
        c.close()


def test_lease_mux_grant_and_keepalive(served):
    from kubebrain_tpu_torch.client import EtcdCompatClient, LeaseMux

    target, _backend = served
    c = EtcdCompatClient(target)
    mux = LeaseMux(c, streams=2)
    try:
        ids = mux.grant_bulk(5, ttl=30, window=2)
        assert len(ids) == len(set(ids)) == 5
        acks = []
        for i, lid in enumerate(ids):
            assert mux.keepalive_async(
                lid, shard=i, on_ack=lambda dt, ttl: acks.append(ttl))
        assert mux.flush(10.0)
        assert mux.sent == mux.acked == 5
        assert mux.expired_acks == 0
        assert len(acks) == 5 and all(t > 0 for t in acks)
        assert mux.keepalive_async(1234567890123, shard=0)
        assert mux.flush(10.0)
        assert mux.expired_acks == 1
    finally:
        mux.close()
        c.close()


# --------------------------------------------------------- end-to-end smoke
def test_small_n_replay_smoke(tmp_path):
    """A small-N replay through a spawned ``python -m kubebrain_tpu_torch.cli
    --device cpu --storage cuda``: all four subsystems driven, the report
    reconciled against /metrics, schema-valid and passing."""
    from kubebrain_tpu_torch.workload.runner import run_workload

    spec = WorkloadSpec.for_smoke(8, seed=1, storage="cuda")
    out = str(tmp_path / "WORKLOAD_smoke.json")
    report = run_workload(spec, out_path=out, device="cpu")

    slo.validate_report(report)
    assert report["slo"]["pass"], report["slo"]["violations"]
    assert report["reconcile"]["ok"], report["reconcile"]["checks"]
    assert report["reconcile"]["not_applicable"] == {}
    checks = report["reconcile"]["checks"]
    for name in ("txn_rpcs", "range_rpcs", "compact_rpcs",
                 "lease_grant_rpcs", "lease_keepalives", "watchers"):
        assert checks[name]["ok"], (name, checks[name])
        assert checks[name]["client"] > 0, (name, checks[name])
    assert report["watch"]["watchers"] == spec.nodes
    assert report["watch"]["events"] > 0
    assert report["leases"]["granted"] == spec.nodes
    assert report["leases"]["keepalives_acked"] >= spec.nodes
    assert report["leases"]["metrics"]["expired_delta"] == 0
    assert report["op_kinds"]["COMPACT"]["ok"] >= 1
    for lane in ("system", "normal", "background", "write"):
        assert report["lanes"][lane]["count"] > 0, lane
    assert report["watch"]["lag_wire_p99_s"] is not None
    assert report["platform"] == {
        "platform": "cpu",
        "device": "kubebrain-torch-cli(storage=cuda, front=sync-grpc)"}
    # the device compaction's phases reached the report
    assert report["compact"]["phases"]["mark"]["count"] >= 1
    assert report["trace"]["sha256"] == generator.generate(spec).sha256()
    assert report["trace"]["determinism_checked"]
    with open(out, encoding="utf-8") as f:
        on_disk = json.load(f)
    slo.validate_report(on_disk)
    assert on_disk["trace"]["sha256"] == report["trace"]["sha256"]
    assert os.path.getsize(out) > 500


def test_churn_heavy_scenario_forms_write_groups():
    """The churn_heavy preset through the port's front forms write commit
    groups, carries the mandatory write_groups_formed check and passes."""
    from kubebrain_tpu_torch.workload.runner import run_workload

    spec = WorkloadSpec.for_churn_heavy(
        60, seed=1, duration_s=6.0, time_scale=3.0,
        compact_interval_s=2.5)
    assert spec.bounds.min_write_batched_ops > 0
    report = run_workload(spec, write_report=False, device="cpu")

    slo.validate_report(report)
    assert report["slo"]["pass"], report["slo"]["violations"]
    sched = report["sched"]
    assert sched["write_batched_groups"] > 0
    assert sched["write_batched_ops"] >= spec.bounds.min_write_batched_ops
    assert sched["write_batched_ops"] >= 2 * sched["write_batched_groups"]
    check = report["reconcile"]["checks"]["write_groups_formed"]
    assert check["ok"], check
    writes = report["lanes"]["write"]["count"]
    reads = (report["lanes"]["normal"]["count"]
             + report["lanes"]["background"]["count"])
    assert writes > reads, (writes, reads)


def test_churn_heavy_bound_fails_without_group_formation():
    report = _minimal_report()
    passed, violations = slo.evaluate(
        report, SLOBounds(min_compactions=0, min_write_batched_ops=2))
    assert not passed
    assert any("group commit never formed" in v for v in violations)


def test_smoke_replayed_by_both_runners_alike():
    """``for_smoke`` through the JAX runner (the JAX CLI on the CPU) and
    through the port's (the port's CLI, ``cuda`` over memkv on the CPU):
    the same trace, the same ops of every kind, both reports green."""
    from kubebrain_tpu.workload.runner import run_workload as jrun
    from kubebrain_tpu_torch.workload.runner import run_workload

    ours = run_workload(WorkloadSpec.for_smoke(8, seed=5, storage="cuda"),
                        write_report=False, device="cpu")
    theirs = jrun(JWorkloadSpec.for_smoke(8, seed=5), write_report=False)
    assert ours["trace"] == theirs["trace"]
    assert {k: v["count"] for k, v in ours["op_kinds"].items()} == \
        {k: v["count"] for k, v in theirs["op_kinds"].items()}
    for report, bounds in ((ours, SLOBounds()), (theirs, JSLOBounds())):
        assert slo.evaluate(report, bounds) == (True, [])
        assert report["slo"]["pass"], report["slo"]["violations"]
