"""The readers of the program's spans (``kbbench/spans.py`` and the five
metrics on it) on synthetic spans, the gap labels of ``spans.host_label``,
``devtrace`` on a fixed Chrome trace against the numbers its code gives,
and the five entries of ``BENCHMARK.json``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest

from kbbench import devtrace, run, spans
from kubebrain_tpu_torch import trace

ROOT = Path(__file__).resolve().parents[2]
METRICS = ROOT / "kbbench" / "metrics"
FIXTURE = Path(__file__).resolve().parent / "devtrace_fixture.json"
CELL = "kb-upstream-rw.insert-read"
NEW = {"write.commit_ms": ("ms", "write path"),
       "read.point_ms": ("ms", "point read"),
       "mirror.merge_host_ms": ("ms/s", "delta and merge"),
       "mirror.merge_upload_ms": ("ms/s", "delta and merge"),
       "mirror.merge_stall_ms": ("ms", "delta and merge")}
MS = 1_000_000  # ns


def read(name: str, w) -> float | None:
    return run.reader(METRICS, name).read(w)


def window(spans_: list[dict] | None, seconds: float = 10.0):
    """A window of ``seconds`` whose captured spans are ``spans_``, built
    by :func:`span` relative to the window's start (``T0``)."""
    w = SimpleNamespace(scratch={"spans": spans_}, t0=100.0,
                        t1=100.0 + seconds, seconds=seconds)
    return w


def t_ns(off_ms: float) -> int:
    """``off_ms`` after the window's start, in epoch nanoseconds."""
    return trace.epoch_ns(100.0) + round(off_ms * MS)


def span(name, a_ms, b_ms, *stages, tid=1):
    return {"name": name, "start_ns": t_ns(a_ms), "end_ns": t_ns(b_ms),
            "tid": tid, "error": None,
            "stages": [(n, t_ns(a), t_ns(b)) for n, a, b in stages]}


# ---------------------------------------------------------------- readers
def test_write_commit_and_point_read_means():
    got = [
        span("sched.create", 10, 20, ("queue_wait", 10, 12),
             ("engine_commit", 12, 13), ("event_notify", 13, 20)),
        # a group of one that committed twice (a create over a tombstone)
        span("sched.create", 30, 40, ("engine_commit", 31, 33),
             ("engine_commit", 34, 35)),
        # began before the window, ended in it: counts
        span("sched.update", -5, 1, ("engine_commit", -4, 0)),
        # ended after the window: left out
        span("sched.create", 9990, 10_010, ("engine_commit", 9991, 10_009)),
        span("backend.get", 50, 51, ("engine_get", 50, 50.5)),
        span("etcd.KV/Range", 60, 62, ("engine_get", 60, 61.5)),
    ]
    w = window(got)
    assert read("write.commit_ms", w) == pytest.approx((1 + 3 + 4) / 3)
    assert read("read.point_ms", w) == pytest.approx((0.5 + 1.5) / 2)
    none = window([span("backend.get", 1, 2, ("engine_get", 1, 2))])
    assert read("write.commit_ms", none) is None
    assert read("read.point_ms", window([])) is None


def test_merge_stages_per_second_are_clipped_to_the_window():
    got = [
        # began 100 ms before the window: 50 ms of its host stage count
        span("mirror.merge", -100, 60, ("merge_snapshot", -100, -90),
             ("merge_sort", -90, 10), ("merge_host", 10, 50),
             ("merge_upload", 50, 58), ("merge_swap", 58, 60)),
        # ends 200 ms after the window: its upload counts 100 ms
        span("mirror.merge", 9800, 10_200, ("merge_host", 9800, 9900),
             ("merge_upload", 9900, 10_200)),
        span("mirror.merge", 5000, 5030, ("merge_rebuild", 5000, 5030)),
        # a request's stages are not the merge's
        span("sched.create", 0, 5, ("engine_commit", 0, 5)),
    ]
    w = window(got)
    host = 10 + 40 + 2 + 100 + 30
    assert read("mirror.merge_host_ms", w) == pytest.approx(host / 10.0)
    assert read("mirror.merge_upload_ms", w) == pytest.approx((8 + 100) / 10)
    quiet = window([span("sched.create", 0, 5, ("engine_commit", 0, 5))])
    assert read("mirror.merge_host_ms", quiet) is None
    assert read("mirror.merge_upload_ms", quiet) is None


def test_merge_stall_compares_requests_beside_a_merge_with_the_rest():
    merge = span("mirror.merge", 1000, 2000, ("merge_host", 1000, 2000),
                 tid=9)
    near = [span("sched.create", 990, 1010), span("backend.get", 1500, 1530),
            span("sched.list", 1995, 2015)]
    far = [span("backend.get", 100, 101), span("sched.create", 3000, 3003),
           span("sched.count", 2001, 2003),
           span("etcd.KV/Range", 1500, 1600)]  # not a request root below
    w = window([merge, *near, *far])
    assert read("mirror.merge_stall_ms", w) == pytest.approx(
        (20 + 30 + 20) / 3 - (1 + 3 + 2) / 3)
    assert read("mirror.merge_stall_ms", window([merge, *far])) is None
    assert read("mirror.merge_stall_ms", window([merge, *near])) is None
    assert read("mirror.merge_stall_ms", window(far)) is None


def test_no_capture_in_the_program_reads_nothing(monkeypatch):
    """A program whose tracer has no capture (the parent of this change):
    every reader returns nothing and raises nothing."""
    monkeypatch.delattr(type(trace.TRACER), "capture")
    w = window(None)
    w.scratch = {}
    for name in NEW:
        mod = run.reader(METRICS, name)
        mod.start(w)
        assert mod.read(w) is None
    assert spans.spans(w) is None


def test_the_capture_keeps_the_windows_spans():
    import time

    w = SimpleNamespace(scratch={}, t0=0.0, t1=0.0, seconds=0.0)
    for name in NEW:
        run.reader(METRICS, name).start(w)  # one capture for all of them
    with trace.TRACER.span("before"):
        pass
    w.t0 = time.monotonic()
    with trace.TRACER.span("backend.get"):
        with trace.TRACER.stage("engine_get"):
            time.sleep(0.002)
    w.t1 = time.monotonic()
    w.seconds = w.t1 - w.t0
    with trace.TRACER.span("after"):
        pass
    names = [s["name"] for s in spans.spans(w)]
    assert names == ["backend.get"], names
    assert read("read.point_ms", w) >= 2.0
    assert w.scratch["spans.capture"] not in trace.TRACER._captures


# --------------------------------------------------------------- devtrace
#: what ``summarize`` gives on the fixture (the code of the benchmark as
#: first accepted), to the last bit
OLD_BUSY_S = 0.017422955566406252
OLD_OPS = {"Memset (Device)": [13, 0.0054704820000000005],
           "Memcpy HtoD (Pageable -> Device)": [8, 0.004182888],
           "Memcpy DtoD (Device -> Device)": [7, 0.0026405510000000005],
           "scan_visibility_kernel": [16, 0.006060584]}
OLD_GAPS = [
    ["after Memcpy HtoD (Pageable -> Device), before Memcpy HtoD (Pageable -> Device)", 0.368154119140625],
    ["after scan_visibility_kernel, before scan_visibility_kernel", 0.3605447529296875],
    ["after scan_visibility_kernel, before Memset (Device)", 0.3551926789550781],
    ["after scan_visibility_kernel, before scan_visibility_kernel", 0.33483866796875],
    ["after scan_visibility_kernel, before Memset (Device)", 0.3280147111816406],
    ["after Memcpy DtoD (Device -> Device), before Memset (Device)", 0.32146381103515625],
    ["after Memset (Device), before Memcpy HtoD (Pageable -> Device)", 0.3066768681640625],
    ["after Memcpy DtoD (Device -> Device), before Memcpy HtoD (Pageable -> Device)", 0.274646466796875],
    ["after Memset (Device), before Memcpy HtoD (Pageable -> Device)", 0.22019978100585938],
    ["after Memcpy HtoD (Pageable -> Device), before Memcpy DtoD (Device -> Device)", 0.19447060693359375],
]


class FixtureProfile:
    def export_chrome_trace(self, path):
        shutil.copy(FIXTURE, path)


def test_devtrace_numbers_are_those_of_the_code_before():
    s = devtrace.summarize(FixtureProfile())
    assert s["busy_s"] == OLD_BUSY_S
    assert s["ops"] == OLD_OPS
    assert s["gaps"] == OLD_GAPS
    b = devtrace.breakdown(s)
    assert b["idle_gaps"] == OLD_GAPS
    assert b["device_ops"] == [[n, sec] for n, (_k, sec) in sorted(
        OLD_OPS.items(), key=lambda kv: -kv[1][1])]


def test_host_label_names_gaps_by_the_planted_host_stages():
    # four gaps of the fixture's lengths, one after another from T0
    ends, t = [], t_ns(0)
    for _label, sec in OLD_GAPS[:4]:
        ends.append((t, t + round(sec * 1e9)))
        t += round(sec * 1e9) + MS
    (a1, b1), (a2, b2), (a3, b3), (a4, b4) = ends
    g1 = b1 - a1
    at = lambda f: a1 + round(f * g1)  # noqa: E731
    planted = [
        {"name": "mirror.merge", "start_ns": a1 - 500_000, "end_ns": b1,
         "tid": 3, "error": None,
         # begins before the gap, in the device's busy time before it:
         # only its part inside the gap counts
         "stages": [("merge_host", a1 - 500_000, at(0.6)),
                    ("merge_upload", at(0.9), b1)]},
        {"name": "sched.create", "start_ns": a1, "end_ns": b1, "tid": 4,
         "error": None,
         # waiting is not host work; two commits on two threads that
         # overlap count once: 7%
         "stages": [("queue_wait", a1, b1), ("engine_commit", at(0.10),
                                             at(0.15))]},
        {"name": "sched.create", "start_ns": a1, "end_ns": b1, "tid": 5,
         "error": None, "stages": [("engine_commit", at(0.12), at(0.17))]},
        # the third gap holds only waiting
        {"name": "sched.list", "start_ns": a3, "end_ns": b3, "tid": 6,
         "error": None, "stages": [("result_deliver", a3, b3)]},
        # the fourth: three stages too long to name all within 60
        {"name": "x", "start_ns": a4, "end_ns": b4, "tid": 7, "error": None,
         "stages": [("a_stage_with_a_rather_long_name", a4, b4),
                    ("another_stage_with_a_long_name", a4, b4),
                    ("third", a4, b4)]},
    ]
    labels = [spans.host_label(a, b, planted) for a, b in ends]
    assert labels[0] == "host merge_host 60% merge_upload 10% engine_commit 7%"
    assert labels[1] == "host none"
    assert labels[2] == "host none"
    # the first (ties by name) fits; the second would pass 60 characters
    assert labels[3] == "host a_stage_with_a_rather_long_name 100%"
    assert all(len(lb) <= spans.LABEL_CHARS for lb in labels)
    assert spans.host_label(a1, b1, []) == "host none"


# --------------------------------------------------------------- manifest
@pytest.mark.parametrize("name", sorted(NEW))
def test_the_manifest_holds_the_new_metric(name):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [m for m in manifest["per_layer"] if m["name"] == name]
    unit, layer = NEW[name]
    assert entry["unit"] == unit and entry["better"] == "lower"
    assert entry["source"] == "program_span"
    assert entry["moves"] == "ops_per_s"
    assert entry["workloads"] == [CELL]
    assert entry["layer"].startswith(layer)
    assert (METRICS / f"{name}.py").exists()


def test_breakdown_names_each_gap_by_the_host_where_spans_are_at_hand():
    s = devtrace.summarize(FixtureProfile())
    base = json.loads(FIXTURE.read_text())["baseTimeNanoseconds"]
    assert len(s["gap_ns"]) == len(OLD_GAPS)
    for (a, b), (_label, sec) in zip(s["gap_ns"], OLD_GAPS):
        assert a > base and abs((b - a) / 1e9 - sec) < 1e-8
    (a1, b1), (a2, b2) = s["gap_ns"][:2]
    planted = [
        {"name": "mirror.merge", "start_ns": a1, "end_ns": b1, "tid": 3,
         "error": None, "stages": [("merge_host", a1, a1 + (b1 - a1) // 2)]},
        {"name": "backend.get", "start_ns": a2, "end_ns": b2, "tid": 4,
         "error": None, "stages": [("engine_get", a2, b2)]}]
    got = devtrace.breakdown(s, planted)["idle_gaps"]
    assert [sec for _l, sec in got] == [sec for _l, sec in OLD_GAPS]
    assert got[0][0] == "host merge_host 50%"
    assert got[1][0] == "host engine_get 100%"
    assert all(label == "host none" for label, _s in got[2:])
    # no spans, or a trace with no base: its device neighbours name it
    assert devtrace.breakdown(s, None)["idle_gaps"] == OLD_GAPS
    assert devtrace.breakdown(s, [])["idle_gaps"] == OLD_GAPS
    assert devtrace.breakdown({**s, "gap_ns": None},
                              planted)["idle_gaps"] == OLD_GAPS
