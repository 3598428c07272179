"""The reference's model against brute force, the port against the
reference at a tiny size on the CPU in every cell, and the checks against
the control and against faults planted in the timed path: each must come
out not correct."""

from __future__ import annotations

import json
import random
from pathlib import Path

import pytest
from conftest import KEPT_CELLS, KEPT_PEAK, run_cell

from kbbench import reference

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())[
        "workloads"]]
CELLS += [c for c in (*KEPT_CELLS, KEPT_PEAK) if c not in CELLS]


def test_model_against_brute_force():
    rng = random.Random(7)
    keys = [b"/k/%02d" % i for i in range(30)]
    history = []
    rev = 0
    for _ in range(400):
        rev += 1
        k = rng.choice(keys)
        verb = rng.choice([reference.PUT, reference.PUT, reference.DELETE])
        history.append((verb, k, b"v%d" % rev, rev))
    m = reference.Model()
    for verb, k, v, r in history:
        m.apply(verb, k, r, v)
    for at in (1, 57, 200, 400):
        state = {}
        for verb, k, v, r in history:
            if r <= at:
                state[k] = None if verb == reference.DELETE else (v, r)
        live = sorted((k, *x) for k, x in state.items() if x)
        assert m.range(b"/k/", b"/k0", at)[0] == live
        assert m.count(b"/k/", b"/k0", at) == len(live)
        assert m.range(b"/k/", b"/k0", at, 5) == (live[:5], len(live) > 5)
        for k in keys:
            assert m.get(k, at) == state.get(k)
        versions = [(verb, k, r) for verb, k, _v, r in history if r <= at]
        gone = 0
        for k in keys:
            mine = [(verb, r) for verb, kk, r in versions if kk == k]
            if mine:
                gone += len(mine) - 1 + (mine[-1][0] == reference.DELETE)
        assert m.victims(at) == gone


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_the_reference(tiny, cell):
    res = run_cell(tiny, cell, seed=2**31 + 3)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert all(c["limit"] == 0 for c in res["checks"].values())
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", [c for c in CELLS if c != KEPT_PEAK])
def test_traced_run_reports_its_per_layer_metrics(tiny, cell):
    res = run_cell(tiny, cell, seed=2**32 + 5, trace=1)
    assert res["correct"], res["checks"]
    assert "sched.queue_wait_ms" in res["metrics"]
    assert "ops_per_s" not in res["metrics"]
    assert res["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    res = run_cell(tiny, cell, seed=11, control=True)
    assert not res["correct"]
    bad = {n for n, c in res["checks"].items() if c["value"] > c["limit"]}
    assert bad & {"stale_reads", "wrong_answers"}, res["checks"]


# ------------------------------------------------------------------ faults
def unchanged(backend):
    """Every fifth update is acknowledged with the key's old revision and
    the store left as it was: a step that returns its state unchanged."""
    sched = backend._kb_scheduler
    real, n = sched.update, [0]

    def update(key, value, expected_revision, **kw):
        n[0] += 1
        if n[0] % 5 == 0:
            return expected_revision
        return real(key, value, expected_revision, **kw)

    sched.update = update
    real_create = sched.create

    def create(key, value, **kw):
        n[0] += 1
        if n[0] % 5 == 0:
            return backend.current_revision()
        return real_create(key, value, **kw)

    sched.create = create


def half(backend):
    """A Range answers with the first half of its rows."""
    scanner = backend.scanner
    real = scanner.range_

    def range_(start, end, rev, limit=0):
        kvs, more = real(start, end, rev, limit)
        return kvs[: len(kvs) // 2], more

    scanner.range_ = range_


def altered(backend):
    """One byte of a value changed where the scanner and the point read
    produce it."""
    scanner = backend.scanner
    real = scanner.range_

    def range_(start, end, rev, limit=0):
        kvs, more = real(start, end, rev, limit)
        if kvs:
            kv = kvs[len(kvs) // 2]
            kv.value = bytes(kv.value)[:-1] + b"?"
        return kvs, more

    scanner.range_ = range_
    real_get = backend.get

    def get(key, revision=0):
        kv = real_get(key, revision)
        kv.value = bytes(kv.value)[:-1] + b"?"
        return kv

    backend.get = get


def dropped(backend):
    """Every third event batch a watcher's queue receives is lost."""
    real = backend.watch_range

    def watch_range(start, end, revision=0, **kw):
        wid, q = real(start, end, revision, **kw)
        put, n = q.put_nowait, [0]

        def put_nowait(item):
            n[0] += 1
            if n[0] % 3:
                put(item)

        q.put_nowait = put_nowait
        return wid, q

    backend.watch_range = watch_range


def uncompacted(backend):
    """Compaction returns its target and collects nothing."""
    backend.compact = lambda revision: revision


FAULTS = [("k8s-cl2-5k.relist", unchanged), ("k8s-cl2-5k.relist", half),
          ("k8s-cl2-5k.relist", altered), ("k8s-cl2-5k.relist", dropped),
          ("kb-upstream-rw.insert-read", unchanged),
          ("kb-upstream-rw.insert-read", altered),
          ("kb-upstream-rw.insert-read", dropped),
          ("kb-upstream-rw.insert-read-peak", unchanged),
          ("kb-upstream-rw.insert-read-peak", altered),
          ("kb-upstream-rw.insert-read-peak", dropped),
          ("k8s-cl2-5k.churn", unchanged), ("k8s-cl2-5k.churn", half),
          ("k8s-cl2-5k.churn", dropped), ("k8s-cl2-5k.churn", uncompacted)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(tiny, cell, fault):
    res = run_cell(tiny, cell, seed=13, faults=fault)
    assert not res["correct"], res["checks"]
