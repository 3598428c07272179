"""The port's linearizability checker (``kubebrain_tpu_torch/lincheck.py``)
held against the JAX package's (``kubebrain_tpu/lincheck.py``):
counterparts of the 17 cases of ``tests/test_linearizability.py`` through
the port's checker and the port's Backend and engines on the CPU (the live
soak also over ``cuda`` on memkv, ``device="cpu"``; the replicated tier
over two ``kbstored``, built on first use), plus seeded histories on which
both checkers must return the same verdict and violation.

Run as a script, it runs the replicated-tier soak on the JAX tier and on
the port's, with the JAX test's client and with the backing-off one, and
prints each soak's unknown outcomes::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_lincheck.py --census 3
"""

import math
import threading
import time
import random

import numpy as np
import pytest

from kubebrain_tpu import lincheck as jlincheck
from kubebrain_tpu_torch import lincheck as tlincheck
from kubebrain_tpu_torch.backend import Backend, BackendConfig
from kubebrain_tpu_torch.backend.errors import (
    CASRevisionMismatchError,
    FutureRevisionError,
    KeyExistsError,
)
from kubebrain_tpu_torch.lincheck import History, Op, _apply, _check_key
from kubebrain_tpu_torch.storage import new_storage
from kubebrain_tpu_torch.storage.errors import KeyNotFoundError

from kbstored_build import kbstored  # noqa: F401


# --------------------------------------------------------------- unit: model
def test_model_create_then_read():
    s0 = (False, b"", 0)
    (s1,) = _apply(Op(0, "create", b"k", 0, 1, value=b"a", ok=True, rev=5), s0)
    assert s1 == (True, b"a", 5)
    assert _apply(Op(0, "get", b"k", 2, 3, value=b"a", ok=True, rev=5), s1) == [s1]
    assert _apply(Op(0, "get", b"k", 2, 3, value=b"stale", ok=True, rev=5), s1) == []
    assert _apply(Op(0, "get", b"k", 2, 3, ok=False), s1) == []


def test_model_cas_chain():
    s = (True, b"a", 5)
    # CAS success requires matching prev_rev and a larger new rev
    assert _apply(Op(0, "update", b"k", 0, 1, value=b"b", prev_rev=5, ok=True, rev=9), s) \
        == [(True, b"b", 9)]
    assert _apply(Op(0, "update", b"k", 0, 1, value=b"b", prev_rev=4, ok=True, rev=9), s) == []
    assert _apply(Op(0, "update", b"k", 0, 1, value=b"b", prev_rev=5, ok=True, rev=3), s) == []
    # a conflict against the matching revision is unjustified
    assert _apply(Op(0, "update", b"k", 0, 1, prev_rev=5, ok=False, err="conflict"), s) == []
    assert _apply(Op(0, "update", b"k", 0, 1, prev_rev=4, ok=False, err="conflict"), s) == [s]


def test_model_unknown_write_then_revealing_read():
    """An unacknowledged create may have landed; a later read reveals its rev."""
    s0 = (False, b"", 0)
    (s1,) = _apply(Op(0, "create", b"k", 0, math.inf, value=b"a", ok=None), s0)
    assert s1 == (True, b"a", -1)
    assert _apply(Op(1, "get", b"k", 5, 6, value=b"a", ok=True, rev=77), s1) \
        == [(True, b"a", 77)]


# -------------------------------------------------------------- unit: search
def _seq(*ops):
    h = History()
    h.ops = list(ops)
    return h.check()


def test_sequential_history_passes():
    r = _seq(
        Op(0, "create", b"k", 0.0, 1.0, value=b"a", ok=True, rev=1),
        Op(0, "get", b"k", 2.0, 3.0, value=b"a", ok=True, rev=1),
        Op(0, "update", b"k", 4.0, 5.0, value=b"b", prev_rev=1, ok=True, rev=2),
        Op(0, "delete", b"k", 6.0, 7.0, prev_rev=2, ok=True, rev=3),
        Op(0, "get", b"k", 8.0, 9.0, ok=False),
    )
    assert r["ok"], r


def test_concurrent_overlap_passes():
    # two overlapping creates: one wins, one conflicts — legal
    r = _seq(
        Op(0, "create", b"k", 0.0, 5.0, value=b"a", ok=True, rev=1),
        Op(1, "create", b"k", 0.1, 5.1, value=b"b", ok=False, err="conflict", conflict_rev=1),
    )
    assert r["ok"], r


def test_stale_read_rejected():
    """A read that returns the OLD value after the overwrite completed (in
    real time) has no linearization point — must be rejected."""
    r = _seq(
        Op(0, "create", b"k", 0.0, 1.0, value=b"a", ok=True, rev=1),
        Op(0, "update", b"k", 2.0, 3.0, value=b"b", prev_rev=1, ok=True, rev=2),
        Op(1, "get", b"k", 4.0, 5.0, value=b"a", ok=True, rev=1),  # stale!
    )
    assert not r["ok"]


def test_lost_acked_write_rejected():
    # acked create, then a completed read says not-found
    r = _seq(
        Op(0, "create", b"k", 0.0, 1.0, value=b"a", ok=True, rev=1),
        Op(1, "get", b"k", 2.0, 3.0, ok=False),
    )
    assert not r["ok"]


def test_duplicate_revision_rejected():
    r = _seq(
        Op(0, "create", b"a", 0.0, 1.0, value=b"x", ok=True, rev=7),
        Op(1, "create", b"b", 0.0, 1.0, value=b"y", ok=True, rev=7),
    )
    assert not r["ok"] and "twice" in r["violation"]


def test_cross_key_realtime_revision_rejected():
    # A finished (rev 9) before B started, yet B got a smaller revision
    r = _seq(
        Op(0, "create", b"a", 0.0, 1.0, value=b"x", ok=True, rev=9),
        Op(1, "create", b"b", 2.0, 3.0, value=b"y", ok=True, rev=4),
    )
    assert not r["ok"] and "real-time" in r["violation"]


def test_unjustified_conflict_rejected():
    # create conflicts but nothing ever wrote the key
    r = _seq(
        Op(0, "create", b"k", 0.0, 1.0, ok=False, err="conflict", value=b"a"),
    )
    assert not r["ok"]


def test_unknown_op_both_branches():
    # unacked create: history is legal whether it landed or not
    ok_landed = _seq(
        Op(0, "create", b"k", 0.0, math.inf, value=b"a", ok=None),
        Op(1, "get", b"k", 5.0, 6.0, value=b"a", ok=True, rev=3),
    )
    assert ok_landed["ok"], ok_landed
    ok_skipped = _seq(
        Op(0, "create", b"k", 0.0, math.inf, value=b"a", ok=None),
        Op(1, "get", b"k", 5.0, 6.0, ok=False),
    )
    assert ok_skipped["ok"], ok_skipped
    # but it cannot have landed BEFORE an earlier completed not-found read
    # and still be read back afterward with no other writer
    bad = _seq(
        Op(1, "get", b"k", 0.0, 1.0, value=b"a", ok=True, rev=3),
        Op(0, "create", b"k", 2.0, math.inf, value=b"a", ok=None),
    )
    assert not bad["ok"]


def _hard_history(n_ops=20):
    """A single-key history that forces near-exhaustive search: n overlapping
    unknown-outcome creates (any subset may have landed, in any order) plus a
    completed read of a value nobody wrote. Proving it non-linearizable means
    visiting O(2^n) (mask, state) nodes — exactly the shape that exhausts a
    node budget before reaching a verdict."""
    ops = [
        Op(i, "create", b"k", 0.0, math.inf, value=b"v%d" % i, ok=None)
        for i in range(n_ops)
    ]
    ops.append(Op(99, "get", b"k", 5.0, 6.0, value=b"nope", ok=True, rev=999))
    h = History()
    h.ops = ops
    return h


def test_budget_exhaustion_fails_strict():
    """VERDICT r3 weak #5: a truncated search must NOT count as a pass.

    This history previously returned ok=True with a "budget exhausted" note;
    strict mode (the default) now fails it loudly with truncated=True."""
    h = _hard_history()
    res = h.check(node_budget=50)
    assert not res["ok"]
    assert res.get("truncated") is True
    assert "budget" in res["violation"]
    # permissive mode still completes, but names the unproven keys
    loose = h.check(node_budget=50, strict=False)
    assert loose["ok"] and loose["truncated_keys"] == [b"k"]


def test_budget_exhaustion_cannot_mask_seeded_bug():
    """A real violation buried in a budget-busting history must never come
    back as a pass: either the search reaches a verdict (big budget, real
    violation reported) or strict mode fails on truncation (small budget).
    Both are red — green is impossible."""
    h = _hard_history(n_ops=12)  # small enough to finish under the big budget
    # seeded lost-acked-write bug: acked create then completed not-found read
    h.ops.append(Op(90, "create", b"bug", 0.0, 1.0, value=b"a", ok=True, rev=1))
    h.ops.append(Op(91, "get", b"bug", 2.0, 3.0, ok=False))
    small = h.check(node_budget=50)
    assert not small["ok"] and small.get("truncated")  # truncation -> red
    big = h.check(node_budget=5_000_000)
    assert not big["ok"] and not big.get("truncated")  # full verdict -> red

def test_check_reports_nodes_searched():
    h = History()
    h.ops = [
        Op(0, "create", b"k", 0.0, 1.0, value=b"a", ok=True, rev=1),
        Op(0, "get", b"k", 2.0, 3.0, value=b"a", ok=True, rev=1),
    ]
    res = h.check()
    assert res["ok"] and res["nodes_searched"] > 0
    assert res["max_key_nodes"] <= res["nodes_searched"]
    assert res["truncated_keys"] == []


# ------------------------------------------------- live soak vs real backend
class _Recorder:
    """Wraps a Backend; records every op into a History."""

    def __init__(self, backend):
        self.b = backend
        self.h = History()
        self._lock = threading.Lock()

    def _rec(self, **kw):
        with self._lock:
            self.h.record(**kw)

    def create(self, client, key, value):
        t0 = time.monotonic()
        try:
            rev = self.b.create(key, value)
            self._rec(client=client, kind="create", key=key, call=t0,
                      ret=time.monotonic(), value=value, ok=True, rev=rev)
            return rev
        except KeyExistsError as e:
            self._rec(client=client, kind="create", key=key, call=t0,
                      ret=time.monotonic(), value=value, ok=False,
                      err="conflict", conflict_rev=e.revision)
            return None
        except FutureRevisionError:
            # drift-back: definite no-op failure (the caller's retry would
            # deal a fresh revision); no linearization obligation
            return None

    def update(self, client, key, value, prev_rev):
        t0 = time.monotonic()
        try:
            rev = self.b.update(key, value, prev_rev)
            self._rec(client=client, kind="update", key=key, call=t0,
                      ret=time.monotonic(), value=value, prev_rev=prev_rev,
                      ok=True, rev=rev)
            return rev
        except CASRevisionMismatchError as e:
            self._rec(client=client, kind="update", key=key, call=t0,
                      ret=time.monotonic(), value=value, prev_rev=prev_rev,
                      ok=False, err="conflict", conflict_rev=e.revision)
            return None

    def delete(self, client, key, prev_rev=0):
        t0 = time.monotonic()
        try:
            rev, _prev = self.b.delete(key, prev_rev)
            self._rec(client=client, kind="delete", key=key, call=t0,
                      ret=time.monotonic(), prev_rev=prev_rev, ok=True, rev=rev)
            return rev
        except KeyNotFoundError:
            self._rec(client=client, kind="delete", key=key, call=t0,
                      ret=time.monotonic(), prev_rev=prev_rev, ok=False,
                      err="notfound")
        except CASRevisionMismatchError as e:
            self._rec(client=client, kind="delete", key=key, call=t0,
                      ret=time.monotonic(), prev_rev=prev_rev, ok=False,
                      err="conflict", conflict_rev=e.revision)
        return None

    def get(self, client, key):
        t0 = time.monotonic()
        try:
            kv = self.b.get(key)
            self._rec(client=client, kind="get", key=key, call=t0,
                      ret=time.monotonic(), value=bytes(kv.value), ok=True,
                      rev=kv.revision)
            return kv
        except KeyNotFoundError:
            self._rec(client=client, kind="get", key=key, call=t0,
                      ret=time.monotonic(), ok=False)
            return None


def _soak(rec, n_clients=6, n_ops=120, n_keys=4, seed=1, barrier_every=0):
    """``barrier_every > 0`` is the raw-soak analogue of the nemesis tests'
    uncertain-window capping: under CI
    load, preempted recorder threads stretch op windows until they bridge
    every would-be quiescent cut, the per-key segments fuse, and the
    checker's Wing-Gong search exhausts its node budget — strict mode then
    fails with no verdict (the known load-sensitive flake). A periodic
    all-thread rendezvous *bounds the uncertainty windows by
    construction*: no op interval spans the barrier instant, so every
    epoch ends in a genuine quiescent cut and the per-key search stays
    small no matter how the host schedules the threads. Unlike post-hoc
    window shrinking this is sound by construction — the recorded
    timestamps are untouched; the soak itself is shaped so unbounded
    overlap cannot accumulate."""
    barrier = threading.Barrier(n_clients) if barrier_every else None

    def worker(c):
        rng = random.Random(seed * 1000 + c)
        for i in range(n_ops):
            if barrier is not None and i and i % barrier_every == 0:
                try:
                    barrier.wait(timeout=60.0)
                except threading.BrokenBarrierError:
                    pass  # a straggler broke it: degrade to the unfenced soak
            key = b"/lin/hot-%d" % rng.randrange(n_keys)
            roll = rng.random()
            if roll < 0.35:
                rec.get(c, key)
            elif roll < 0.55:
                rec.create(c, key, b"c%d" % c)
            elif roll < 0.9:
                kv = rec.get(c, key)
                if kv is not None:
                    rec.update(c, key, b"u%d" % c, kv.revision)
            else:
                kv = rec.get(c, key)
                if kv is not None:
                    rec.delete(c, key, kv.revision)

    threads = [threading.Thread(target=worker, args=(c,)) for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _engine(engine: str):
    if engine == "cuda":
        return new_storage("cuda", inner="memkv", device="cpu")
    return new_storage(engine)


@pytest.mark.parametrize("engine", ["memkv", "native", "cuda"])
def test_live_backend_is_linearizable(engine):
    store = _engine(engine)
    b = Backend(store, BackendConfig(event_ring_capacity=65536))
    try:
        rec = _Recorder(b)
        # barrier_every bounds the search no matter the host load — the
        # raw-soak counterpart of the nemesis tests' window capping (the
        # load-sensitive budget-exhaustion flake)
        _soak(rec, barrier_every=12)
        res = rec.h.check()
        assert res["ok"], res["violation"]
        assert not res.get("truncated") and res["truncated_keys"] == []
        assert res["ops"] > 500
    finally:
        b.close()
        store.close()


def test_seeded_stale_read_bug_is_caught():
    """Break the backend on purpose — serve reads from a never-invalidated
    cache — and require the checker to reject the history."""
    store = new_storage("memkv")
    b = Backend(store, BackendConfig(event_ring_capacity=65536))
    try:
        rec = _Recorder(b)
        cache = {}
        real_get = rec.get

        def buggy_get(client, key):
            t0 = time.monotonic()
            if key in cache:
                kv = cache[key]  # stale: ignores every later write
                rec._rec(client=client, kind="get", key=key, call=t0,
                         ret=time.monotonic(), value=bytes(kv.value), ok=True,
                         rev=kv.revision)
                return kv
            kv = real_get(client, key)
            if kv is not None:
                cache[key] = kv
            return kv

        rec.get = buggy_get
        _soak(rec, seed=7)
        res = rec.h.check()
        assert not res["ok"], "checker failed to catch the seeded stale-read bug"
    finally:
        b.close()
        store.close()


# ----------------------- live soak vs the REPLICATED tier, with a nemesis
def _tier_soak(tmp_path, stored_bin, backoff: bool) -> dict:
    """Concurrent clients against a Backend over the semi-sync replicated
    kbstored tier (the port's ``remote`` engine); mid-soak the primary is
    SIGKILLed and the follower promoted (storage failover). Returns the
    recorded history (the uncertain ops from the failover window capped as
    below), the kill and promotion times and the checker's result.

    ``backoff`` False is the JAX test's client: after an unknown outcome it
    goes on at once. ``backoff`` True waits for the promotion before its
    next op, as a client backs off before it retries."""
    import os
    import signal
    import subprocess

    from kubebrain_tpu_torch.storage.errors import (
        StorageError,
        UncertainResultError,
    )

    stored_bin = str(stored_bin)

    import socket as _socket

    def free_port():
        s = _socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    def start(args):
        os.makedirs(args[1], exist_ok=True)
        proc = subprocess.Popen([stored_bin] + args, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL)
        assert b"READY" in proc.stdout.readline()
        return proc

    pp, fp = free_port(), free_port()
    prim = start([str(pp), str(tmp_path / "p")])
    fol = start([str(fp), str(tmp_path / "f"), "--follow", f"127.0.0.1:{pp}"])
    store = new_storage("remote", address=f"127.0.0.1:{pp},127.0.0.1:{fp}",
                        pool=4, timeout=3.0, read_followers=True)
    # wait for the replica stream (pre-attach acks are standalone-durable)
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            if store.role(0)[2] >= 1:
                break
        except Exception:
            pass
        time.sleep(0.05)
    b = Backend(store, BackendConfig(event_ring_capacity=65536))
    promoted = threading.Event()

    class _TierRecorder(_Recorder):
        """Transport death => outcome unknown (ok=None, open return window);
        definite server-side rejections carry no state change and drop."""

        def _guard(self, fn, client, kind, key, **kw):
            t0 = time.monotonic()
            try:
                return fn()
            except UncertainResultError:
                self._rec(client=client, kind=kind, key=key, call=t0,
                          ret=math.inf, ok=None, **kw)
                if backoff:
                    promoted.wait(timeout=75)
            except (StorageError, OSError, TimeoutError):
                pass  # definite failure or failed read: no obligation
            return None

        def create(self, client, key, value):
            return self._guard(lambda: _Recorder.create(self, client, key, value),
                               client, "create", key, value=value)

        def update(self, client, key, value, prev_rev):
            return self._guard(
                lambda: _Recorder.update(self, client, key, value, prev_rev),
                client, "update", key, value=value, prev_rev=prev_rev)

        def delete(self, client, key, prev_rev=0):
            return self._guard(
                lambda: _Recorder.delete(self, client, key, prev_rev),
                client, "delete", key, prev_rev=prev_rev)

        def get(self, client, key):
            try:
                return _Recorder.get(self, client, key)
            except Exception:
                return None

    rec = _TierRecorder(b)
    stop_nemesis = threading.Event()
    t_promote = [math.inf]  # when the follower finished taking over
    t_kill = [math.inf]     # when SIGKILL was sent to the primary

    def nemesis():
        # progress-triggered: kill once the soak is ~1/3 through, so the
        # failover window always lands inside the recorded history
        deadline = time.time() + 30
        while time.time() < deadline and len(rec.h.ops) < 1200:
            time.sleep(0.01)
        prim.send_signal(signal.SIGKILL)
        t_kill[0] = time.monotonic()
        prim.wait()
        time.sleep(0.3)
        # load-aware promote bound (the test_raft_tier election-bound
        # discipline): under full-suite load the follower's stream
        # liveness check + promotion RPC lag far behind the standalone
        # timings, so the bound covers observation lag, not just the
        # nominal election window. Jittered probe cadence (kblint KB118).
        deadline = time.time() + 60
        while time.time() < deadline and not stop_nemesis.is_set():
            try:
                store.failover()
                t_promote[0] = time.monotonic()
                promoted.set()
                return
            except Exception:
                time.sleep(0.3 * random.uniform(0.7, 1.3))

    nt = threading.Thread(target=nemesis, daemon=True)
    nt.start()
    try:
        # barrier_every bounds every op window by construction (the same
        # rendezvous discipline the raw soak and test_raft_tier use) —
        # without it, full-suite host load stretches preempted threads'
        # op windows until the checker's per-key search fuses
        _soak(rec, n_clients=6, n_ops=600, n_keys=8, seed=7,
              barrier_every=12)
    finally:
        # rendezvous with the nemesis BEFORE aborting it: the soak can
        # finish while the promote loop is still probing a mid-election
        # tier, and stop_nemesis aborting that loop was exactly the
        # "failover never completed" full-suite flake — promotion then
        # never happened and the assertion below misfired
        nt.join(timeout=75)
        stop_nemesis.set()
        nt.join(timeout=20)

    try:
        # Close the uncertain-op windows: cap ONLY ops whose call preceded
        # the SIGKILL — an op called after
        # the kill can be re-issued by the remote tier's redirectable-
        # refusal retry loop to the newly promoted leader, where a timeout
        # yields an uncertain op whose true effect lands AFTER promotion;
        # capping that would exclude its real linearization point and
        # fabricate a violation. The cap VALUE stays promotion time: a
        # pre-kill write's replication frame can still be sitting in the
        # follower's buffers at primary-death time and apply (become
        # visible) a few ms later, so t_dead is too tight a bound — but by
        # the time promotion completes the reactor has long drained those
        # frames, so promote_at soundly bounds any pre-kill effect.
        # Snapshot the nemesis timestamps into locals only after proving
        # the thread is gone — a live nemesis could still be writing them
        # while this loop reads.
        if nt.is_alive():
            return {"nemesis_alive": True}
        kill_at, promote_at = t_kill[0], t_promote[0]
        for op in rec.h.ops:
            if op.ok is None and op.ret == math.inf and op.call < kill_at:
                op.ret = promote_at
        return {"nemesis_alive": False, "ops": rec.h.ops, "kill_at": kill_at,
                "promote_at": promote_at, "result": rec.h.check()}
    finally:
        b.close()
        store.close()
        for p in (prim, fol):
            try:
                p.kill()
                p.wait()
            except Exception:
                pass


def unknown_census(ops, kill_at: float) -> dict:
    """The unknown-outcome writes of a soak's history: in all, called after
    the kill, and the most on one key (after the kill)."""
    unknown = [op for op in ops if op.ok is None]
    after = [op for op in unknown if op.call >= kill_at]
    per_key: dict = {}
    for op in after:
        per_key[op.key] = per_key.get(op.key, 0) + 1
    return {"unknown": len(unknown), "after_kill": len(after),
            "max_per_key_after_kill": max(per_key.values(), default=0)}


def test_replicated_tier_failover_soak_is_linearizable(tmp_path, kbstored):
    """The soak of :func:`_tier_soak` with the backing-off client: the
    recorded history must check linearizable, and the failover window must
    have produced uncertainty.

    The JAX test's client, which goes on at once after an unknown outcome,
    piles the unknown writes of the failover window onto each key: each
    keeps its window open to the end of the soak, the key's segments fuse
    and the search runs out of budget with no verdict. It does so on the
    JAX tier and on the port's alike, under the same kill (``PYTHONPATH=.
    JAX_PLATFORMS=cpu python tests/test_torch_lincheck.py --census 3``
    runs both side by side and prints the unknown outcomes per key;
    ROADMAP §3 holds its counts)."""
    soak = _tier_soak(tmp_path, kbstored, backoff=True)
    assert not soak["nemesis_alive"], "nemesis thread still alive after join"
    assert soak["promote_at"] < math.inf, \
        "failover never completed — nemesis misfired?"
    res = soak["result"]
    census = unknown_census(soak["ops"], soak["kill_at"])
    assert res["ok"], (res["violation"], census)
    assert res["ops"] > 300, res
    # the nemesis window must actually have produced uncertainty
    assert census["unknown"] >= 1, \
        "failover produced no uncertain ops — nemesis misfired?"


# ------------------------------------- the port's checker against the JAX one
def _seeded_history(mod, seed: int):
    """A history of ``mod.Op`` drawn from a numpy seed: a sequential MVCC
    register per key run in a shuffled real-time order with overlapping
    intervals and some unknown outcomes, then, for half the seeds, one
    field of one op corrupted, so both verdicts occur."""
    rng = np.random.RandomState(seed)
    state: dict = {}
    rev, t, ops = 0, 0.0, []
    for _ in range(rng.randint(6, 40)):
        key = b"k%d" % rng.randint(3)
        kind = ("create", "update", "delete", "get")[rng.randint(4)]
        call = t + rng.rand()
        ret = call + rng.rand() * 0.5
        t = call + rng.rand() * 0.6  # the next op may overlap this one
        exists, value, cur = state.get(key, (False, b"", 0))
        kw: dict = {}
        if kind == "get":
            kw = ({"ok": True, "value": value, "rev": cur} if exists
                  else {"ok": False})
        elif kind == "create":
            if exists:
                kw = {"ok": False, "err": "conflict", "conflict_rev": cur,
                      "value": b"c"}
            else:
                rev += 1
                kw = {"ok": True, "value": b"c%d" % rev, "rev": rev}
                state[key] = (True, kw["value"], rev)
        elif kind == "update":
            prev = cur if rng.rand() < 0.8 else cur + 1
            if exists and prev == cur:
                rev += 1
                kw = {"ok": True, "value": b"u%d" % rev, "rev": rev,
                      "prev_rev": prev}
                state[key] = (True, kw["value"], rev)
            else:
                kw = {"ok": False, "err": "conflict", "prev_rev": prev,
                      "value": b"u"}
        else:
            if exists:
                rev += 1
                kw = {"ok": True, "rev": rev, "prev_rev": cur}
                state[key] = (False, b"", rev)
            else:
                kw = {"ok": False, "err": "notfound"}
        if kind != "get" and kw["ok"] and rng.rand() < 0.1:
            kw["ok"], ret = None, math.inf  # the client never saw it
        ops.append(mod.Op(int(rng.randint(4)), kind, key, call, ret, **kw))
    done = [o for o in ops if o.ok]
    if seed % 2 and done:
        # a read of a value nobody wrote, or a revision dealt twice
        op = done[rng.randint(len(done))]
        writes = [o for o in done if o.kind != "get" and o is not op]
        if op.kind == "get" or not writes:
            op.kind, op.value, op.rev = "get", b"corrupt", op.rev
        else:
            op.rev = writes[rng.randint(len(writes))].rev
    return ops


@pytest.mark.parametrize("seed", range(16))
def test_checker_gives_the_jax_verdict(seed):
    ours, theirs = History(), jlincheck.History()
    ours.ops = _seeded_history(tlincheck, seed)
    theirs.ops = _seeded_history(jlincheck, seed)
    got, want = ours.check(node_budget=200_000), theirs.check(
        node_budget=200_000)
    assert got == want
    assert got["ops"] == len(ours.ops)
    for key in {o.key for o in ours.ops}:
        mine = [o for o in ours.ops if o.key == key]
        jax = [o for o in theirs.ops if o.key == key]
        assert _check_key(mine)[:2] == jlincheck._check_key(jax)[:2]


def census_main(rounds: int) -> None:
    """The replicated-tier soak's unknown outcomes, JAX tier beside the
    port's, under the same kill: per round the JAX test
    (``tests/test_linearizability.py``, its history taken at its check),
    then :func:`_tier_soak` with the JAX test's client and with the
    backing-off one. One JSON line per soak."""
    import json
    import signal
    import subprocess
    import sys
    import tempfile
    from pathlib import Path
    from unittest import mock

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import kbstored_build
    import test_linearizability as jtest
    from kubebrain_tpu.storage import remote as jremote

    stored_bin = kbstored_build.build_kbstored()
    for r in range(rounds):
        seen: dict = {}
        orig_check, orig_signal = jlincheck.History.check, \
            subprocess.Popen.send_signal

        def check(self, *a, **kw):
            seen["ops"] = list(self.ops)
            seen["result"] = orig_check(self, *a, **kw)
            return seen["result"]

        def send_signal(self, sig):
            if sig == signal.SIGKILL:  # the nemesis's, not the clean-up's
                seen.setdefault("kill_at", time.monotonic())
            return orig_signal(self, sig)

        orig_failover = jremote.RemoteKvStorage.failover

        def failover(self, *a, **kw):
            out = orig_failover(self, *a, **kw)
            seen.setdefault("promote_at", time.monotonic())
            return out

        with tempfile.TemporaryDirectory() as d, \
                mock.patch.object(jlincheck.History, "check", check), \
                mock.patch.object(subprocess.Popen, "send_signal",
                                  send_signal), \
                mock.patch.object(jremote.RemoteKvStorage, "failover",
                                  failover):
            try:
                jtest.test_replicated_tier_failover_soak_is_linearizable(
                    Path(d))
                error = None
            except (AssertionError, Exception) as e:  # report, go on
                error = f"{type(e).__name__}: {str(e)[:200]}"
        runs = [("jax", seen, error)]
        for backoff in (False, True):
            with tempfile.TemporaryDirectory() as d:
                try:
                    runs.append((f"port backoff={backoff}",
                                 _tier_soak(Path(d), stored_bin, backoff),
                                 None))
                except Exception as e:  # report, go on
                    runs.append((f"port backoff={backoff}", {},
                                 f"{type(e).__name__}: {str(e)[:200]}"))
        for tier, soak, error in runs:
            line = {"round": r, "tier": tier, "error": error}
            if "ops" in soak and "kill_at" in soak:
                res = soak["result"]
                line |= unknown_census(soak["ops"], soak["kill_at"]) | {
                    "promote_s": soak.get("promote_at", math.inf)
                    - soak["kill_at"],
                    "ops": len(soak["ops"]), "ok": res["ok"],
                    "nodes_searched": res.get("nodes_searched"),
                    "violation": (res.get("violation") or "")[:200]}
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="the replicated-tier soak's "
                                 "unknown outcomes, JAX tier and port tier")
    ap.add_argument("--census", type=int, default=3, metavar="ROUNDS")
    census_main(ap.parse_args().census)
