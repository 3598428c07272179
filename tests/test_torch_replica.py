"""The port's follower role (``kubebrain_tpu_torch/replica``) through the
port's CLI and gRPC front on the CPU (``--device cpu``), driven by the
port's client: counterparts of the eleven cases of ``tests/test_replica.py``
(``test_two_replica_end_to_end_smoke`` through the port's workload
runner), with the ``tpu`` mirror-identity case over the ``cuda``
engine (raw and encoded mirror keys), and a cross-package differential: a
JAX pair and a port pair run one seeded write script, and their followers'
Range and Count answers at the same pinned revisions must be equal.

- fence-read correctness: a follower's linearizable read is byte-identical
  to the leader's under concurrent (group-commit-batched) writers, and a
  fence across the leader's revision GAPS (failed ops) completes via the
  ordered watch progress marks;
- bounded-staleness enforcement: a follower past its staleness bound
  REFUSES serializable reads and degrades to explicit-revision-only
  serving; a stalled watermark turns linearizable reads into
  fence-timeout refusals, never stale answers;
- follower watch resume: a replication-stream reset loses no event and
  duplicates none for the follower's OWN watchers;
- bootstrap floor: history below the follower's bootstrap revision
  refuses as compacted.
"""

import random
import threading
import time

import grpc
import pytest

from kubebrain_tpu import cli as jax_cli
from kubebrain_tpu import client as jax_client
from kubebrain_tpu_torch.cli import build_endpoint, build_parser
from kubebrain_tpu_torch.client import EtcdCompatClient, WatchMux

from test_etcd_server import free_port


class Node:
    """One in-process server (leader or follower) built through the real
    cli wiring (the port's, or ``cli`` given), serving on real ports."""

    def __init__(self, argv, cli=None):
        parse, build = ((cli.build_parser, cli.build_endpoint) if cli
                        else (build_parser, build_endpoint))
        args = parse().parse_args(argv)
        self.endpoint, self.backend, self.store = build(args)
        self.endpoint.run()
        self.client_port = args.client_port
        self.info_port = args.info_port
        self.target = f"127.0.0.1:{args.client_port}"
        self.role = getattr(self.endpoint.server, "replica", None)

    def close(self):
        self.endpoint.close()
        self.backend.close()
        self.store.close()


def spawn_pair(storage="memkv", leader_extra=(), follower_extra=(),
               preload=0, package=None):
    """A leader and a follower through the port's CLI on the CPU, or, with
    ``package`` (a module pair ``(cli, client)``), through that package's."""
    cli, client_cls = ((package[0], package[1].EtcdCompatClient) if package
                       else (None, EtcdCompatClient))
    device = [] if package else ["--device", "cpu"]
    lc, lp, li = free_port(), free_port(), free_port()
    leader = Node(["--single-node", "--storage", storage, *device,
                   "--host", "127.0.0.1",
                   "--client-port", str(lc), "--peer-port", str(lp),
                   "--info-port", str(li), "--compact-interval", "86400",
                   *leader_extra], cli)
    lcli = client_cls(leader.target)
    for i in range(preload):
        ok, _ = lcli.create(b"/registry/pods/ns0/pre%03d" % i, b"v0")
        assert ok
    fc, fp, fi = free_port(), free_port(), free_port()
    follower = Node(["--role", "follower",
                     "--leader-address", leader.target,
                     "--leader-info", f"127.0.0.1:{li}",
                     "--storage", storage, *device, "--host", "127.0.0.1",
                     "--client-port", str(fc), "--peer-port", str(fp),
                     "--info-port", str(fi), "--compact-interval", "86400",
                     *follower_extra], cli)
    fcli = client_cls(follower.target)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            fcli.count(b"/probe", b"/probe0")
            break
        except grpc.RpcError:
            time.sleep(0.1)
    else:
        raise RuntimeError("follower never served")
    return leader, lcli, follower, fcli


PODS = b"/registry/pods/"
PODS_END = b"/registry/pods0"


def rows(kvs):
    return [(k.key, k.value, k.mod_revision) for k in kvs]


def _divergence_diagnostics(leader, follower, kvs_f, kvs_l, fence, got):
    """Rich dump for a follower-vs-leader pinned-revision mismatch: the
    per-key revision records on BOTH stores tell exactly which revisions
    the follower is missing relative to its claimed watermark."""
    sf = {(k.key, k.mod_revision) for k in kvs_f}
    sl = {(k.key, k.mod_revision) for k in kvs_l}
    lines = [f"DIVERGED at fence={fence} follower_got={got} "
             f"wm={follower.backend.tso.committed()} "
             f"leader_committed={leader.backend.tso.committed()}"]
    lines.append(f"stream={follower.role.status()['stream']}")
    for label, only in (("follower-only", sf - sl), ("leader-only", sl - sf)):
        for key, rev in sorted(only)[:6]:
            lrec = leader.backend._read_rev_record(key)
            frec = follower.backend._read_rev_record(key)
            lines.append(f"{label} {key!r}@{rev}: leader_rec={lrec} "
                         f"follower_rec={frec}")
    return "\n".join(lines)


# ----------------------------------------------------------- fence reads
def test_fence_read_correctness_under_concurrent_writers():
    leader, lcli, follower, fcli = spawn_pair()
    try:
        stop = threading.Event()
        errs = []

        def writer(wid):
            c = EtcdCompatClient(leader.target)
            try:
                rev = 0
                i = 0
                while not stop.is_set():
                    key = b"/registry/pods/nsw/%d-%d" % (wid, i)
                    ok, rev = c.create(key, b"x" * 64)
                    if ok and i % 3 == 0:
                        c.update(key, b"y" * 64, rev)
                    if ok and i % 5 == 0:
                        c.delete(key, 0)
                    i += 1
            except Exception as e:  # pragma: no cover
                errs.append(e)
            finally:
                c.close()

        # several concurrent writers so the scheduler actually forms
        # commit groups on the leader (docs/writes.md)
        threads = [threading.Thread(target=writer, args=(w,), daemon=True)
                   for w in range(4)]
        for t in threads:
            t.start()
        try:
            probes = 0
            deadline = time.monotonic() + 60
            while probes < 10 and time.monotonic() < deadline:
                # linearizable fence probe: leader revision first, then a
                # rev-0 non-serializable read on the follower must come
                # back at or above it. A fence-timeout REFUSAL under box
                # load is legal (the contract is refusals, never stale
                # answers) — retry it; a below-fence answer never is.
                fence = lcli.current_revision()
                if fence == 0:
                    # nothing committed yet (writers still starting):
                    # list(revision=0) would be a HEAD read, not a pinned
                    # one, and head reads at two different instants
                    # legitimately differ — the degenerate case behind a
                    # long-lived "divergence" flake in this test
                    continue
                try:
                    got = fcli.current_revision()
                except grpc.RpcError as e:
                    assert "replica refused" in (e.details() or "")
                    continue
                assert got >= fence, (got, fence)
                # explicit pinned revision: byte-identical to the leader
                kvs_f, _ = fcli.list(PODS, PODS_END, revision=fence)
                kvs_l, _ = lcli.list(PODS, PODS_END, revision=fence)
                if rows(kvs_f) != rows(kvs_l):
                    diag = _divergence_diagnostics(
                        leader, follower, kvs_f, kvs_l, fence, got)
                    raise AssertionError(diag)
                probes += 1
            assert probes >= 3, "too few successful fence probes"
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        assert not errs
    finally:
        fcli.close()
        lcli.close()
        follower.close()
        leader.close()


def test_fence_crosses_revision_gaps_via_progress_marks():
    # a FAILED leader write consumes a revision but streams no event: the
    # follower can only reach the new committed floor through the ordered
    # progress marks — a fenced read right after must still complete
    leader, lcli, follower, fcli = spawn_pair()
    try:
        ok, rev1 = lcli.create(b"/registry/pods/ns0/a", b"v")
        assert ok
        ok, _rev2 = lcli.update(b"/registry/pods/ns0/a", b"w", rev1)
        assert ok
        # update against the STALE revision: the CAS conflict consumes a
        # dealt revision but streams no event = a revision gap
        ok3, _ = lcli.update(b"/registry/pods/ns0/a", b"x", rev1)
        assert not ok3
        fence = lcli.current_revision()
        t0 = time.monotonic()
        got = fcli.current_revision()  # fenced on the follower
        assert got >= fence
        assert time.monotonic() - t0 < 3.0  # progress mark, not timeout
    finally:
        fcli.close()
        lcli.close()
        follower.close()
        leader.close()


def test_fence_leader_revision_never_predates_the_call():
    """The fence's leader-revision sample must come from a fetch that
    STARTED after the read arrived: joining an already-in-flight /status
    fetch could return a revision sampled before a write this read must
    observe — a real-time linearizability hole (the ticketed-singleflight
    regression)."""
    from kubebrain_tpu_torch.replica.role import FollowerConfig, FollowerRole

    cfg = FollowerConfig(leader_address="unused:1", leader_info="unused:2",
                         fence_timeout_s=5.0)
    role = FollowerRole(None, cfg)
    rev_box = [10]
    first_started = threading.Event()
    gate = threading.Event()

    def fetch():
        v = rev_box[0]  # the leader's revision AT FETCH START
        first_started.set()
        gate.wait(5)
        return v

    role._syncer._fetch = fetch
    out = {}
    a = threading.Thread(
        target=lambda: out.__setitem__("a", role.leader_revision()))
    a.start()
    assert first_started.wait(5)
    rev_box[0] = 20  # the leader advanced AFTER fetch #1 began
    b = threading.Thread(
        target=lambda: out.__setitem__("b", role.leader_revision()))
    b.start()
    time.sleep(0.1)  # b must be parked on generation 2, not flight 1
    gate.set()
    a.join(5)
    b.join(5)
    assert out["a"] == 10      # a arrived before the advance: 10 is legal
    assert out["b"] == 20, out  # b arrived after: the stale flight is not


def test_fence_survives_a_waiter_timeout():
    """A waiter timing out while a fetch is in flight must not wedge the
    generation singleflight: later fences still get fresh fetches (the
    pre-committed-producer regression)."""
    from kubebrain_tpu_torch.replica.role import (
        FollowerConfig, FollowerRole, LeaderUnreachableError)

    cfg = FollowerConfig(leader_address="unused:1", leader_info="unused:2",
                         fence_timeout_s=5.0)
    role = FollowerRole(None, cfg)
    gate = threading.Event()
    started = threading.Event()

    def fetch():
        started.set()
        gate.wait(5)
        return 7

    role._syncer._fetch = fetch
    a = threading.Thread(target=role.leader_revision, daemon=True)
    a.start()
    assert started.wait(5)
    # b times out while a's fetch is in flight (needs generation 2,
    # which nobody ever produces before its deadline)
    with pytest.raises(LeaderUnreachableError):
        role.leader_revision(timeout=0.05)
    gate.set()
    a.join(5)
    # the path must still work: c runs generation 2 itself
    assert role.leader_revision(timeout=5.0) == 7


def test_resync_converges_state_and_emits_deletes():
    """Rung 3 of the degradation ladder: a follower whose resume point
    fell out of the leader's cache re-lists and diffs — changed keys
    re-applied, vanished keys tombstoned (watch-visible), state
    byte-identical after."""
    leader, lcli, follower, fcli = spawn_pair()
    try:
        keys = {}
        for i in range(8):
            k = b"/registry/pods/ns0/rs%d" % i
            ok, rev = lcli.create(k, b"v%d" % i)
            assert ok
            keys[k] = rev
        deadline = time.monotonic() + 10
        while follower.role.applied_revision() < max(keys.values()):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        # partition: stop the stream, then mutate the leader underneath
        follower.role._stream.close()
        time.sleep(0.3)
        lcli.delete(b"/registry/pods/ns0/rs0", 0)
        lcli.update(b"/registry/pods/ns0/rs1", b"changed", keys[
            b"/registry/pods/ns0/rs1"])
        lcli.create(b"/registry/pods/ns0/rs-new", b"fresh")
        # follower-local watcher must see the diff as events
        mux = WatchMux(fcli, streams=1)
        w = mux.add(PODS, PODS_END,
                    start_revision=follower.role.applied_revision() + 1)
        # drive the resync directly (the reconnect loop would take it on
        # a compacted cancel; forcing leader-cache expiry is impractical
        # in-test)
        probe = EtcdCompatClient(leader.target)
        try:
            follower.role._stream._resync(probe)
        finally:
            probe.close()
        kvs_f, _ = fcli.list(PODS, PODS_END, serializable=True)
        kvs_l, _ = lcli.list(PODS, PODS_END)
        assert rows(kvs_f) == rows(kvs_l)
        deadline = time.monotonic() + 10
        while w.events < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert w.events >= 3  # delete + update + create all fanned out
        mux.close()
    finally:
        fcli.close()
        lcli.close()
        follower.close()
        leader.close()


# ----------------------------------------------- staleness + degradation
def test_bounded_staleness_refusal_and_degradation_ladder():
    leader, lcli, follower, fcli = spawn_pair(
        follower_extra=["--max-staleness-ms", "300",
                        "--fence-timeout-ms", "700"])
    try:
        ok, rev = lcli.create(b"/registry/pods/ns0/k", b"v")
        assert ok
        # serializable reads promise bounded staleness, not read-your-
        # leader-writes: wait for the watermark to cover the create first
        deadline = time.monotonic() + 15
        while follower.role.applied_revision() < rev:
            assert time.monotonic() < deadline, "replication never caught up"
            time.sleep(0.05)
        # healthy: serializable reads serve locally. The 300ms bound can
        # trip transiently when the 0.2s progress ticker runs late under
        # full-suite load on a small box — retry through those; with the
        # stream LIVE a read must succeed within the deadline
        deadline = time.monotonic() + 10
        while True:
            try:
                kvs, srev = fcli.list(PODS, PODS_END, serializable=True)
                break
            except grpc.RpcError as e:
                assert "stale" in (e.details() or "")
                assert time.monotonic() < deadline, "never un-stale"
                time.sleep(0.1)
        assert len(kvs) == 1 and srev >= rev
        # stall replication: the stream stops advancing the watermark,
        # so within the deadline every serializable read must REFUSE
        follower.role._stream.close()
        wm = follower.role.applied_revision()
        time.sleep(0.5)  # past the 300ms bound
        with pytest.raises(grpc.RpcError) as ei:
            deadline = time.monotonic() + 10
            while True:
                fcli.list(PODS, PODS_END, serializable=True)
                assert time.monotonic() < deadline, "never refused"
                time.sleep(0.1)
        assert ei.value.code() == grpc.StatusCode.UNAVAILABLE
        assert "etcdserver: replica refused (stale)" in ei.value.details()
        # degradation ladder: explicit-revision reads <= the watermark
        # STILL serve, byte-identical
        kvs_f, _ = fcli.list(PODS, PODS_END, revision=wm)
        kvs_l, _ = lcli.list(PODS, PODS_END, revision=wm)
        assert rows(kvs_f) == rows(kvs_l)
        # a linearizable read with the watermark stalled BELOW the leader
        # head must refuse (fence timeout), never answer stale
        ok, _ = lcli.create(b"/registry/pods/ns0/k2", b"v2")
        assert ok
        with pytest.raises(grpc.RpcError) as ei:
            fcli.list(PODS, PODS_END)
        assert ei.value.code() == grpc.StatusCode.UNAVAILABLE
        assert "replica refused" in ei.value.details()
        assert follower.role.refused  # counted
    finally:
        fcli.close()
        lcli.close()
        follower.close()
        leader.close()


def test_reads_below_bootstrap_floor_refuse_as_compacted():
    # history below the follower's bootstrap revision is honestly
    # unservable: the follower refuses it as compacted so clients re-list
    leader, lcli, follower, fcli = spawn_pair(preload=10)
    try:
        assert follower.backend.compact_revision() >= 10
        with pytest.raises(grpc.RpcError) as ei:
            fcli.list(PODS, PODS_END, revision=5)
        assert ei.value.code() == grpc.StatusCode.OUT_OF_RANGE
        assert "compacted" in ei.value.details()
        # the same revision still serves on the leader
        kvs, _ = lcli.list(PODS, PODS_END, revision=5)
        assert len(kvs) == 5
    finally:
        fcli.close()
        lcli.close()
        follower.close()
        leader.close()


# ------------------------------------------------------ watch + resume
def test_follower_watch_survives_replication_reset():
    leader, lcli, follower, fcli = spawn_pair()
    try:
        ok, rev = lcli.create(b"/registry/pods/ns0/w0", b"v")
        assert ok
        # wait for the follower to apply, then watch IT from rev+1
        deadline = time.monotonic() + 10
        while follower.role.applied_revision() < rev:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        mux = WatchMux(fcli, streams=1, record_revisions=True)
        w = mux.add(PODS, PODS_END, start_revision=rev + 1)
        seen_pre = lcli.create(b"/registry/pods/ns0/w1", b"v1")[1]
        # reset the replication stream; the teardown lands at the next
        # 0.2s ticker tick, so the writes below straddle it
        stream = follower.role._stream
        stream.reset()
        revs = [seen_pre]
        for i in range(5):
            okw, r = lcli.create(b"/registry/pods/ns0/r%d" % i, b"x")
            assert okw
            revs.append(r)
            time.sleep(0.06)
        deadline = time.monotonic() + 15
        while (w.events < len(revs) or stream.resets < 1) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert stream.resets >= 1  # the reset really happened
        # exactly once, in revision order — no loss, no duplicates across
        # the replication reset
        assert w.revisions == sorted(revs), (w.revisions, revs)
        mux.close()
    finally:
        fcli.close()
        lcli.close()
        follower.close()
        leader.close()


# ------------------------------------------------ cuda mirror identity
@pytest.mark.parametrize("encoding", ["encoded", "raw"])
def test_follower_mirror_identity_pinned_revision_cuda(encoding):
    extra = ["--merge-threshold", "32", "--key-encoding", encoding]
    leader, lcli, follower, fcli = spawn_pair(
        storage="cuda", leader_extra=extra, follower_extra=extra)
    try:
        keys = []
        for i in range(60):
            key = b"/registry/pods/ns%d/p%03d" % (i % 3, i)
            ok, rev = lcli.create(key, b"v" * (32 + i % 64))
            assert ok
            keys.append((key, rev))
        for key, rev in keys[::4]:
            lcli.update(key, b"u" * 48, rev)
        for key, _ in keys[::9]:
            lcli.delete(key, 0)
        pinned = lcli.current_revision()
        # fenced explicit-revision read: the follower's replicated delta
        # blocks (sealed into its OWN mirror via the same _DeltaIndex
        # machinery, past the 32-row merge threshold) must serve the
        # pinned snapshot byte-identically through the real gRPC front
        kvs_f, _ = fcli.list(PODS, PODS_END, revision=pinned)
        kvs_l, _ = lcli.list(PODS, PODS_END, revision=pinned)
        assert rows(kvs_f) == rows(kvs_l)
        assert len(kvs_f) > 40
        # keep writing so another merge cycle lands, then re-compare at a
        # fresh pinned revision AND at the old one (history intact)
        for i in range(40):
            lcli.create(b"/registry/pods/ns9/q%03d" % i, b"z" * 40)
        pinned2 = lcli.current_revision()
        kvs_f2, _ = fcli.list(PODS, PODS_END, revision=pinned2)
        kvs_l2, _ = lcli.list(PODS, PODS_END, revision=pinned2)
        assert rows(kvs_f2) == rows(kvs_l2)
        kvs_f3, _ = fcli.list(PODS, PODS_END, revision=pinned)
        assert rows(kvs_f3) == rows(kvs_f)
        # the replicated rows reached the follower's own mirror by merges
        assert follower.backend.scanner.merge_count > 0
    finally:
        fcli.close()
        lcli.close()
        follower.close()
        leader.close()


# --------------------------------------------------- forwarded surfaces
def test_forwarding_and_counters():
    leader, lcli, follower, fcli = spawn_pair()
    try:
        ok, rev = fcli.create(b"/registry/pods/ns0/fwd", b"via-follower")
        assert ok
        got = lcli.get(b"/registry/pods/ns0/fwd")
        assert got is not None and got.value == b"via-follower"
        lease_id, granted = fcli.lease_grant(10)
        assert granted >= 10
        ttl, granted2, _keys = fcli.lease_time_to_live(lease_id)
        assert 0 <= ttl <= granted2
        fcli.lease_revoke(lease_id)
        fwd = follower.role.forwarded
        assert fwd["txn"] >= 1 and fwd["lease_grant"] == 1
        assert fwd["lease_ttl"] == 1 and fwd["lease_revoke"] == 1
        base = follower.role.served["range"]
        fcli.list(PODS, PODS_END, serializable=True)
        assert follower.role.served["range"] > base
    finally:
        fcli.close()
        lcli.close()
        follower.close()
        leader.close()


# ------------------------------------------------ cross-package differential
def _write_script(lcli, seed: int) -> list[int]:
    """A seeded mix of creates, CAS updates, deletes and failed CAS
    updates (revision gaps) on the leader; returns the pinned revisions
    the followers are read at."""
    rng = random.Random(seed)
    live: dict[bytes, int] = {}
    pinned = []
    for i in range(90):
        op = rng.random()
        if op < 0.5 or not live:
            key = b"/registry/pods/ns%d/d%03d" % (rng.randrange(3), i)
            ok, rev = lcli.create(key, b"v%d-" % i + b"x" * rng.randrange(64))
            assert ok
            live[key] = rev
        elif op < 0.75:
            key = rng.choice(sorted(live))
            ok, rev = lcli.update(key, b"u%d" % i, live[key])
            assert ok
            live[key] = rev
        elif op < 0.9:
            key = rng.choice(sorted(live))
            assert lcli.delete(key, live.pop(key))
        else:
            key = rng.choice(sorted(live))
            ok, _ = lcli.update(key, b"stale", live[key] - 1)
            assert not ok
        if i % 15 == 14:
            pinned.append(lcli.current_revision())
    return pinned


def _pinned_answers(package, storage: str, seed: int) -> list:
    """The follower's Range (whole, limited) and Count answers at every
    pinned revision of the write script, as serialized wire messages,
    after checking that each equals the leader's."""
    from kubebrain_tpu_torch.proto import rpc_pb2

    leader, lcli, follower, fcli = spawn_pair(
        storage=storage, package=package,
        leader_extra=["--merge-threshold", "32"],
        follower_extra=["--merge-threshold", "32"])
    try:
        pinned = _write_script(lcli, seed)
        fcli.current_revision()  # fenced: the follower has applied it all
        out = []
        for rev in pinned:
            for ns in (b"/registry/pods/", b"/registry/pods/ns1/"):
                end = ns[:-1] + b"0"
                for req in (
                        rpc_pb2.RangeRequest(key=ns, range_end=end, revision=rev),
                        rpc_pb2.RangeRequest(key=ns, range_end=end, revision=rev,
                                             limit=4),
                        rpc_pb2.RangeRequest(key=ns, range_end=end, revision=rev,
                                             count_only=True)):
                    got = [fcli._range(req), lcli._range(req)]
                    f, l_ = ((r.count, r.more, [kv.SerializeToString()
                                                for kv in r.kvs])
                             for r in got)
                    assert f == l_, (rev, req)
                    out.append(f)
        return pinned, out
    finally:
        fcli.close()
        lcli.close()
        follower.close()
        leader.close()


def test_followers_answer_alike_across_packages():
    """One seeded write script on a JAX pair (``tpu`` mirror, jnp) and on a
    port pair (``cuda`` mirror on the CPU): at the same pinned revisions
    the followers' Range and Count answers (kvs with their create and mod
    revisions and versions, count, more) are equal, exactly."""
    jax_pinned, jax_out = _pinned_answers((jax_cli, jax_client), "tpu", 7)
    port_pinned, port_out = _pinned_answers(None, "cuda", 7)
    assert port_pinned == jax_pinned
    assert port_out == jax_out
    assert any(count for count, _more, _kvs in port_out)


def test_apply_delete_constant_is_the_wire_delete():
    """``replica/apply.py`` names etcd's ``mvccpb.Event_DELETE`` instead of
    importing the generated protos: the two agree."""
    from kubebrain_tpu_torch.proto import kv_pb2
    from kubebrain_tpu_torch.replica import apply

    assert apply.EVENT_DELETE == kv_pb2.Event.DELETE == 1
    assert not hasattr(apply, "kv_pb2")


def _clocked_role(role_mod, monkeypatch, applied):
    """A role of ``role_mod`` over a watermark ``applied[0]`` and a clock
    ``clock[0]`` the test moves, with a 5 s staleness bound; the leader's
    head fetches answer ``heads[0]``."""
    import types

    clock, heads = [0.0], [0]
    monkeypatch.setattr(role_mod, "time",
                        types.SimpleNamespace(monotonic=lambda: clock[0]))
    backend = types.SimpleNamespace(tso=types.SimpleNamespace(
        committed=lambda: applied[0]))
    role = role_mod.FollowerRole(backend, role_mod.FollowerConfig(
        leader_address="unused:1", leader_info="unused:2",
        max_staleness_ms=5000.0))
    role._syncer._fetch = lambda: heads[0]
    return role, clock, heads


@pytest.mark.parametrize("package", ["port", "jax"])
def test_staleness_clock_runs_from_the_newest_covered_leader_head(
        package, monkeypatch):
    """Under steady writes and fences the watermark seldom covers the
    highest head heard of. The port's clock runs from the start of the
    newest fetch whose head the watermark covers, so a follower 4.5 s
    behind serves a serializable read and one 5.5 s behind refuses it;
    a head it has not covered never makes it fresher. The JAX role's
    clock runs from the last instant the watermark covered the highest
    head, and refuses the read at 4.5 s (a kept divergence)."""
    if package == "jax":
        from kubebrain_tpu.replica import role as role_mod
    else:
        from kubebrain_tpu_torch.replica import role as role_mod
    applied = [100]
    role, clock, heads = _clocked_role(role_mod, monkeypatch, applied)

    def at(t, head=None, fence=False, watermark=None):
        clock[0] = t
        if head is not None:
            heads[0] = head
            if fence:
                role.leader_revision()
            elif package == "port":
                role.sample_leader_head()
            else:  # the JAX stream's compact sync notes a head
                role._note_leader_rev(head)
        if watermark is not None:
            applied[0] = watermark
            role.note_applied(watermark, watermark)

    def refused() -> bool:
        try:
            role.gate_read(0, True)
            return False
        except role_mod.StaleReplicaError:
            return True

    at(0.0, watermark=100)
    at(1.0, head=200, fence=True)
    at(2.0, head=250)
    at(3.0, watermark=200)
    at(4.0, head=400, fence=True)
    at(6.5, watermark=250)
    assert refused() == (package == "jax")
    if package == "jax":
        return
    assert role.lag_seconds() == 4.5
    at(7.5)
    assert refused() and role.lag_seconds() == 5.5
    at(9.0, watermark=399)  # the head fetched at 4.0 is not covered yet
    assert refused() and role.lag_seconds() == 7.0
    applied[0] = 400        # covered: the clock runs from 4.0
    assert role.lag_seconds() == 5.0


def test_a_failed_head_sample_pauses_the_samples(monkeypatch):
    """A leader-head sample that fails pauses the samples for the compact
    sync's interval: the stream's ticks then take no fetch timeout each."""
    from kubebrain_tpu_torch.replica import role as role_mod

    role, clock, _heads = _clocked_role(role_mod, monkeypatch, [0])
    calls = []

    def fetch():
        calls.append(clock[0])
        raise OSError("leader /status unreachable")

    role._syncer._fetch = fetch
    for t in (0.0, 0.2, 4.9, 5.1):
        clock[0] = t
        role.sample_leader_head()
    assert calls == [0.0, 5.1]
    role._syncer._fetch = lambda: 9
    clock[0] = 10.2
    role.sample_leader_head()
    assert role._heads[-1] == (10.2, 9)


def test_two_replica_end_to_end_smoke():
    """A spawned leader and two followers of the port's CLI on the CPU,
    through the port's workload harness: the gRPC front, follower-routed
    list+watch, fence probes, the schema'd replica report section, and
    every reconcile check green."""
    from kubebrain_tpu_torch.workload.runner import run_workload
    from kubebrain_tpu_torch.workload.spec import WorkloadSpec

    spec = WorkloadSpec.for_smoke(8, replicas=2)
    report = run_workload(spec, write_report=False, device="cpu")
    assert report["slo"]["pass"], report["slo"]["violations"]
    rep = report["replica"]
    assert rep["replicas"] == 2 and len(rep["per_replica"]) == 2
    for pr in rep["per_replica"]:
        assert pr["revision_bound_ok"]
        assert pr["applied_revision"] > 0
        assert pr["served"].get("range", 0) > 0
        assert pr["max_client_revision"] <= pr["applied_revision"]
    assert rep["fence_probes"]["violations"] == 0
    assert rep["reconcile"]["ok"]
    assert report["replay"]["rows_per_sec"] > 0
    # writes round-robin over all three endpoints, so some land on
    # followers and are forwarded
    assert sum(pr["forwarded"].get("txn", 0)
               for pr in rep["per_replica"]) > 0
