"""Watch robustness under server-side stream resets (docs/faults.md), on
the port: the seven cases of ``tests/test_watch_robustness.py`` with the
port's client (``kubebrain_tpu_torch.client.WatchMux``) against the port's
front, hub and fault plane, over memkv.

Proves the chaos-mode watch contract end to end through the real gRPC
front: a server-side watch drop (slow consumer or fault injection) makes
the resume-armed client WatchMux re-register from last-delivered
revision + 1 with NO lost and NO duplicated events; the slow-consumer
drop fires at the subscriber-queue bound and is scrape-visible.
"""

import queue
import threading
import time

import pytest

from test_etcd_server import free_port

from kubebrain_tpu_torch.backend import Backend, BackendConfig
from kubebrain_tpu_torch.client import EtcdCompatClient, WatchMux
from kubebrain_tpu_torch.endpoint import Endpoint, EndpointConfig
from kubebrain_tpu_torch.metrics import NoopMetrics, new_metrics
from kubebrain_tpu_torch.server import Server
from kubebrain_tpu_torch.server.service import SingleNodePeerService
from kubebrain_tpu_torch.storage import new_storage


@pytest.fixture()
def served():
    store = new_storage("memkv")
    backend = Backend(store, BackendConfig(event_ring_capacity=8192))
    peers = SingleNodePeerService(backend)
    metrics = new_metrics("")  # real prometheus sink: drop counter visible
    backend.watcher_hub.set_metrics(metrics)
    server = Server(backend, peers, metrics)
    port = free_port()
    ep = Endpoint(server, metrics, EndpointConfig(
        host="127.0.0.1", client_port=port,
        peer_port=free_port(), info_port=free_port(),
    ))
    ep.run()
    yield f"127.0.0.1:{port}", backend, metrics
    ep.close()
    backend.close()
    store.close()


def _hub_wids(backend):
    return backend.watcher_hub.watcher_ids()


def _wait(cond, timeout=10.0, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def test_watchmux_resumes_after_server_side_reset(served):
    """Server-side stream reset mid-watch: the client resumes from
    last-delivered revision + 1 — every event delivered exactly once."""
    target, backend, _m = served
    c = EtcdCompatClient(target)
    mux = WatchMux(c, streams=2, resume=True, record_revisions=True)
    try:
        w = mux.add(b"/rw/", b"/rw0", start_revision=0, timeout=30.0)
        expected = []
        for i in range(5):
            expected.append(backend.create(b"/rw/k-%02d" % i, b"v%d" % i))
        _wait(lambda: w.events >= 5, what="first batch delivery")
        # server-side reset: drop the hub watcher (the same path a slow-
        # consumer drop and the fault plane's watch_reset injection take)
        wids = _hub_wids(backend)
        assert len(wids) == 1
        backend.watcher_hub.delete_watcher(wids[0])
        # events written WHILE the client re-registers: the watch cache
        # replays them on resume — none may be lost
        for i in range(5, 12):
            expected.append(backend.create(b"/rw/k-%02d" % i, b"v%d" % i))
        _wait(lambda: w.events >= 12, what="post-resume delivery")
        _wait(lambda: w.resumes >= 1, what="resume accounting")
        assert not w.cancelled
        # exactly once, in revision order: no loss, no duplicates
        assert w.revisions == expected
        # the server sees a live watcher again
        _wait(lambda: len(_hub_wids(backend)) == 1, what="re-registration")
    finally:
        mux.close()
        c.close()


def test_watchmux_survives_repeated_resets_no_loss_no_dup(served):
    """Chaos cadence: resets fired repeatedly while a writer streams —
    the delivered revision sequence must be the exact commit sequence."""
    target, backend, _m = served
    c = EtcdCompatClient(target)
    mux = WatchMux(c, streams=1, resume=True, record_revisions=True)
    try:
        w = mux.add(b"/rr/", b"/rr0", start_revision=0, timeout=30.0)
        expected = []
        stop = threading.Event()

        def nemesis():
            while not stop.is_set():
                for wid in _hub_wids(backend):
                    backend.watcher_hub.delete_watcher(wid)
                time.sleep(0.05)

        t = threading.Thread(target=nemesis, daemon=True)
        t.start()
        for i in range(60):
            expected.append(backend.create(b"/rr/k-%03d" % i, b"v"))
            time.sleep(0.005)
        stop.set()
        t.join(timeout=5)
        _wait(lambda: w.events >= 60, timeout=20.0,
              what="all events after repeated resets")
        assert w.revisions == expected, (
            f"lost={set(expected) - set(w.revisions)} "
            f"dup={[r for r in w.revisions if w.revisions.count(r) > 1]}")
        assert w.resumes >= 1 and not w.cancelled
    finally:
        mux.close()
        c.close()


def test_resume_not_armed_keeps_terminal_cancel(served):
    """Without resume (the pre-chaos default) a server-side drop stays a
    terminal cancel — the legacy contract is unchanged."""
    target, backend, _m = served
    c = EtcdCompatClient(target)
    mux = WatchMux(c, streams=1, resume=False)
    try:
        w = mux.add(b"/nc/", b"/nc0", start_revision=0, timeout=30.0)
        backend.create(b"/nc/k", b"v")
        _wait(lambda: w.events >= 1, what="delivery")
        for wid in _hub_wids(backend):
            backend.watcher_hub.delete_watcher(wid)
        _wait(lambda: w.cancelled, what="terminal cancel")
        assert w.resumes == 0
    finally:
        mux.close()
        c.close()


def test_slow_consumer_drop_fires_at_backlog_bound():
    """The documented backlog bound: a consumer that stops draining is
    dropped once its subscriber queue fills, the poison pill ends the
    stream, and the drop is visible on /metrics (kb_watch_dropped_total)
    alongside the kb_watch_backlog gauge."""
    store = new_storage("memkv")
    backend = Backend(store, BackendConfig(event_ring_capacity=8192))
    metrics = new_metrics("")
    backend.watcher_hub.set_metrics(metrics)
    try:
        bound = 4
        wid, q = backend.watch_range(
            b"/sc/", b"/sc0",
            queue_factory=lambda _maxsize: queue.Queue(maxsize=bound))
        # backlog gauge reflects the (undrained) queue depth
        for i in range(bound):
            backend.create(b"/sc/k-%02d" % i, b"v")
        _ctype, body = metrics.http_handler()()
        text = body.decode()
        assert f'kb_watch_backlog{{watcher="{wid}"}} {float(bound)}' in text
        # one more batch past the bound: the hub drops the watcher
        backend.create(b"/sc/k-xx", b"v")
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline \
                and backend.watcher_hub.watcher_count() > 0:
            time.sleep(0.02)
        assert backend.watcher_hub.watcher_count() == 0
        # the stream ends with the poison pill (after the buffered batches)
        seen_pill = False
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                seen_pill = True
        assert seen_pill, "dropped watcher never got the poison pill"
        _ctype, body = metrics.http_handler()()
        assert "kb_watch_dropped_total 1.0" in body.decode()
    finally:
        backend.close()
        store.close()


def test_fault_plane_watch_reset_drops_live_watchers():
    """The plane's watch_reset injection drops seeded-random live hub
    watchers — the server half of the resume contract."""
    from kubebrain_tpu_torch import faults

    store = new_storage("memkv")
    backend = Backend(store, BackendConfig())
    try:
        plane = faults.FaultPlane(faults.generate("watch", 1, 5.0))
        plane.bind_hub(backend.watcher_hub)
        wids = [backend.watch_range(b"/fp/", b"/fp0")[0] for _ in range(6)]
        assert backend.watcher_hub.watcher_count() == 6
        assert plane._reset_watchers(2) == 2
        assert backend.watcher_hub.watcher_count() == 4
        assert plane._reset_watchers(100) == 4  # clamped to live set
        assert backend.watcher_hub.watcher_count() == 0
        assert wids  # ids were real
    finally:
        backend.close()
        store.close()


# ------------------------------------------------- delivered-order holes
# Two server-side paths used to open an INVISIBLE gap in a
# delivered-in-order watch stream — fatal once a later response (event
# batch or replica progress mark) vouches for the skipped revisions and a
# resume watermark carries the loss forward (docs/replication.md):
#   1. _WatchSession._send dropping ONE response when the per-stream out
#      queue stayed full, while later responses kept flowing;
#   2. WatcherHub.delete_watcher evicting only the HEAD of a full
#      subscriber queue to fit the poison pill, delivering the newer
#      batches after the gap.
# Both must instead END the stream at the last delivered response.

def test_session_send_overflow_poisons_stream_instead_of_gapping():
    from kubebrain_tpu_torch.server.etcd.watch import _WatchSession

    store = new_storage("memkv")
    backend = Backend(store, BackendConfig())
    try:
        out: queue.Queue = queue.Queue(maxsize=2)
        session = _WatchSession(backend, out, context=None)
        out.put("r1")
        out.put("r2")  # full: the next _send cannot deliver in order
        session._send("r3-would-gap")
        # the session must be POISONED (the stream writer checks the flag
        # before every yield, so the wire sequence stays a strict prefix
        # of the enqueued order) — never a silent skip of one response
        assert session.poisoned
        with session._lock:
            assert session._closed
        # the dropped response never entered the queue
        assert "r3-would-gap" not in list(out.queue)
    finally:
        backend.close()
        store.close()


def test_delete_watcher_flags_before_pill():
    from kubebrain_tpu_torch.backend.common import WatchEvent
    from kubebrain_tpu_torch.backend.watcherhub import WatcherHub

    hub = WatcherHub()
    wid, q = hub.add_watcher(
        b"", b"", 0, queue_factory=lambda _ms: queue.Queue(maxsize=3))
    for rev in (1, 2, 3):
        hub.stream([WatchEvent(revision=rev, key=b"/k%d" % rev)])
    assert q.full()
    hub.delete_watcher(wid)
    # nothing may be delivered past the drop point: delete_watcher sets
    # kb_dropped BEFORE evicting for the pill, and the pump checks it
    # before every delivery — a consumer seeing batch 2 or 3 after batch
    # 1 was evicted would resume past rev 1 (the invisible-gap shape)
    assert getattr(q, "kb_dropped", False)
    delivered = []
    while True:
        item = q.get_nowait()
        if item is None or getattr(q, "kb_dropped", False):
            break
        delivered.append(item)
    assert delivered == []
