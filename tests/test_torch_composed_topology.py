"""The composed production topology on the port:

    kbfront (native frontend) -> kubebrain_tpu_torch process
        --storage cuda --inner-storage remote  ->  kbstored (shared tier)

Counterparts of ``tests/test_composed_topology.py``: the bulk-export op
(``export_mvcc``) that rebuilds the ``cuda`` mirror from ``kbstored``
without per-row Python, against the slow path (iter + decode) and paged by
hand; the ``cuda``-over-remote composition rebuilding by export; and the
full wire topology of three port CLI processes on the CPU (``--device
cpu``), each with its kbfront listener, over one ``kbstored``: writes
through the leader's kbfront, ``kill -9`` of the leader, and the new
leader's list through its kbfront held against an in-process memkv oracle
that replayed the acknowledged writes. ``kbstored`` and ``kbfront`` are
built on first use (``tests/kbstored_build.py``).
"""

import json
import signal
import socket
import struct
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from kubebrain_tpu_torch import coder
from kubebrain_tpu_torch.backend import Backend, BackendConfig
from kubebrain_tpu_torch.backend.common import TOMBSTONE
from kubebrain_tpu_torch.ops.keys import KEY_WIDTH
from kubebrain_tpu_torch.storage import new_storage

from kbstored_build import REPO, kbfront, kbstored  # noqa: F401
from test_etcd_server import free_port


@pytest.fixture
def stored(kbstored):  # noqa: F811
    port = free_port()
    proc = subprocess.Popen([str(kbstored), str(port)],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    assert b"READY" in proc.stdout.readline()
    yield port
    proc.terminate()
    proc.wait(timeout=5)


def test_remote_export_mvcc_matches_iter_decode(stored):
    """OP_EXPORT returns exactly the rows the slow path (iter + decode)
    yields, in the same order, with the same values, revisions and
    tombstones."""
    s = new_storage("remote", address=f"127.0.0.1:{stored}", pool=2)
    b = Backend(s, BackendConfig(event_ring_capacity=1024,
                                 watch_cache_capacity=1024))
    try:
        revs = {}
        for i in range(40):
            k = b"/registry/exp/k%03d" % i
            revs[k] = b.create(k, b"val-%d" % i)
        for i in range(0, 40, 4):
            k = b"/registry/exp/k%03d" % i
            b.update(k, b"upd-%d" % i, revs[k])
        for i in range(1, 40, 8):
            b.delete(b"/registry/exp/k%03d" % i)

        snap = s.get_timestamp_oracle()
        lo, hi = coder.internal_range(b"", b"")
        want = []
        for ikey, value in s.iter(lo, hi, snapshot_ts=snap):
            ukey, rev = coder.decode(ikey)
            if rev != 0:
                want.append((ukey, rev, value == TOMBSTONE, value))

        keys, lens, revs_a, tomb, arena, offsets = s.export_mvcc(
            lo, hi, snap, KEY_WIDTH, coder.MAGIC, TOMBSTONE)
        assert len(lens) == len(want)
        for i, (ukey, rev, is_tomb, value) in enumerate(want):
            assert keys[i, : lens[i]].tobytes() == ukey
            assert int(revs_a[i]) == rev
            assert bool(tomb[i]) == is_tomb
            assert arena[int(offsets[i]) : int(offsets[i + 1])].tobytes() == value
    finally:
        b.close()
        s.close()


def test_remote_export_paging(stored):
    """Pages stitch seamlessly: pages of 3 rows requested through the wire
    op by hand equal the one-shot export."""
    from kubebrain_tpu_torch.storage.remote import (
        OP_EXPORT,
        ST_OK,
        _bytes_field,
        _Reader,
    )

    s = new_storage("remote", address=f"127.0.0.1:{stored}", pool=2)
    b = Backend(s, BackendConfig(event_ring_capacity=1024,
                                 watch_cache_capacity=1024))
    try:
        for i in range(10):
            b.create(b"/pg/k%02d" % i, b"v%d" % i)
        snap = s.get_timestamp_oracle()
        lo, hi = coder.internal_range(b"", b"")
        full = s.export_mvcc(lo, hi, snap, KEY_WIDTH, coder.MAGIC, TOMBSTONE)

        rows = []
        cursor = lo
        for _ in range(100):
            body = bytearray(struct.pack("<QQI", snap, KEY_WIDTH, 3))
            for f in (coder.MAGIC, TOMBSTONE, cursor, hi):
                _bytes_field(body, f)
            status, payload = s._call(OP_EXPORT, bytes(body))
            assert status == ST_OK
            r = _Reader(payload)
            n = r.u32()
            more = bool(r.u8())
            nxt = r.bytes_()
            off = r.off
            keys = np.frombuffer(payload, np.uint8, n * KEY_WIDTH,
                                 off).reshape(n, KEY_WIDTH)
            off += n * KEY_WIDTH
            lens = np.frombuffer(payload, np.int32, n, off)
            off += 4 * n
            revs = np.frombuffer(payload, np.uint64, n, off)
            assert n <= 3
            for i in range(n):
                rows.append((keys[i, : lens[i]].tobytes(), int(revs[i])))
            if not more:
                break
            cursor = nxt
        assert len(rows) == len(full[1])
        for i, (k, rv) in enumerate(rows):
            assert k == full[0][i, : full[1][i]].tobytes()
            assert rv == int(full[2][i])
    finally:
        b.close()
        s.close()


def test_cuda_over_remote_rebuild_uses_bulk_export(stored, monkeypatch):
    """``cuda`` over remote: a rebuild of the mirror from the store (the
    uncertain-commit quarantine) takes the bulk export, not per-row
    Python, and serves the right lists."""
    from kubebrain_tpu_torch.storage.remote import RemoteKvStorage

    calls = {"n": 0}
    orig = RemoteKvStorage.export_mvcc

    def counting(self, *a, **kw):
        calls["n"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(RemoteKvStorage, "export_mvcc", counting)
    store = new_storage("cuda", inner="remote", device="cpu",
                        address=f"127.0.0.1:{stored}", pool=2)
    b = Backend(store, BackendConfig(event_ring_capacity=1024,
                                     watch_cache_capacity=1024))
    b.scanner._host_limit_threshold = 0
    try:
        for i in range(25):
            b.create(b"/registry/ct/p%02d" % i, b"v%d" % i)
        b.delete(b"/registry/ct/p03")
        b.scanner.publish()
        before = (calls["n"], b.scanner.mirror_builds["export"])
        b.scanner.mark_uncertain()
        res = b.list_(b"/registry/ct/", b"/registry/ct0")
        assert calls["n"] > before[0], "the rebuild did not use the export"
        assert b.scanner.mirror_builds["export"] > before[1]
        assert b.scanner.mirror_builds["rows"] == 0
        got = {kv.key: kv.value for kv in res.kvs}
        assert len(got) == 24 and b"/registry/ct/p03" not in got
        assert got[b"/registry/ct/p07"] == b"v7"
        assert b.count(b"/registry/ct/", b"/registry/ct0")[0] == 24
    finally:
        b.close()
        store.close()


# --------------------------------------------------- full wire topology
class ComposedNode:
    """A port CLI process: ``cuda`` over remote ``kbstored`` on the CPU,
    with its kbfront listener and the etcd proxy."""

    def __init__(self, stored_port):
        self.client_port = free_port()
        self.peer_port = free_port()
        self.info_port = free_port()
        self.front_port = free_port()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubebrain_tpu_torch.cli",
             "--storage", "cuda", "--inner-storage", "remote",
             "--device", "cpu",
             "--storage-address", f"127.0.0.1:{stored_port}",
             "--storage-pool", "2",
             "--host", "127.0.0.1",
             "--client-port", str(self.client_port),
             "--peer-port", str(self.peer_port),
             "--info-port", str(self.info_port),
             "--front-port", str(self.front_port),
             "--enable-etcd-proxy"],
            cwd=REPO, stderr=subprocess.DEVNULL)

    def status(self, timeout=2.0):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.peer_port}/status",
                timeout=timeout) as resp:
            return json.loads(resp.read())

    def wait_front(self, deadline=60):
        """kbfront starts after the Python listeners: wait until its port
        accepts."""
        end = time.time() + deadline
        while time.time() < end:
            rc = self.proc.poll()
            if rc is not None:
                raise AssertionError(f"node died (exit {rc}) before kbfront "
                                     f"came up")
            try:
                socket.create_connection(("127.0.0.1", self.front_port),
                                         timeout=1.0).close()
                return
            except OSError:
                time.sleep(0.2)
        raise AssertionError(f"kbfront on :{self.front_port} never came up")

    def kill(self):
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=5)

    def terminate(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()


def test_composed_topology_failover_differential(kbstored, kbfront):  # noqa: F811
    """Three port CLI processes, each ``cuda`` over remote with a kbfront
    listener, over one kbstored. Writes go through the leader's kbfront;
    then ``kill -9`` of the leader, and the new leader's full list
    through its kbfront must equal an in-process memkv oracle that
    replayed the acknowledged writes."""
    from kubebrain_tpu_torch.client import EtcdCompatClient

    sport = free_port()
    stored_proc = subprocess.Popen([str(kbstored), str(sport)],
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.DEVNULL)
    assert b"READY" in stored_proc.stdout.readline()
    nodes = [ComposedNode(sport) for _ in range(3)]
    oracle_store = new_storage("memkv")
    oracle = Backend(oracle_store, BackendConfig(event_ring_capacity=1024,
                                                 watch_cache_capacity=1024))
    try:
        def leaders(candidates, deadline=90):
            end = time.time() + deadline
            while time.time() < end:
                found = []
                for n in candidates:
                    try:
                        if n.status().get("is_leader"):
                            found.append(n)
                    except Exception:
                        pass
                if len(found) == 1:
                    return found
                time.sleep(0.3)
            return []

        ls = leaders(nodes)
        assert len(ls) == 1, "the cluster must elect exactly one leader"
        leader = ls[0]
        leader.wait_front()
        c = EtcdCompatClient(f"127.0.0.1:{leader.front_port}")
        for i in range(40):
            k = b"/registry/comp/k%03d" % i
            ok, _rev = c.create(k, b"v%d" % i)
            assert ok
            oracle.create(k, b"v%d" % i)
        for i in range(0, 40, 10):
            k = b"/registry/comp/k%03d" % i
            kvs, _ = c.list(k, k + b"\x00")
            assert len(kvs) == 1
            ok, _rev = c.update(k, b"u%d" % i, kvs[0].mod_revision)
            assert ok
            oracle.update(k, b"u%d" % i, oracle.get(k).revision)
        kvs, _ = c.list(b"/registry/comp/k005", b"/registry/comp/k005\x00")
        assert c.delete(b"/registry/comp/k005", kvs[0].mod_revision)
        oracle.delete(b"/registry/comp/k005")
        c.close()

        leader.kill()
        survivors = [n for n in nodes if n is not leader]
        ls = leaders(survivors)
        assert len(ls) == 1, "no single new leader within 90 s"
        new_leader = ls[0]

        want = sorted((kv.key, kv.value) for kv in oracle.list_(
            b"/registry/comp/", b"/registry/comp0").kvs)
        new_leader.wait_front()
        c2 = EtcdCompatClient(f"127.0.0.1:{new_leader.front_port}")
        got = []
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                kvs, _ = c2.list(b"/registry/comp/", b"/registry/comp0")
                got = sorted((bytes(kv.key), bytes(kv.value)) for kv in kvs)
                if got == want:
                    break
            except Exception:
                pass
            time.sleep(0.5)
        c2.close()
        assert len(want) == 39
        assert got == want, (f"the composed topology diverged from the "
                             f"oracle: {len(got)} vs {len(want)} rows")
    finally:
        oracle.close()
        oracle_store.close()
        for n in nodes:
            n.terminate()
        stored_proc.terminate()
        stored_proc.wait(timeout=5)
