"""Replay engine: executes a generated schedule against a real kubebrain
server **through a transport** and emits the SLO report.

The transport hands the runner its clients, its watch and lease
multiplexers and its ``/metrics`` scrape. The default,
:class:`GrpcTransport`, does what the JAX runner does: a spawned
``python -m kubebrain_tpu_torch.cli`` (``--device`` passed through)
reached over the gRPC front with the port's client. ``chip_smoke.py`` phase (k)
hands the runner an in-process transport instead, since the card's machine
has no ``grpcio``; this module loads without ``grpc`` for that reason, and
imports it only inside :class:`GrpcTransport`.

Execution model (bounded open-loop):

- a single dispatcher thread walks the replay schedule on the
  :class:`~kubebrain_tpu.workload.clock.ReplayPacer` and routes each op to
  a shard — pod writes hash by key (per-key ordering, so CAS revisions
  thread through without coordination), controller reads hash by watcher,
  compaction runs on a dedicated admin shard, keepalives go straight to
  the multiplexed lease streams;
- every shard is one worker thread + one gRPC channel + a bounded queue:
  the schedule never waits for completions (open-loop), but a full shard
  queue blocks the dispatcher (bounded) — the recorded dispatch lag is
  then part of the result, exactly like a congested real client fleet;
- watches ride the transport's ``WatchMux`` (N watchers over a few
  streams), keepalives its ``LeaseMux``.

The report reconciles client-side RPC counts against the server's own
/metrics exposition (rpc_server_count deltas, kb_lease_* counters,
kb_watch_backlog series) — a replay whose numbers don't add up is a
harness bug, not a benchmark.

CLI: ``python -m kubebrain_tpu_torch.workload.runner --nodes 5000``
(``--device cpu`` on a machine without a card; ``--smoke`` for the small
CI shape). Reports land in the checkout's ``build/workload/``.

Counterpart of ``kubebrain_tpu/workload/runner.py``; ROADMAP §3 lists where
it differs (the transport seam, the spawned CLI's flags).
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time
import urllib.request
import zlib
from collections import Counter
from dataclasses import asdict
from typing import Any

from .. import coder
from ..device import resolve_device
from ..faults import schedule as fault_schedule
from . import generator, slo
from .clock import ReplayPacer
from .generator import (
    COMPACT, CTRL_LIST, CTRL_RELIST, CTRL_START, LEASE_GRANT,
    LEASE_KEEPALIVE, LEASE_LIST, LEASE_PREFIX, POD_CREATE, POD_DELETE,
    POD_UPDATE, PODS_PREFIX, PRELOAD_CREATE, ns_name,
)
from .spec import WorkloadSpec

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: where a report lands unless the caller names a path
REPORT_DIR = os.path.join(REPO_ROOT, "build", "workload")

#: op kind -> report lane. Writes aren't scheduler lanes (the write path
#: bypasses the read scheduler) but they are a latency population the
#: report must keep separate; compaction is an administrative write.
#: PRELOAD_CREATE is deliberately absent: preload is an untimed pipelined
#: burst, and its samples would dilute the replay's lane percentiles and
#: shed/error denominators (it still appears under op_kinds).
LANE_OF = {
    POD_CREATE: "write",
    POD_UPDATE: "write",
    POD_DELETE: "write",
    COMPACT: "write",
    LEASE_GRANT: "system",
    LEASE_KEEPALIVE: "system",
    LEASE_LIST: "system",
    CTRL_START: "normal",
    CTRL_LIST: "normal",
    CTRL_RELIST: "background",
}

_TXN = "/etcdserverpb.KV/Txn"
_RANGE = "/etcdserverpb.KV/Range"
_COMPACT = "/etcdserverpb.KV/Compact"
_LEASE_GRANT_RPC = "/etcdserverpb.Lease/LeaseGrant"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class GrpcTransport:
    """The runner's default transport: servers of the port's CLI, spawned
    by the runner (or one given by ``--target``), reached through the
    port's gRPC client. ``grpc`` and the client load on first use."""

    #: the runner spawns and probes the servers itself, and reconciles
    #: their ``rpc_server_count`` with the RPCs its clients sent
    in_process = False

    def __init__(self, device: str | None = None) -> None:
        #: passed to each spawned server as ``--device`` (None: ``cuda``)
        self.device = device or "cuda"

    @property
    def rpc_errors(self) -> tuple:
        import grpc

        return (grpc.RpcError,)

    def client(self, target: str | list[str], **kw: Any) -> Any:
        from ..client import EtcdCompatClient

        if isinstance(target, str):
            return EtcdCompatClient(target, **kw)
        return EtcdCompatClient(endpoints=list(target), **kw)

    def watch_mux(self, client: Any, streams: int, resume: bool) -> Any:
        from ..client import WatchMux

        return WatchMux(client, streams=streams, resume=resume)

    def lease_mux(self, client: Any, streams: int) -> Any:
        from ..client import LeaseMux

        return LeaseMux(client, streams=streams)

    def is_shed(self, e: BaseException) -> bool:
        import grpc

        return (hasattr(e, "code")
                and e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED)

    def classify(self, e: BaseException, write: bool) -> str:
        from ..client import classify_rpc_error

        return classify_rpc_error(e, write=write)

    def describe(self, e: BaseException) -> str:
        code = e.code() if hasattr(e, "code") else None
        return f"{code}: {e}"

    def scrape(self, host: str, info_port: int) -> slo.PromSnapshot:
        with urllib.request.urlopen(
            f"http://{host}:{info_port}/metrics", timeout=15,
        ) as resp:
            return slo.parse_prom(resp.read().decode())


class _Stats:
    """Thread-safe per-kind latency samples + outcome counters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.samples: dict[str, list[float]] = {}
        self.outcomes: Counter = Counter()
        self.error_samples: list[str] = []

    def record(self, kind: str, dt: float, outcome: str = "ok",
               err: str | None = None, sample: bool = True) -> None:
        with self._lock:
            self.outcomes[(kind, outcome)] += 1
            if outcome == "ok" and sample:
                self.samples.setdefault(kind, []).append(dt)
            if err is not None and len(self.error_samples) < 20:
                self.error_samples.append(f"{kind}: {err}")

    def count(self, kind: str, outcome: str | None = None) -> int:
        with self._lock:
            if outcome is not None:
                return self.outcomes[(kind, outcome)]
            return sum(n for (k, _o), n in self.outcomes.items() if k == kind)


class _Shard(threading.Thread):
    """One worker thread + one client + a bounded op queue. ``target`` may
    be a list of endpoints: the client then round-robins with safe-only
    failover (the replica topology's load-balanced apiserver shape)."""

    def __init__(self, name: str, target: str | list[str], qsize: int,
                 stats: _Stats, transport: Any) -> None:
        super().__init__(name=name, daemon=True)
        self.client = transport.client(target)
        self.q: queue.Queue = queue.Queue(maxsize=qsize)
        self._stats = stats
        self.start()

    def submit(self, fn: Any) -> None:
        self.q.put(fn)  # blocks when full: the bounded part of open-loop

    def run(self) -> None:
        while True:
            fn = self.q.get()
            try:
                if fn is None:
                    return
                fn(self.client)
            except Exception as e:  # a broken op must not kill the shard
                self._stats.record("SHARD", 0.0, "error", err=repr(e))
            finally:
                self.q.task_done()

    def close(self) -> None:
        self.q.put(None)
        self.join(timeout=10.0)
        self.client.close()


class WorkloadRunner:
    def __init__(self, spec: WorkloadSpec, target: str | None = None,
                 info_port: int = 0, out_path: str | None = None,
                 write_report: bool = True,
                 server_log: str | None = None,
                 transport: Any = None) -> None:
        self.transport = (transport if transport is not None
                          else GrpcTransport())
        if self.transport.in_process:
            # one backend in this process: no server to spawn, follow or
            # arm (the fault plane's HTTP arm and the followers' /status
            # need the spawned topology)
            if target or spec.replicas or spec.faults != "none":
                raise ValueError(
                    "an in-process transport drives its own backend: no "
                    "target, replicas or faults")
            # its clients and scrape ignore the target and the info port
            target, info_port = "in-process", -1
        if target and not info_port:
            raise ValueError(
                "--target needs the server's info port too (the /metrics "
                "listener the report reconciles against); pass info_port/"
                "--target-info-port")
        self.spec = spec
        self._target = target
        self._out_path = out_path
        self._write = write_report
        self._server_log = server_log or os.environ.get("KB_WORKLOAD_SERVER_LOG")
        self.stats = _Stats()
        self._rpc_lock = threading.Lock()
        self._rpc: Counter = Counter()
        self._revs_lock = threading.Lock()
        self._revs: dict[bytes, int] = {}
        self._max_rev = 0
        self._last_compact = 0
        self._lease_lock = threading.Lock()
        self._lease_ids: dict[int, int] = {}
        self._server: subprocess.Popen | None = None
        self._info_port = info_port
        # /metrics lives on the target's host, not necessarily localhost
        self._info_host = (target.rsplit(":", 1)[0] if target
                           else "127.0.0.1")
        # ---- read scale-out (docs/replication.md) ----
        if spec.replicas and target:
            raise ValueError(
                "replicas>0 needs the runner to own the topology; "
                "--target mode drives a single external server")
        #: all endpoints, leader first; parallel info-port list. Single-
        #: server runs keep one entry so every code path below is shared.
        self._targets: list[str] = [target] if target else []
        self._info_ports: list[int] = [info_port] if target else []
        self._followers: list[subprocess.Popen] = []
        self._rows_lock = threading.Lock()
        self._rows_listed = 0
        self._fence_probe_stop = threading.Event()
        self._fence_probes: dict = {"count": 0, "ok": 0, "refused": 0,
                                    "violations": 0}
        self._lag_probe_samples: dict[str, list[int]] = {}
        self._probe_clients: list[Any] = []
        # ---- chaos mode (docs/faults.md) ----
        self.chaos = spec.faults != "none"
        #: the deterministic fault schedule this run declares (regenerated
        #: identically by the spawned server; sha echoed + self-checked)
        self._fault_sched = None
        if self.chaos:
            self._fault_sched = fault_schedule.generate(
                spec.faults, spec.fault_seed, self._fault_horizon_s())
        self._fault_armed_at: float | None = None
        # acknowledged-write ledger: POD key -> (state, revision) with
        # state in {"live", "deleted", "ambiguous", "failed"} — the input
        # to the keystone consistency check (every acked write present,
        # every definite error absent, ambiguous either way)
        self._ledger_lock = threading.Lock()
        self._ledger: dict[bytes, tuple[str, int]] = {}
        self._lease_keys_issued: set[bytes] = set()
        # latency samples for ops that completed INSIDE an active fault
        # window, per lane (the degraded-window p99 the report bounds)
        self._degraded_samples: dict[str, list[float]] = {}

    def _fault_horizon_s(self) -> float:
        """Fault windows span the REAL replay duration: everything after
        is the recovery window the final consistency scan runs in."""
        return max(1.0, self.spec.duration_s / self.spec.time_scale)

    # ------------------------------------------------------------- plumbing
    def _count_rpc(self, what: str, n: int = 1) -> None:
        with self._rpc_lock:
            self._rpc[what] += n

    def _note_rev(self, key: bytes, rev: int, ok: bool) -> None:
        with self._revs_lock:
            if rev > self._max_rev:
                self._max_rev = rev
            if ok:
                self._revs[key] = rev

    # --------------------------------------------------- chaos: ack ledger
    def _ledger_ack(self, key: bytes, state: str, rev: int = 0) -> None:
        """An ACKNOWLEDGED outcome re-establishes certain state — a later
        ack after an ambiguous op is only reachable when the ambiguous op
        did not apply (its CAS chain would otherwise conflict), so
        overwriting the ambiguous mark is sound."""
        with self._ledger_lock:
            self._ledger[key] = (state, rev)

    def _ledger_ambiguous(self, key: bytes) -> None:
        with self._ledger_lock:
            self._ledger[key] = ("ambiguous", 0)

    def _ledger_definite_failure(self, key: bytes) -> None:
        """Definite (provably-not-applied) failure: only meaningful when
        the key has no established state — it must then be ABSENT from the
        final scan (a present key would be a definite-error ghost)."""
        with self._ledger_lock:
            self._ledger.setdefault(key, ("failed", 0))

    def _in_fault_window(self) -> bool:
        armed, sched = self._fault_armed_at, self._fault_sched
        if armed is None or sched is None:
            return False
        t_ms = int((time.monotonic() - armed) * 1000)
        return any(w.active(t_ms) for w in sched.windows)

    def _execute(self, kind: str, fn: Any, client: Any,
                 key: bytes | None = None, write: bool = False) -> None:
        t0 = time.monotonic()
        in_window = self._in_fault_window()
        try:
            outcome = fn(client) or "ok"
        except self.transport.rpc_errors as e:
            if key is not None and write:
                # safe-vs-ambiguous classification (docs/faults.md): a
                # maybe-applied write constrains the final-state check
                if self.transport.classify(e, write=True) == "ambiguous":
                    self._ledger_ambiguous(key)
                else:
                    self._ledger_definite_failure(key)
            if self.transport.is_shed(e):
                self.stats.record(kind, 0.0, "shed")
            else:
                self.stats.record(kind, 0.0, "error",
                                  err=self.transport.describe(e))
            return
        except Exception as e:
            # e.g. a WatchMux registration timeout in CTRL_START: it must
            # land under the op's own kind/lane so the error-rate bound can
            # see it, not vanish into a synthetic bucket
            self.stats.record(kind, 0.0, "error", err=repr(e))
            return
        dt = time.monotonic() - t0
        if in_window:
            lane = LANE_OF.get(kind)
            if lane is not None and outcome == "ok":
                with self._ledger_lock:
                    self._degraded_samples.setdefault(lane, []).append(dt)
        self.stats.record(kind, dt, outcome)

    def _scrape(self, info_port: int | None = None) -> slo.PromSnapshot:
        return self.transport.scrape(self._info_host,
                                     info_port or self._info_port)

    def _scrape_all(self) -> list:
        """One snapshot per server, leader first (reconcile sums them via
        slo.merge_snapshots; per-replica fields read the individual
        follower snapshots)."""
        return [self._scrape(port) for port in self._info_ports]

    # ------------------------------------------------------------ op bodies
    def _ns_bounds(self, ns: int) -> tuple[bytes, bytes]:
        prefix = PODS_PREFIX + ns_name(ns) + b"/"
        return prefix, coder.prefix_end(prefix)

    def _do_pod_create(self, op):
        def fn(client):
            self._count_rpc("txn")
            ok, rev = client.create(op.key, b"v" * op.size)
            self._note_rev(op.key, rev, ok)
            if ok:
                self._ledger_ack(op.key, "live", rev)
            else:
                # a conflicting FIRST create on a unique key can only mean
                # an earlier maybe-applied attempt landed: ambiguous
                self._ledger_ambiguous(op.key)
            return None if ok else "conflict"
        return fn

    def _do_pod_update(self, op):
        def fn(client):
            with self._revs_lock:
                rev = self._revs.get(op.key)
            if rev is None:
                return "skip"  # its create failed/shed earlier
            self._count_rpc("txn")
            ok, newrev = client.update(op.key, b"u" * op.size, rev)
            self._note_rev(op.key, newrev, ok)
            if ok:
                self._ledger_ack(op.key, "live", newrev)
            return None if ok else "conflict"
        return fn

    def _do_pod_delete(self, op):
        def fn(client):
            with self._revs_lock:
                rev = self._revs.get(op.key)
            if rev is None:
                return "skip"
            self._count_rpc("txn")
            ok = client.delete(op.key, rev)
            if ok:
                with self._revs_lock:
                    self._revs.pop(op.key, None)
                self._ledger_ack(op.key, "deleted")
            return None if ok else "conflict"
        return fn

    def _do_lease_grant(self, op):
        def fn(client):
            with self._ledger_lock:
                self._lease_keys_issued.add(op.key)
            self._count_rpc("lease_grant")
            lid, _granted = client.lease_grant(self.spec.lease_ttl_s)
            self._count_rpc("txn")
            ok, rev = client.create(op.key, b"node-lease", lease=lid)
            self._note_rev(op.key, rev, ok)
            with self._lease_lock:
                self._lease_ids[op.node] = lid
            return None if ok else "conflict"
        return fn

    def _note_rows(self, n: int) -> None:
        with self._rows_lock:
            self._rows_listed += n

    @property
    def _serializable(self) -> bool:
        """With follower replicas, controller reads are bounded-staleness
        (serializable) so they terminate ON the replica — the load the
        read scale-out exists to absorb (docs/replication.md); the fence
        probes keep the linearizable path honest in parallel."""
        return bool(self.spec.replicas)

    def _do_ctrl_start(self, op):
        def fn(client):
            start, end = self._ns_bounds(op.ns)
            st: dict = {}
            try:
                kvs, rev = client.list(start, end, page=self.spec.list_limit,
                                       stats=st,
                                       serializable=self._serializable)
                self._note_rows(len(kvs))
            finally:
                # the server's rpc_server_count includes shed/errored RPCs,
                # so the client must count attempts, not successes
                self._count_rpc("range", st.get("rpcs", 0))
            w = self._watchmux.add(start, end, start_revision=rev + 1,
                                   shard=op.watcher, timeout=60.0)
            return "error" if w.cancelled else None
        return fn

    def _do_ctrl_list(self, op):
        def fn(client):
            start, end = self._ns_bounds(op.ns)
            st: dict = {}
            try:
                kvs, _rev = client.list(start, end, limit=self.spec.list_limit,
                                        page=self.spec.list_limit, stats=st,
                                        serializable=self._serializable)
                self._note_rows(len(kvs))
            finally:
                self._count_rpc("range", st.get("rpcs", 0))
        return fn

    def _do_ctrl_relist(self, op):
        def fn(client):
            start, end = self._ns_bounds(op.ns)
            self._count_rpc("range")
            kvs, _rev = client.list_unpaged(
                start, end, serializable=self._serializable)
            self._note_rows(len(kvs))
        return fn

    def _do_lease_list(self, _op):
        def fn(client):
            st: dict = {}
            try:
                kvs, _rev = client.list(
                    LEASE_PREFIX, coder.prefix_end(LEASE_PREFIX),
                    page=1000, stats=st, serializable=self._serializable)
                self._note_rows(len(kvs))
            finally:
                self._count_rpc("range", st.get("rpcs", 0))
        return fn

    def _do_compact(self, _op):
        def fn(client):
            with self._revs_lock:
                max_rev, last = self._max_rev, self._last_compact
            target = (max_rev + last) // 2
            if target <= last:
                return "skip"  # not enough new history yet
            self._count_rpc("compact")
            client.compact(target)
            with self._revs_lock:
                if target > self._last_compact:
                    self._last_compact = target
        return fn

    def _dispatch_keepalive(self, op: Any) -> None:
        with self._lease_lock:
            lid = self._lease_ids.get(op.node)
        if lid is None:
            # replay is running ahead of the (queued) grant — count it, the
            # reconciliation only tracks keepalives actually sent
            self.stats.record(LEASE_KEEPALIVE, 0.0, "skip")
            return
        def on_ack(dt: float, ttl: int) -> None:
            self.stats.record(LEASE_KEEPALIVE, dt,
                              "ok" if ttl > 0 else "error",
                              err=None if ttl > 0 else "keepalive TTL<=0")
        if not self._leasemux.keepalive_async(lid, shard=op.node, on_ack=on_ack):
            self.stats.record(LEASE_KEEPALIVE, 0.0, "error",
                              err="keepalive stream dead")

    # -------------------------------------------------------------- phases
    @property
    def _follower_targets(self) -> list[str]:
        return self._targets[1:]

    def _spawn_one(self, role_args: list[str], chaos_args: list[str],
                   env: dict[str, str],
                   stderr: Any) -> tuple[subprocess.Popen, str, int]:
        client_port, info_port = free_port(), free_port()
        args = [sys.executable, "-m", "kubebrain_tpu_torch.cli",
                "--storage", self.spec.storage,
                "--device", self.transport.device, "--host", "127.0.0.1",
                "--client-port", str(client_port),
                "--peer-port", str(free_port()),
                "--info-port", str(info_port),
                # the replay owns compaction cadence; the server's own
                # compactor would make the op trace's COMPACT accounting lie
                "--compact-interval", "86400"]
        if self.spec.storage == "cuda":
            args += ["--inner-storage", self.spec.inner_storage]
        args += role_args + chaos_args
        proc = subprocess.Popen(args, cwd=REPO_ROOT, stderr=stderr, env=env)
        return proc, f"127.0.0.1:{client_port}", info_port

    def _spawn_server(self) -> None:
        spec = self.spec
        # fail here, not in a child that exits at boot: ``cuda`` raises
        # without a card
        resolve_device(self.transport.device)
        chaos_args: list[str] = []
        follower_chaos: list[str] = []
        if self.chaos:
            # chaos mode: the armed servers regenerate the SAME
            # deterministic schedule (preset+seed+horizon); the /faults/arm
            # echo is asserted against our local sha below. The `replica`
            # preset arms the FOLLOWERS (its kinds act at the follower's
            # replication/fence boundaries); every other preset arms the
            # leader, exactly as before.
            preset_args = ["--faults", spec.faults,
                           "--fault-seed", str(spec.fault_seed),
                           "--fault-horizon-s", str(self._fault_horizon_s())]
            if spec.faults == "replica":
                follower_chaos = preset_args
            else:
                chaos_args = preset_args
                if spec.storage == "cuda":
                    # a chaos-scale write count must actually cross the
                    # merge threshold, or the merge-fault windows never
                    # meet a merge
                    chaos_args += ["--merge-threshold", "32"]
        env = None
        stderr = subprocess.DEVNULL
        log_fh = None
        if self._server_log:
            stderr = log_fh = open(self._server_log, "ab")  # noqa: SIM115
        try:
            mesh_args = self._mesh_args()
            self._server, self._target, self._info_port = self._spawn_one(
                ["--single-node"] + mesh_args, chaos_args, env, stderr)
            self._targets = [self._target]
            self._info_ports = [self._info_port]
            if spec.replicas:
                self._probe()  # followers bootstrap FROM the leader
                leader_info = f"127.0.0.1:{self._info_port}"
                for _ in range(spec.replicas):
                    role = ["--role", "follower",
                            "--leader-address", self._target,
                            "--leader-info", leader_info,
                            "--max-staleness-ms", str(spec.max_staleness_ms),
                            "--max-staleness-rev", str(spec.max_staleness_rev),
                            ] + mesh_args
                    proc, target, info = self._spawn_one(
                        role, follower_chaos, env, stderr)
                    self._followers.append(proc)
                    self._targets.append(target)
                    self._info_ports.append(info)
        finally:
            # every child holds its own dup of the log fd after spawn; the
            # parent's handle must not outlive this scope — and must close
            # when a spawn fails partway
            if log_fh is not None:
                log_fh.close()

    def _mesh_args(self) -> list[str]:
        # the multi-device flags are refused by spec.validate (ROADMAP
        # item 10); the device matcher reaches leader AND followers, so
        # every replica carries it — the follower offload leg of
        # docs/watch.md (watch clients already pin to followers when
        # replicas > 0)
        return ["--tpu-fanout"] if self.spec.tpu_fanout else []

    def _probe(self, target: str | None = None, proc: Any = None,
               deadline_s: float = 60.0) -> None:
        # fresh channel per attempt: a channel opened before the server
        # binds accrues reconnect backoff (the test_kvrpc boot lesson).
        # Follower probes (count = a linearizable read) only pass once the
        # follower has bootstrapped AND its fence reaches the leader — a
        # passing probe certifies the whole replication pipeline.
        target = target or self._target
        proc = proc if proc is not None else self._server
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            # a boot-time flag rejection (e.g. --mesh-part > visible
            # devices) exits the child immediately: fail fast with the
            # exit status instead of probing a dead port for 60s
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(
                    f"server at {target} exited rc="
                    f"{proc.returncode} before serving (rerun with "
                    f"server_log= to capture its stderr)")
            probe = self.transport.client(target)
            try:
                probe.count(b"/workload-probe", b"/workload-probe0")
                probe.close()
                return
            except self.transport.rpc_errors:
                probe.close()
                time.sleep(0.3)
        raise RuntimeError(f"server at {target} never served")

    def _probe_all(self) -> None:
        self._probe()
        for proc, target in zip(self._followers, self._follower_targets):
            self._probe(target=target, proc=proc)

    def _preload(self, preload_ops: list[Any]) -> float:
        t0 = time.monotonic()
        client = self.transport.client(self._target)
        try:
            items = [(op.key, b"v" * op.size) for op in preload_ops]
            self._count_rpc("txn", len(items))
            results = client.create_bulk(items, window=128)
        finally:
            client.close()
        for op, (ok, rev) in zip(preload_ops, results):
            self._note_rev(op.key, rev, ok)
            if ok:
                self._ledger_ack(op.key, "live", rev)
            # outcome bookkeeping only: pipelined-burst latency is not a
            # per-op sample (it would be a fabricated 0)
            self.stats.record(PRELOAD_CREATE, 0.0, "ok" if ok else "conflict",
                              sample=False)
        return time.monotonic() - t0

    def _route(self, op: Any) -> None:
        kind = op.kind
        if kind == LEASE_KEEPALIVE:
            self._dispatch_keepalive(op)
            return
        if kind in (POD_CREATE, POD_UPDATE, POD_DELETE, LEASE_GRANT):
            shard = self._write_shards[zlib.crc32(op.key) % len(self._write_shards)]
            body = {POD_CREATE: self._do_pod_create,
                    POD_UPDATE: self._do_pod_update,
                    POD_DELETE: self._do_pod_delete,
                    LEASE_GRANT: self._do_lease_grant}[kind](op)
        elif kind in (CTRL_START, CTRL_LIST, CTRL_RELIST, LEASE_LIST):
            shard = self._range_shards[op.watcher % len(self._range_shards)]
            body = {CTRL_START: self._do_ctrl_start,
                    CTRL_LIST: self._do_ctrl_list,
                    CTRL_RELIST: self._do_ctrl_relist,
                    LEASE_LIST: self._do_lease_list}[kind](op)
        elif kind == COMPACT:
            shard = self._admin_shard
            body = self._do_compact(op)
        else:  # pragma: no cover
            raise AssertionError(f"unroutable op kind {kind}")
        is_write = kind in (POD_CREATE, POD_UPDATE, POD_DELETE, LEASE_GRANT)
        wkey = op.key if is_write else None
        shard.submit(lambda client, k=kind, b=body, wk=wkey, w=is_write:
                     self._execute(k, b, client, key=wk, write=w))

    # ----------------------------------------------------- fence probes
    FENCE_PROBE_INTERVAL_S = 0.5

    def _start_fence_probes(self) -> None:
        """A probe thread proving linearizable reads on followers: each
        tick reads the LEADER's committed revision R, then asks every
        follower for its current revision through the fenced path — the
        answer must be >= R (a refusal counts as a refusal, never a
        violation). Probe lag samples (R - follower watermark estimate)
        feed the per-replica lag p99 in the report."""
        leader_cli = self.transport.client(self._target)
        followers = [(t, self.transport.client(t), self._info_ports[1 + i])
                     for i, t in enumerate(self._follower_targets)]
        self._probe_clients = [leader_cli] + [c for _t, c, _p in followers]

        def applied_of(info_port: int) -> int:
            # the UNFENCED watermark view (/status replica block) — the
            # fenced read below always answers >= the fence by
            # construction, so lag must be sampled pre-fence
            try:
                with urllib.request.urlopen(
                        f"http://{self._info_host}:{info_port}/status",
                        timeout=5) as resp:
                    payload = json.loads(resp.read().decode())
                return int(payload.get("replica", {})
                           .get("applied_revision", 0))
            except Exception:
                return -1

        def loop() -> None:
            while not self._fence_probe_stop.wait(
                    self.FENCE_PROBE_INTERVAL_S):
                try:
                    self._count_rpc("range")
                    fence = leader_cli.current_revision()
                except self.transport.rpc_errors:
                    continue  # leader busy/unreachable: nothing to assert
                for target, cli, info_port in followers:
                    applied = applied_of(info_port)
                    if applied >= 0:
                        self._lag_probe_samples.setdefault(
                            target, []).append(max(0, fence - applied))
                    self._fence_probes["count"] += 1
                    try:
                        self._count_rpc("range")
                        got = cli.current_revision()
                    except self.transport.rpc_errors:
                        self._fence_probes["refused"] += 1
                        continue
                    if got >= fence:
                        self._fence_probes["ok"] += 1
                    else:
                        self._fence_probes["violations"] += 1

        t = threading.Thread(target=loop, name="kb-wl-fence-probe",
                             daemon=True)
        t.start()

    def _await_follower_catchup(self, timeout_s: float = 30.0) -> None:
        """Bounded wait until every follower's applied watermark covers
        the highest response revision any client recorded (replication is
        live post-drain, so this converges; on timeout the reconcile just
        reports what it sees)."""
        want = 0
        for c in self._all_clients():
            for rev in getattr(c, "max_header_revision", {}).values():
                want = max(want, rev)
        if not want:
            return
        deadline = time.monotonic() + timeout_s
        for i in range(1, 1 + len(self._followers)):
            while time.monotonic() < deadline:
                try:
                    with urllib.request.urlopen(
                            f"http://{self._info_host}:"
                            f"{self._info_ports[i]}/status",
                            timeout=5) as resp:
                        payload = json.loads(resp.read().decode())
                    if int(payload.get("replica", {})
                           .get("applied_revision", 0)) >= want:
                        break
                except Exception:
                    pass
                time.sleep(0.1)

    # ------------------------------------------------------------ chaos
    @property
    def _armed_indices(self) -> list[int]:
        """Which spawned servers carry the fault plane: the `replica`
        preset's kinds act at the follower boundaries, every other preset
        at the leader's."""
        if self.spec.faults == "replica" and self.spec.replicas:
            return list(range(1, 1 + self.spec.replicas))
        return [0]

    def _faults_http(self, path: str, idx: int = 0) -> dict:
        with urllib.request.urlopen(
            f"http://{self._info_host}:{self._info_ports[idx]}{path}",
            timeout=15,
        ) as resp:
            return json.loads(resp.read().decode())

    def _faults_state_sum(self) -> dict:
        """Aggregate injected counters over every armed server."""
        injected: Counter = Counter()
        for idx in self._armed_indices:
            state = self._faults_http("/faults/state", idx)
            for k, v in state.get("injected", {}).items():
                injected[k] += int(v)
        return dict(injected)

    def _arm_faults(self) -> None:
        """Start every armed server's fault-window clock at replay start
        and assert each side generated the SAME schedule (sha echo)."""
        want = self._fault_sched.sha256()
        for idx in self._armed_indices:
            ack = self._faults_http("/faults/arm", idx)
            if ack.get("sha256") != want:
                raise RuntimeError(
                    f"fault schedule divergence: server {idx} armed "
                    f"{ack.get('sha256')}, runner declared {want}")
        self._fault_armed_at = time.monotonic()

    def _consistency_check(self, drained: bool = True) -> dict:
        """The keystone chaos invariant (docs/faults.md): one final
        authoritative scan, judged against the acknowledged-write ledger —
        every acked write present at its acked revision, every
        definite-error key absent, ambiguous outcomes free to be either
        (the linearizability discipline of tests/test_linearizability.py).

        Only sound against a QUIESCENT server: with the drain timed out,
        in-flight writes acked after the scan would read as phantom
        losses, so the check reports itself unreliable (and fails — the
        drain timeout is already its own SLO violation)."""
        client = self.transport.client(self._target, retries=4)
        try:
            st: dict = {}
            try:
                pod_kvs, _rev = client.list(
                    PODS_PREFIX, coder.prefix_end(PODS_PREFIX),
                    page=1000, stats=st)
                lease_kvs, _ = client.list(
                    LEASE_PREFIX, coder.prefix_end(LEASE_PREFIX),
                    page=1000, stats=st)
            finally:
                # attempts (incl. transparent safe retries) must land in
                # the reconcile counts — the server counted them too
                self._count_rpc("range", st.get("rpcs", 0)
                                + sum(client.retries_sent.values()))
        finally:
            client.close()
        found = {kv.key: kv.mod_revision for kv in pod_kvs}
        with self._ledger_lock:
            ledger = dict(self._ledger)
            lease_issued = set(self._lease_keys_issued)
        losses: list[str] = []
        ghosts: list[str] = []
        rev_mismatches: list[str] = []
        counts = Counter()
        for key, (state, rev) in ledger.items():
            if not key.startswith(PODS_PREFIX):
                continue  # lease keys: reaper-owned, ghost-checked below
            counts[state] += 1
            if state == "live":
                got = found.get(key)
                if got is None:
                    losses.append(key.decode(errors="replace"))
                elif got != rev:
                    rev_mismatches.append(
                        f"{key.decode(errors='replace')}: acked {rev}, "
                        f"found {got}")
            elif state == "deleted":
                if key in found:
                    losses.append(
                        f"{key.decode(errors='replace')} (acked delete, "
                        "still present)")
            elif state == "failed":
                if key in found:
                    ghosts.append(key.decode(errors="replace"))
            # "ambiguous": present or absent, both legal
        issued = set(ledger) | lease_issued
        for key in found:
            if key not in issued:
                ghosts.append(key.decode(errors="replace") + " (never issued)")
        for kv in lease_kvs:
            if kv.key not in issued:
                ghosts.append(kv.key.decode(errors="replace")
                              + " (never issued)")
        ok = drained and not losses and not ghosts and not rev_mismatches
        return {
            "ok": ok,
            "reliable": drained,
            "checked_keys": sum(counts.values()),
            "acked_live": counts["live"],
            "acked_deleted": counts["deleted"],
            "ambiguous": counts["ambiguous"],
            "definite_failures": counts["failed"],
            "scanned": len(found) + len(lease_kvs),
            "losses": losses[:20],
            "ghosts": ghosts[:20],
            "rev_mismatches": rev_mismatches[:20],
        }

    def _build_faults_section(self, baseline: Any, final: Any) -> dict:
        """The report's ``faults`` section: schedule identity, per-kind
        injected counts (server /metrics + /faults/state), the per-kind
        injected-vs-scheduled reconcile, degraded-window latency stats,
        and the keystone consistency check."""
        if not self.chaos:
            return {"armed": False}
        injected = self._faults_state_sum()
        metrics_injected = {}
        for labels, value in final.get("kb_faults_injected_total", ()):
            metrics_injected[labels.get("kind", "?")] = int(value)
        # reconcile per scheduled kind: a kind with windows AND eligible
        # traffic must have observably injected. Engine kinds only exist
        # on the tpu engine; conn_drop/watch_reset need the endpoint.
        engine_kinds = {fault_schedule.MERGE_FAIL,
                        fault_schedule.MERGE_SUPPRESS,
                        fault_schedule.ENCODE_OVERFLOW,
                        fault_schedule.COMPACT_FAIL}
        # compact_fail fires only when a CLIENT-cadenced compaction lands
        # inside its window (the replay owns the compact cadence) — unlike
        # the write-kicked merge kinds there is no server-side activity to
        # guarantee a hit, so its reconcile asserts the two counter views
        # agree without requiring an injection
        client_driven = {fault_schedule.COMPACT_FAIL}
        replica_kinds = set(fault_schedule.REPLICA_KINDS)
        reconcile: dict[str, dict] = {}
        for kind in self._fault_sched.kinds():
            if kind in engine_kinds:
                eligible = self.spec.storage == "cuda"
            elif kind in replica_kinds:
                # follower-boundary kinds need followers to act on
                eligible = self.spec.replicas > 0
            else:
                eligible = True
            n = injected.get(kind, 0)
            reconcile[kind] = {
                "scheduled": True,
                "eligible": eligible,
                "injected": n,
                "metrics": metrics_injected.get(kind, 0),
                # the /faults/state counter and the /metrics counter are
                # two views of one increment; both must agree, and an
                # eligible kind must have fired at least once
                "ok": (n == metrics_injected.get(kind, 0)
                       and (n > 0 or not eligible
                            or kind in client_driven)),
            }
        with self._ledger_lock:
            deg = {lane: list(s) for lane, s in self._degraded_samples.items()}
        all_deg = [dt for s in deg.values() for dt in s]
        degraded = {
            "in_window_ops": len(all_deg),
            "p50_ms": round(slo.percentile(all_deg, 0.5) * 1e3, 3),
            "p99_ms": round(slo.percentile(all_deg, 0.99) * 1e3, 3)
                      if all_deg else None,
            "per_lane_p99_ms": {
                lane: round(slo.percentile(s, 0.99) * 1e3, 3)
                for lane, s in deg.items()},
            "degraded_seconds": slo.series_sum(
                final, "kb_degraded_seconds"),
            "mirror_state": {
                labels.get("state", "?"): value
                for labels, value in final.get("kb_mirror_state", ())},
        }
        # schedule determinism self-check: regeneration must reproduce the
        # declared sha (the fault-trace replay identity)
        sha = self._fault_sched.sha256()
        sha2 = fault_schedule.generate(
            self.spec.faults, self.spec.fault_seed,
            self._fault_horizon_s()).sha256()
        if sha != sha2:
            raise RuntimeError(
                f"non-deterministic fault schedule: {sha} != {sha2}")
        return {
            "armed": True,
            "schedule": self._fault_sched.to_dict(),
            "determinism_checked": True,
            "injected": injected,
            "reconcile": reconcile,
            "consistency": self._consistency,
            "degraded": degraded,
            "repairs": {
                "rewritten": int(slo.delta(
                    final, baseline, "kb_uncertain_repairs_total",
                    outcome="rewritten")),
                "dropped": int(slo.delta(
                    final, baseline, "kb_uncertain_repairs_total",
                    outcome="dropped")),
                "gave_up": int(slo.delta(
                    final, baseline, "kb_uncertain_repairs_total",
                    outcome="gave_up")),
            },
            "merge": {
                "errors": int(slo.delta(
                    final, baseline, "kb_mirror_merge_errors_total")),
                "retries": int(slo.delta(
                    final, baseline, "kb_mirror_merge_retries_total")),
                "escalations": int(slo.delta(
                    final, baseline, "kb_mirror_merge_escalations_total")),
            },
        }

    def _drain(self, timeout_s: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout_s
        shards = [*self._write_shards, *self._range_shards, self._admin_shard]
        while time.monotonic() < deadline:
            if all(s.q.unfinished_tasks == 0 for s in shards):
                break
            time.sleep(0.05)
        else:
            return False
        return self._leasemux.flush(max(1.0, deadline - time.monotonic()))

    # ----------------------------------------------------------------- run
    def run(self) -> dict:
        spec = self.spec
        spec.validate()
        schedule = generator.generate(spec)
        sha = schedule.sha256()
        # determinism self-check: the SAME spec must regenerate the SAME
        # byte trace (the replay's identity; acceptance gate)
        sha2 = generator.generate(spec).sha256()
        if sha != sha2:
            raise RuntimeError(f"non-deterministic schedule: {sha} != {sha2}")

        owns_server = self._target is None
        if owns_server:
            self._spawn_server()
        self._write_shards: list[_Shard] = []
        self._range_shards: list[_Shard] = []
        try:
            self._probe_all()
            baseline = self._scrape_all()
            preload_wall = self._preload(schedule.preload)

            followers = self._follower_targets
            def rotated(eps: list[str], i: int) -> list[str]:
                k = i % len(eps)
                return eps[k:] + eps[:k]
            if followers:
                # the load-balanced apiserver topology (docs/replication.md):
                # writes + admin round-robin over EVERY endpoint (follower-
                # landed writes forward to the leader), while the list+watch
                # load pins to the followers — the read traffic they exist
                # to absorb
                write_target = lambda i: rotated(self._targets, i)  # noqa: E731
                read_target = lambda i: rotated(followers, i)  # noqa: E731
                admin_target: object = list(self._targets)
                watch_target: object = followers
            else:
                write_target = lambda i: self._target  # noqa: E731
                read_target = lambda i: self._target  # noqa: E731
                admin_target = self._target
                watch_target = self._target
            transport = self.transport
            self._write_shards = [
                _Shard(f"kb-wl-write-{i}", write_target(i), spec.shard_queue,
                       self.stats, transport)
                for i in range(spec.write_shards)]
            self._range_shards = [
                _Shard(f"kb-wl-range-{i}", read_target(i), spec.shard_queue,
                       self.stats, transport)
                for i in range(spec.range_shards)]
            self._admin_shard = _Shard(
                "kb-wl-admin", admin_target, spec.shard_queue, self.stats,
                transport)
            self._watch_client = transport.client(watch_target)
            # chaos: watches must survive injected server-side stream
            # resets — resume from last-delivered revision + 1
            self._watchmux = transport.watch_mux(
                self._watch_client, spec.watch_streams,
                self.chaos or bool(followers))
            self._lease_client = transport.client(watch_target)
            self._leasemux = transport.lease_mux(self._lease_client,
                                                 spec.lease_streams)

            if self.chaos:
                # arm AFTER preload so the fault windows align with replay
                self._arm_faults()
            if followers:
                self._start_fence_probes()
            replay_ops = schedule.replay
            pacer = ReplayPacer(spec.time_scale)
            for op in replay_ops:
                pacer.wait_until(op.t_ms)
                self._route(op)
            self._fence_probe_stop.set()
            # chaos runs get a larger drain budget: the consistency scan
            # is only sound against a quiescent server (an in-flight write
            # acked after the scan would read as a phantom loss)
            drained = self._drain(timeout_s=180.0 if self.chaos else 60.0)
            replay_wall = pacer.elapsed_s()
            time.sleep(0.3)  # let the last watch batches reach the wire
            # the keystone chaos check runs BEFORE the final scrape so its
            # Range RPCs land inside the reconcile window
            self._consistency = (self._consistency_check(drained)
                                 if self.chaos else None)
            if followers:
                # the revision-bound reconcile compares each follower's
                # FINAL applied watermark against the max response
                # revision any client saw — a forwarded write near the
                # end of replay returns the LEADER's revision, which the
                # follower may legitimately not have applied yet. Wait
                # out the replication tail before scraping.
                self._await_follower_catchup()
            final = self._scrape_all()
            report = self._build_report(
                schedule, sha, baseline, final, preload_wall, replay_wall,
                pacer, drained)
        finally:
            self._fence_probe_stop.set()
            for s in [*self._write_shards, *self._range_shards,
                      *([self._admin_shard] if hasattr(self, "_admin_shard") else [])]:
                s.close()
            if hasattr(self, "_watchmux"):
                self._watchmux.close()
                self._watch_client.close()
            if hasattr(self, "_leasemux"):
                self._leasemux.close()
                self._lease_client.close()
            for c in self._probe_clients:
                c.close()
            # followers first: a follower outliving its leader would just
            # spin its reconnect loop through the teardown
            for proc in self._followers:
                proc.terminate()
            if owns_server and self._server is not None:
                self._server.terminate()
            for proc in [*self._followers,
                         *([self._server] if owns_server and self._server
                           else [])]:
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()

        passed, violations = slo.evaluate(report, spec.bounds)
        report["slo"]["pass"] = passed
        report["slo"]["violations"] = violations
        if self._write:
            os.makedirs(REPORT_DIR, exist_ok=True)
            path = self._out_path or slo.next_report_path(
                REPORT_DIR, chaos=self.chaos,
                replica=self.spec.replicas > 0)
            slo.write_report(report, path)
            print(f"[workload] SLO report: {path} "
                  f"({'PASS' if passed else 'FAIL'})", file=sys.stderr)
        else:
            slo.validate_report(report)
        return report

    # --------------------------------------------------------------- report
    def _build_report(self, schedule: Any, sha: str, baseline: Any,
                      final: Any, preload_wall: float, replay_wall: float,
                      pacer: Any, drained: bool) -> dict:
        spec = self.spec
        stats = self.stats
        # baseline/final arrive as per-server snapshot lists (leader
        # first); counters and histograms reconcile against the SUM, the
        # per-replica fields read the individual follower snapshots
        base_snaps, final_snaps = baseline, final
        baseline = slo.merge_snapshots(base_snaps)
        final = slo.merge_snapshots(final_snaps)

        op_kinds: dict[str, dict] = {}
        for kind in generator.ALL_KINDS:
            with stats._lock:
                samples = list(stats.samples.get(kind, ()))
                outs = {o: n for (k, o), n in stats.outcomes.items() if k == kind}
            if not outs and not samples:
                continue
            op_kinds[kind] = {
                "count": sum(outs.values()),
                "ok": outs.get("ok", 0),
                "shed": outs.get("shed", 0),
                "errors": outs.get("error", 0),
                "conflicts": outs.get("conflict", 0),
                "skipped": outs.get("skip", 0),
                "p50_ms": round(slo.percentile(samples, 0.5) * 1e3, 3),
                "p99_ms": round(slo.percentile(samples, 0.99) * 1e3, 3),
            }

        lanes: dict[str, dict] = {}
        for lane in ("system", "normal", "background", "write"):
            kinds = [k for k, l in LANE_OF.items() if l == lane]
            samples = []
            with stats._lock:
                for k in kinds:
                    samples.extend(stats.samples.get(k, ()))
            lanes[lane] = {
                "count": sum(op_kinds.get(k, {}).get("count", 0) for k in kinds),
                "ok": sum(op_kinds.get(k, {}).get("ok", 0) for k in kinds),
                "shed": sum(op_kinds.get(k, {}).get("shed", 0) for k in kinds),
                "errors": sum(op_kinds.get(k, {}).get("errors", 0) for k in kinds),
                "p50_ms": round(slo.percentile(samples, 0.5) * 1e3, 3),
                "p99_ms": round(slo.percentile(samples, 0.99) * 1e3, 3),
            }

        watchers = self._watchmux.watchers()
        live_watchers = sum(1 for w in watchers if not w.cancelled)
        watch = {
            "watchers": live_watchers,
            "events": self._watchmux.total_events(),
            "cancelled": self._watchmux.cancelled_count(),
            # chaos: server-side stream resets this run's watches survived
            # (resume-from-revision+1; docs/faults.md)
            "resumed": self._watchmux.resumed_total(),
            "dropped_server_total": int(slo.delta(
                final, baseline, "kb_watch_dropped_total")),
            "lag_wire_p99_s": slo.hist_quantile(
                final, "kb_watch_lag_seconds", 0.99, point="wire"),
            "lag_queue_p99_s": slo.hist_quantile(
                final, "kb_watch_lag_seconds", 0.99, point="queue"),
        }

        mux = self._leasemux
        leases = {
            "granted": stats.count(LEASE_GRANT, "ok"),
            "keepalives_sent": mux.sent,
            "keepalives_acked": mux.acked,
            "expired_acks": mux.expired_acks,
            "keepalives_skipped": stats.count(LEASE_KEEPALIVE, "skip"),
            "metrics": {
                "granted_delta": int(slo.delta(
                    final, baseline, "kb_lease_granted_total")),
                "keepalive_delta": int(slo.delta(
                    final, baseline, "kb_lease_keepalive_total")),
                "expired_delta": int(slo.delta(
                    final, baseline, "kb_lease_expired_total")),
                "active": slo.series_sum(final, "kb_lease_active"),
            },
        }

        b_count, b_sum = slo.hist_count_sum(baseline, "kb_sched_batch_size")
        f_count, f_sum = slo.hist_count_sum(final, "kb_sched_batch_size")
        wb_count, wb_sum = slo.hist_count_sum(
            baseline, "kb_sched_write_batch_size")
        wf_count, wf_sum = slo.hist_count_sum(
            final, "kb_sched_write_batch_size")
        sched = {
            "batched_launches": int(f_count - b_count),
            "batched_requests": int(f_sum - b_sum),
            # write groups (docs/writes.md): histogram samples only on
            # REAL formation (>= 2 ops riding one commit group)
            "write_batched_groups": int(wf_count - wb_count),
            "write_batched_ops": int(wf_sum - wb_sum),
            "shed_total": int(slo.delta(final, baseline, "kb_sched_shed_total")),
            "coalesced_total": int(slo.delta(
                final, baseline, "kb_sched_coalesced_total")),
        }

        # device-side compaction (docs/compaction.md): client-cadence
        # accounting + the scanner's phase/victim scrape-deltas. All-zero
        # metric deltas on non-tpu storage — only the TPU scanner emits
        # kb_compact_*; the COMPACT op counts come from the client side
        # either way.
        compact_phases = {}
        for ph in ("mark", "gc", "merge", "publish"):
            c0, s0 = slo.hist_count_sum(baseline, "kb_compact_seconds",
                                        phase=ph)
            c1, s1 = slo.hist_count_sum(final, "kb_compact_seconds", phase=ph)
            compact_phases[ph] = {"count": int(c1 - c0),
                                  "seconds": round(s1 - s0, 4)}
        compact = {
            "completed": stats.count(COMPACT, "ok"),
            "skipped": stats.count(COMPACT, "skip"),
            "phases": compact_phases,
            "victims": {k: int(slo.delta(
                final, baseline, "kb_compact_victims_total", kind=k))
                for k in ("superseded", "tombstone", "ttl_expired",
                          "rev_record")},
            "errors": int(slo.delta(
                final, baseline, "kb_compact_errors_total")),
            "retries": int(slo.delta(
                final, baseline, "kb_compact_retries_total")),
            "escalations": int(slo.delta(
                final, baseline, "kb_compact_escalations_total")),
            # the steady-state invariant: compactions must not drive the
            # full-rebuild series (docs/compaction.md fallback ladder)
            "full_rebuilds": int(slo.delta(
                final, baseline, "kb_mirror_merge_seconds_count",
                kind="full_rebuild")),
        }

        replica = self._build_replica_section(base_snaps, final_snaps,
                                              replay_wall)

        with self._rpc_lock:
            rpc = dict(self._rpc)
        checks: dict[str, dict] = {}

        def chk(name: str, client_v: int, server_v: int) -> None:
            checks[name] = {"client": int(client_v), "server": int(server_v),
                            "ok": int(client_v) == int(server_v)}

        # multi-endpoint accounting (docs/replication.md): a safe-only
        # endpoint failover is one extra server-side RPC the client's op
        # counter never saw — add them per method. A write landing on a
        # follower is counted TWICE server-side (once by the follower,
        # once by the leader it forwards to) — subtract the followers'
        # forwarded counters so the reconcile stays exact. Reads never
        # forward.
        fo = Counter()
        for c in self._all_clients():
            fo.update(getattr(c, "failovers_by_method", ()))
        fwd: Counter = Counter()
        for i in range(1, len(final_snaps)):
            for rpc_label in ("txn", "compact", "lease_grant"):
                fwd[rpc_label] += int(slo.delta(
                    final_snaps[i], base_snaps[i],
                    "kb_replica_forwarded_total", rpc=rpc_label))
        #: the RPC-count checks, which need a front that counts RPCs
        rpc_checks = ("txn_rpcs", "range_rpcs", "compact_rpcs",
                      "lease_grant_rpcs")
        if not self.transport.in_process:
            chk("txn_rpcs", rpc.get("txn", 0) + fo.get(_TXN, 0),
                slo.delta(final, baseline, "rpc_server_count", method=_TXN)
                - fwd["txn"])
            chk("range_rpcs", rpc.get("range", 0) + fo.get(_RANGE, 0),
                slo.delta(final, baseline, "rpc_server_count",
                          method=_RANGE))
            chk("compact_rpcs", rpc.get("compact", 0) + fo.get(_COMPACT, 0),
                slo.delta(final, baseline, "rpc_server_count",
                          method=_COMPACT) - fwd["compact"])
            chk("lease_grant_rpcs",
                rpc.get("lease_grant", 0) + fo.get(_LEASE_GRANT_RPC, 0),
                slo.delta(final, baseline, "rpc_server_count",
                          method=_LEASE_GRANT_RPC) - fwd["lease_grant"])
        chk("lease_keepalives", mux.acked - mux.expired_acks,
            slo.delta(final, baseline, "kb_lease_keepalive_total"))
        # each follower's replication stream IS one whole-keyspace watcher
        # on the leader (docs/replication.md) — expected alongside the
        # client's own watches
        chk("watchers", live_watchers + spec.replicas,
            sum(slo.series_count(s, "kb_watch_backlog")
                for s in final_snaps))
        if spec.bounds.min_write_batched_ops > 0:
            # scenario declares write-group formation mandatory: the
            # kb_sched_write_batch_size histogram COUNT must have moved
            # (samples land only on real >= 2-op groups)
            checks["write_groups_formed"] = {
                "client": int(spec.bounds.min_write_batched_ops),
                "server": sched["write_batched_ops"],
                "ok": sched["write_batched_groups"] > 0
                and sched["write_batched_ops"]
                >= spec.bounds.min_write_batched_ops,
            }
        reconcile_ok = all(c["ok"] for c in checks.values())
        # an in-process transport has no front that counts RPCs: those
        # checks are named as not applicable, and never counted as passed
        not_applicable = ({
            name: "no rpc_server_count: the in-process transport has no "
                  "gRPC front"
            for name in rpc_checks} if self.transport.in_process else {})

        replay_ops = len(schedule.replay)
        front = "in-process" if self.transport.in_process else "sync-grpc"
        report = {
            "schema": slo.SCHEMA_ID,
            "spec": spec.to_dict(),
            "platform": {
                "platform": self.transport.device,
                "device": f"kubebrain-torch-cli(storage={spec.storage}, "
                          f"front={front})",
            },
            "trace": {
                "sha256": sha,
                "ops": len(schedule.ops),
                "preload_ops": len(schedule.preload),
                "replay_ops": replay_ops,
                "determinism_checked": True,
            },
            "replay": {
                "wall_s": round(replay_wall, 3),
                "preload_wall_s": round(preload_wall, 3),
                "ops_per_sec": round(replay_ops / replay_wall, 1)
                               if replay_wall > 0 else 0.0,
                # rows actually LISTED per second across the whole
                # topology — the read-throughput number the replica
                # scale-out is judged by (docs/replication.md)
                "rows_listed": self._rows_listed,
                "rows_per_sec": round(self._rows_listed / replay_wall, 1)
                                if replay_wall > 0 else 0.0,
                "max_dispatch_lag_s": round(pacer.max_lag_s, 3),
                "drained": drained,
            },
            "lanes": lanes,
            "op_kinds": op_kinds,
            "watch": watch,
            "leases": leases,
            "sched": sched,
            "compact": compact,
            "reconcile": {"ok": reconcile_ok, "checks": checks,
                          "not_applicable": not_applicable,
                          # client-side safe-only endpoint failovers
                          # (kb_client_endpoint_failovers): informational
                          # next to the hard checks — there is no server
                          # counter to reconcile them against (a failed-
                          # over attempt never completed anywhere)
                          "endpoint_failovers": self._endpoint_failovers()},
            "replica": replica,
            "slo": {"pass": False, "violations": [],
                    "bounds": asdict(spec.bounds)},
            "errors": list(stats.error_samples),
            "faults": self._build_faults_section(baseline, final),
        }
        return report

    def _all_clients(self) -> list[Any]:
        out = [s.client for s in [*self._write_shards, *self._range_shards]]
        if hasattr(self, "_admin_shard"):
            out.append(self._admin_shard.client)
        if hasattr(self, "_watch_client"):
            out.append(self._watch_client)
        if hasattr(self, "_lease_client"):
            out.append(self._lease_client)
        out.extend(self._probe_clients)
        return out

    def _endpoint_failovers(self) -> int:
        return sum(getattr(c, "endpoint_failovers", 0)
                   for c in self._all_clients())

    def _build_replica_section(self, base_snaps: Any, final_snaps: Any,
                               replay_wall: float) -> dict:
        """The report's ``replica`` section (docs/replication.md):
        per-replica served/forwarded/refused counts and lag, the fence
        probes, and the revision-consistency reconcile — no response
        revision above the serving replica's applied watermark (the
        watermark is monotone and the final scrape runs after the drain,
        so client-max <= final-watermark is exact)."""
        spec = self.spec
        if not spec.replicas:
            return {"replicas": 0}
        # client-side per-endpoint max response revision, across all
        # multi-endpoint clients
        max_rev: dict[str, int] = {}
        for c in self._all_clients():
            for target, rev in getattr(c, "max_header_revision", {}).items():
                if rev > max_rev.get(target, 0):
                    max_rev[target] = rev

        def counter_by_label(snap: Any, name: str, label: str) -> dict:
            return {labels.get(label, "?"): int(v)
                    for labels, v in snap.get(name, ())}

        per_replica = []
        checks: dict[str, dict] = {}
        for i, target in enumerate(self._follower_targets):
            snap = final_snaps[1 + i]
            applied = int(slo.series_sum(snap, "kb_replica_applied_revision"))
            client_max = max_rev.get(target, 0)
            ok = client_max <= applied
            lag_samples = self._lag_probe_samples.get(target, [])
            per_replica.append({
                "target": target,
                "applied_revision": applied,
                "lag_revisions": int(slo.series_sum(
                    snap, "kb_replica_lag_revisions")),
                "lag_probe_p99_revisions": int(slo.percentile(
                    [float(s) for s in lag_samples], 0.99)),
                "served": counter_by_label(
                    snap, "kb_replica_served_total", "rpc"),
                "forwarded": counter_by_label(
                    snap, "kb_replica_forwarded_total", "rpc"),
                "refused": counter_by_label(
                    snap, "kb_replica_refused_total", "reason"),
                "fence_wait_p99_s": slo.hist_quantile(
                    snap, "kb_fence_wait_seconds", 0.99),
                "max_client_revision": client_max,
                "revision_bound_ok": ok,
            })
            checks[f"revision_bound[{target}]"] = {
                "client_max": client_max, "applied": applied, "ok": ok}
        fence = dict(self._fence_probes)
        rows_per_sec = (round(self._rows_listed / replay_wall, 1)
                        if replay_wall > 0 else 0.0)
        # acceptance comparison: KB_REPLICA_BASELINE_ROWS carries the
        # rows_per_sec of an equal-spec single-server run (REPLICAS=0) so
        # the report can state the scale-out claim machine-readably. On a
        # box without a core per process the topology cannot express its
        # parallelism (leader + followers + clients time-share the same
        # cores, so the extra processes are pure overhead): the bar is
        # stamped pending_multicore there, the same machine-visible
        # discipline as the pending_tpu hardware bars (docs/multichip.md)
        base_rows = float(
            os.environ.get("KB_REPLICA_BASELINE_ROWS", 0) or 0)
        cores = os.cpu_count() or 1
        enough_cores = cores >= spec.replicas + 2
        if not base_rows:
            status = "no_baseline"
        elif not enough_cores:
            status = "pending_multicore"
        elif rows_per_sec > base_rows:
            status = "pass"
        else:
            status = "fail"
        return {
            "replicas": spec.replicas,
            "endpoints": list(self._targets),
            "per_replica": per_replica,
            "fence_probes": fence,
            "endpoint_failovers": self._endpoint_failovers(),
            "rows_per_sec": rows_per_sec,
            "acceptance": {
                "single_server_rows_per_sec": base_rows or None,
                "aggregate_rows_per_sec": rows_per_sec,
                "cores": cores,
                "exceeds_single_server": (rows_per_sec > base_rows)
                                         if base_rows and enough_cores
                                         else None,
                "status": status,
            },
            "reconcile": {
                "ok": all(c["ok"] for c in checks.values()),
                "checks": checks,
            },
        }


def run_workload(spec: WorkloadSpec, target: str | None = None,
                 info_port: int = 0, out_path: str | None = None,
                 write_report: bool = True,
                 server_log: str | None = None,
                 device: str | None = None,
                 transport: Any = None) -> dict:
    """Replay ``spec``. ``device`` is what the spawned servers serve on
    (None: ``cuda``, which raises without a card); ``transport`` replaces
    the spawned gRPC servers (:class:`GrpcTransport`)."""
    if transport is None:
        transport = GrpcTransport(device)
    return WorkloadRunner(spec, target=target, info_port=info_port,
                          out_path=out_path, write_report=write_report,
                          server_log=server_log, transport=transport).run()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="kubebrain-workload",
        description="deterministic kube-apiserver workload replay "
                    "(docs/workloads.md)")
    ap.add_argument("--nodes", "-n", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--duration", type=float, default=30.0,
                    help="simulated seconds")
    ap.add_argument("--scale", type=float, default=5.0,
                    help="simulated seconds per real second")
    ap.add_argument("--storage", default="memkv",
                    choices=["memkv", "native", "cuda"])
    ap.add_argument("--inner-storage", default="memkv",
                    choices=["memkv", "native"],
                    help="the host engine under --storage cuda")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="what the spawned servers serve on (--device of "
                         "the port's CLI); cuda raises without a card")
    ap.add_argument("--mesh-part", type=int, default=0,
                    help="refused above 0 until multi-GPU support "
                         "(ROADMAP item 10)")
    ap.add_argument("--scan-partitions", type=int, default=0,
                    help="refused above 0 until multi-GPU support "
                         "(ROADMAP item 10)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="read scale-out (docs/replication.md): spawn this "
                         "many follower replicas next to the leader; "
                         "controller list+watch traffic routes to them "
                         "(bounded-staleness local serving) and the report "
                         "gains a schema'd `replica` section "
                         "(REPLICA_rNN.json)")
    ap.add_argument("--max-staleness-ms", type=float, default=15000.0,
                    help="follower bounded-staleness bound forwarded to "
                         "the spawned followers")
    ap.add_argument("--max-staleness-rev", type=int, default=0,
                    help="follower bounded-staleness bound in revisions "
                         "(0 = unbounded), forwarded to the spawned "
                         "followers")
    ap.add_argument("--target", default="",
                    help="host:port of a running server (default: spawn one)")
    ap.add_argument("--target-info-port", type=int, default=0,
                    help="info/metrics HTTP port of the --target server "
                         "(required with --target)")
    ap.add_argument("--out", default="",
                    help="report path (default: WORKLOAD_rNN.json in the "
                         "checkout's build/workload/)")
    ap.add_argument("--smoke", action="store_true",
                    help="small-N CI smoke shape (short, every traffic kind)")
    ap.add_argument("--scenario", default="cluster",
                    choices=["cluster", "smoke", "churn-heavy",
                             "watch-heavy"],
                    help="traffic preset: cluster (default), smoke, "
                         "churn-heavy (pod-churn + keepalive-storm write "
                         "skew exercising group commit; docs/writes.md), or "
                         "watch-heavy (multi-controller fan-in over thin "
                         "writes exercising block-batched watch fan-out; "
                         "docs/watch.md)")
    ap.add_argument("--tpu-fanout", action="store_true",
                    help="spawn servers with the device fan-out matcher "
                         "(implied by --scenario watch-heavy)")
    ap.add_argument("--mesh-wat", type=int, default=0,
                    help="refused above 0 until multi-GPU support "
                         "(ROADMAP item 10)")
    ap.add_argument("--faults", default="none",
                    help="chaos mode (docs/faults.md): arm this fault "
                         "preset on the spawned server (none, smoke, "
                         "storage, watch, merge, full) and judge the run "
                         "by the acknowledged-write consistency check; "
                         "the report lands in CHAOS_rNN.json")
    ap.add_argument("--fault-seed", type=int, default=0)
    args = ap.parse_args(argv)

    mesh_kw = {"inner_storage": args.inner_storage,
               "mesh_part": args.mesh_part,
               "scan_partitions": args.scan_partitions,
               "replicas": args.replicas,
               "max_staleness_ms": args.max_staleness_ms,
               "max_staleness_rev": args.max_staleness_rev}
    if args.tpu_fanout or args.mesh_wat:
        mesh_kw["tpu_fanout"] = True
        mesh_kw["mesh_wat"] = args.mesh_wat
    chaos = args.faults and args.faults != "none"
    scenario = "smoke" if args.smoke else args.scenario
    if chaos:
        spec = WorkloadSpec.for_chaos(
            args.nodes, preset=args.faults, fault_seed=args.fault_seed,
            seed=args.seed, duration_s=args.duration,
            time_scale=args.scale, storage=args.storage, **mesh_kw)
    elif scenario == "smoke":
        spec = WorkloadSpec.for_smoke(args.nodes, seed=args.seed,
                                      storage=args.storage, **mesh_kw)
    elif scenario == "churn-heavy":
        spec = WorkloadSpec.for_churn_heavy(
            args.nodes, seed=args.seed, duration_s=args.duration,
            time_scale=args.scale, storage=args.storage, **mesh_kw)
    elif scenario == "watch-heavy":
        spec = WorkloadSpec.for_watch_heavy(
            args.nodes, seed=args.seed, duration_s=args.duration,
            time_scale=args.scale, storage=args.storage, **mesh_kw)
    else:
        spec = WorkloadSpec.for_cluster(
            args.nodes, seed=args.seed, duration_s=args.duration,
            time_scale=args.scale, storage=args.storage, **mesh_kw)
    report = run_workload(spec, target=args.target or None,
                          info_port=args.target_info_port,
                          out_path=args.out or None, device=args.device)
    line = {
        "metric": "cluster-replay ops/sec",
        "value": report["replay"]["ops_per_sec"],
        "slo_pass": report["slo"]["pass"],
        "violations": report["slo"]["violations"],
        "trace_sha256": report["trace"]["sha256"],
    }
    if report["faults"]["armed"]:
        line["fault_sha256"] = report["faults"]["schedule"]["sha256"]
        line["consistency_ok"] = report["faults"]["consistency"]["ok"]
        line["injected"] = report["faults"]["injected"]
    print(json.dumps(line))
    return 0 if report["slo"]["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
