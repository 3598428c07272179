"""Server composition: gRPC services + info HTTP handlers.

Reference: pkg/server/server.go:70-180 — composes the etcd RPC server, the
brain RPC server, and the HTTP handlers ``/health``, ``/status`` (the
follower→leader revision-sync endpoint, :151-165) and ``/election``.

The gRPC services (``.brain``, ``.etcd``) are imported when a ``Server`` is
built, not with this package: the wiring below the front
(``cli.build_backend``) builds its peers from ``.service`` and must load
where ``grpc`` and ``protobuf`` are not installed.
"""

from __future__ import annotations

import json
import sys
import threading
import traceback

from .. import __version__
from ..backend import Backend
from ..metrics import Metrics, NoopMetrics
from .service import PeerService, SingleNodePeerService


class Server:
    def __init__(
        self,
        backend: Backend,
        peers: PeerService | SingleNodePeerService,
        metrics: Metrics | None = None,
        identity: str = "kubebrain-tpu",
        client_urls: list[str] | None = None,
        compact_interval: float = 60.0,
        replica=None,
    ):
        from .brain import BrainServer, make_brain_handlers
        from .etcd import make_etcd_handlers

        self.backend = backend
        self.peers = peers
        self.metrics = metrics or NoopMetrics()
        self.identity = identity
        #: follower role (``replica.FollowerRole``, which the CLI builds for
        #: ``--role follower``; None on a leader)
        self.replica = replica
        self.brain = BrainServer(backend, peers, compact_interval=compact_interval)
        self.grpc_handlers = (
            make_etcd_handlers(backend, peers, identity, client_urls or [],
                               replica=replica)
            + make_brain_handlers(self.brain)
            + [self._health_handler()]
        )

    def _health_handler(self):
        """grpc.health.v1 terminal; the "leader" service reflects leadership
        (reference wires election callbacks into grpc-health, server.go:72-78)."""
        import grpc

        from ..proto import health_pb2

        def check(request, context):
            if request.service in ("", "etcd", "brain"):
                status = health_pb2.HealthCheckResponse.SERVING
            elif request.service == "leader":
                status = (
                    health_pb2.HealthCheckResponse.SERVING
                    if self.peers.is_leader()
                    else health_pb2.HealthCheckResponse.NOT_SERVING
                )
            else:
                context.abort(grpc.StatusCode.NOT_FOUND, "unknown service")
            return health_pb2.HealthCheckResponse(status=status)

        def watch(request, context):
            """Long-lived status stream (grpc.health.v1 contract): emit the
            current status, then only on change, until the client departs."""
            import time as _time

            last = check(request, context)
            yield last
            while context.is_active():
                _time.sleep(0.5)
                cur = check(request, context)
                if cur.status != last.status:
                    last = cur
                    yield cur

        return grpc.method_handlers_generic_handler("grpc.health.v1.Health", {
            "Check": grpc.unary_unary_rpc_method_handler(
                check,
                request_deserializer=health_pb2.HealthCheckRequest.FromString,
                response_serializer=health_pb2.HealthCheckResponse.SerializeToString,
            ),
            "Watch": grpc.unary_stream_rpc_method_handler(
                watch,
                request_deserializer=health_pb2.HealthCheckRequest.FromString,
                response_serializer=health_pb2.HealthCheckResponse.SerializeToString,
            ),
        })

    def start_background(self) -> None:
        self.brain.start_background()

    # ------------------------------------------------------------------ HTTP
    def http_handlers(self) -> dict:
        """path -> fn() -> (content_type, body). The /status payload is the
        revision-sync contract consumed by HttpRevisionSyncer."""
        return {
            "/health": self._health,
            "/status": self._status,
            "/election": self._election,
            "/debug/threads": self._threads,
            "/debug/traces": self._traces,
            "/debug/profile": self._profile,
            "/debug/jax-profile": self._jax_profile,  # legacy fixed-2s alias
            "/tier/failover": self._tier_failover,
        }

    def _traces(self):
        """Recent request span trees + slow-request log + stage EWMAs from
        the process tracer (kubebrain_tpu_torch.trace)."""
        from ..trace import TRACER

        return "application/json", json.dumps(TRACER.snapshot()).encode()

    def _health(self):
        return "application/json", json.dumps({"health": "true"}).encode()

    def _status(self):
        payload = {
            "revision": self.backend.current_revision(),
            "compact_revision": self.backend.compact_revision(),
            "is_leader": self.peers.is_leader(),
            "leader": self.peers.leader_peer_address(),
            "identity": self.identity,
            "watchers": self.backend.watcher_hub.watcher_count(),
            "version": __version__,
        }
        if self.replica is not None:
            # follower: replication watermark/lag + served/forwarded/
            # refused counters (the workload harness's per-replica view)
            payload["replica"] = self.replica.status()
        return "application/json", json.dumps(payload).encode()

    def _election(self):
        return "application/json", json.dumps({
            "leader": self.peers.leader_peer_address(),
            "identity": self.identity,
            "is_leader": self.peers.is_leader(),
        }).encode()

    def _tier_failover(self):
        """Operator-driven storage-tier failover: promote the first
        reachable kbstored follower and repoint this node's pool
        (RemoteKvStorage.failover). Deliberately a manual surface — the tier
        has no raft quorum, so WHEN to flip is the operator's (or the
        election layer's) call; see README 'Tier replication'."""
        from ..storage import unwrap_store

        store = unwrap_store(self.backend.store, "failover")
        if store is None:
            return "application/json", json.dumps(
                {"error": "storage tier has no failover (not --storage=remote?)"}
            ).encode()
        try:
            idx = store.failover()
            return "application/json", json.dumps({"promoted_index": idx}).encode()
        except Exception as exc:  # surfaced to the operator, not swallowed
            return "application/json", json.dumps({"error": str(exc)}).encode()

    def _threads(self):
        """Poor man's pprof: live thread stacks (reference mounts Go pprof,
        pkg/endpoint/pprof.go — the Python analogue is stack dumps; kernel
        profiling goes through torch.profiler instead)."""
        out = []
        for tid, frame in sys._current_frames().items():
            name = next(
                (t.name for t in threading.enumerate() if t.ident == tid), str(tid)
            )
            out.append(f"--- thread {name} ---")
            out.extend(line.rstrip() for line in traceback.format_stack(frame))
        return "text/plain", "\n".join(out).encode()

    _profile_lock = threading.Lock()

    def _profile(self, query=None):
        """``/debug/profile?seconds=N``: capture an on-demand
        ``torch.profiler`` trace (CPU and, with a card, CUDA activity) of
        the data plane for N seconds (default 2, clamped to [0.05, 60]) —
        the kernel analogue of the reference's pprof mounts,
        pkg/endpoint/pprof.go; the Chrome trace it writes opens in
        Perfetto or chrome://tracing. One capture at a time — an
        overlapping request would stop the in-flight trace mid-capture."""
        import os
        import tempfile
        import time

        import torch
        from torch.profiler import ProfilerActivity, profile

        try:
            seconds = float((query or {}).get("seconds", 2.0))
        except (TypeError, ValueError):
            return "application/json", json.dumps(
                {"error": "seconds must be a number"}
            ).encode()
        seconds = min(60.0, max(0.05, seconds))
        if not self._profile_lock.acquire(blocking=False):
            return "application/json", json.dumps(
                {"error": "profile capture already in progress"}
            ).encode()
        try:
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            out_dir = os.path.join(tempfile.gettempdir(),
                                   f"kb-torch-profile-{int(time.time())}")
            os.makedirs(out_dir, exist_ok=True)
            with profile(activities=activities) as prof:
                time.sleep(seconds)
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
            return "application/json", json.dumps(
                {"trace_dir": out_dir, "seconds": seconds}
            ).encode()
        finally:
            self._profile_lock.release()

    _profile.kb_query = True  # HTTP layers pass the parsed query string

    def _jax_profile(self):
        return self._profile()

    def start_tier_watchdog(self, interval: float = 1.0, failures: int = 3) -> bool:
        """Auto-failover for the replicated kbstored tier: probe the tier
        primary every ``interval``; after ``failures`` consecutive misses,
        attempt ``failover()``. Split-brain safety does NOT rest on this
        node's view: the FOLLOWER refuses promotion while its replication
        stream from the primary is alive (heartbeat-armed, kbstored
        OP_PROMOTE guard), so a node merely partitioned from a healthy
        primary cannot fork the tier. Returns False when the storage stack
        has no failover surface (not a replicated remote tier)."""
        from ..storage import unwrap_store

        store = unwrap_store(self.backend.store, "failover")
        if store is None or len(getattr(store, "_addresses", [])) < 2:
            return False

        import logging

        log = logging.getLogger("kubebrain.tier")

        def loop():
            misses = 0
            while not self._watchdog_stop.wait(interval):
                try:
                    store.role(timeout=min(2.0, interval))
                    misses = 0
                    continue
                except Exception:
                    misses += 1
                if misses < failures:
                    continue
                # Quorum tier (kbstored --peers): leadership moved by
                # internal election — just find it. Legacy tier: no one
                # self-elects, so promote a follower via failover().
                try:
                    idx = store.find_leader()
                    log.warning("tier primary unreachable %d probes; "
                                "repointed at elected leader %d", misses, idx)
                    misses = 0
                    continue
                except Exception:
                    pass
                try:
                    idx = store.failover()
                    log.warning("tier primary unreachable %d probes; "
                                "promoted follower %d", misses, idx)
                    misses = 0
                except Exception as exc:
                    # follower refused (primary alive from ITS view — we are
                    # the partitioned side) or nothing promotable yet
                    log.warning("tier failover attempt failed: %s", exc)

        from ..util.env import crash_guard

        self._watchdog_stop = threading.Event()
        self._watchdog = threading.Thread(
            target=crash_guard(loop), name="kb-tier-watchdog", daemon=True)
        self._watchdog.start()
        return True

    def close(self) -> None:
        if getattr(self, "_watchdog_stop", None) is not None:
            self._watchdog_stop.set()
        self.brain.close()
        self.peers.close()
