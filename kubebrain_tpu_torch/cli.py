"""Process bootstrap: flags, wiring, graceful shutdown.

Reference: cmd/main.go (cobra root command, SIGINT/SIGTERM graceful exit
with a 3s force-kill watchdog, :35-97) and cmd/option/option.go (flags,
validation, dependency wiring — storage → metrics decorator → backend →
endpoint, :230-259). Engine choice is a runtime flag (--storage) instead of
the reference's compile-time Go build tags (option_badger.go:15).

The wiring is split in two. :func:`build_backend` builds everything below
the front (storage, fault plane, fan-out matcher, Backend, request
scheduler, peers, leases, metrics sinks) and imports neither ``grpc`` nor
``protobuf``, so it runs where they are not installed; :func:`build_endpoint`
adds the gRPC server and the HTTP listeners on top of it, and the asyncio
(``--aio-port``) and kbfront (``--front-port``) listeners, whose modules it
imports only when their flag is set. ``--role follower``
builds the follower role (``replica/``) as the peers surface in
:func:`build_backend`; its replication stream and forwarding need ``grpc``
and start with the endpoint.

Run: ``python -m kubebrain_tpu_torch.cli --single-node`` serves from the
``cuda`` engine over memkv on the card (``--device cpu`` runs it, or a
host engine, without one).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from . import __version__


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kubebrain-torch",
        description="GPU-mirrored etcd3-compatible metadata store for Kubernetes",
    )
    p.add_argument("--storage", default="cuda",
                   choices=["memkv", "cuda", "native", "remote"],
                   help="storage engine (reference: build-tag selected TiKV/Badger; "
                        "'cuda' (default) = a host engine (--inner-storage) "
                        "mirrored on --device; 'remote' = shared kbstored "
                        "server, the TiKV role)")
    p.add_argument("--storage-address", default="127.0.0.1:2389",
                   help="kbstored address for --storage=remote; comma-"
                        "separated primary,follower,... enables failover()")
    p.add_argument("--tier-auto-failover", action="store_true",
                   help="probe the kbstored tier primary and auto-promote a "
                        "follower after 3 missed probes (split-brain-guarded "
                        "by the follower's stream-liveness check)")
    p.add_argument("--storage-read-followers", action="store_true",
                   help="route snapshot-pinned reads to kbstored followers "
                        "(tier-level read scaling; falls back to the "
                        "primary on replica lag)")
    p.add_argument("--storage-pool", type=int, default=8,
                   help="connection pool size to kbstored (reference keeps "
                        "200 round-robin TiKV clients, tikv.go:36-82)")
    p.add_argument("--inner-storage", default="memkv",
                   help="host engine backing the cuda mirror (cuda engine only)")
    p.add_argument("--mesh-part", type=int, default=0,
                   help="slots the cuda mirror's partitions shard across: "
                        "the first N visible cards on --device cuda (N CPU "
                        "slots on --device cpu); 0 = every visible card on "
                        "cuda, one slot on cpu")
    p.add_argument("--key-encoding", choices=("encoded", "raw"), default="",
                   help="mirror key layout (--storage=cuda): 'encoded' = "
                        "order-preserving prefix/dictionary compression of "
                        "the device key column, 'raw' = full-width packed "
                        "keys; default follows KB_ENCODE_KEYS (encoded)")
    p.add_argument("--merge-threshold", type=int, default=0,
                   help="cuda engine: delta rows that trigger an incremental "
                        "mirror merge (0 = engine default 4096). Chaos runs "
                        "lower it so merge-fault windows exercise the real "
                        "merge/retry/escalation machinery")
    p.add_argument("--scan-partitions", type=int, default=0,
                   help="mirror partition count (--storage=cuda), a "
                        "multiple of the mesh's slots; 0 = one per slot")
    p.add_argument("--data-dir", default="",
                   help="durable storage dir for the native engine (WAL + "
                        "snapshot); empty = in-memory")
    p.add_argument("--native-partitions", type=int, default=4,
                   help="partition count the native engine samples for "
                        "partition-parallel host scans")
    p.add_argument("--fsync", action="store_true",
                   help="fsync the WAL on every commit")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--client-port", type=int, default=2379)
    p.add_argument("--peer-port", type=int, default=2380)
    p.add_argument("--info-port", type=int, default=8081)
    p.add_argument("--prefix", default="/", help="key prefix served/compacted")
    p.add_argument("--skip-prefixes", default="", help="comma-separated prefixes compaction skips")
    p.add_argument("--watch-cache-size", type=int, default=200_000)
    p.add_argument("--disable-etcd-compatibility", action="store_true",
                   help="serve only the native brain protocol semantics "
                        "(Count over etcd is rejected; reference etcd-compat flag)")
    p.add_argument("--identity", default="", help="host:peerPort; autodetected when empty")
    p.add_argument("--single-node", action="store_true",
                   help="stub leader election (always leader)")
    p.add_argument("--enable-etcd-proxy", action="store_true",
                   help="followers forward writes to the leader")
    p.add_argument("--role", choices=("leader", "follower"), default="leader",
                   help="serving role (docs/replication.md): 'follower' "
                        "keeps its own mirror on --device fed by a resumable "
                        "replication stream from --leader-address, serves "
                        "explicit-revision + bounded-staleness reads and "
                        "Watch locally, fences linearizable reads on the "
                        "leader's revision, and forwards writes/leases/"
                        "compaction")
    p.add_argument("--leader-address", default="",
                   help="leader client (gRPC) host:port (--role follower): "
                        "replication stream source + write/lease forward "
                        "target")
    p.add_argument("--leader-info", default="",
                   help="leader info/peer (HTTP) host:port (--role "
                        "follower): /status for the linearizable-read "
                        "revision fence + compact-watermark sync")
    p.add_argument("--max-staleness-rev", type=int, default=0,
                   help="follower bounded-staleness bound in revisions: "
                        "serializable reads REFUSE (etcdserver: replica "
                        "too stale) once the replication lag exceeds it; "
                        "0 = unbounded")
    p.add_argument("--max-staleness-ms", type=float, default=5000.0,
                   help="follower bounded-staleness bound in wall ms since "
                        "the watermark last covered the leader head; "
                        "refusal past it, 0 = unbounded")
    p.add_argument("--fence-timeout-ms", type=float, default=3000.0,
                   help="follower linearizable-read fence: how long the "
                        "applied watermark may chase the leader revision "
                        "before the read refuses (never answers stale)")
    p.add_argument("--enable-storage-metrics", action="store_true")
    p.add_argument("--tpu-fanout", action="store_true",
                   help="watch fan-out on the device (block-batched "
                        "persistent-table matcher, CUDA kernel K4)")
    p.add_argument("--mesh-wat", type=int, default=0,
                   help="slots the --tpu-fanout watcher table shards "
                        "across (cards on cuda, CPU slots on cpu); 0 = one "
                        "device")
    p.add_argument("--fanout-impl", choices=("block", "legacy"),
                   default="block",
                   help="--tpu-fanout implementation: 'block' = persistent "
                        "watcher table, one dispatch per sequencer drain "
                        "block (K4); 'legacy' = per-batch mask matcher (K5, "
                        "kept for differential runs)")
    p.add_argument("--cert-file", default="")
    p.add_argument("--key-file", default="")
    p.add_argument("--ca-file", default="")
    p.add_argument("--secure-only", action="store_true",
                   help="with TLS configured, refuse plaintext clients "
                        "(reference endpoint secure modes, config.go:159)")
    p.add_argument("--sched-depth", type=int, default=4,
                   help="request scheduler: bounded in-flight device scan "
                        "dispatches. 0 = auto: sized from the tracer's "
                        "measured dispatch-RTT EWMA, clamped 2-16")
    p.add_argument("--trace-slow-ms", type=float, default=500.0,
                   help="request tracer: RPCs slower than this land in the "
                        "slow-request log (/debug/traces \"slow\") and a "
                        "warning log line; 0 disables the slow log")
    p.add_argument("--sched-shed-ms", type=float, default=5000.0,
                   help="request scheduler: shed queued range reads older "
                        "than this (etcd ResourceExhausted on the wire)")
    p.add_argument("--sched-queue-limit", type=int, default=1024,
                   help="request scheduler: per-lane queued-request bound; "
                        "enqueue past it sheds immediately")
    p.add_argument("--sched-batch", type=int, default=8,
                   help="request scheduler: max distinct ready Range/Count "
                        "requests drained into one dispatch slot — over the "
                        "cuda engine they become ONE query-batched kernel "
                        "launch (K2); 1 disables")
    p.add_argument("--sched-write-batch", type=int, default=8,
                   help="request scheduler: max queued write ops (create/"
                        "update/delete) drained into one group commit — a "
                        "contiguous revision block + ONE engine round trip "
                        "with per-op conflict demux; 1 disables")
    p.add_argument("--grpc-workers", type=int, default=256,
                   help="gRPC worker threads; each open watch stream holds one")
    p.add_argument("--aio-port", type=int, default=0,
                   help="additional asyncio etcd3 listener (grpc.aio): watch "
                        "streams are coroutines, not pool threads")
    p.add_argument("--front-port", type=int, default=0,
                   help="native C++ gRPC/HTTP frontend (native/front/kbfront, "
                        "make -C native front/kbfront) on this port, "
                        "forwarding to the Python terminals over a unix "
                        "socket")
    p.add_argument("--lease-reap-interval", type=float, default=1.0,
                   help="lease subsystem: leader-only reaper cadence; expired "
                        "leases' keys become revision-stamped deletes through "
                        "the sequencer (watch-visible, compaction-safe)")
    p.add_argument("--lease-checkpoint-interval", type=float, default=5.0,
                   help="lease subsystem: cadence for persisting remaining "
                        "TTLs + attachments through the storage engine "
                        "(grant/revoke checkpoint synchronously; this covers "
                        "keepalive-refreshed deadlines)")
    p.add_argument("--legacy-ttl-patterns", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="key-pattern TTL fallback (/events/ = 1h, the "
                        "reference's lease.go behavior) for writes WITHOUT an "
                        "explicit lease; an attached lease always wins. "
                        "--no-legacy-ttl-patterns makes leases the only "
                        "expiry mechanism")
    p.add_argument("--faults", default="",
                   help="chaos mode: arm a deterministic fault-injection "
                        "plane with this preset (none, smoke, storage, "
                        "watch, merge, full). The plane is INERT until GET "
                        "/faults/arm on the info port starts the window "
                        "clock; 'none'/empty = no plane")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="seed for the fault schedule (same preset+seed+"
                        "horizon => byte-identical schedule sha)")
    p.add_argument("--fault-horizon-s", type=float, default=30.0,
                   help="fault schedule horizon in real seconds from arm; "
                        "after it the plane goes quiet (recovery window)")
    p.add_argument("--cluster-name", default="")
    p.add_argument("--compact-interval", type=float, default=60.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device of the cuda engine's mirror and of the "
                        "fan-out matcher; 'cuda' raises without a card, "
                        "whatever the engine")
    p.add_argument("--version", action="store_true", help="print version and exit")
    return p


def _parsed(args) -> argparse.Namespace:
    """``args`` as parsed flags: a list of flags is parsed."""
    if isinstance(args, argparse.Namespace):
        return args
    return build_parser().parse_args(list(args))


def _validate_follower(args) -> None:
    """The follower flags' refusals (``kubebrain_tpu/cli.py:282-304``)."""
    if not args.leader_address:
        raise SystemExit("--role follower requires --leader-address")
    if not args.leader_info:
        raise SystemExit("--role follower requires --leader-info "
                         "(the leader's info/peer HTTP host:port)")
    if args.aio_port or args.front_port:
        # those fronts build their services WITHOUT the replica gate:
        # they would serve ungated (silently stale) "linearizable"
        # reads and refuse lease RPCs instead of forwarding
        raise SystemExit("--role follower serves the sync gRPC front "
                         "only (--aio-port/--front-port have no "
                         "replica read gate yet)")
    if args.fence_timeout_ms <= 0:
        raise SystemExit("--fence-timeout-ms must be > 0")
    if args.max_staleness_rev < 0 or args.max_staleness_ms < 0:
        raise SystemExit("--max-staleness-rev/--max-staleness-ms "
                         "must be >= 0 (0 = unbounded)")


def validate_args(args) -> None:
    """Flag validation (reference KubeBrainOption.Validate, option.go:207)."""
    ports = [args.client_port, args.peer_port, args.info_port]
    if len(set(ports)) != len(ports):
        raise SystemExit(f"client/peer/info ports must be distinct, got {ports}")
    for p in ports:
        if not 0 < p < 65536:
            raise SystemExit(f"invalid port {p}")
    if args.role == "follower":
        _validate_follower(args)
    elif args.leader_address or args.leader_info:
        raise SystemExit("--leader-address/--leader-info require "
                         "--role follower")
    if bool(args.cert_file) != bool(args.key_file):
        raise SystemExit("--cert-file and --key-file must be set together")
    if args.secure_only and not args.cert_file:
        raise SystemExit("--secure-only requires --cert-file/--key-file")
    for f in (args.cert_file, args.key_file, args.ca_file):
        if f and not os.path.exists(f):
            raise SystemExit(f"TLS file not found: {f}")
    if args.storage == "cuda" and args.inner_storage == "cuda":
        raise SystemExit("--inner-storage cannot be cuda")
    if args.scan_partitions < 0:
        raise SystemExit("--scan-partitions must be >= 0")
    if args.scan_partitions and args.storage != "cuda":
        raise SystemExit("--scan-partitions requires --storage=cuda")
    # the mesh flags (kubebrain_tpu/cli.py:246-261)
    if args.mesh_part < 0:
        raise SystemExit("--mesh-part must be >= 0")
    if args.mesh_part and args.storage != "cuda":
        raise SystemExit("--mesh-part requires --storage=cuda")
    if args.mesh_wat < 0:
        raise SystemExit("--mesh-wat must be >= 0")
    if args.mesh_wat and not args.tpu_fanout:
        raise SystemExit("--mesh-wat requires --tpu-fanout")
    if args.key_encoding and args.storage != "cuda":
        raise SystemExit("--key-encoding requires --storage=cuda")
    if args.sched_depth < 0 or args.sched_queue_limit < 1:
        raise SystemExit("--sched-depth must be >= 0 (0 = auto) and "
                         "--sched-queue-limit must be >= 1")
    if args.sched_batch < 1:
        raise SystemExit("--sched-batch must be >= 1 (1 disables batching)")
    if args.sched_write_batch < 1:
        raise SystemExit(
            "--sched-write-batch must be >= 1 (1 disables group commit)")
    if args.sched_shed_ms <= 0:
        raise SystemExit("--sched-shed-ms must be > 0")
    if args.trace_slow_ms < 0:
        raise SystemExit("--trace-slow-ms must be >= 0")
    if args.lease_reap_interval <= 0 or args.lease_checkpoint_interval <= 0:
        raise SystemExit("--lease-reap-interval and --lease-checkpoint-interval "
                         "must be > 0")
    if args.data_dir and not (
        args.storage == "native" or (args.storage == "cuda" and args.inner_storage == "native")
    ):
        raise SystemExit("--data-dir requires --storage=native (or cuda over native)")
    if args.faults:
        from .faults.schedule import PRESETS

        if args.faults not in PRESETS:
            raise SystemExit(
                f"--faults {args.faults!r} unknown; presets: {', '.join(PRESETS)}")
        if args.fault_horizon_s <= 0:
            raise SystemExit("--fault-horizon-s must be > 0")


def _boot_mesh(flag: str, n: int | None, axes: tuple, device: str):
    """``make_mesh`` for a mesh flag, its refusal (more slots than visible
    cards) a boot error naming the flag."""
    from .parallel.mesh import make_mesh

    try:
        return make_mesh(n, axes=axes, device=device)
    except ValueError as e:
        raise SystemExit(f"{flag} {n}: {e}") from None


def build_backend(args, metrics=None):
    """Everything below the front (reference KubeBrainOption.Run,
    option.go:230-259, up to the server): storage → [fault plane] →
    [metrics decorator] → fan-out matcher → backend → scheduler → peers →
    leases, with ``metrics`` (``new_metrics(args.cluster_name)`` when None)
    wherever a sink goes. ``args`` is the parsed flags or a list of them.
    Returns (backend, store, peers); under ``--role follower`` the peers
    are the ``FollowerRole``, whose replication stream is not started.

    Imports no ``grpc``, ``protobuf``, ``prometheus_client`` or
    ``cryptography``, apart from the Prometheus sink when ``metrics`` is
    None and ``grpc`` for a follower's ``--ca-file``."""
    args = _parsed(args)
    validate_args(args)
    from .backend import Backend, BackendConfig
    from .device import resolve_device
    from .metrics import new_metrics
    from .server.service import PeerService, SingleNodePeerService
    from .storage import new_storage
    from .util.net import get_host

    # on every path, the host engines too: without a card a server starts
    # only when the caller asks for the CPU (--device cpu)
    resolve_device(args.device)
    if metrics is None:
        metrics = new_metrics(args.cluster_name)

    # arm the process tracer: stage histograms (kb_rpc_stage_seconds) flow
    # into this metrics sink, slow requests into the /debug/traces slow log
    from .trace import TRACER

    TRACER.configure(metrics=metrics, slow_ms=args.trace_slow_ms)

    # chaos mode: build the deterministic fault plane. INERT until
    # /faults/arm — a --faults none (or never-armed) server is
    # byte-identical to a plain one by construction.
    fault_plane = None
    if args.faults and args.faults != "none":
        from .faults import FaultPlane
        from .faults import generate as generate_faults

        fault_plane = FaultPlane(
            generate_faults(args.faults, args.fault_seed, args.fault_horizon_s),
            metrics=metrics)

    native_kw = {"partitions": args.native_partitions}
    if args.data_dir:
        native_kw.update({"data_dir": args.data_dir, "fsync": args.fsync})
    if args.storage == "cuda":
        inner_kw = {}
        if args.inner_storage == "native":
            # the host engine's own partition count goes in as
            # inner_partitions: `partitions` is the mirror's
            inner_kw = {k: v for k, v in native_kw.items() if k != "partitions"}
            inner_kw["inner_partitions"] = args.native_partitions
        elif args.inner_storage == "remote":
            # the composed production topology: the GPU data plane over the
            # shared kbstored tier (reference: scanner over TiKV partitions)
            inner_kw = {"address": args.storage_address, "pool": args.storage_pool,
                        "read_followers": args.storage_read_followers}
        if args.key_encoding:
            inner_kw["encode_keys"] = args.key_encoding == "encoded"
        if args.merge_threshold:
            inner_kw["merge_threshold"] = args.merge_threshold
        if fault_plane is not None:
            # wrap the INNER host engine so injected uncertainty poisons
            # (and quarantines) the device mirror like a real engine fault
            from .faults import FaultyStorage

            inner_kw["inner_wrap"] = (
                lambda s: FaultyStorage(s, fault_plane))
        # the partition mesh is built here, so its errors surface at boot
        # (kubebrain_tpu/cli.py:373-403); no flag = the engine's default
        # mesh, every visible card on cuda, one slot on cpu
        mesh = None
        if args.mesh_part or args.scan_partitions:
            mesh = _boot_mesh("--mesh-part", args.mesh_part or None,
                              ("part",), args.device)
        try:
            store = new_storage("cuda", inner=args.inner_storage,
                                device=args.device, mesh=mesh,
                                partitions=args.scan_partitions, **inner_kw)
        except ValueError as e:  # partitions no multiple of the mesh
            raise SystemExit(f"--scan-partitions: {e}") from None
    elif args.storage == "native":
        store = new_storage("native", **native_kw)
    elif args.storage == "remote":
        store = new_storage(
            "remote", address=args.storage_address, pool=args.storage_pool,
            partitions=args.native_partitions,
            read_followers=args.storage_read_followers,
        )
    else:
        store = new_storage(args.storage)
    if fault_plane is not None and args.storage != "cuda":
        from .faults import FaultyStorage

        store = FaultyStorage(store, fault_plane)
    if args.enable_storage_metrics:
        from .storage.metrics_wrap import MetricsKvStorage

        store = MetricsKvStorage(store, metrics)

    fanout = None
    if args.tpu_fanout:
        # the watcher-table mesh, independent of the partition mesh
        # (kubebrain_tpu/cli.py:425-451)
        wat_mesh = (_boot_mesh("--mesh-wat", args.mesh_wat, ("wat",),
                               args.device) if args.mesh_wat else None)
        if args.fanout_impl == "legacy":
            from .ops.fanout import FanoutMatcher

            fanout = FanoutMatcher(device=args.device, mesh=wat_mesh)
        else:
            from .fanout import DeviceFanout

            fanout = DeviceFanout(device=args.device, mesh=wat_mesh)
        # kb_fanout_sharded: 1 when the table is really distributed
        fanout.set_metrics(metrics)

    backend = Backend(store, BackendConfig(
        prefix=args.prefix.encode(),
        skip_prefixes=[s.encode() for s in args.skip_prefixes.split(",") if s],
        watch_cache_capacity=args.watch_cache_size,
        enable_etcd_compatibility=not args.disable_etcd_compatibility,
        fanout_matcher=fanout,
    ))

    # watch-path lag instrumentation: commit->delivery histogram + per-
    # watcher backlog gauges on /metrics
    backend.watcher_hub.set_metrics(metrics)

    # uncertain-write repair observability: queue-depth gauge + per-outcome
    # repair counters (the chaos report reconciles against these)
    backend.retry.set_metrics(metrics)

    if fault_plane is not None:
        # bind the endpoint-level injections: the watch-reset daemon picks
        # victims from the hub; the cuda scanner gets the merge/encode
        # hooks; the gRPC front adds the conn-drop interceptor (endpoint
        # discovers the plane via backend._kb_faults)
        fault_plane.bind_hub(backend.watcher_hub)
        backend._kb_faults = fault_plane
        if hasattr(backend.scanner, "set_fault_plane"):
            backend.scanner.set_fault_plane(fault_plane)

    # mirror accounting (cuda engine): kb_mirror_bytes{device=} and the
    # encoding gauges, scrape-time off the live mirror, and the engine's
    # merge/compaction counters and histograms
    if hasattr(backend.scanner, "register_metrics"):
        backend.scanner.register_metrics(metrics)

    # the device-aware request scheduler, created here (before any service
    # constructs a KVService) so every surface shares the flag-configured
    # instance with real metrics — later ensure_scheduler calls adopt it
    from .sched import SchedConfig, ensure_scheduler

    ensure_scheduler(backend, SchedConfig(
        depth=args.sched_depth,
        queue_limit=args.sched_queue_limit,
        shed_ms=args.sched_shed_ms,
        batch=args.sched_batch,
        write_batch=args.sched_write_batch,
    ), metrics=metrics)

    identity = args.identity or f"{get_host()}:{args.peer_port}"
    if args.role == "follower":
        # follower role (docs/replication.md): the role object IS the
        # peers surface (is_leader False, no-op revision sync) so every
        # existing service works unchanged, plus the per-RPC replica
        # routing the etcd terminals consult
        from .replica import FollowerConfig, FollowerRole

        leader_creds = None
        if args.ca_file:
            # a TLS-serving leader: verify it against the configured CA
            # on the forwarding + replication channels
            import grpc

            with open(args.ca_file, "rb") as f:
                leader_creds = grpc.ssl_channel_credentials(
                    root_certificates=f.read())
        peers = FollowerRole(
            backend,
            FollowerConfig(
                leader_address=args.leader_address,
                leader_info=args.leader_info,
                max_staleness_rev=args.max_staleness_rev,
                max_staleness_ms=args.max_staleness_ms,
                fence_timeout_s=args.fence_timeout_ms / 1000.0,
                credentials=leader_creds,
            ),
            metrics=metrics, fault_plane=fault_plane, identity=identity)
    elif args.single_node:
        peers = SingleNodePeerService(backend, identity)
    else:
        peers = PeerService(
            backend, identity, args.client_port, enable_proxy=args.enable_etcd_proxy
        )

    # lease subsystem: key-pattern TTLs demoted to a flag-gated fallback
    # (explicit PutRequest.lease always wins); registry + leader-only reaper
    # created here with the flag-derived cadences so every service surface
    # shares one table (later ensure_lease calls adopt it). Last: the reaper
    # ticks from here on, so a caller that keeps leases alive attaches as
    # soon as this function returns.
    from .backend import creator
    from .lease import ensure_lease

    creator.LEGACY_TTL_PATTERNS = bool(args.legacy_ttl_patterns)
    ensure_lease(
        backend, peers=peers, metrics=metrics,
        reap_interval=args.lease_reap_interval,
        checkpoint_interval=args.lease_checkpoint_interval,
    )
    return backend, store, peers


def build_endpoint(args):
    """Dependency wiring (reference KubeBrainOption.Run, option.go:230-259):
    :func:`build_backend`, then server → endpoint. Returns (endpoint,
    backend, store)."""
    args = _parsed(args)
    from .endpoint import Endpoint, EndpointConfig
    from .metrics import new_metrics
    from .server import Server

    metrics = new_metrics(args.cluster_name)
    backend, store, peers = build_backend(args, metrics=metrics)
    identity = peers.identity
    replica_role = peers if args.role == "follower" else None
    server = Server(
        backend, peers, metrics, identity,
        client_urls=[f"http://{identity.rsplit(':', 1)[0]}:{args.client_port}"],
        compact_interval=args.compact_interval,
        replica=replica_role,
    )
    extra_http = {}
    fault_plane = getattr(backend, "_kb_faults", None)
    if fault_plane is not None:
        # chaos-runner control surface on the info port: arm aligns the
        # fault windows with replay start; state feeds the SLO report's
        # injected/observed reconciliation
        extra_http["/faults/arm"] = fault_plane.http_arm
        extra_http["/faults/state"] = fault_plane.http_state
    endpoint = Endpoint(server, metrics, EndpointConfig(
        host=args.host,
        client_port=args.client_port,
        peer_port=args.peer_port,
        info_port=args.info_port,
        cert_file=args.cert_file,
        key_file=args.key_file,
        ca_file=args.ca_file,
        insecure=not args.secure_only,
        grpc_workers=args.grpc_workers,
        extra_http=extra_http,
    ))
    # the asyncio and kbfront listeners import grpc at the top: imported
    # here only, so that build_backend loads without grpc
    if args.aio_port:
        from .endpoint.aio import AioEndpoint

        creds = None
        if args.cert_file and args.key_file:
            creds = endpoint._grpc_creds()
        aio = AioEndpoint(
            backend, peers, args.host, args.aio_port, identity,
            credentials=creds, insecure=not args.secure_only,
        )
        _orig_run, _orig_close = endpoint.run, endpoint.close

        def run_both():
            _orig_run()
            aio.run()

        def close_both(grace: float = 1.0):
            aio.close(grace)
            _orig_close(grace)

        endpoint.run = run_both
        endpoint.close = close_both
    if args.front_port:
        from .endpoint.front import FrontServer

        # over a network engine (remote, or cuda over remote) every write
        # is a TCP round trip: the unary terminals run in the executor
        engine = args.inner_storage if args.storage == "cuda" else args.storage
        front = FrontServer(
            backend, peers, server, identity, metrics=metrics,
            brain=server.brain, inline_unary=engine != "remote",
        )
        _frun, _fclose = endpoint.run, endpoint.close

        def run_with_front():
            _frun()
            front.run(args.front_port, args.host,
                      cert_file=args.cert_file, key_file=args.key_file,
                      ca_file=args.ca_file, secure_only=args.secure_only)

        def close_with_front(grace: float = 1.0):
            front.close()
            _fclose(grace)

        endpoint.run = run_with_front
        endpoint.close = close_with_front
    if replica_role is not None:
        # start the replication stream once the listeners are up; stop it
        # (and the forwarding channel) before the backend goes away
        _rp_run, _rp_close = endpoint.run, endpoint.close

        def run_with_replica():
            _rp_run()
            replica_role.start()

        def close_with_replica(grace: float = 1.0):
            replica_role.close()
            _rp_close(grace)

        endpoint.run = run_with_replica
        endpoint.close = close_with_replica
    return endpoint, backend, store


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        print(f"kubebrain-torch {__version__} (storage engines: memkv, cuda, "
              f"native, remote)")
        return 0

    # server-profile gc: the default thresholds collect every ~700
    # allocations — at informer fan-out scale (10k watch streams, 100k+
    # protobuf deliveries) collection pauses halved write throughput in the
    # config-5 sim. Protobufs/events are acyclic; raise the thresholds.
    # KB_GC_THRESHOLD=a[,b[,c]] overrides; 0 keeps Python defaults.
    gc_env = os.environ.get("KB_GC_THRESHOLD", "")
    if gc_env != "0":
        import gc

        try:
            parts = [int(x) for x in gc_env.split(",") if x.strip()]
        except ValueError:
            print(f"ignoring malformed KB_GC_THRESHOLD={gc_env!r}", file=sys.stderr)
            parts = []
        if not parts or any(p <= 0 for p in parts):
            # zero disables gc entirely; negatives crash set_threshold
            parts = [200_000, 1000, 1000]
        gc.set_threshold(*parts[:3])

    endpoint, backend, store = build_endpoint(args)
    if args.tier_auto_failover:
        if not endpoint.server.start_tier_watchdog():
            # an explicitly requested HA feature that cannot arm must not
            # be silently dropped (validate_args style)
            raise SystemExit(
                "--tier-auto-failover requires --storage=remote (or "
                "cuda-over-remote) with --storage-address primary,follower,...")
    stop = threading.Event()
    watchdog: list[threading.Timer] = []

    def _graceful_exit(signum, frame):  # noqa: ARG001
        # force-kill watchdog (reference forceExitWhileGracefulExitTimeout,
        # cmd/main.go:62): a wedged close must not block exit; budget covers
        # grpc drain + engine checkpoint
        t = threading.Timer(10.0, lambda: os._exit(2))
        t.daemon = True
        t.start()
        watchdog.append(t)
        stop.set()

    signal.signal(signal.SIGINT, _graceful_exit)
    signal.signal(signal.SIGTERM, _graceful_exit)

    endpoint.run()
    print(
        f"kubebrain-torch {__version__} serving: etcd3+brain gRPC :{args.client_port}, "
        f"peer http :{args.peer_port}, info http :{args.info_port} "
        f"(storage={args.storage}, device={args.device})",
        file=sys.stderr,
    )
    stop.wait()
    endpoint.close()
    backend.close()
    store.close()
    for t in watchdog:
        t.cancel()
    return 0


if __name__ == "__main__":
    sys.exit(main())
