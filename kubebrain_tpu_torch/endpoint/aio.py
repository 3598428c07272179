"""Asyncio gRPC endpoint: coroutine-held watch streams.

The sync gRPC stack pins one worker thread per ACTIVE stream, capping
concurrent watches at the pool size. Here the etcd3 surface runs on
``grpc.aio``: unary RPCs execute the existing sync terminals in a small
executor, while Watch streams are native coroutines fed by a thread-safe
bridge queue — 10k open watch streams cost 10k queue objects, not 10k
threads (the goroutine-parity answer to the reference's watcher model,
watch.go:83-117).

Enabled with ``--aio-port``; serves the same wire surface as the sync
endpoint, over whatever engine the CLI built (the ``cuda`` mirror by
default). Counterpart of ``kubebrain_tpu/endpoint/aio.py``; it imports
``grpc`` at the top, so ``cli.build_endpoint`` imports it only when the
flag is given.
"""

from __future__ import annotations

import asyncio
import collections
import queue as sync_queue
import threading

import grpc
import grpc.aio

from ..proto import rpc_pb2
from ..server.etcd import shim
from ..server.etcd.kv import KVService
from ..server.etcd.misc import ClusterService, LeaseService, MaintenanceService


class _LoopNotifier:
    """Coalesces cross-thread loop wakeups: ``call_soon_threadsafe`` writes
    the loop's self-pipe on EVERY call, so one hub batch fanning out to W
    subscriber queues used to cost W syscalls on the sequencer thread (the
    top stack in the 10k-watcher informer-sim profile). All queues of one
    loop share a notifier that schedules a single drain per burst."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._lock = threading.Lock()
        self._pending: list[AioBridgeQueue] = []
        self._scheduled = False

    def notify(self, q: "AioBridgeQueue") -> None:
        with self._lock:
            self._pending.append(q)
            if self._scheduled:
                return
            self._scheduled = True
        self._loop.call_soon_threadsafe(self._drain)

    def _drain(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
            self._scheduled = False
        for q in pending:
            q._event.set()


class AioBridgeQueue:
    """WatcherHub-compatible subscriber queue consumable from asyncio.

    The hub (sequencer thread) calls ``put_nowait`` / ``get_nowait`` and
    expects ``queue.Full`` on overflow; the watch coroutine awaits ``get``.
    A deque + lock keeps the sync side synchronous (so slow-consumer drop
    semantics hold); the loop is woken through the shared ``_LoopNotifier``
    (or a direct ``call_soon_threadsafe`` when none is given), and only on
    the empty -> non-empty transition — a queue with a backlog needs no
    further wakeups.
    """

    def __init__(self, maxsize: int, loop: asyncio.AbstractEventLoop,
                 notifier: _LoopNotifier | None = None):
        self._maxsize = maxsize
        self._loop = loop
        self._notifier = notifier
        self._lock = threading.Lock()
        self._items: collections.deque = collections.deque()
        self._event = asyncio.Event()

    # ---- sync side (sequencer / hub)
    def put_nowait(self, item) -> None:
        with self._lock:
            if len(self._items) >= self._maxsize:
                raise sync_queue.Full
            was_empty = not self._items
            self._items.append(item)
        if was_empty:
            if self._notifier is not None:
                self._notifier.notify(self)
            else:
                self._loop.call_soon_threadsafe(self._event.set)

    def get_nowait(self):
        with self._lock:
            if not self._items:
                raise sync_queue.Empty
            return self._items.popleft()

    def empty(self) -> bool:
        with self._lock:
            return not self._items

    def qsize(self) -> int:
        with self._lock:
            return len(self._items)

    # ---- async side (watch coroutine)
    async def get(self):
        while True:
            with self._lock:
                if self._items:
                    return self._items.popleft()
                self._event.clear()
            await self._event.wait()


class _AbortError(Exception):
    def __init__(self, code, details):
        self.code = code
        self.details = details


class _SyncContextAdapter:
    """Sync-terminal context whose abort raises through the executor."""

    def abort(self, code, details):
        raise _AbortError(code, details)

    def is_active(self) -> bool:
        return True


def _wrap_unary(fn):
    async def handler(request, context):
        loop = asyncio.get_running_loop()
        try:
            return await loop.run_in_executor(None, fn, request, _SyncContextAdapter())
        except _AbortError as e:
            await context.abort(e.code, e.details)

    return handler


class AioWatchService:
    """Native-async Watch terminal — full parity with the sync protocol
    (server/etcd/watch.py): shared response builders, negative-start-revision
    list-over-watch streams, progress-notify bookmarks, compacted cancels."""

    PROGRESS_INTERVAL = 60.0

    def __init__(self, backend, peers=None):
        self.backend = backend
        self.peers = peers
        self._notifiers: dict[int, _LoopNotifier] = {}

    def _notifier_for(self, loop) -> _LoopNotifier:
        n = self._notifiers.get(id(loop))
        if n is None:
            n = self._notifiers[id(loop)] = _LoopNotifier(loop)
        return n

    async def Watch(self, request_iterator, context):
        from ..server.etcd.watch import (
            compacted_response,
            dropped_response,
            events_response,
        )

        if self.peers is not None and not self.peers.is_leader():
            # follower watch-forwarding is a sync-proxy feature; refuse loudly
            # rather than serve from a non-leader pipeline
            await context.abort(
                grpc.StatusCode.UNAVAILABLE,
                "etcdserver: not leader (watch on the aio port requires the leader; "
                "use the sync client port for proxied watches)",
            )

        loop = asyncio.get_running_loop()
        out: asyncio.Queue = asyncio.Queue(maxsize=1024)
        watches: dict[int, tuple[int, asyncio.Task]] = {}
        stream_tasks: set[asyncio.Task] = set()
        next_id = [0]

        async def pump(watch_id, wid, q, want_prev, no_put, no_delete, progress_notify):
            last_sent = loop.time()
            # poll loop, not a retry loop: the TimeoutError tick is the
            # progress-notify cadence; exits on the queue's poison pill
            while True:
                if progress_notify:
                    try:
                        batch = await asyncio.wait_for(q.get(), timeout=0.5)
                    except asyncio.TimeoutError:
                        if loop.time() - last_sent >= self.PROGRESS_INTERVAL:
                            last_sent = loop.time()
                            await out.put(rpc_pb2.WatchResponse(
                                header=shim.header(self.backend.current_revision()),
                                watch_id=watch_id,
                            ))
                        continue
                else:
                    # event-driven: at 10k idle streams, a 0.5s poll per pump
                    # is 20k timer events/s of pure loop overhead
                    batch = await q.get()
                if batch is None or getattr(q, "kb_dropped", False):
                    # the drop flag is checked BEFORE every delivery so
                    # buffered batches past the drop point never reach the
                    # wire — the delivered sequence stays a prefix (the
                    # hub drop protocol's no-invisible-gap contract)
                    await out.put(dropped_response(self.backend.current_revision(), watch_id))
                    return
                resp = events_response(batch, watch_id, want_prev, no_put, no_delete)
                if resp is not None:
                    last_sent = loop.time()
                    await out.put(resp)

        async def range_stream(creq, watch_id):
            """List-over-watch (negative start revision, watch.py protocol)."""
            from ..backend.errors import CompactedError, FutureRevisionError
            from ..proto import kv_pb2
            from ..server.service.revision import decode_list_revision

            revision = decode_list_revision(creq.start_revision)
            from ..sched import ensure_scheduler

            try:
                rev, stream = await loop.run_in_executor(
                    None, ensure_scheduler(self.backend).list_by_stream,
                    bytes(creq.key), bytes(creq.range_end), revision,
                )
            except (CompactedError, FutureRevisionError):
                await out.put(compacted_response(
                    self.backend.current_revision(),
                    self.backend.compact_revision(), watch_id,
                ))
                return
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                # any other failure must still answer the client — otherwise
                # it waits forever on this watch_id
                await out.put(rpc_pb2.WatchResponse(
                    header=shim.header(self.backend.current_revision()),
                    watch_id=watch_id, canceled=True,
                    cancel_reason=f"range stream failed: {exc}",
                ))
                return
            await out.put(rpc_pb2.WatchResponse(
                header=shim.header(rev), watch_id=watch_id, created=True
            ))
            it = iter(stream)
            try:
                while True:
                    batch = await loop.run_in_executor(None, next, it, None)
                    if batch is None:
                        break
                    resp = rpc_pb2.WatchResponse(header=shim.header(rev), watch_id=watch_id)
                    for kv in batch:
                        resp.events.append(
                            kv_pb2.Event(type=kv_pb2.Event.PUT, kv=shim.to_kv(kv))
                        )
                    await out.put(resp)
                reason = ""
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # mid-stream failure: tell the client
                reason = f"range stream failed: {exc}"
            await out.put(rpc_pb2.WatchResponse(
                header=shim.header(rev), watch_id=watch_id, canceled=True,
                cancel_reason=reason,
            ))

        async def reader():
            try:
                async for req in request_iterator:
                    which = req.WhichOneof("request_union")
                    if which == "create_request":
                        creq = req.create_request
                        next_id[0] += 1
                        watch_id = creq.watch_id if creq.watch_id > 0 else next_id[0]
                        from ..server.service.revision import is_list_over_watch

                        if is_list_over_watch(creq.start_revision):
                            task = asyncio.create_task(range_stream(creq, watch_id))
                            stream_tasks.add(task)
                            task.add_done_callback(stream_tasks.discard)
                            continue
                        end = bytes(creq.range_end)
                        if not end:
                            end = bytes(creq.key) + b"\x00"
                        elif end == b"\x00":
                            end = b""
                        from ..backend import WatchExpiredError

                        try:
                            wid, q = self.backend.watch_range(
                                bytes(creq.key), end, int(creq.start_revision),
                                queue_factory=lambda maxsize: AioBridgeQueue(
                                    maxsize, loop, self._notifier_for(loop)),
                            )
                        except WatchExpiredError:
                            await out.put(compacted_response(
                                self.backend.current_revision(),
                                self.backend.compact_revision(), watch_id,
                            ))
                            continue
                        await out.put(rpc_pb2.WatchResponse(
                            header=shim.header(self.backend.current_revision()),
                            watch_id=watch_id, created=True,
                        ))
                        no_put = rpc_pb2.WatchCreateRequest.NOPUT in creq.filters
                        no_delete = rpc_pb2.WatchCreateRequest.NODELETE in creq.filters
                        task = asyncio.create_task(pump(
                            watch_id, wid, q, bool(creq.prev_kv), no_put, no_delete,
                            bool(creq.progress_notify),
                        ))
                        watches[watch_id] = (wid, task)
                    elif which == "cancel_request":
                        watch_id = req.cancel_request.watch_id
                        entry = watches.pop(watch_id, None)
                        if entry:
                            wid, task = entry
                            task.cancel()
                            self.backend.unwatch(wid)
                        await out.put(rpc_pb2.WatchResponse(
                            header=shim.header(self.backend.current_revision()),
                            watch_id=watch_id, canceled=True,
                            cancel_reason="watch cancelled by client",
                        ))
                    elif which == "progress_request":
                        await out.put(rpc_pb2.WatchResponse(
                            header=shim.header(self.backend.current_revision()),
                            watch_id=-1,
                        ))
            except Exception:
                pass
            await out.put(None)

        reader_task = asyncio.create_task(reader())
        try:
            while True:
                item = await out.get()
                if item is None:
                    return
                yield item
        finally:
            reader_task.cancel()
            # list-over-watch tasks block on `out.put` once the consumer is
            # gone (bounded queue) — cancel them or they leak with their
            # backend list streams
            for task in list(stream_tasks):
                task.cancel()
            for wid, task in watches.values():
                task.cancel()
                self.backend.unwatch(wid)


def _aio_lease_keepalive(lease):
    """Coroutine keepalive stream over the shared LeaseService: the refresh
    goes through the scheduler's SYSTEM lane (a blocking submit), so it runs
    in the executor — the loop thread must never block on admission."""
    from ..server.etcd.misc import ERR_NOT_LEADER, LeaseNotLeaderError

    async def handler(request_iterator, context):
        loop = asyncio.get_running_loop()
        async for req in request_iterator:
            try:
                yield await loop.run_in_executor(None, lease.keepalive_one, req)
            except LeaseNotLeaderError:
                await context.abort(grpc.StatusCode.UNAVAILABLE, ERR_NOT_LEADER)

    return handler


def make_aio_handlers(backend, peers=None, identity="kubebrain-tpu"):
    kv = KVService(backend, peers)
    lease = LeaseService(backend, peers)
    cluster = ClusterService(backend, identity)
    maint = MaintenanceService(backend)
    watch = AioWatchService(backend, peers)
    p = rpc_pb2

    def unary(fn, req, resp):
        return grpc.unary_unary_rpc_method_handler(
            _wrap_unary(fn),
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )

    return [
        grpc.method_handlers_generic_handler("etcdserverpb.KV", {
            "Range": unary(kv.Range, p.RangeRequest, p.RangeResponse),
            "Txn": unary(kv.Txn, p.TxnRequest, p.TxnResponse),
            "Compact": unary(kv.Compact, p.CompactionRequest, p.CompactionResponse),
            "Put": unary(kv.Put, p.PutRequest, p.PutResponse),
            "DeleteRange": unary(kv.DeleteRange, p.DeleteRangeRequest, p.DeleteRangeResponse),
        }),
        grpc.method_handlers_generic_handler("etcdserverpb.Watch", {
            "Watch": grpc.stream_stream_rpc_method_handler(
                watch.Watch,
                request_deserializer=p.WatchRequest.FromString,
                response_serializer=p.WatchResponse.SerializeToString,
            ),
        }),
        grpc.method_handlers_generic_handler("etcdserverpb.Lease", {
            "LeaseGrant": unary(lease.LeaseGrant, p.LeaseGrantRequest, p.LeaseGrantResponse),
            "LeaseRevoke": unary(lease.LeaseRevoke, p.LeaseRevokeRequest, p.LeaseRevokeResponse),
            "LeaseKeepAlive": grpc.stream_stream_rpc_method_handler(
                _aio_lease_keepalive(lease),
                request_deserializer=p.LeaseKeepAliveRequest.FromString,
                response_serializer=p.LeaseKeepAliveResponse.SerializeToString,
            ),
            "LeaseTimeToLive": unary(lease.LeaseTimeToLive, p.LeaseTimeToLiveRequest, p.LeaseTimeToLiveResponse),
            "LeaseLeases": unary(lease.LeaseLeases, p.LeaseLeasesRequest, p.LeaseLeasesResponse),
        }),
        grpc.method_handlers_generic_handler("etcdserverpb.Cluster", {
            "MemberList": unary(cluster.MemberList, p.MemberListRequest, p.MemberListResponse),
        }),
        grpc.method_handlers_generic_handler("etcdserverpb.Maintenance", {
            "Status": unary(maint.Status, p.StatusRequest, p.StatusResponse),
            "Defragment": unary(maint.Defragment, p.DefragmentRequest, p.DefragmentResponse),
        }),
    ]


class AioEndpoint:
    """Runs the aio gRPC server in a dedicated event-loop thread so the rest
    of the (threaded) process is unchanged. TLS mirrors the sync endpoint:
    with credentials configured, a secure port is bound (plus plaintext only
    when ``insecure``)."""

    def __init__(
        self, backend, peers, host: str, port: int, identity="kubebrain-tpu",
        credentials: grpc.ServerCredentials | None = None, insecure: bool = True,
    ):
        self.backend = backend
        self.peers = peers
        self.host = host
        self.port = port
        self.identity = identity
        self.credentials = credentials
        self.insecure = insecure
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._error: BaseException | None = None

    def run(self) -> None:
        self._thread = threading.Thread(target=self._serve, name="kb-aio", daemon=True)
        self._thread.start()
        self._started.wait(timeout=10)
        if self._error is not None:
            raise RuntimeError(f"aio endpoint failed to start: {self._error}")

    def _serve(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def main():
            self._server = grpc.aio.server()
            for h in make_aio_handlers(self.backend, self.peers, self.identity):
                self._server.add_generic_rpc_handlers((h,))
            bound = False
            if self.credentials is not None:
                self._server.add_secure_port(f"{self.host}:{self.port}", self.credentials)
                bound = True
            if self.insecure or not bound:
                self._server.add_insecure_port(f"{self.host}:{self.port}")
            await self._server.start()
            self._started.set()
            await self._server.wait_for_termination()

        try:
            self._loop.run_until_complete(main())
        except Exception as e:
            import traceback

            traceback.print_exc()
            self._error = e
            self._started.set()

    def close(self, grace: float = 0.5) -> None:
        if self._loop is not None and self._server is not None:
            fut = asyncio.run_coroutine_threadsafe(self._server.stop(grace), self._loop)
            try:
                fut.result(timeout=grace + 1.0)
            except Exception:
                pass
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=2)
