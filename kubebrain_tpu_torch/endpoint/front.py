"""Native-frontend backhaul: the Python side of kbfront.

kbfront (native/front/kbfront.cc) terminates gRPC (HTTP/2) and plain HTTP
on one TCP port — the single-port protocol demux the reference builds with
cmux (pkg/endpoint/server.go:65-100) — and forwards de-framed requests over
a pipelined unix socket. This module is the other end of that socket: an
asyncio server that dispatches frames to the SAME service terminals the
grpc stacks use (server/etcd/kv.py, server/brain/server.py, endpoint/aio.py),
so MVCC semantics stay in exactly one place.

Why it is fast: the per-RPC interpreter work drops to frame header parse +
protobuf decode (upb) + the backend op. All HTTP/2, HPACK and gRPC message
framing runs in C++. Hot unary terminals run INLINE on the event loop —
backend writes are inline-drain sequenced and take ~tens of microseconds,
so a thread hop would cost more than the op.

Frame protocol (little-endian), mirrored in kbfront.cc:
  u32 payload_len | u32 conn_id | u32 stream_id | u8 kind | payload
front -> python kinds: 1 START(path) 2 MSG 3 HALF_CLOSE 4 RST 6 HTTP(req)
python -> front kinds: 2 MSG 5 END(u32 status|u16 len|msg) 4 RST

Counterpart of ``kubebrain_tpu/endpoint/front.py``. ``kbfront`` is the
repository's ``native/front/kbfront`` (``make -C native front/kbfront``),
found from this file's location; the backhaul socket goes to the
temporary directory (``TMPDIR``) unless a path is given.
"""

from __future__ import annotations

import asyncio
import logging
import os
import struct
import subprocess
import tempfile
import threading

import grpc

from ..proto import brain_pb2, rpc_pb2
from ..server.etcd.kv import KVService
from ..server.etcd.misc import ClusterService, LeaseService, MaintenanceService
from .aio import AioBridgeQueue, AioWatchService, _AbortError, _SyncContextAdapter

logger = logging.getLogger("kubebrain")

K_START, K_MSG, K_HALF_CLOSE, K_RST, K_END, K_HTTP = 1, 2, 3, 4, 5, 6

_HDR = struct.Struct("<IIIB")


def _status_num(code) -> int:
    return code.value[0] if hasattr(code, "value") else int(code)


_SYNC_CTX = _SyncContextAdapter()
# the backhaul forwards pre-serialized responses verbatim, so handlers may
# take the raw wire fast path (kv.py _list / _RawResponse)
_SYNC_CTX.kb_raw_ok = True
_END_OK = struct.pack("<IH", 0, 0)  # END payload: status 0, empty message


class _Stream:
    __slots__ = ("queue", "task", "half_closed")

    def __init__(self):
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=1024)
        self.task: asyncio.Task | None = None
        self.half_closed = False


class FrontServer:
    """Backhaul listener + kbfront subprocess supervisor."""

    def __init__(self, backend, peers=None, server=None, identity="kubebrain-tpu",
                 metrics=None, brain=None, inline_unary: bool = True):
        # inline_unary: run unary terminals on the event loop (right for
        # in-process engines, ~tens of us/op). With a NETWORK engine
        # (--storage=remote) every op is a TCP round trip that would stall
        # all frontend traffic — those run in the executor instead.
        self._inline_unary = inline_unary
        self.backend = backend
        self.peers = peers
        self.server = server  # Server composite for /status etc (may be None)
        self.identity = identity
        self.metrics = metrics
        self.kv = KVService(backend, peers)
        self.lease = LeaseService(backend, peers)
        self.cluster = ClusterService(backend, identity)
        self.maint = MaintenanceService(backend)
        self.watch = AioWatchService(backend, peers)
        self.brain = brain
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._proc: subprocess.Popen | None = None
        self._writer: asyncio.StreamWriter | None = None
        # corked backhaul writes: every response frame lands here and ONE
        # flusher task does one write()+drain() per burst — per-message
        # write/drain was the loop thread's top cost in the 10k-watcher sim
        self._cork: list[bytes] = []
        self._cork_bytes = 0
        self._cork_event: asyncio.Event | None = None
        # producer gate: cleared while the cork backlog is over the high-water
        # mark so stream producers pause (keeps the hub's slow-consumer drop
        # reachable); unary replies are bounded by kbfront's in-flight request
        # window and bypass the gate
        self._gate: asyncio.Event | None = None
        self._flusher: asyncio.Task | None = None
        self._streams: dict[tuple[int, int], _Stream] = {}
        # unary fast path: (cid, sid) -> [(req_cls, fn), raw_request_bytes]
        self._unary_pending: dict[tuple[int, int], list] = {}
        self._ready = threading.Event()
        self._closing = False

        p = rpc_pb2
        b = brain_pb2
        # path -> (request_cls, handler, kind); kind: "unary" | "sstream"
        self.unary = {}
        self.sstream = {}

        def u(path, req_cls, fn):
            self.unary[path] = (req_cls, fn)

        u("/etcdserverpb.KV/Range", p.RangeRequest, self.kv.Range)
        u("/etcdserverpb.KV/Txn", p.TxnRequest, self.kv.Txn)
        u("/etcdserverpb.KV/Compact", p.CompactionRequest, self.kv.Compact)
        u("/etcdserverpb.KV/Put", p.PutRequest, self.kv.Put)
        u("/etcdserverpb.KV/DeleteRange", p.DeleteRangeRequest, self.kv.DeleteRange)
        u("/etcdserverpb.Lease/LeaseGrant", p.LeaseGrantRequest, self.lease.LeaseGrant)
        u("/etcdserverpb.Lease/LeaseRevoke", p.LeaseRevokeRequest, self.lease.LeaseRevoke)
        u("/etcdserverpb.Lease/LeaseTimeToLive", p.LeaseTimeToLiveRequest, self.lease.LeaseTimeToLive)
        u("/etcdserverpb.Lease/LeaseLeases", p.LeaseLeasesRequest, self.lease.LeaseLeases)
        u("/etcdserverpb.Cluster/MemberList", p.MemberListRequest, self.cluster.MemberList)
        u("/etcdserverpb.Maintenance/Status", p.StatusRequest, self.maint.Status)
        u("/etcdserverpb.Maintenance/Defragment", p.DefragmentRequest, self.maint.Defragment)
        if brain is not None:
            u("/brainpb.Brain/Create", b.CreateRequest, brain.Create)
            u("/brainpb.Brain/Update", b.UpdateRequest, brain.Update)
            u("/brainpb.Brain/Delete", b.BrainDeleteRequest, brain.Delete)
            u("/brainpb.Brain/Compact", b.BrainCompactRequest, brain.Compact)
            u("/brainpb.Brain/Get", b.GetRequest, brain.Get)
            u("/brainpb.Brain/Range", b.BrainRangeRequest, brain.Range)
            u("/brainpb.Brain/Count", b.CountRequest, brain.Count)
            u("/brainpb.Brain/ListPartition", b.ListPartitionRequest, brain.ListPartition)
            self.sstream["/brainpb.Brain/RangeStream"] = (
                b.BrainRangeRequest, brain.RangeStream)
            self.sstream["/brainpb.Brain/Watch"] = (
                b.BrainWatchRequest, brain.Watch)

    # ------------------------------------------------------------- lifecycle
    def run(self, tcp_port: int, host: str = "127.0.0.1",
            socket_path: str | None = None, cert_file: str = "",
            key_file: str = "", ca_file: str = "",
            secure_only: bool = False) -> None:
        """Start the backhaul loop thread + kbfront subprocess.

        With cert/key, kbfront terminates TLS in its reactor (reference
        secure modes, endpoint/config.go:159): both-modes by default,
        plaintext refused when ``secure_only``."""
        self.socket_path = socket_path or os.path.join(
            tempfile.gettempdir(), f"kbfront-{os.getpid()}-{tcp_port}.sock")
        self.tcp_port = tcp_port
        self.host = host
        self._tls_args: list[str] = []
        if cert_file and key_file:
            self._tls_args = ["--cert", cert_file, "--key", key_file]
            if ca_file:
                self._tls_args += ["--ca", ca_file]
            if secure_only:
                self._tls_args.append("--secure-only")
        self._start_error: Exception | None = None
        self._thread = threading.Thread(
            target=self._thread_main, name="kb-front", daemon=True
        )
        self._thread.start()
        if not self._ready.wait(timeout=20):
            raise RuntimeError("kbfront backhaul failed to start")
        if self._start_error is not None:
            raise self._start_error

    def _thread_main(self) -> None:
        asyncio.run(self._main())

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        server = await asyncio.start_unix_server(self._on_backhaul, self.socket_path)
        binary = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "native", "front", "kbfront",
        )
        # one startup fork/exec before any stream is served: the loop is
        # not shared yet
        self._proc = subprocess.Popen(
            [binary, str(self.tcp_port), self.socket_path, self.host,
             *getattr(self, "_tls_args", [])],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL if os.environ.get("KB_FRONT_QUIET") else None,
        )
        # startup must fail loudly: wait for kbfront's READY line (printed
        # after bind+listen+backhaul connect) before reporting up
        loop = asyncio.get_running_loop()
        try:
            line = await asyncio.wait_for(
                loop.run_in_executor(None, self._proc.stdout.readline), timeout=10
            )
        except asyncio.TimeoutError:
            line = b""
        if b"READY" not in line:
            rc = self._proc.poll()
            self._start_error = RuntimeError(
                f"kbfront failed to start (rc={rc}) — port {self.tcp_port} in "
                "use, or libnghttp2 missing?"
            )
            self._proc.terminate()
            self._ready.set()
            return
        self._ready.set()
        async with server:
            while not self._closing:
                await asyncio.sleep(0.5)
                if self._proc.poll() is not None and not self._closing:
                    logger.critical(
                        "kbfront exited rc=%s; native frontend down",
                        self._proc.returncode,
                    )
                    return

    def close(self) -> None:
        self._closing = True
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
        if self._thread is not None:
            self._thread.join(timeout=5)
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    # --------------------------------------------------------------- framing
    _CORK_HIGH_WATER = 4 << 20

    def _send(self, cid: int, sid: int, kind: int, payload: bytes = b"") -> None:
        w = self._writer
        if w is None or w.is_closing():
            return
        frame = _HDR.pack(len(payload), cid, sid, kind) + payload
        self._cork.append(frame)
        self._cork_bytes += len(frame)
        if self._cork_bytes > self._CORK_HIGH_WATER and self._gate is not None:
            self._gate.clear()
        if self._cork_event is not None:
            self._cork_event.set()

    async def _send_gated(self, cid: int, sid: int, kind: int,
                          payload: bytes = b"") -> None:
        """_send for stream producers: waits out a backlogged backhaul first
        (the pump stalls, its hub queue fills, the hub drops it if slow)."""
        if self._gate is not None and not self._gate.is_set():
            await self._gate.wait()
        self._send(cid, sid, kind, payload)

    async def _flush_loop(self, writer: asyncio.StreamWriter) -> None:
        ev = self._cork_event
        try:
            while True:
                await ev.wait()
                ev.clear()
                if self._cork:
                    bufs, self._cork = self._cork, []
                    self._cork_bytes = 0
                    writer.write(b"".join(bufs))
                    await writer.drain()  # sole backpressure point
                    if self._gate is not None and self._cork_bytes <= self._CORK_HIGH_WATER:
                        self._gate.set()
        except asyncio.CancelledError:
            raise
        except Exception:
            # ANY transport failure: the backhaul is done for — don't leave
            # producers parked on a gate nobody will ever open
            logger.exception("backhaul flusher died; closing writer")
            writer.close()
        finally:
            if self._gate is not None:
                self._gate.set()

    def _send_end(self, cid: int, sid: int, status: int = 0, msg: str = "") -> None:
        raw = msg.encode()[:65535]
        self._send(cid, sid, K_END, struct.pack("<IH", status, len(raw)) + raw)

    async def _on_backhaul(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._writer = writer
        self._cork_event = asyncio.Event()
        self._gate = asyncio.Event()
        self._gate.set()
        self._flusher = asyncio.get_running_loop().create_task(
            self._flush_loop(writer))
        logger.info("kbfront connected on %s", self.socket_path)
        buf = b""
        try:
            while True:
                chunk = await reader.read(1 << 16)
                if not chunk:
                    break
                buf += chunk
                off = 0
                n = len(buf)
                while n - off >= 13:
                    plen, cid, sid, kind = _HDR.unpack_from(buf, off)
                    if n - off - 13 < plen:
                        break
                    payload = buf[off + 13:off + 13 + plen]
                    off += 13 + plen
                    self._handle(cid, sid, kind, payload)
                buf = buf[off:]
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            if self._flusher is not None:
                self._flusher.cancel()
                self._flusher = None
            self._cork.clear()
            self._cork_bytes = 0
            if self._gate is not None:
                self._gate.set()  # unblock producers so their tasks can exit
            for key, st in list(self._streams.items()):
                if st.task is not None:
                    st.task.cancel()
            self._streams.clear()
            self._unary_pending.clear()
            # detach the connection from the unix server: on Python 3.12
            # the server's wait_closed (the exit of `async with server` in
            # _main) waits for every connection's transport to close, and
            # would hold close() to its join timeout with the loop thread
            # left running
            writer.close()

    # -------------------------------------------------------------- dispatch
    def _handle(self, cid: int, sid: int, kind: int, payload: bytes) -> None:
        """Frame dispatch. Unary RPCs take a fast path with NO task and no
        queue: the request is buffered on START/MSG and the terminal runs
        inline at HALF_CLOSE — per-op cost is a dict hit + protobuf decode +
        the backend op. Task machinery (~the cost of the op itself) is
        reserved for genuinely streaming methods."""
        key = (cid, sid)
        if kind == K_START:
            path = payload.decode()
            u = self.unary.get(path)
            if u is not None:
                self._unary_pending[key] = [u, b""]
                return
            st = _Stream()
            self._streams[key] = st
            st.task = asyncio.ensure_future(self._run_stream(cid, sid, path, st))
        elif kind == K_MSG:
            pending = self._unary_pending.get(key)
            if pending is not None:
                pending[1] = payload
                return
            st = self._streams.get(key)
            if st is not None:
                try:
                    st.queue.put_nowait(payload)
                except asyncio.QueueFull:
                    self._send(cid, sid, K_RST)
                    self._drop(key)
        elif kind == K_HALF_CLOSE:
            pending = self._unary_pending.pop(key, None)
            if pending is not None:
                if self._inline_unary:
                    self._unary_finish(cid, sid, pending)
                else:
                    loop = asyncio.get_running_loop()
                    fut = loop.run_in_executor(
                        None, self._unary_compute, pending)
                    fut.add_done_callback(
                        lambda f, c=cid, s=sid: self._unary_done(c, s, f))
                return
            st = self._streams.get(key)
            if st is not None:
                st.half_closed = True
                st.queue.put_nowait(None)
        elif kind == K_RST:
            self._unary_pending.pop(key, None)
            self._drop(key)
        elif kind == K_HTTP:
            asyncio.ensure_future(self._run_http(cid, sid, payload.decode()))

    def _drop(self, key) -> None:
        st = self._streams.pop(key, None)
        if st is not None and st.task is not None:
            st.task.cancel()

    # ----------------------------------------------------------- unary paths
    @staticmethod
    def _unary_compute(pending):
        """The handler call itself (inline or in the executor)."""
        (req_cls, fn), raw = pending
        return fn(req_cls.FromString(raw), _SYNC_CTX)

    def _unary_reply(self, cid: int, sid: int, result) -> None:
        """ONE copy of the response/error protocol: result() yields the
        response message or raises."""
        try:
            resp = result()
            out = bytes(resp) if isinstance(resp, bytes) else resp.SerializeToString()
            w = self._writer
            if w is not None and not w.is_closing():
                # MSG + END corked as one frame pair; counted against the
                # high-water gate (unary sends bypass the gate but their
                # bytes must still backpressure the stream producers)
                frame = (
                    _HDR.pack(len(out), cid, sid, K_MSG) + out
                    + _HDR.pack(6, cid, sid, K_END) + _END_OK
                )
                self._cork.append(frame)
                self._cork_bytes += len(frame)
                if self._cork_bytes > self._CORK_HIGH_WATER and self._gate is not None:
                    self._gate.clear()
                if self._cork_event is not None:
                    self._cork_event.set()
        except _AbortError as e:
            self._send_end(cid, sid, _status_num(e.code), e.details)
        except Exception as exc:
            logger.exception("front unary failed")
            self._send_end(
                cid, sid, _status_num(grpc.StatusCode.INTERNAL), str(exc))

    def _unary_finish(self, cid: int, sid: int, pending) -> None:
        self._unary_reply(cid, sid, lambda: self._unary_compute(pending))

    def _unary_done(self, cid: int, sid: int, fut) -> None:
        self._unary_reply(cid, sid, fut.result)

    # --------------------------------------------------------------- streams
    async def _run_stream(self, cid: int, sid: int, path: str, st: _Stream) -> None:
        # unary paths never reach here — _handle's fast path serves them
        # inline without a task
        key = (cid, sid)
        try:
            if path == "/etcdserverpb.Watch/Watch":
                await self._run_watch(cid, sid, st)
            elif path == "/etcdserverpb.Lease/LeaseKeepAlive":
                from ..server.etcd.misc import ERR_NOT_LEADER, LeaseNotLeaderError

                loop = asyncio.get_running_loop()
                while True:
                    raw = await st.queue.get()
                    if raw is None:
                        break
                    req = rpc_pb2.LeaseKeepAliveRequest.FromString(raw)
                    # real refresh via the shared registry; the scheduler
                    # SYSTEM-lane submit blocks, so keep it off the loop
                    try:
                        resp = await loop.run_in_executor(
                            None, self.lease.keepalive_one, req)
                    except LeaseNotLeaderError:
                        self._send_end(
                            cid, sid,
                            _status_num(grpc.StatusCode.UNAVAILABLE),
                            ERR_NOT_LEADER)
                        return
                    self._send(cid, sid, K_MSG, resp.SerializeToString())
                self._send_end(cid, sid, 0)
            elif path in self.sstream:
                req_cls, fn = self.sstream[path]
                first = await st.queue.get()
                request = req_cls.FromString(first or b"")
                loop = asyncio.get_running_loop()
                ctx = _SyncContextAdapter()
                gen = fn(request, ctx)
                it = iter(gen)
                try:
                    while True:
                        resp = await loop.run_in_executor(None, next, it, None)
                        if resp is None:
                            break
                        await self._send_gated(cid, sid, K_MSG, resp.SerializeToString())
                except _AbortError as e:
                    self._send_end(cid, sid, _status_num(e.code), e.details)
                    return
                self._send_end(cid, sid, 0)
            elif path == "/grpc.health.v1.Health/Check":
                from ..proto import health_pb2
                resp = health_pb2.HealthCheckResponse(status=1)  # SERVING
                self._send(cid, sid, K_MSG, resp.SerializeToString())
                self._send_end(cid, sid, 0)
            else:
                self._send_end(
                    cid, sid, _status_num(grpc.StatusCode.UNIMPLEMENTED),
                    f"unknown method {path}")
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # terminal bug: surface as INTERNAL
            logger.exception("front stream %s failed", path)
            self._send_end(cid, sid, _status_num(grpc.StatusCode.INTERNAL), str(exc))
        finally:
            self._streams.pop(key, None)

    def _header(self):
        from ..server.etcd import shim
        return shim.header(self.backend.current_revision())

    async def _run_watch(self, cid: int, sid: int, st: _Stream) -> None:
        """Drive the shared AioWatchService against a backhaul-fed iterator."""
        async def req_iter():
            while True:
                raw = await st.queue.get()
                if raw is None:
                    return
                yield rpc_pb2.WatchRequest.FromString(raw)

        ctx = _FrontStreamContext()
        try:
            async for resp in self.watch.Watch(req_iter(), ctx):
                await self._send_gated(cid, sid, K_MSG, resp.SerializeToString())
        except _AbortError as e:
            self._send_end(cid, sid, _status_num(e.code), e.details)
            return
        self._send_end(cid, sid, 0)

    async def _run_http(self, cid: int, sid: int, req: str) -> None:
        """Plain-HTTP on the gRPC port (cmux parity): /health /status
        /election /metrics /debug/*."""
        parts = req.split(" ", 1)
        path = parts[1] if len(parts) == 2 else "/"
        path, _, qs = path.partition("?")
        handlers = self.server.http_handlers() if self.server is not None else {}
        try:
            if path in handlers:
                from .endpoint import http_call

                loop = asyncio.get_running_loop()
                _ctype, body = await loop.run_in_executor(
                    None, http_call(handlers[path], qs))
                self._send(cid, sid, K_END, struct.pack("<IH", 200, 0) + body)
            elif path == "/metrics" and self.metrics is not None:
                loop = asyncio.get_running_loop()
                _ctype, body = await loop.run_in_executor(
                    None, self.metrics.http_handler())
                self._send(cid, sid, K_END, struct.pack("<IH", 200, 0) + body)
            else:
                self._send(cid, sid, K_END,
                           struct.pack("<IH", 404, 0) + b"not found\n")
        except Exception as exc:
            logger.exception("front http %s failed", path)
            self._send(cid, sid, K_END,
                       struct.pack("<IH", 500, 0) + str(exc).encode())


class _FrontStreamContext:
    """Context shim for the aio watch coroutine."""

    def abort(self, code, details):
        raise _AbortError(code, details)

    async def write(self, *_a, **_k):  # pragma: no cover - not used
        raise NotImplementedError

    def is_active(self) -> bool:
        return True
