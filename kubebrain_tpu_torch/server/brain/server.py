"""Native protocol terminal + background jobs.

Reference: pkg/server/brain/{server,read,write}.go —

- every read syncs the read revision from the leader first
  (read.go:128,148,168,188,207);
- writes check leadership (write.go:363) and run with a bounded deadline
  (write.go:259);
- the leader runs a 60-second compaction loop compacting to
  ``current_revision - 1000`` (server.go:52,64-74).
"""

from __future__ import annotations

import threading

import grpc

from ...backend import (
    Backend,
    CASRevisionMismatchError,
    CompactedError,
    FutureRevisionError,
    KeyExistsError,
)
from ...sched import SchedOverloadError, SchedResultTimeoutError, client_of
from ...storage.errors import (
    KeyNotFoundError,
    StorageError,
    UncertainResultError,
)
from ...proto import brain_pb2
from ..etcd.server import _bidi, _unary

COMPACT_INTERVAL_SECONDS = 60.0
COMPACT_KEEP_REVISIONS = 1000


class BrainServer:
    def __init__(
        self,
        backend: Backend,
        peers=None,
        compact_interval: float = COMPACT_INTERVAL_SECONDS,
        compact_keep: int = COMPACT_KEEP_REVISIONS,
    ):
        self.backend = backend
        self.peers = peers
        self._compact_interval = compact_interval
        self._compact_keep = compact_keep
        self._stop = threading.Event()
        self._compact_thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle
    def start_background(self) -> None:
        """Leader campaign + compaction loop (reference server.go:51-52)."""
        if self.peers is not None:
            self.peers.campaign()
        self._compact_thread = threading.Thread(
            target=self._compact_loop, name="kb-compactor", daemon=True
        )
        self._compact_thread.start()

    def _compact_loop(self) -> None:
        while not self._stop.wait(self._compact_interval):
            if self.peers is not None and not self.peers.is_leader():
                continue
            target = self.backend.current_revision() - self._compact_keep
            if target > 0:
                try:
                    self.backend.compact(target)
                except Exception:
                    pass  # next tick retries

    def close(self) -> None:
        self._stop.set()

    # ----------------------------------------------------------------- reads
    def _sync_read(self):
        if self.peers is not None:
            self.peers.sync_read_revision()

    def Get(self, request, context) -> brain_pb2.GetResponse:
        self._sync_read()
        try:
            kv = self.backend.get(request.key, request.revision)
        except KeyNotFoundError:
            return brain_pb2.GetResponse(header_revision=self.backend.current_revision())
        except (CompactedError, FutureRevisionError) as e:
            context.abort(grpc.StatusCode.OUT_OF_RANGE, str(e))
        return brain_pb2.GetResponse(
            kv=brain_pb2.BrainKeyValue(key=kv.key, value=kv.value, revision=kv.revision),
            header_revision=self.backend.current_revision(),
        )

    def _sched(self):
        """Range reads share the etcd surface's admission scheduler: both
        protocols drain one device pipeline, so they must share one queue."""
        from ...sched import ensure_scheduler

        return ensure_scheduler(self.backend)

    def Range(self, request, context) -> brain_pb2.BrainRangeResponse:
        self._sync_read()
        try:
            res = self._sched().list_(
                request.start, request.end, request.revision, int(request.limit),
                client=self._client_of(context),
            )
        except SchedOverloadError as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except (CompactedError, FutureRevisionError) as e:
            context.abort(grpc.StatusCode.OUT_OF_RANGE, str(e))
        resp = brain_pb2.BrainRangeResponse(more=res.more, header_revision=res.revision)
        for kv in res.kvs:
            resp.kvs.add(key=kv.key, value=kv.value, revision=kv.revision)
        return resp

    def RangeStream(self, request, context):
        self._sync_read()
        try:
            rev, stream = self._sched().list_by_stream(
                request.start, request.end, request.revision,
                client=self._client_of(context),
            )
        except SchedOverloadError as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        for batch in stream:
            resp = brain_pb2.BrainRangeResponse(header_revision=rev)
            for kv in batch:
                resp.kvs.add(key=kv.key, value=kv.value, revision=kv.revision)
            yield resp

    def Count(self, request, context) -> brain_pb2.CountResponse:
        self._sync_read()
        try:
            n, rev = self._sched().count(
                request.start, request.end, client=self._client_of(context)
            )
        except SchedOverloadError as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        return brain_pb2.CountResponse(count=n, header_revision=rev)

    _client_of = staticmethod(client_of)  # fair-queuing flow id (sched)

    def ListPartition(self, request, context) -> brain_pb2.ListPartitionResponse:
        self._sync_read()
        parts = self.backend.get_partitions(request.start, request.end)
        resp = brain_pb2.ListPartitionResponse(
            header_revision=self.backend.current_revision()
        )
        resp.borders.append(parts[0].left)
        for p in parts:
            resp.borders.append(p.right)
        return resp

    # ---------------------------------------------------------------- writes
    def _check_leader_write(self, context):
        if self.peers is not None and not self.peers.is_leader():
            context.abort(grpc.StatusCode.UNAVAILABLE, "not leader")  # write.go:363

    def Create(self, request, context) -> brain_pb2.CreateResponse:
        self._check_leader_write(context)
        try:
            # writes ride the scheduler lanes + group commit like the etcd
            # surface (kblint KB106; docs/writes.md)
            rev = self._sched().create(request.key, request.value,
                                       client=self._client_of(context))
            return brain_pb2.CreateResponse(succeeded=True, revision=rev)
        except SchedResultTimeoutError:
            # post-dispatch wait timeout: outcome ambiguous, not a shed
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, "request timed out")
        except SchedOverloadError as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except KeyExistsError as e:
            return brain_pb2.CreateResponse(succeeded=False, revision=e.revision)
        except FutureRevisionError:
            # drift-back race (concurrent delete drew a higher revision):
            # definite failure, retry deals a fresh revision (write.go analog
            # of the etcd shim's mapping, server/etcd/kv.py)
            context.abort(grpc.StatusCode.UNAVAILABLE, "revision drift, retry")
        except UncertainResultError:
            # engine cannot know whether the commit landed: the same
            # ambiguous status as a result-wait timeout (docs/faults.md)
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, "request timed out")
        except StorageError as e:
            # definite engine refusal, nothing applied: safe to retry
            context.abort(grpc.StatusCode.UNAVAILABLE, f"storage error: {e}")

    def Update(self, request, context) -> brain_pb2.UpdateResponse:
        self._check_leader_write(context)
        try:
            rev = self._sched().update(request.key, request.value,
                                       request.expected_revision,
                                       client=self._client_of(context))
            return brain_pb2.UpdateResponse(succeeded=True, revision=rev)
        except SchedResultTimeoutError:
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, "request timed out")
        except SchedOverloadError as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except CASRevisionMismatchError as e:
            resp = brain_pb2.UpdateResponse(succeeded=False, revision=e.revision)
            if e.value is not None:
                resp.latest.key = request.key
                resp.latest.value = e.value
                resp.latest.revision = e.revision
            return resp
        except UncertainResultError:
            # engine cannot know whether the commit landed: the same
            # ambiguous status as a result-wait timeout (docs/faults.md)
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, "request timed out")
        except StorageError as e:
            # definite engine refusal, nothing applied: safe to retry
            context.abort(grpc.StatusCode.UNAVAILABLE, f"storage error: {e}")

    def Delete(self, request, context) -> brain_pb2.BrainDeleteResponse:
        self._check_leader_write(context)
        try:
            rev, prev = self._sched().delete(request.key,
                                             request.expected_revision,
                                             client=self._client_of(context))
            return brain_pb2.BrainDeleteResponse(
                succeeded=True,
                revision=rev,
                prev_kv=brain_pb2.BrainKeyValue(
                    key=prev.key, value=prev.value, revision=prev.revision
                ),
            )
        except SchedResultTimeoutError:
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, "request timed out")
        except SchedOverloadError as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except (KeyNotFoundError, CASRevisionMismatchError):
            return brain_pb2.BrainDeleteResponse(
                succeeded=False, revision=self.backend.current_revision()
            )
        except UncertainResultError:
            # engine cannot know whether the commit landed: the same
            # ambiguous status as a result-wait timeout (docs/faults.md)
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, "request timed out")
        except StorageError as e:
            # definite engine refusal, nothing applied: safe to retry
            context.abort(grpc.StatusCode.UNAVAILABLE, f"storage error: {e}")

    def Compact(self, request, context) -> brain_pb2.BrainCompactResponse:
        self._check_leader_write(context)
        done = self.backend.compact(request.revision)
        return brain_pb2.BrainCompactResponse(compacted_revision=done)

    # ----------------------------------------------------------------- watch
    def Watch(self, request, context):
        from ...backend import WatchExpiredError

        try:
            wid, q = self.backend.watch(request.prefix, request.start_revision)
        except WatchExpiredError:
            yield brain_pb2.BrainWatchResponse(
                expired=True, header_revision=self.backend.current_revision()
            )
            return
        import queue as _q

        try:
            while context.is_active():
                try:
                    batch = q.get(timeout=0.5)
                except _q.Empty:
                    continue
                if batch is None:
                    return
                resp = brain_pb2.BrainWatchResponse(
                    header_revision=self.backend.current_revision()
                )
                for ev in batch:
                    resp.events.add(
                        type=int(ev.verb),
                        revision=ev.revision,
                        prev_revision=ev.prev_revision,
                        kv=brain_pb2.BrainKeyValue(
                            key=ev.key, value=ev.value, revision=ev.revision
                        ),
                    )
                yield resp
        finally:
            self.backend.unwatch(wid)


def make_brain_handlers(server: BrainServer):
    p = brain_pb2
    s = server

    def unary_stream(fn, req_cls, resp_cls):
        return grpc.unary_stream_rpc_method_handler(
            fn, request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )

    return [
        grpc.method_handlers_generic_handler("brainpb.Brain", {
            "Create": _unary(s.Create, p.CreateRequest, p.CreateResponse),
            "Update": _unary(s.Update, p.UpdateRequest, p.UpdateResponse),
            "Delete": _unary(s.Delete, p.BrainDeleteRequest, p.BrainDeleteResponse),
            "Compact": _unary(s.Compact, p.BrainCompactRequest, p.BrainCompactResponse),
            "Get": _unary(s.Get, p.GetRequest, p.GetResponse),
            "Range": _unary(s.Range, p.BrainRangeRequest, p.BrainRangeResponse),
            "RangeStream": unary_stream(s.RangeStream, p.BrainRangeRequest, p.BrainRangeResponse),
            "Count": _unary(s.Count, p.CountRequest, p.CountResponse),
            "ListPartition": _unary(s.ListPartition, p.ListPartitionRequest, p.ListPartitionResponse),
            "Watch": unary_stream(s.Watch, p.BrainWatchRequest, p.BrainWatchResponse),
        }),
    ]
