"""Backend ⇄ etcd protobuf conversion.

Reference: pkg/server/etcd/backendshim.go — maps brain revisions into
``mvccpb.KeyValue{ModRevision, CreateRevision}`` and brain events into
``mvccpb.Event``. Like the reference, per-key create-revision/version
counters are not tracked by the MVCC core, so create_revision mirrors
mod_revision and version is 1 — kube-apiserver keys its optimistic
concurrency entirely off mod_revision.
"""

from __future__ import annotations

from ...backend.common import KeyValue, Verb, WatchEvent
from ...proto import kv_pb2, rpc_pb2


def to_kv(kv: KeyValue) -> kv_pb2.KeyValue:
    return kv_pb2.KeyValue(
        key=kv.key,
        value=kv.value,
        mod_revision=kv.revision,
        create_revision=kv.revision,
        version=1,
    )


def header(revision: int) -> rpc_pb2.ResponseHeader:
    return rpc_pb2.ResponseHeader(revision=revision)


def to_event(ev: WatchEvent, want_prev: bool = False) -> kv_pb2.Event:
    if ev.verb == Verb.DELETE:
        out = kv_pb2.Event(
            type=kv_pb2.Event.DELETE,
            kv=kv_pb2.KeyValue(key=ev.key, mod_revision=ev.revision),
        )
        if want_prev and ev.prev_value is not None:
            out.prev_kv.CopyFrom(
                kv_pb2.KeyValue(
                    key=ev.key, value=ev.prev_value,
                    mod_revision=ev.prev_revision, create_revision=ev.prev_revision,
                    version=1,
                )
            )
        return out
    out = kv_pb2.Event(
        type=kv_pb2.Event.PUT,
        kv=kv_pb2.KeyValue(
            key=ev.key, value=ev.value,
            mod_revision=ev.revision,
            create_revision=ev.revision if ev.verb == Verb.CREATE else ev.prev_revision or ev.revision,
            version=1,
        ),
    )
    if want_prev and ev.prev_value is not None:
        out.prev_kv.CopyFrom(
            kv_pb2.KeyValue(
                key=ev.key, value=ev.prev_value,
                mod_revision=ev.prev_revision, create_revision=ev.prev_revision,
                version=1,
            )
        )
    return out
