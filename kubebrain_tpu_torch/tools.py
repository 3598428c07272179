"""Operational tooling: snapshot save/restore (the etcdctl-snapshot story).

``python -m kubebrain_tpu_torch.tools snapshot-save --endpoint host:2379 out.snap``
streams a consistent backup (Maintenance/Snapshot, KBSNAP1 framing);
``snapshot-restore`` replays it into a fresh server — engine-portable, so a
memkv-backed dev snapshot restores into a durable native deployment.

Counterpart of ``kubebrain_tpu/tools.py``, on the port's client and protos
(imported inside the commands).
"""

from __future__ import annotations

import argparse
import struct
import sys


def parse_snapshot(blob: bytes):
    """KBSNAP1 + be64(revision) + repeated (klen,key,vlen,value,be64 rev)."""
    if blob[:7] != b"KBSNAP1":
        raise ValueError("not a kubebrain-tpu snapshot (bad magic)")
    header_rev = struct.unpack(">Q", blob[7:15])[0]
    pos = 15
    out = []
    n = len(blob)
    while pos < n:
        (klen,) = struct.unpack(">I", blob[pos : pos + 4])
        pos += 4
        key = blob[pos : pos + klen]
        pos += klen
        (vlen,) = struct.unpack(">I", blob[pos : pos + 4])
        pos += 4
        value = blob[pos : pos + vlen]
        pos += vlen
        (rev,) = struct.unpack(">Q", blob[pos : pos + 8])
        pos += 8
        out.append((key, value, rev))
    return header_rev, out


def snapshot_save(endpoint: str, path: str) -> int:
    import grpc

    from .proto import rpc_pb2

    ch = grpc.insecure_channel(endpoint)
    snap = ch.unary_stream(
        "/etcdserverpb.Maintenance/Snapshot",
        request_serializer=rpc_pb2.SnapshotRequest.SerializeToString,
        response_deserializer=rpc_pb2.SnapshotResponse.FromString,
    )
    with open(path, "wb") as f:
        total = 0
        for resp in snap(rpc_pb2.SnapshotRequest()):
            f.write(resp.blob)
            total += len(resp.blob)
    ch.close()
    print(f"saved {total} bytes to {path}", file=sys.stderr)
    return 0


def snapshot_restore(endpoint: str, path: str) -> int:
    """Replay a snapshot's live keys into a (fresh) server as creates.
    Revisions are re-dealt — like etcd restores, the restored cluster has
    its own revision history."""
    from .client import EtcdCompatClient

    with open(path, "rb") as f:
        header_rev, kvs = parse_snapshot(f.read())
    c = EtcdCompatClient(endpoint)
    ok_count = 0
    for key, value, _rev in kvs:
        ok, _ = c.create(key, value)
        ok_count += int(ok)
    c.close()
    print(
        f"restored {ok_count}/{len(kvs)} keys (snapshot revision {header_rev})",
        file=sys.stderr,
    )
    return 0 if ok_count == len(kvs) else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kubebrain-torch-tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("snapshot-save", help="stream a backup from a server")
    s.add_argument("--endpoint", default="127.0.0.1:2379")
    s.add_argument("path")
    r = sub.add_parser("snapshot-restore", help="replay a backup into a server")
    r.add_argument("--endpoint", default="127.0.0.1:2379")
    r.add_argument("path")
    args = p.parse_args(argv)
    if args.cmd == "snapshot-save":
        return snapshot_save(args.endpoint, args.path)
    return snapshot_restore(args.endpoint, args.path)


if __name__ == "__main__":
    sys.exit(main())
