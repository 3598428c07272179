"""Read scale-out: stateless follower serving (docs/replication.md).

The first *horizontal* scaling axis (replicas x chips, vs the `part` mesh
axis's chips-per-replica). A follower process keeps its own storage stack
(including the device mirror when --storage=cuda) fed by a resumable
replication stream from the leader — the etcd Watch protocol over the
whole keyspace, ridden through the client's WatchMux resume machinery —
and serves reads locally under an explicit consistency contract:

- explicit-revision reads <= the applied watermark: served locally,
  byte-identical to the leader by construction (same MVCC rows, same
  scanner stack);
- bounded-staleness reads (``serializable=true``): served locally at the
  applied watermark while the replica's lag stays inside
  ``--max-staleness-rev`` / ``--max-staleness-ms``; past the bound the
  follower REFUSES (``etcdserver: replica too stale``) instead of
  answering stale — clients fail over;
- linearizable reads (rev-0, serializable=false): a TSO revision fence —
  fetch the leader's committed revision, wait until the local watermark
  reaches it, then serve locally;
- writes, lease RPCs, and Compact: forwarded to the leader with status
  passthrough (an ambiguous forward failure stays ambiguous).

Reference: the kubebrain service layer's follower role (PAPER.md §1:
follower→leader revision sync + etcd-proxy write forwarding), extended
with the explicit-revision snapshot serving that the MVCC multiversion
line of work (PAPERS.md) shows needs no coordination at all.

Counterpart of ``kubebrain_tpu/replica/__init__.py`` with the same
exports, but ``ReplicationStream`` resolves on first access (a module
``__getattr__``): the stream rides the client, which imports ``grpc``,
and the CLI's ``build_backend`` imports this package without it.
"""

from .apply import ReplicaApplier
from .role import (
    FenceTimeoutError,
    FollowerConfig,
    FollowerRole,
    FutureRevisionWaitError,
    LeaderUnreachableError,
    ReplicaRefusedError,
    StaleReplicaError,
)

__all__ = [
    "FollowerConfig",
    "FollowerRole",
    "ReplicaApplier",
    "ReplicationStream",
    "ReplicaRefusedError",
    "StaleReplicaError",
    "FenceTimeoutError",
    "FutureRevisionWaitError",
    "LeaderUnreachableError",
]


def __getattr__(name: str):
    if name == "ReplicationStream":
        from .stream import ReplicationStream

        return ReplicationStream
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
