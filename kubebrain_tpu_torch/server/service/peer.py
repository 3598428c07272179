"""PeerService — the composite the RPC terminals depend on.

Reference: pkg/server/service/peer_service.go:28-68
(PeerService = RevisionSyncer + LeaderElection + EtcdProxy). Identity format
is "host:peerPort" (cmd/option/option.go:234-238); the leader's client port
(for proxying) is derived by swapping the port.
"""

from __future__ import annotations

from ...backend import Backend
from ...backend.election import LeaderElection, ResourceLock, StubLeaderElection
from .etcdproxy import DisabledEtcdProxy, EtcdProxy
from .revision import HttpRevisionSyncer, RevisionSyncError


class PeerService:
    def __init__(
        self,
        backend: Backend,
        identity: str,
        client_port: int,
        enable_proxy: bool = False,
        on_leader_change=None,
    ):
        self.backend = backend
        self.identity = identity
        self._client_port = client_port
        host = identity.rsplit(":", 1)[0]
        self.election = LeaderElection(
            ResourceLock(
                backend.store, identity,
                meta={"client": f"{host}:{client_port}"},
            ),
            on_started_leading=self._on_started_leading,
            # default: reset the term (drop watchers, poison the scan
            # mirror) — the reference's panic-on-leader-loss contract
            on_stopped_leading=on_leader_change or backend.reset_term,
        )
        self.syncer = HttpRevisionSyncer(self.leader_peer_address, backend.set_current_revision)
        self.proxy = EtcdProxy(self.leader_client_address) if enable_proxy else DisabledEtcdProxy()

    REVISION_GUARD = 1000  # headroom for revisions dealt-but-unpersisted by a crashed leader

    def _on_started_leading(self, start_revision: int) -> None:
        """Seed the revision sequencer on taking leadership (reference
        leader.go:96-107 → backend.SetCurrentRevision): the max of the lock
        record's engine clock, the persisted last-committed-revision
        watermark, and our local view — plus a guard so revisions a crashed
        leader dealt to *failed* ops (never persisted anywhere) cannot be
        re-dealt in the new term."""
        seed = max(
            start_revision,
            self.backend.recover_revision(),
            self.backend.current_revision(),
        )
        self.backend.set_current_revision(seed + self.REVISION_GUARD)

    # -------------------------------------------------------------- addresses
    def leader_peer_address(self) -> str | None:
        if self.election.is_leader():
            return self.identity
        return self.election.leader_identity()

    def leader_client_address(self) -> str | None:
        """The leader's client (gRPC) address, published in the election
        record meta; falls back to swapping the peer port for same-config
        deployments."""
        if self.election.is_leader():
            host = self.identity.rsplit(":", 1)[0]
            return f"{host}:{self._client_port}"
        rec = self.election._lock.get()
        import time as _time

        if rec is None or rec.expired(_time.time()):
            return None
        if rec.meta and rec.meta.get("client"):
            return rec.meta["client"]
        host = rec.holder.rsplit(":", 1)[0]
        return f"{host}:{self._client_port}"

    # ------------------------------------------------------------- contract
    def is_leader(self) -> bool:
        return self.election.is_leader()

    def campaign(self) -> None:
        self.election.campaign()

    def sync_read_revision(self) -> None:
        """Followers sync the read revision from the leader before every read
        (reference revision.go:114-128, read.go:128); failure fails the read."""
        if self.election.is_leader():
            return
        self.syncer.sync()

    def forward_txn(self, request):
        return self.proxy.forward_txn(request)

    def forward_watch(self, request_iterator):
        return self.proxy.forward_watch(request_iterator)

    def close(self) -> None:
        self.election.close()
        self.proxy.close()


class SingleNodePeerService:
    """Always-leader, no peers (stub election, reference leader/stub.go)."""

    def __init__(self, backend: Backend, identity: str = "local"):
        self.backend = backend
        self.identity = identity
        self.election = StubLeaderElection(identity)

    def is_leader(self) -> bool:
        return True

    def campaign(self) -> None:
        pass

    def sync_read_revision(self) -> None:
        pass

    def forward_txn(self, request):  # noqa: ARG002
        return None

    def forward_watch(self, request_iterator):  # noqa: ARG002
        return None

    def leader_peer_address(self) -> str:
        return self.identity

    def close(self) -> None:
        pass


__all__ = ["PeerService", "SingleNodePeerService", "RevisionSyncError"]
