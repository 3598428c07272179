"""Peer plumbing (reference pkg/server/service): leader election wrapper,
follower→leader revision sync, etcd-proxy write forwarding."""

from .peer import PeerService, SingleNodePeerService

__all__ = ["PeerService", "SingleNodePeerService"]
