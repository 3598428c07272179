"""etcd3 protocol shim (reference pkg/server/etcd)."""

from .server import make_etcd_handlers

__all__ = ["make_etcd_handlers"]
