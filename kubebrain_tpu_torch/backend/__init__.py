"""MVCC backend core (reference pkg/backend)."""

from .backend import Backend, BackendConfig, wait_for_revision
from .common import TOMBSTONE, KeyValue, RangeResult, Verb, WatchEvent
from .errors import (
    BackendError,
    CASRevisionMismatchError,
    CompactedError,
    FutureRevisionError,
    KeyExistsError,
    NotLeaderError,
    WatchExpiredError,
)

__all__ = [
    "Backend",
    "BackendConfig",
    "wait_for_revision",
    "KeyValue",
    "RangeResult",
    "Verb",
    "WatchEvent",
    "TOMBSTONE",
    "BackendError",
    "CompactedError",
    "FutureRevisionError",
    "KeyExistsError",
    "CASRevisionMismatchError",
    "NotLeaderError",
    "WatchExpiredError",
]
