"""The pluggable key-value engine contract.

Reference: pkg/storage/interface.go:28-156 and docs/storage_engine.md:3-15.
An engine must provide: a logical clock (timestamp oracle), a shard map
(partitions), snapshot point reads, bidirectional snapshot range iteration,
and atomic conditional write batches whose commit can report *uncertainty*.
MVCC (revisions, tombstones, watch) is built entirely above this contract by
``kubebrain_tpu_torch.backend``; the engine only ever sees opaque internal keys.

Engines shipped in this package:

- ``memkv``   — in-memory versioned sorted map, the test fake
                (reference pkg/storage/memkv).
- ``native``  — C++ host engine with a WAL, over ctypes (reference's Badger
                role).
- ``remote``  — client of the ``kbstored`` storage daemon over TCP
                (reference's TiKV client role).
- ``cuda``    — a host engine (any of the above) plus a sorted block mirror
                held in GPU memory; range scans, counts and compaction
                victims run as CUDA kernels over it.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Callable, Iterator

from .errors import (
    CASFailedError,
    Conflict,
    KeyNotFoundError,
    StorageError,
    UncertainResultError,
)

__all__ = [
    "Partition",
    "BatchWrite",
    "Iter",
    "KvStorage",
    "Conflict",
    "CASFailedError",
    "KeyNotFoundError",
    "UncertainResultError",
    "StorageError",
    "new_storage",
]


@dataclass(frozen=True)
class Partition:
    """A contiguous key-range shard [left, right) of the engine's key space.

    Reference: pkg/storage/interface.go:150. For distributed engines these are
    real placement shards (TiKV regions); for the cuda engine they are the
    mirror's partition ranges.
    An empty ``right`` means "unbounded above".
    """

    left: bytes
    right: bytes


class Iter(abc.ABC):
    """Streaming snapshot iterator over [start, end).

    Reference: pkg/storage/interface.go:125. Iteration is *reverse* when the
    constructor received start > end (used by the point-get path,
    pkg/backend/range.go:83-121).
    """

    @abc.abstractmethod
    def next(self) -> tuple[bytes, bytes]:
        """Return the next (key, value); raise StopIteration when drained."""

    def __iter__(self) -> Iterator[tuple[bytes, bytes]]:
        while True:
            try:
                yield self.next()
            except StopIteration:
                return

    def close(self) -> None:  # pragma: no cover - default no-op
        pass


class BatchWrite(abc.ABC):
    """An atomic conditional write batch.

    Reference: pkg/storage/interface.go:81-123. Ops are recorded in order;
    ``commit`` applies all-or-nothing. Conditional ops that lose raise
    ``CASFailedError`` carrying a ``Conflict`` (index + observed value).
    ``commit`` raises ``UncertainResultError`` when the outcome is unknowable
    (interface.go:104) — the caller must treat the write as *maybe applied*.
    """

    @abc.abstractmethod
    def put_if_not_exist(self, key: bytes, value: bytes, ttl_seconds: int = 0) -> None: ...

    @abc.abstractmethod
    def cas(self, key: bytes, new_value: bytes, old_value: bytes, ttl_seconds: int = 0) -> None: ...

    @abc.abstractmethod
    def put(self, key: bytes, value: bytes, ttl_seconds: int = 0) -> None: ...

    @abc.abstractmethod
    def delete(self, key: bytes) -> None: ...

    @abc.abstractmethod
    def del_current(self, key: bytes, expected_value: bytes) -> None:
        """Delete ``key`` only if its current value equals ``expected_value``
        (reference DelCurrent — delete-if-unchanged)."""

    @abc.abstractmethod
    def commit(self) -> None: ...


class KvStorage(abc.ABC):
    """The engine contract (reference KvStorage, pkg/storage/interface.go:34).

    Requirements (docs/storage_engine.md:3-15): snapshot reads, bidirectional
    traversal, CAS write transactions, an exposed logical clock; snapshot
    isolation and linearizable writes.
    """

    @abc.abstractmethod
    def get_timestamp_oracle(self) -> int:
        """Current logical clock; any snapshot_ts <= this is a valid snapshot."""

    @abc.abstractmethod
    def get_partitions(self, start: bytes, end: bytes) -> list[Partition]:
        """Shard map of [start, end), clamped to the range. Never empty."""

    @abc.abstractmethod
    def get(self, key: bytes, snapshot_ts: int | None = None) -> bytes:
        """Point read at a snapshot (latest when None). KeyNotFoundError on miss."""

    @abc.abstractmethod
    def iter(
        self,
        start: bytes,
        end: bytes,
        snapshot_ts: int | None = None,
        limit: int = 0,
    ) -> Iter:
        """Range iterator at a snapshot; reverse iteration when start > end."""

    @abc.abstractmethod
    def begin_batch_write(self) -> BatchWrite: ...

    def delete(self, key: bytes) -> None:
        """Unconditional single delete (reference KvStorage.Del)."""
        b = self.begin_batch_write()
        b.delete(key)
        b.commit()

    def del_current(self, key: bytes, expected_value: bytes) -> None:
        """Single delete-if-unchanged (reference KvStorage.DelCurrent)."""
        b = self.begin_batch_write()
        b.del_current(key, expected_value)
        b.commit()

    def support_ttl(self) -> bool:
        """Whether the engine expires TTL'd entries natively.

        Reference: badger.go:48 returns True, TiKV/memkv False — when False the
        compaction path expires ``/events/`` keys itself (scanner.go:566-591).
        """
        return False

    def exclusive_client(self) -> "KvStorage":
        """An isolated handle for bulk maintenance (compaction) so GC I/O does
        not contend with serving traffic. Reference: ExclusiveKvStorage,
        pkg/storage/interface.go:28-31. Default: self."""
        return self

    def make_scanner(self, **kwargs):
        """Engines that bring their own scan offload (the ``cuda`` engine)
        return a backend Scanner here; None selects the generic iterator
        scanner. Mirrors how the reference picks partition-parallel scan
        behavior from the engine's GetPartitions shape."""
        return None

    def close(self) -> None:  # pragma: no cover - default no-op
        pass


_FACTORIES: dict[str, Callable[..., KvStorage]] = {}


def unwrap_store(store, attr: str):
    """Walk a decorator stack (cuda mirror → …) down ``_inner``
    links until a layer offering ``attr`` appears; cycle-safe. Returns None
    when no layer has it. Shared by the admin surfaces (Defragment,
    /tier/failover) so the unwrap rule cannot diverge."""
    seen: set = set()
    while store is not None and id(store) not in seen:
        seen.add(id(store))
        if hasattr(store, attr):
            return store
        store = getattr(store, "_inner", None)
    return None


def register_engine(name: str, factory: Callable[..., KvStorage]) -> None:
    _FACTORIES[name] = factory


def new_storage(name: str, **kwargs) -> KvStorage:
    """Runtime engine selection — replaces the reference's compile-time Go
    build tags (cmd/option/option_badger.go:15 vs option_tikv.go:62)."""
    if name not in _FACTORIES:
        # Lazy-import shipped engines so `new_storage` works without callers
        # importing the adapter modules first.
        if name == "memkv":
            from . import memkv  # noqa: F401
        elif name == "cuda":
            from . import cuda  # noqa: F401
        elif name == "native":
            from . import native  # noqa: F401
        elif name == "remote":
            from . import remote  # noqa: F401
    if name not in _FACTORIES:
        raise ValueError(f"unknown storage engine {name!r}; have {sorted(_FACTORIES)}")
    return _FACTORIES[name](**kwargs)
