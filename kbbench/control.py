"""The control: the reference's model put in the program's place, with one
guarantee that the configurations state broken.

It serves the benchmark's requests from :class:`reference.Model` under one
lock, exactly, except that a read at the head (revision 0) is served from a
snapshot of the store refreshed every :data:`REFRESH_S` (a read cache),
which also answers the current revision, as a response header carries it:
a stale read, which a linearizable store never gives. ``python3 kbbench/run.py ... --control``
drives it through the same clients, watchers and checks as the program;
the checks have to find it not correct (``stale_reads`` above its limit).
"""

from __future__ import annotations

import itertools
import queue
import threading
from types import SimpleNamespace

from kbbench.reference import CREATE, DELETE, PUT, Model

VERB_CODE = {CREATE: 0, PUT: 1, DELETE: 2}
#: how often the control's read snapshot follows the store
REFRESH_S = 0.1


class Refused(Exception):
    """A write whose precondition failed (the key exists, or its revision
    moved)."""


class ControlBackend:
    def __init__(self, ds):
        self.model = Model()
        self.model.load(ds.records)
        self.lock = threading.Lock()
        self.watchers: dict[int, tuple[bytes, bytes, queue.Queue]] = {}
        self.ids = itertools.count(1)
        self.compacted = 0
        self._kb_scheduler = self
        self.snapshot = self.model.head
        self.halt = threading.Event()
        threading.Thread(target=self._refresh, daemon=True).start()

    def _refresh(self) -> None:
        while not self.halt.wait(REFRESH_S):
            self.snapshot = self.model.head

    def close(self) -> None:
        self.halt.set()

    # ------------------------------------------------------------- reads
    def current_revision(self) -> int:
        return self.snapshot  # the broken guarantee: the cache's revision

    def _read_rev(self, rev: int) -> int:
        return rev or self.snapshot  # the broken guarantee

    def list_(self, start, end, revision=0, limit=0, client=""):
        with self.lock:
            rev = self._read_rev(revision)
            if rev < self.compacted:
                from kubebrain_tpu_torch.backend.errors import CompactedError

                raise CompactedError(rev, self.compacted)
            kvs, more = self.model.range(start, end, rev, limit)
        return SimpleNamespace(revision=rev, more=more, kvs=[
            SimpleNamespace(key=k, value=v, revision=r) for k, v, r in kvs])

    def count(self, start, end, revision=0, client=""):
        with self.lock:
            rev = self._read_rev(revision)
            return self.model.count(start, end, rev), rev

    def get(self, key, revision=0):
        from kubebrain_tpu_torch.storage.errors import KeyNotFoundError

        with self.lock:
            hit = self.model.get(key, self._read_rev(revision))
        if hit is None:
            raise KeyNotFoundError(key)
        return SimpleNamespace(key=key, value=hit[0], revision=hit[1])

    # ------------------------------------------------------------ writes
    def _write(self, verb, key, value, expect):
        with self.lock:
            hit = self.model.get(key, self.model.head)
            if verb == CREATE and hit is not None:
                raise Refused("exists")
            if verb != CREATE and (hit is None or hit[1] != expect):
                raise Refused("revision moved")
            rev = self.model.head + 1
            self.model.apply(verb, key, rev, value)
            ev = SimpleNamespace(revision=rev, verb=VERB_CODE[verb], key=key,
                                 value=value or b"")
            for start, end, q in self.watchers.values():
                if start <= key < end:
                    q.put([ev])
            return rev

    def create(self, key, value, client=""):
        return self._write(CREATE, key, value, 0)

    def update(self, key, value, expected_revision, client=""):
        return self._write(PUT, key, value, expected_revision)

    def delete(self, key, expected_revision=0, client=""):
        return self._write(DELETE, key, None, expected_revision), None

    # ------------------------------------------------------- watch, compact
    def watch_range(self, start, end, revision=0):
        wid = next(self.ids)
        q = queue.Queue()
        with self.lock:
            self.watchers[wid] = (start, end, q)
        return wid, q

    def unwatch(self, wid):
        with self.lock:
            self.watchers.pop(wid, None)

    def compact(self, revision):
        with self.lock:
            self.compacted = max(self.compacted, revision)
        return revision
