"""Follower→leader read-revision sync.

Reference: pkg/server/service/revision/revision.go — a follower cannot serve
reads from its stale local revision: before each read it HTTP-GETs the
leader's ``/status`` endpoint (which reports the committed revision,
server/server.go:151-165), deduplicated through a singleflight so a burst of
reads costs one round-trip (revision.go:114-128), with http/https schema
auto-probing (revision.go:142-209).
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Callable

SYNC_TIMEOUT_SECONDS = 1.0


# ---------------------------------------------------------------------------
# Revision-value helpers. Revisions are opaque monotonic tokens minted by
# the sequencer; every transformation the serving surface needs lives here
# so the etcd shim never invents revisions by raw arithmetic (kblint KB105
# enforces this over server/etcd/).

def is_list_over_watch(start_revision: int) -> bool:
    """Whether a WatchCreateRequest start_revision selects the
    list-over-watch protocol (negative = 'stream me a list')."""
    return int(start_revision) < 0


def decode_list_revision(start_revision: int) -> int:
    """The list revision a negative list-over-watch start_revision encodes
    (the protocol ships ``-rev``; 0 means 'latest')."""
    return -int(start_revision)


class RevisionSyncError(Exception):
    pass


class HttpRevisionSyncer:
    def __init__(
        self,
        get_leader_address: Callable[[], str | None],
        set_revision: Callable[[int], None],
        timeout: float = SYNC_TIMEOUT_SECONDS,
    ):
        self._get_leader_address = get_leader_address
        self._set_revision = set_revision
        self._timeout = timeout
        self._schema_cache: dict[str, str] = {}  # address -> working schema
        # singleflight: one in-flight sync; followers pile onto its result
        self._flight_lock = threading.Lock()
        self._flight: threading.Event | None = None
        self._flight_result: tuple[int | None, BaseException | None] = (None, None)

    def sync(self) -> int:
        """Fetch the leader revision and apply it locally; singleflighted."""
        with self._flight_lock:
            flight = self._flight
            if flight is None:
                flight = self._flight = threading.Event()
                owner = True
            else:
                owner = False
        if not owner:
            flight.wait(self._timeout * 2)
            rev, err = self._flight_result
            if err is not None:
                raise RevisionSyncError(str(err))
            if rev is None:
                raise RevisionSyncError("sync timed out")
            return rev
        try:
            rev = self._fetch()
            self._set_revision(rev)
            self._flight_result = (rev, None)
            return rev
        except BaseException as e:
            self._flight_result = (None, e)
            raise RevisionSyncError(str(e)) from e
        finally:
            with self._flight_lock:
                self._flight = None
            flight.set()

    def _fetch(self) -> int:
        return int(self.fetch_status()["revision"])

    def fetch_status(self) -> dict:
        """The leader's full /status payload, with http/https schema
        auto-probing + per-address caching — the ONE transport for every
        leader-status consumer (the follower fence and the replication
        stream's compact sync share it; docs/replication.md)."""
        address = self._get_leader_address()
        if not address:
            raise RevisionSyncError("no leader")
        schemas = [self._schema_cache.get(address)] if address in self._schema_cache else []
        schemas += [s for s in ("http", "https") if s not in schemas]
        last_err: BaseException | None = None
        for schema in schemas:
            if schema is None:
                continue
            try:
                payload = self._fetch_one(f"{schema}://{address}/status")
                self._schema_cache[address] = schema
                return payload
            except BaseException as e:  # wrong schema / transient: try next
                last_err = e
        raise RevisionSyncError(f"leader /status unreachable: {last_err}")

    def _fetch_one(self, url: str) -> dict:
        import ssl

        ctx = None
        if url.startswith("https"):
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE  # peer identity comes from the lock record
        with urllib.request.urlopen(url, timeout=self._timeout, context=ctx) as resp:
            return json.loads(resp.read().decode())
