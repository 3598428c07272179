"""The runtime fault plane: one armed :class:`FaultPlane` per process maps
a deterministic :class:`~kubebrain_tpu_torch.faults.schedule.FaultSchedule` onto
the monotonic clock and answers injection decisions from every boundary
(docs/faults.md).

The plane is INERT until armed: decisions short-circuit to None/False so a
``--faults none`` server (or one whose runner never calls ``/faults/arm``)
takes exactly the un-instrumented code paths — the inertness contract the
chaos acceptance gate asserts byte-identically. Arming starts the window
clock and the watch-reset daemon; it happens over the info HTTP port so
the chaos runner can align windows with replay start (after preload).

Decision randomness is a seeded ``random.Random(seed)`` draw per boundary
call under one lock — runtime decision *counts* depend on op arrival (and
are reconciled injected-vs-observed in the SLO report); the schedule
itself is the deterministic replay identity (its sha).
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
from collections import Counter
from typing import Any

from ..storage.errors import StorageError, UncertainResultError
from . import schedule as _sched

logger = logging.getLogger("kubebrain")


class FaultInjectedError(StorageError):
    """Definite injected storage failure: nothing was applied."""


class FaultPlane:
    #: cadence of the watch-reset daemon's window polling
    WATCH_TICK_S = 0.25

    def __init__(self, sched: _sched.FaultSchedule,
                 metrics: Any = None) -> None:
        self.schedule = sched
        self._metrics = metrics
        self._lock = threading.Lock()
        self._rng = random.Random(sched.seed)
        self._t0: float | None = None  # None = not armed (inert)
        self._stop = threading.Event()
        self._hub = None  # WatcherHub, bound by the server wiring
        self._watch_thread: threading.Thread | None = None
        self.injected: Counter = Counter()

    # ------------------------------------------------------------- lifecycle
    def bind_hub(self, hub: Any) -> None:
        """Give the plane the watcher hub so armed ``watch_reset`` windows
        can drop live watch streams server-side."""
        self._hub = hub

    @property
    def armed(self) -> bool:
        with self._lock:
            return self._t0 is not None

    def arm(self) -> None:
        with self._lock:
            if self._t0 is not None:
                return
            self._t0 = time.monotonic()
        if self._hub is not None and any(
                w.kind == _sched.WATCH_RESET for w in self.schedule.windows):
            self._watch_thread = threading.Thread(
                target=self._watch_reset_loop, name="kb-fault-watchreset",
                daemon=True)
            self._watch_thread.start()
        logger.warning("fault plane ARMED: preset=%s seed=%d horizon=%dms "
                       "sha=%s", self.schedule.preset, self.schedule.seed,
                       self.schedule.horizon_ms, self.schedule.sha256())

    def close(self) -> None:
        self._stop.set()

    # -------------------------------------------------------------- plumbing
    def _elapsed_ms(self) -> int | None:
        # snapshot under the lock: arm() publishes _t0 under it, and this
        # runs on every injection-point probe across request threads and
        # the watch-reset daemon
        with self._lock:
            t0 = self._t0
        if t0 is None:
            return None
        return int((time.monotonic() - t0) * 1000)

    def _count(self, kind: str) -> None:
        with self._lock:
            self.injected[kind] += 1
        if self._metrics is not None:
            self._metrics.emit_counter("kb.faults.injected", 1, kind=kind)

    def _roll(self, rate: float) -> bool:
        with self._lock:
            return self._rng.random() < rate

    # -------------------------------------------------------------- storage
    def decide_storage(self, write: bool) -> tuple[str, float] | None:
        """One decision per storage boundary call. Returns None (no fault)
        or ``(kind, param)`` with kind one of ``latency`` / ``error`` /
        ``uncertain_applied`` / ``uncertain_dropped``. Reads only ever see
        latency/error — a read cannot be "maybe applied"."""
        t = self._elapsed_ms()
        if t is None:
            return None
        kinds = _sched.WRITE_KINDS if write else _sched.READ_KINDS
        for kind in kinds:
            for w in self.schedule.active(t, kind):
                if not self._roll(w.rate):
                    continue
                if kind == _sched.STORAGE_LATENCY:
                    self._count(kind)
                    return ("latency", w.param or 0.02)
                if kind == _sched.STORAGE_ERROR:
                    self._count(kind)
                    return ("error", 0.0)
                # uncertain: the injector itself flips whether the op
                # really committed — the layer above must treat both
                # identically (that asymmetry of knowledge IS the fault)
                applied = self._roll(0.5)
                self._count(kind)
                self._count(_sched.STORAGE_UNCERTAIN
                            + ("_applied" if applied else "_dropped"))
                return ("uncertain_applied" if applied
                        else "uncertain_dropped", 0.0)
        return None

    # ------------------------------------------------------------- endpoint
    def conn_drop(self) -> bool:
        """Abort this RPC as if the client's connection dropped (the
        endpoint interceptor consults this per unary call)."""
        t = self._elapsed_ms()
        if t is None:
            return False
        for w in self.schedule.active(t, _sched.CONN_DROP):
            if self._roll(w.rate):
                self._count(_sched.CONN_DROP)
                return True
        return False

    def _watch_reset_loop(self) -> None:
        while not self._stop.wait(self.WATCH_TICK_S):
            t = self._elapsed_ms()
            if t is None or t > self.schedule.horizon_ms:
                return
            for w in self.schedule.active(t, _sched.WATCH_RESET):
                if not self._roll(w.rate):
                    continue
                n = self._reset_watchers(int(w.param) or 1)
                for _ in range(n):
                    self._count(_sched.WATCH_RESET)

    def _reset_watchers(self, n: int) -> int:
        """Drop up to ``n`` seeded-randomly-chosen live watchers: their
        pumps see the hub poison pill and send the client the same
        retriable cancel a slow-consumer drop sends — the shape the client
        WatchMux must resume from (revision+1, no lost or dup events)."""
        hub = self._hub
        if hub is None:
            return 0
        wids = hub.watcher_ids()
        if not wids:
            return 0
        with self._lock:
            picks = self._rng.sample(wids, min(n, len(wids)))
        for wid in picks:
            hub.delete_watcher(wid)
        return len(picks)

    # ---------------------------------------------------------- cuda engine
    def merge_fault(self) -> bool:
        t = self._elapsed_ms()
        if t is None:
            return False
        for w in self.schedule.active(t, _sched.MERGE_FAIL):
            if self._roll(w.rate):
                self._count(_sched.MERGE_FAIL)
                return True
        return False

    def merge_fail_active(self) -> bool:
        """Pure window check (no roll, no count): the engine kicks merges
        eagerly while a merge-fail window is open so the failing-merge
        machinery is actually exercised — a fault window nothing runs in
        proves nothing."""
        t = self._elapsed_ms()
        if t is None:
            return False
        return any(True for _ in self.schedule.active(t, _sched.MERGE_FAIL))

    def merges_suppressed(self) -> bool:
        """Pure window check (no counting — the engine checks this per
        write). The engine reports actually-suppressed merge kicks via
        :meth:`note_suppressed_merge` so the injected counter reflects
        suppressed *merges*, not write ops."""
        t = self._elapsed_ms()
        if t is None:
            return False
        return any(True for _ in self.schedule.active(
            t, _sched.MERGE_SUPPRESS))

    def note_suppressed_merge(self) -> None:
        self._count(_sched.MERGE_SUPPRESS)

    def compact_fault(self) -> bool:
        """Fail the compaction's mirror half (stored-domain survivor
        merge), pre-mutation — the GC deletes stay durable; the engine's
        bounded retries then re-roll here, and exhausting them must
        escalate to quarantine + background rebuild (docs/compaction.md)."""
        t = self._elapsed_ms()
        if t is None:
            return False
        for w in self.schedule.active(t, _sched.COMPACT_FAIL):
            if self._roll(w.rate):
                self._count(_sched.COMPACT_FAIL)
                return True
        return False

    # -------------------------------------------------------- replica role
    def repl_reset(self) -> bool:
        """Tear the follower's replication stream down (checked once per
        stream ticker tick): the next pass must resume from the applied
        watermark + 1 with no event lost or duplicated."""
        t = self._elapsed_ms()
        if t is None:
            return False
        for w in self.schedule.active(t, _sched.REPL_RESET):
            if self._roll(w.rate):
                self._count(_sched.REPL_RESET)
                return True
        return False

    def leader_unreachable(self) -> bool:
        """Window gate consulted before every leader-touching action on a
        follower (fence fetch, write/lease forward, stream reconnect).
        Counted per gated action — both counter views (plane state and
        /metrics) increment together, so the chaos reconcile stays exact."""
        t = self._elapsed_ms()
        if t is None:
            return False
        for w in self.schedule.active(t, _sched.LEADER_UNREACH):
            if self._roll(w.rate):
                self._count(_sched.LEADER_UNREACH)
                return True
        return False

    def fence_timeout(self) -> bool:
        """Force a linearizable-read fence to report the follower stale
        (checked once per fence): the read must REFUSE, proving bounded
        staleness degrades to refusals, never stale answers."""
        t = self._elapsed_ms()
        if t is None:
            return False
        for w in self.schedule.active(t, _sched.FENCE_TIMEOUT):
            if self._roll(w.rate):
                self._count(_sched.FENCE_TIMEOUT)
                return True
        return False

    def encode_overflow(self) -> bool:
        t = self._elapsed_ms()
        if t is None:
            return False
        for w in self.schedule.active(t, _sched.ENCODE_OVERFLOW):
            if self._roll(w.rate):
                self._count(_sched.ENCODE_OVERFLOW)
                return True
        return False

    # ----------------------------------------------------------- HTTP admin
    def http_arm(self) -> tuple[str, bytes]:
        """GET /faults/arm — starts the window clock (chaos runner calls
        this when replay begins so windows align with replay time)."""
        self.arm()
        return ("application/json", json.dumps(
            {"armed": True, "sha256": self.schedule.sha256()}).encode())

    def http_state(self) -> tuple[str, bytes]:
        """GET /faults/state — schedule identity + injected counters, the
        server half of the report's injected/observed reconciliation."""
        with self._lock:
            injected = dict(self.injected)
        return ("application/json", json.dumps({
            "armed": self.armed,
            "schedule": self.schedule.to_dict(),
            "elapsed_ms": self._elapsed_ms(),
            "injected": injected,
        }).encode())

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.injected)


__all__ = ["FaultPlane", "FaultInjectedError", "UncertainResultError"]
