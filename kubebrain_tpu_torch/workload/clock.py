"""Simulated-time machinery: the deterministic event wheel the generator
schedules traffic on, and the pacer that maps simulated milliseconds onto
the real clock at replay.

The wheel is the determinism anchor: events pop in ``(time, insertion
seq)`` order, so two generations from the same seed walk the PRNG in the
identical order and emit byte-identical traces. Nothing in this module
reads the wall clock (kblint KB110); the pacer uses the monotonic clock
only, and only at replay time.
"""

from __future__ import annotations

import heapq
import time
from typing import Any, Iterator


class EventWheel:
    """Min-heap of ``(t_ms, seq, kind, ident)`` with insertion-order
    tie-break — simultaneous events replay in the order they were
    scheduled, never in heap-internal order."""

    def __init__(self) -> None:
        self._heap: list[tuple[int, int, str, Any]] = []
        self._seq = 0

    def push(self, t_ms: int, kind: str, ident: Any = None) -> None:
        if t_ms < 0:
            raise ValueError(f"negative event time {t_ms}")
        heapq.heappush(self._heap, (t_ms, self._seq, kind, ident))
        self._seq += 1

    def pop(self) -> tuple[int, str, Any]:
        t_ms, _seq, kind, ident = heapq.heappop(self._heap)
        return t_ms, kind, ident

    def peek_t(self) -> int:
        return self._heap[0][0]

    def __len__(self) -> int:
        return len(self._heap)

    def drain_until(self, horizon_ms: int) -> Iterator[tuple[int, str, Any]]:
        """Pop every event with ``t < horizon_ms`` in deterministic order."""
        while self._heap and self._heap[0][0] < horizon_ms:
            yield self.pop()


class ReplayPacer:
    """Open-loop dispatch clock: ``wait_until(t_ms)`` sleeps until the real
    instant simulated time ``t_ms`` maps to, and returns how late dispatch
    is running (0.0 when on schedule). Open-loop means the schedule never
    waits for completions — when the system under test falls behind, ops
    keep arriving and the lateness (plus queue backpressure) is the
    signal, exactly like real cluster traffic."""

    def __init__(self, time_scale: float) -> None:
        if time_scale <= 0:
            raise ValueError("time_scale must be > 0")
        self._scale = time_scale
        self._t0 = time.monotonic()
        self.max_lag_s = 0.0

    def wait_until(self, t_ms: int) -> float:
        target = self._t0 + (t_ms / 1000.0) / self._scale
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
            return 0.0
        lag = -delay
        if lag > self.max_lag_s:
            self.max_lag_s = lag
        return lag

    def elapsed_s(self) -> float:
        return time.monotonic() - self._t0
