"""A recording metrics sink, after ``chip_smoke.RecordingMetrics``.

``cli.build_backend(args, metrics=sink)`` wires it wherever the port emits:
counters are summed and histogram samples kept by (name, tags), each with
the time it was emitted, so a per-layer reader takes the samples of a
window between two marks (:meth:`mark`) or by when they were emitted
(:meth:`timed`).
Gauges are not kept: no reader takes one.
"""

from __future__ import annotations

import collections
import threading
import time

from kubebrain_tpu_torch.metrics import Metrics


class RecordingMetrics(Metrics):
    def __init__(self):
        self.lock = threading.Lock()
        self.counters: collections.Counter = collections.Counter()
        self.histograms: dict = collections.defaultdict(list)
        self.emitted: dict = collections.defaultdict(list)

    @staticmethod
    def _key(name, tags):
        return name, tuple(sorted((k, str(v)) for k, v in tags.items()))

    def emit_counter(self, name, value=1, **tags):
        with self.lock:
            self.counters[self._key(name, tags)] += value

    def emit_gauge(self, name, value, **tags):
        pass

    def emit_histogram(self, name, value, **tags):
        t = time.monotonic()
        with self.lock:
            key = self._key(name, tags)
            self.histograms[key].append(value)
            self.emitted[key].append(t)

    def counter(self, name: str, **tags) -> float:
        """The counter ``name`` summed over its series that carry ``tags``."""
        want = set(self._key(name, tags)[1])
        with self.lock:
            return sum(v for (n, t), v in self.counters.items()
                       if n == name and want <= set(t))

    def mark(self) -> dict:
        """The samples held so far in each histogram series, for ``since``."""
        with self.lock:
            return {key: len(vs) for key, vs in self.histograms.items()}

    def samples(self, name: str, since: dict | None = None,
                until: dict | None = None, **tags) -> list:
        """The samples of the histogram ``name`` in its series that carry
        ``tags``: those after the mark ``since`` and up to the mark
        ``until``, where given."""
        want = set(self._key(name, tags)[1])
        since = since or {}
        with self.lock:
            return [v for key, vs in self.histograms.items()
                    if key[0] == name and want <= set(key[1])
                    for v in vs[since.get(key, 0):
                                None if until is None else until.get(key, 0)]]

    def timed(self, name: str, **tags) -> list:
        """Every sample of the histogram ``name`` in its series that carry
        ``tags``, as (``time.monotonic()`` when emitted, value)."""
        want = set(self._key(name, tags)[1])
        with self.lock:
            return [tv for key, vs in self.histograms.items()
                    if key[0] == name and want <= set(key[1])
                    for tv in zip(self.emitted[key], vs)]
