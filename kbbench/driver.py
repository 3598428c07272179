"""The closed-loop clients, the watchers and the measured window.

One general generator: a traffic file (``kbbench/traffic/<mix>.json``)
names the clients, the loop, the operations with their shares of the
requests, the watchers and whether compaction runs; a configuration file
names the resources they act on. Each client draws its operations from its
own seeded stream and owns a disjoint share of every resource's keys, so
its compare-and-swap writes never race another client's.

In a closed loop (``"loop": "closed"``) a client sends its next request
when the last is answered. In an open loop (``"loop": "open"``) the mix
offers ``rate`` requests a second: each client sends one every
``clients / rate`` seconds from a phase drawn from the seed, so every seed
offers the same number of requests, and a request's latency runs from when
it was due, so a client that falls behind counts its wait.

Requests enter where the etcd services enter below the gRPC front:
Range, Count and Txn through the request scheduler
(``backend._kb_scheduler``), a single-key Range on ``Backend.get``, Watch on
``Backend.watch_range`` and Compact on ``Backend.compact``.
"""

from __future__ import annotations

import math
import os
import queue
import random
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field

from kbbench.dataset import Dataset, prefix_end, random_suffix, value_of
from kbbench.reference import CREATE, DELETE, PUT, sample

from kubebrain_tpu_torch import cli, coder
from kubebrain_tpu_torch.backend.common import LAST_REV_KEY
from kubebrain_tpu_torch.backend.errors import CompactedError
from kubebrain_tpu_torch.backend.watcherhub import ProgressMarker
from kubebrain_tpu_torch.sched import SchedOverloadError, SchedResultTimeoutError
from kubebrain_tpu_torch.storage.errors import KeyNotFoundError

VERBS = (CREATE, PUT, DELETE)  # the port's Verb values 0, 1, 2
#: rows to a batch when the store is loaded
LOAD_BATCH = 1024
#: how long a client or a watcher may take to finish after the window
DRAIN_S = 90.0


# ------------------------------------------------------------------ boot
def load_store(ds: Dataset, engine) -> None:
    """Write the dataset into ``engine``: every version row, each key's
    revision record and the store's last revision, through the engine's
    own batches."""
    last: dict[bytes, int] = {}
    recs = ds.records
    for b0 in range(0, len(recs), LOAD_BATCH):
        bw = engine.begin_batch_write()
        for key, rev, value in recs[b0:b0 + LOAD_BATCH]:
            bw.put(coder.encode_object_key(key, rev), value)
            last[key] = rev
        bw.commit()
    items = list(last.items())
    for b0 in range(0, len(items), LOAD_BATCH):
        bw = engine.begin_batch_write()
        for key, rev in items[b0:b0 + LOAD_BATCH]:
            bw.put(coder.encode_revision_key(key), coder.encode_rev_value(rev))
        bw.commit()
    bw = engine.begin_batch_write()
    bw.put(LAST_REV_KEY, coder.encode_rev_value(ds.top))
    bw.commit()


def boot(config: dict, ds: Dataset, data_dir: str, sink, device: str):
    """The Backend as the port's CLI boots one (``cli.build_backend`` with
    the configuration's flags, over a native engine on ``data_dir``), the
    dataset written straight into its host engine underneath the mirror
    (``store.untracked()``), the revision sequence seeded at the dataset's
    top (``Backend.set_current_revision``, as a leader's start seeds it)
    and the mirror's first publish, by the engine's bulk export. The
    loaded log is made durable before the window (:func:`flush_dir`).
    Returns (backend, (seconds of the boot, of the load, of the
    publish))."""
    t0 = time.monotonic()
    args = cli.build_parser().parse_args(
        [*config["cli_flags"], "--data-dir", data_dir, "--device", device])
    backend, store, _peers = cli.build_backend(args, metrics=sink)
    t1 = time.monotonic()
    try:
        load_store(ds, store.untracked())
        flush_dir(data_dir)
        backend.set_current_revision(ds.top)
        t2 = time.monotonic()
        backend.scanner.publish()
    except BaseException:
        backend.close()
        raise
    return backend, (t1 - t0, t2 - t1, time.monotonic() - t2)


# --------------------------------------------------------------- traffic
def request_shares(traffic: dict, ds: Dataset) -> list[tuple[dict, float]]:
    """Each operation with the weight of one draw: a namespace LIST walk
    issues one request per page, so its draws are rarer by the pages a walk
    takes and the traffic file's shares stay shares of the requests."""
    out = []
    for op in traffic["ops"]:
        per_draw = 1
        if op["op"] == "list_walk":
            res = ds.resources[op["resource"]]
            per_ns = len(res.keys) // len(res.namespaces)
            per_draw = max(1, math.ceil(per_ns / op["page"]))
        out.append((op, op["share"] / per_draw))
    total = sum(w for _op, w in out)
    return [(op, w / total) for op, w in out]


@dataclass
class Outputs:
    """What the program gave, for ``reference.judge``."""

    acked: list = field(default_factory=list)
    read_revisions: list = field(default_factory=list)
    answers: list = field(default_factory=list)
    readback: list = field(default_factory=list)
    full_reads: list = field(default_factory=list)
    watched: list = field(default_factory=list)
    compactions: list = field(default_factory=list)
    victims: int = 0
    below_compaction: list = field(default_factory=list)
    unanswered: list = field(default_factory=list)


class Client(threading.Thread):
    """One client. Closed loop: its warm-up operations, then operations
    until ``stop``, without a pause between the two. Open loop: a request
    every ``period`` from the schedule's start until the window's end.
    Records every request as ``(class, t_send, t_done, ok)`` (class ``r``
    or ``w``; ``t_send`` is the due time in an open loop), every
    acknowledged write, the read revision of every head read and the
    answers drawn for the check."""

    def __init__(self, run: "Run", i: int):
        super().__init__(name=f"kbbench-client-{i}", daemon=True)
        self.run_ = run
        self.i = i
        self.name_ = f"kbbench-{i}"
        self.rng = random.Random(f"kbbench-client:{run.seed}:{i}")
        self.sched = run.backend._kb_scheduler
        self.backend = run.backend
        self.ops: list = []
        self.acked: list = []
        self.read_revs: list = []
        self.answers: list = []
        self.errors: list = []
        self.n = 0
        #: the due time of the request being sent, in an open loop
        self.due: float | None = None
        n_clients = run.traffic["clients"]
        #: the keys this client owns, by resource: live ones, and their
        #: mod revisions
        self.owned: dict[str, list[bytes]] = {}
        self.modrev: dict[bytes, int] = {}
        for name, res in run.ds.resources.items():
            mine = res.keys[i::n_clients]
            self.owned[name] = list(mine)
            for k in mine:
                self.modrev[k] = run.last_rev[k]

    # ------------------------------------------------------------ helpers
    def _value(self, res) -> bytes:
        self.n += 1
        lo, hi = res.value_bytes
        return value_of(self.run_.ds.payload, self.rng, lo, hi,
                        b"#c%d-%d" % (self.i, self.n))

    def _sent(self) -> float:
        """When the request being sent counts as sent: its due time, once,
        in an open loop; now otherwise."""
        due, self.due = self.due, None
        return time.monotonic() if due is None else due

    def _record(self, cls: str, t0: float, ok: bool) -> None:
        self.ops.append((cls, t0, time.monotonic(), ok))

    def _checked(self) -> bool:
        return self.rng.random() < self.run_.traffic["check_share"]

    def _fail(self, cls: str, t0: float, what: str, e: Exception) -> None:
        """A request that got no answer: a shed (SchedOverloadError, never
        dealt a revision) is a failed request; any other error, or a
        dispatched request whose outcome is unknown, is also reported."""
        self._record(cls, t0, False)
        if isinstance(e, SchedResultTimeoutError) or not isinstance(
                e, (SchedOverloadError, CompactedError)):
            self.errors.append(f"{what}: {type(e).__name__}: {e}")

    # ---------------------------------------------------------- operations
    def _write(self, verb: str, key: bytes, value: bytes | None, fn) -> int:
        t0 = self._sent()
        try:
            rev = fn()
        except Exception as e:  # reported by the check, not raised
            self._fail("w", t0, f"{verb} {key!r}", e)
            return 0
        t1 = time.monotonic()
        self.ops.append(("w", t0, t1, True))
        self.acked.append((verb, key, value, rev, t0, t1))
        return rev

    def op_update(self, op):
        res = self.run_.ds.resources[op["resource"]]
        owned = self.owned[op["resource"]]
        key = owned[self.rng.randrange(len(owned))]
        value = self._value(res)
        prev = self.modrev[key]
        rev = self._write(PUT, key, value, lambda: self.sched.update(
            key, value, prev, client=self.name_))
        if rev:
            self.modrev[key] = rev

    def op_create(self, op):
        res = self.run_.ds.resources[op["resource"]]
        if res.namespaces:
            ns = res.namespaces[self.rng.randrange(len(res.namespaces))]
            key = res.prefix + ns + b"/churn-%03d-%07d" % (self.i, self.n)
        else:
            tag = b"c%03dn%08d" % (self.i, self.n)
            key = res.prefix + tag + random_suffix(
                self.rng, res.key_bytes - len(res.prefix) - len(tag))
        value = self._value(res)
        rev = self._write(CREATE, key, value, lambda: self.sched.create(
            key, value, client=self.name_))
        if rev:
            self.owned[op["resource"]].append(key)
            self.modrev[key] = rev

    def op_delete(self, op):
        owned = self.owned[op["resource"]]
        j = self.rng.randrange(len(owned))
        key = owned[j]
        prev = self.modrev[key]
        rev = self._write(DELETE, key, None, lambda: self.sched.delete(
            key, prev, client=self.name_)[0])
        if rev:
            owned[j] = owned[-1]
            owned.pop()

    def op_get(self, op):
        """A single-key Range at the head of a key the store started with,
        answered as the etcd KV service answers one: ``Backend.get``, then
        the response header's revision, the store's current revision (at
        least the key's)."""
        res = self.run_.ds.resources[op["resource"]]
        key = res.keys[self.rng.randrange(len(res.keys))]
        check = self._checked()
        rev = self.backend.current_revision() if check else 0
        t0 = self._sent()
        t_real = time.monotonic()
        try:
            kv = self.backend.get(key, 0)
            got = (bytes(kv.value), kv.revision)
            header = max(self.backend.current_revision(), kv.revision)
        except KeyNotFoundError:
            got = None
            header = self.backend.current_revision()
        except Exception as e:  # reported by the check, not raised
            self._fail("r", t0, f"get {key!r}", e)
            return
        self._record("r", t0, True)
        self.read_revs.append((t_real, header, f"get {key!r}"))
        if check:
            self.answers.append((rev, "get", (key,), got))

    def op_count(self, op):
        res = self.run_.ds.resources[op["resource"]]
        check = self._checked()
        t0 = self._sent()
        t_real = time.monotonic()
        try:
            n, rev = self.sched.count(res.prefix, res.end, 0,
                                      client=self.name_)
        except Exception as e:  # reported by the check, not raised
            self._fail("r", t0, f"count {res.prefix!r}", e)
            return
        self._record("r", t0, True)
        self.read_revs.append((t_real, rev, f"count {res.prefix!r}"))
        if check:
            self.answers.append((rev, "count", (res.prefix, res.end), n))

    def _page(self, kind: str, start: bytes, end: bytes, rev: int,
              limit: int):
        check = self._checked()
        t0 = self._sent()
        t_real = time.monotonic()
        try:
            res = self.sched.list_(start, end, rev, limit, client=self.name_)
        except Exception as e:  # reported by the check, not raised
            self._fail("r", t0, f"{kind} {start!r} at {rev}", e)
            return None
        self._record("r", t0, True)
        if not rev:
            self.read_revs.append((t_real, res.revision,
                                   f"{kind} {start!r}"))
        if check:
            self.answers.append((res.revision, kind, (start, end, limit), res))
        return res

    def op_list_page(self, op):
        res = self.run_.ds.resources[op["resource"]]
        start = res.keys[self.rng.randrange(len(res.keys))]
        self._page("cpage", start, res.end, 0, op["page"])

    def op_list_walk(self, op):
        """A client-go pager: pages of ``page`` through one namespace, each
        after the first pinned to the first page's revision."""
        res = self.run_.ds.resources[op["resource"]]
        ns = res.namespaces[self.rng.randrange(len(res.namespaces))]
        start = res.prefix + ns + b"/"
        end = prefix_end(start)
        rev = 0
        while True:
            page = self._page("page", start, end, rev, op["page"])
            if page is None or not page.more or self.run_.stop.is_set():
                return
            rev = page.revision
            start = page.kvs[-1].key + b"\0"

    def step(self) -> None:
        x = self.rng.random()
        for op, w in self.run_.shares:
            x -= w
            if x < 0:
                break
        getattr(self, "op_" + op["op"])(op)

    def run(self) -> None:
        try:
            if self.run_.period:
                self._open_loop()
                return
            for _ in range(self.run_.traffic["warmup_ops_per_client"]):
                self.step()
            self.run_.warmed()
            while not self.run_.stop.is_set():
                self.step()
        except Exception as e:  # reported by the check, not raised
            self.errors.append(f"client {self.i} stopped: "
                               f"{type(e).__name__}: {e}")
            self.run_.warmed()

    def _open_loop(self) -> None:
        """Every request due from the schedule's start to the window's end,
        each sent at its due time or, where the last one is still out,
        when that one is answered."""
        period = self.run_.period
        due = self.run_.base + self.rng.random() * period
        while due < self.run_.t1:
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            self.due = due
            self.step()
            due += period


class Watcher(threading.Thread):
    """One watch on [start, end) from the revision it was registered at,
    drained by a thread of its own; every event is stamped with the time
    its batch was taken off the queue."""

    def __init__(self, backend, name: str, start: bytes, end: bytes):
        super().__init__(name=f"kbbench-watch-{name}", daemon=True)
        self.backend = backend
        self.label = name
        self.start_, self.end = start, end
        self.after = backend.current_revision()
        self.wid, self.q = backend.watch_range(start, end, 0)
        self.events: list = []
        self.dropped = False
        self.halt = threading.Event()
        self.start()

    def run(self) -> None:
        while not self.halt.is_set():
            try:
                item = self.q.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is None:
                self.dropped = True
                return
            if isinstance(item, ProgressMarker):
                continue
            t = time.monotonic()
            self.events.extend((e.revision, VERBS[int(e.verb)], e.key,
                                e.value, t) for e in item)

    def last(self) -> int:
        return self.events[-1][0] if self.events else self.after

    def close(self) -> None:
        self.halt.set()
        self.join(timeout=DRAIN_S)
        self.backend.unwatch(self.wid)


class Run:
    """One cell's run: the clients, the watchers and the window."""

    def __init__(self, backend, ds: Dataset, config: dict, traffic: dict,
                 seed: int):
        self.backend = backend
        self.ds = ds
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.shares = request_shares(traffic, ds)
        self.last_rev: dict[bytes, int] = {}
        for key, rev, _v in ds.records:
            self.last_rev[key] = rev
        self.stop = threading.Event()
        self._cold = traffic["clients"]
        self._cold_lock = threading.Lock()
        self.all_warm = threading.Event()
        self.compactions: list[tuple[int, float, float]] = []
        self.compact_errors: list[str] = []
        self.watchers = [
            Watcher(backend, f"{w['resource']}-{j}", res.prefix, res.end)
            for w in traffic["watchers"]
            for res in (ds.resources[w["resource"]],)
            for j in range(w["count"])]
        #: an open loop's period per client, and the schedule's start
        self.period = (traffic["clients"] / traffic["rate"]
                       if traffic["loop"] == "open" else 0.0)
        self.base = 0.0
        self.clients = [Client(self, i) for i in range(traffic["clients"])]
        self.t0 = 0.0
        self.t1 = math.inf

    def warmed(self) -> None:
        """One more client has made its warm-up operations."""
        with self._cold_lock:
            self._cold -= 1
            if self._cold == 0:
                self.all_warm.set()

    def compact(self, rev: int) -> None:
        t = time.monotonic()
        try:
            self.backend.compact(rev)
        except Exception as e:  # reported by the check, not raised
            self.compact_errors.append(f"compact {rev}: {type(e).__name__}: {e}")
            return
        self.compactions.append((rev, t, time.monotonic()))

    def _compactor(self) -> None:
        """``Backend.compact`` every ``etcd_compaction_interval_s`` of the
        window, to the revision the store had one interval earlier."""
        every = self.config["etcd_compaction_interval_s"]
        rev = self.backend.current_revision()
        k = 1
        while not self.stop.wait(max(0.0, self.t0 + k * every - time.monotonic())):
            if time.monotonic() >= self.t1:
                return
            nxt = self.backend.current_revision()
            self.compact(rev)
            rev = nxt
            k += 1

    def warm_and_measure(self, seconds: float, on_start, on_stop) -> None:
        """Start the clients; when every one has made its warm-up
        operations (closed loop) or after the mix's ``warmup_s`` of its
        schedule (open loop), open the window (``on_start()`` first), keep
        it open ``seconds``, then stop them (``on_stop()`` after). A
        request counts in the window when it was sent inside it."""
        self.base = time.monotonic()
        for c in self.clients:
            c.start()
        if self.period:
            time.sleep(max(0.0, self.base + self.traffic["warmup_s"]
                           - time.monotonic()))
        else:
            self.all_warm.wait()
        on_start()
        self.t0 = time.monotonic()
        self.t1 = self.t0 + seconds
        comp = None
        if self.traffic["compaction"]:
            comp = threading.Thread(target=self._compactor, daemon=True)
            comp.start()
        time.sleep(max(0.0, self.t1 - time.monotonic()))
        self.stop.set()
        on_stop()
        if comp is not None:
            comp.join(timeout=DRAIN_S)

    def drain(self) -> list[str]:
        """Wait for every client's last request and for every watcher to
        see the last acknowledged write of its range; close the watchers.
        Returns what did not end."""
        late = []
        deadline = time.monotonic() + DRAIN_S
        for c in self.clients:
            c.join(timeout=max(0.0, deadline - time.monotonic()))
            if c.is_alive():
                late.append(f"client {c.i} still waiting {DRAIN_S} s "
                            "after the window")
        want = {}
        for w in self.watchers:
            want[w] = max((a[3] for c in self.clients for a in c.acked
                           if w.start_ <= a[1] < w.end), default=w.after)
        deadline = time.monotonic() + DRAIN_S
        while any(w.last() < want[w] and not w.dropped for w in self.watchers) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        for w in self.watchers:
            w.close()
            if w.dropped:
                late.append(f"watcher {w.label} dropped by the hub")
        return late

    # ------------------------------------------------------------ results
    def window_ops(self) -> list:
        return [o for c in self.clients for o in c.ops
                if self.t0 <= o[1] < self.t1]

    def latencies(self) -> dict:
        """Milliseconds of every read and write sent in the window and of
        every (write, watcher) pair (:meth:`watch_lags`); a failed request
        counts as longer than any limit."""
        lat = {"read": [], "write": []}
        for cls, t0, t1, ok in self.window_ops():
            lat["read" if cls == "r" else "write"].append(
                (t1 - t0) * 1e3 if ok else math.inf)
        lat["watch"] = self.watch_lags()
        return lat

    def e2e(self) -> dict:
        """The end-to-end metrics of the window (milliseconds)."""
        done = sum(1 for c in self.clients for o in c.ops
                   if o[3] and self.t0 <= o[2] < self.t1)
        lat = self.latencies()
        return {"ops_per_s": done / (self.t1 - self.t0),
                "read_p95_ms": percentile(lat["read"], 0.95),
                "write_p95_ms": percentile(lat["write"], 0.95),
                "watch_lag_p95_ms": percentile(lat["watch"], 0.95)}

    def watch_lags(self) -> list[float]:
        """Milliseconds from a write's send to each covering watcher's
        receipt, for every write acknowledged in the window."""
        recv = [{e[0]: e[4] for e in w.events} for w in self.watchers]
        out = []
        for c in self.clients:
            for verb, key, _v, rev, t0, t1 in c.acked:
                if not self.t0 <= t1 < self.t1:
                    continue
                for w, got in zip(self.watchers, recv):
                    if w.start_ <= key < w.end:
                        t = got.get(rev)
                        out.append(math.inf if t is None else (t - t0) * 1e3)
        return out

    def slices(self, width: float) -> list[int]:
        """Requests answered in each ``width`` seconds of the window."""
        n = max(1, math.ceil((self.t1 - self.t0) / width - 1e-9))
        out = [0] * n
        for c in self.clients:
            for _cls, _t0, t1, ok in c.ops:
                if ok and self.t0 <= t1 < self.t1:
                    out[min(n - 1, int((t1 - self.t0) / width))] += 1
        return out

    def counts(self) -> tuple[int, int]:
        ops = self.window_ops()
        return len(ops), sum(1 for o in ops if not o[3])

    def outputs(self, readback: int, sink) -> Outputs:
        """Everything the program answered, for the reference: gathered
        after the window, through the same Backend."""
        out = Outputs()
        for c in self.clients:
            out.acked += c.acked
            out.read_revisions += c.read_revs
            out.unanswered += c.errors
            for rev, kind, args, got in c.answers:
                if kind in ("page", "cpage"):
                    got = ([(kv.key, bytes(kv.value), kv.revision)
                            for kv in got.kvs], got.more)
                out.answers.append((rev, kind, args, got))
        out.unanswered += self.compact_errors
        for w in self.watchers:
            out.watched.append((w.label, w.start_, w.end, w.after,
                                [(r, v, k, None if v == DELETE else bytes(x))
                                 for r, v, k, x, _t in w.events]))
        b = self.backend
        floor = 0
        if self.compactions:
            floor = max(r for r, _a, _b in self.compactions)
            out.compactions = [r for r, _a, _b in self.compactions]
            out.victims = int(
                sink.counter("kb.compact.victims.total", kind="superseded")
                + sink.counter("kb.compact.victims.total", kind="tombstone"))
        writes = sorted((a for a in out.acked if a[3] >= floor),
                        key=lambda a: a[3])
        for verb, key, value, rev, _t0, _t1 in sample(writes, readback,
                                                      self.seed):
            try:
                kv = b.get(key, rev)
                got = (bytes(kv.value), kv.revision)
            except KeyNotFoundError:
                got = None
            out.readback.append((verb, key, value, rev, got))
        head = b.current_revision()
        for rev in ([head, floor] if floor else [head]):
            for res in self.ds.resources.values():
                kvs = b.list_(res.prefix, res.end, rev, 0).kvs
                out.full_reads.append((rev, res.prefix, res.end, [
                    (kv.key, bytes(kv.value), kv.revision) for kv in kvs]))
        if floor:
            res = next(iter(self.ds.resources.values()))
            try:
                b.list_(res.prefix, res.end, floor - 1, 1)
                out.below_compaction.append(floor - 1)
            except CompactedError:
                pass
        return out


def percentile(samples: list[float], q: float) -> float:
    """Nearest-rank percentile (``workload/slo.py::percentile``)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, max(0, int(math.ceil(q * len(s))) - 1))]


def data_dir() -> str:
    """The native engine's directory, a fresh one under ``TMPDIR``."""
    return tempfile.mkdtemp(prefix="kbbench-store-")


def flush_dir(path: str) -> None:
    """``fsync`` every file under ``path``: the gigabyte of log the load
    wrote reaches the disk in set-up, not as write-back under the
    window's own commits."""
    for d, _dirs, files in os.walk(path):
        for f in files:
            fd = os.open(os.path.join(d, f), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


def disk_bytes(path: str) -> int:
    """Bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _dirs, files in os.walk(path) for f in files)


def remove(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)
