"""The plain reference: an MVCC key-value model and the judge of a run.

It imports nothing of the program. :class:`Model` is a dictionary of
version chains built from the dataset's records and the acknowledged writes
of a run, in revision order; it answers a Range, a Count and a point read
at any revision as etcd does, and works out what compaction to a revision
removes. :func:`judge` holds the program's outputs against it and returns
each number compared with its limit.
"""

from __future__ import annotations

import bisect
import random

CREATE, PUT, DELETE = "create", "put", "delete"


class Model:
    def __init__(self):
        #: user key -> [(revision, value or None for a delete)], ascending
        self.chains: dict[bytes, list[tuple[int, bytes | None]]] = {}
        self.keys: list[bytes] = []  # every key ever written, sorted
        self.head = 0

    def load(self, records) -> None:
        """Records ``(key, revision, value)`` in revision order."""
        chains = self.chains
        for key, rev, value in records:
            chain = chains.get(key)
            if chain is None:
                chains[key] = [(rev, value)]
            else:
                chain.append((rev, value))
            self.head = max(self.head, rev)
        self.keys = sorted(chains)

    def apply(self, verb: str, key: bytes, rev: int, value: bytes | None
              ) -> None:
        """One acknowledged write, in revision order."""
        chain = self.chains.get(key)
        if chain is None:
            self.chains[key] = chain = []
            bisect.insort(self.keys, key)
        chain.append((rev, None if verb == DELETE else value))
        self.head = max(self.head, rev)

    @staticmethod
    def _at(chain, rev: int):
        """(revision, value) of the newest version at or below ``rev``."""
        for r, v in reversed(chain):
            if r <= rev:
                return r, v
        return None

    def get(self, key: bytes, rev: int) -> tuple[bytes, int] | None:
        chain = self.chains.get(key)
        hit = self._at(chain, rev) if chain else None
        if hit is None or hit[1] is None:
            return None
        return hit[1], hit[0]

    def _keys_in(self, start: bytes, end: bytes):
        i = bisect.bisect_left(self.keys, start)
        j = bisect.bisect_left(self.keys, end)
        return self.keys[i:j]

    def range(self, start: bytes, end: bytes, rev: int, limit: int = 0
              ) -> tuple[list[tuple[bytes, bytes, int]], bool]:
        """Visible (key, value, mod revision) of [start, end) at ``rev``,
        the first ``limit`` (0: all), and whether more follow."""
        out = []
        i = bisect.bisect_left(self.keys, start)
        keys = self.keys
        while i < len(keys) and keys[i] < end:
            hit = self._at(self.chains[keys[i]], rev)
            if hit is not None and hit[1] is not None:
                if limit and len(out) == limit:
                    return out, True
                out.append((keys[i], hit[1], hit[0]))
            i += 1
        return out, False

    def count(self, start: bytes, end: bytes, rev: int) -> int:
        return sum(1 for k in self._keys_in(start, end)
                   if (hit := self._at(self.chains[k], rev)) is not None
                   and hit[1] is not None)

    def version_rows(self, start: bytes, end: bytes, rev: int) -> int:
        """Version rows (deletes included) of [start, end) at or below
        ``rev``: the rows a store that keeps every version holds there."""
        return sum(sum(1 for r, _v in self.chains[k] if r <= rev)
                   for k in self._keys_in(start, end))

    def victims(self, rev: int) -> int:
        """Version rows that compaction to ``rev`` removes: every version
        older than a key's newest version at or below ``rev``, and that
        newest version where it is a delete."""
        n = 0
        for chain in self.chains.values():
            at = [v for r, v in chain if r <= rev]
            if at:
                n += len(at) - 1 + (at[-1] is None)
        return n


def watch_events(writes, start: bytes, end: bytes, after: int) -> list:
    """What a watcher on [start, end) registered at revision ``after`` must
    receive: every acknowledged write in the range above it, in revision
    order, as (revision, verb, key, value; None for a delete)."""
    return [(rev, verb, key, None if verb == DELETE else value)
            for verb, key, value, rev, *_t in writes
            if start <= key < end and rev > after]


def _count(name: str, value, limit, what: list) -> dict:
    return {"name": name, "value": value, "limit": limit,
            "what": [str(w) for w in what[:5]]}


def judge(records, outputs) -> list[dict]:
    """Every number compared, with its limit: ``{"name", "value",
    "limit", "what"}``, where ``what`` names up to five of the cases that
    the number counts. ``records`` are the dataset's; ``outputs`` is what
    the program gave (``driver.Outputs``). Every limit is 0: the
    comparisons are exact."""
    model = Model()
    model.load(records)
    writes = sorted(outputs.acked, key=lambda w: w[3])
    revs = [w[3] for w in writes]
    checks = []

    # revisions: each acknowledged once, above the dataset's
    dup = [r for i, r in enumerate(revs) if i and revs[i - 1] == r]
    low = [r for r in revs if r <= model.head]
    checks.append(_count("duplicate_revisions", len(dup) + len(low), 0,
                         dup + low))

    # linearizable reads: no read revision below a write acknowledged
    # before the read was sent
    acks = sorted((w[5], w[3]) for w in writes)
    ack_t = [t for t, _r in acks]
    ack_max = []
    m = 0
    for _t, r in acks:
        m = max(m, r)
        ack_max.append(m)
    stale = []
    for t_send, read_rev, what in outputs.read_revisions:
        i = bisect.bisect_left(ack_t, t_send)
        if i and read_rev < ack_max[i - 1]:
            stale.append(f"{what} at {read_rev} < {ack_max[i - 1]}")
    checks.append(_count("stale_reads", len(stale), 0, stale))

    # the sampled answers, each at its own revision
    for verb, key, value, rev in (w[:4] for w in writes):
        model.apply(verb, key, rev, value)
    wrong = []
    for rev, kind, args, got in outputs.answers:
        if kind == "count":
            want = model.count(args[0], args[1], rev)
        elif kind == "get":
            want = model.get(args[0], rev)
        else:
            want = model.range(args[0], args[1], rev, args[2])
        if got != want:
            wrong.append(f"{kind} {args[0][:48]!r} at {rev}")
    checks.append(_count("wrong_answers", len(wrong), 0, wrong))

    # acknowledged writes read back at their revisions
    lost = []
    for verb, key, value, rev, got in outputs.readback:
        want = None if verb == DELETE else (value, rev)
        if got != want:
            lost.append(f"{verb} {key[:48]!r} at {rev}")
    checks.append(_count("lost_writes", len(lost), 0, lost))

    # the whole store at the head, and at the last compaction revision
    differ = []
    for rev, start, end, got in outputs.full_reads:
        want, _more = model.range(start, end, rev)
        if got != want:
            differ.append(f"{start!r} at {rev}: {len(got)} keys, "
                          f"reference {len(want)}")
    checks.append(_count("store_mismatch", len(differ), 0, differ))

    # every watcher's events
    bad = []
    for name, start, end, after, got in outputs.watched:
        want = watch_events(writes, start, end, after)
        if got != want:
            first = next((i for i, (a, b) in enumerate(zip(got, want))
                          if a != b), min(len(got), len(want)))
            bad.append(f"{name}: {len(got)} events, reference {len(want)}, "
                       f"first difference at {first}")
    checks.append(_count("watch_mismatch", len(bad), 0, bad))

    if outputs.compactions:
        crev = max(outputs.compactions)
        want = model.victims(crev)
        got = outputs.victims
        refused = [f"read at {r} served" for r in outputs.below_compaction]
        checks.append(_count("compaction_mismatch",
                             abs(got - want) + len(refused), 0,
                             [f"victims {got}, reference {want} at {crev}"]
                             * (got != want) + refused))

    checks.append(_count("unanswered", len(outputs.unanswered), 0,
                         outputs.unanswered))
    return checks


def sample(items: list, n: int, seed: int) -> list:
    """``n`` of ``items`` drawn from ``seed`` (all where there are fewer),
    with the last one always in."""
    if len(items) <= n:
        return list(items)
    rng = random.Random(f"kbbench-sample:{seed}")
    return rng.sample(items[:-1], n - 1) + [items[-1]]
