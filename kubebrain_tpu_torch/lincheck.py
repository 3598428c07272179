"""Porcupine-style linearizability checker for MVCC op histories (the
port's copy of ``kubebrain_tpu/lincheck.py``, unchanged in behavior).

The reference lists Jepsen-style verification as an open TODO (its
README's TODO list); this module closes it with an offline
checker in the style of Porcupine / Wing-Gong: record every client
operation as a (call_ts, return_ts, result) interval, then search for a
legal linearization — a total order consistent with real time in which
every operation's observed result matches a sequential MVCC register.

Structure exploited:

- All point ops (create / update / delete / get) name a single user key, so
  the history is P-compositional: check each key independently against a
  single-register model, which turns one exponential search into many tiny
  ones (Horn & Kroening, "Faster linearizability checking via
  P-compositionality").
- Successful writes carry the globally-allocated revision, which must be
  unique and must respect real time ACROSS keys (A returned before B was
  called => rev(A) < rev(B)); that cross-key slice is checked directly in
  O(n log n) rather than by search.

Unknown outcomes (client crashed / UncertainResultError mid-failover) are
modeled the Jepsen way: the op either never took effect or took effect at
some point after its call — both branches are searched. Its revision is
unknown, so the model tracks an UNKNOWN revision that a later read or CAS
may observe (permissive: UNKNOWN matches any expected revision).

Usage:
    h = History()
    h.record(client, "create", key, call, ret, value=v, ok=True, rev=r)
    res = h.check()           # {"ok": bool, "violation": str | None, ...}
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

UNKNOWN_REV = -1  # revision of a write whose outcome was never observed


@dataclass
class Op:
    client: int
    kind: str  # create | update | delete | get
    key: bytes
    call: float
    ret: float  # math.inf when the client never saw a response
    value: bytes | None = None  # written value (writes) / returned value (get)
    prev_rev: int = 0  # expected revision for update / conditional delete
    ok: bool | None = None  # None = outcome unknown
    rev: int = 0  # revision returned on success / mod_revision of a get
    err: str | None = None  # "conflict" | "notfound" when ok is False
    conflict_rev: int = 0  # revision carried by a conflict error (0 = not captured)


# A per-key register state: (exists, value, revision). revision is the mod
# revision of the latest write, or UNKNOWN_REV right after an unknown write,
# or the tombstone's revision after a delete (exists=False).
_INIT = (False, b"", 0)


def _apply(op: Op, state):
    """Sequential MVCC-register model. Returns the list of states the key can
    be in after `op` executes atomically from `state` — [] when the observed
    result is impossible from `state`."""
    exists, value, rev = state
    known = rev != UNKNOWN_REV

    if op.kind == "get":
        if op.ok:
            if not exists or value != op.value:
                return []
            if known and rev != op.rev:
                return []
            # a read of an unknown-rev write reveals its revision
            return [(True, value, op.rev)]
        else:  # not found
            return [] if exists else [state]

    if op.ok is None:
        # outcome unknown: "took effect" branch (skip branch handled by caller)
        if op.kind == "create":
            return [] if exists else [(True, op.value, UNKNOWN_REV)]
        if op.kind == "update":
            if not exists or (known and rev != op.prev_rev):
                return []
            return [(True, op.value, UNKNOWN_REV)]
        if op.kind == "delete":
            if not exists or (op.prev_rev and known and rev != op.prev_rev):
                return []
            return [(False, b"", UNKNOWN_REV)]
        return []

    if op.kind == "create":
        if op.ok:
            if exists or (known and op.rev <= rev):
                return []
            return [(True, op.value, op.rev)]
        # conflict must be justified by a live key (create's only failure)
        if not exists:
            return []
        if op.conflict_rev and known and op.conflict_rev != rev:
            return []
        return [state]

    if op.kind == "update":
        if op.ok:
            if not exists or (known and rev != op.prev_rev) or (known and op.rev <= rev):
                return []
            return [(True, op.value, op.rev)]
        if op.err == "conflict":
            # justified iff the key is missing or at a different revision;
            # an UNKNOWN rev may or may not equal prev_rev — permissive
            if exists and known and rev == op.prev_rev:
                return []
            if op.conflict_rev and exists and known and op.conflict_rev != rev:
                return []
            return [state]
        return []

    if op.kind == "delete":
        if op.ok:
            if not exists or (op.prev_rev and known and rev != op.prev_rev):
                return []
            if known and op.rev <= rev:
                return []
            return [(False, b"", op.rev)]
        if op.err == "notfound":
            return [] if exists else [state]
        if op.err == "conflict":
            if not exists:
                return []
            if known and op.prev_rev and rev == op.prev_rev:
                return []
            return [state]
        return []

    raise ValueError(f"unknown op kind {op.kind!r}")


class BudgetExhausted(Exception):
    """The Wing-Gong search was truncated before reaching a verdict.

    A truncated search proves nothing — in particular it must NOT count as a
    pass (the histories hard enough to exhaust the budget are exactly the
    ones most likely to hide an anomaly). check() surfaces this as a failed
    result unless the caller explicitly opts into permissive mode."""


def _search_segment(ops: list[Op], seeds, node_budget: int, nodes: int,
                    collect_finals: bool, total_ops: int):
    """Wing-Gong search over one segment with memoization on
    (remaining-set, state), seeded with every state the previous segment
    could have ended in.

    An op may be linearized first among the remaining ops iff no other
    remaining op returned before it was called. Unknown-outcome ops may also
    be dropped entirely (they never took effect).

    When collect_finals is set, enumerates ALL reachable end states (needed
    to seed the next segment); otherwise exits on the first complete
    linearization. Returns (ok, finals, nodes). Raises BudgetExhausted when
    the shared node budget runs out before a verdict."""
    n = len(ops)
    calls = [o.call for o in ops]
    rets = [o.ret for o in ops]
    # Symmetry reduction: two ops with the same observable signature are
    # interchangeable — their _apply effect is identical, so among the ones
    # currently available it suffices to expand ONLY the smallest-ret one
    # (both branches). Soundness: availability (call < min_ret(remaining))
    # is monotone as ops are removed, so any schedule that takes an
    # identical sibling now can be rewritten to take the minimal-ret op now
    # and the sibling at the later slot, and keeping the larger-ret sibling
    # only raises min_ret for everyone else. This collapses the 2^k subsets
    # of k identical unknown-outcome writes (e.g. a failover window full of
    # uncertain creates carrying the same per-client value) to k+1 prefixes.
    sigs = [
        (o.kind, o.value, o.prev_rev, o.ok, o.rev, o.err, o.conflict_rev)
        for o in ops
    ]
    full = (1 << n) - 1
    seen: set = set()
    finals: set = set()
    stack = [(full, s) for s in seeds]
    while stack:
        mask, state = stack.pop()
        if mask == 0:
            if not collect_finals:
                return True, finals, nodes
            finals.add(state)
            continue
        key = (mask, state)
        if key in seen:
            continue
        seen.add(key)
        nodes += 1
        if nodes > node_budget:
            n_unknown = sum(1 for o in ops if o.ok is None)
            raise BudgetExhausted(
                f"key {ops[0].key!r}: search budget ({node_budget} nodes) "
                f"exhausted over {total_ops} ops — no verdict "
                f"(segment: {n} ops, {n_unknown} unknown-outcome, "
                f"{len(seeds)} seed states)"
            )
        min_ret = math.inf
        m = mask
        while m:
            i = (m & -m).bit_length() - 1
            m &= m - 1
            if rets[i] < min_ret:
                min_ret = rets[i]
        chosen: dict = {}  # signature -> available index with minimal ret
        m = mask
        while m:
            i = (m & -m).bit_length() - 1
            m &= m - 1
            if calls[i] >= min_ret:
                continue
            j = chosen.get(sigs[i])
            if j is None or rets[i] < rets[j]:
                chosen[sigs[i]] = i
        for i in chosen.values():
            op = ops[i]
            for nxt in _apply(op, state):
                stack.append((mask & ~(1 << i), nxt))
            if op.ok is None:
                # the unacknowledged op may simply never have happened
                stack.append((mask & ~(1 << i), state))
    return bool(finals), finals, nodes


def _check_key(ops: list[Op], node_budget: int = 2_000_000):
    """Per-key search, decomposed at quiescent cuts.

    A cut is a point in real time that no op interval spans: every earlier
    op returned strictly before every later op was called. Real-time order
    then forces ALL pre-cut ops before ALL post-cut ops in any
    linearization, so the history factors into segments that compose
    through their reachable end states — turning one exponential search
    over hundreds of ops into many small ones. Open-window ops
    (ret = inf, i.e. unknown outcomes) span every later cut and keep their
    segment intact, preserving Jepsen semantics.

    Returns (ok, why, nodes_searched). Raises BudgetExhausted when the
    node budget runs out before a verdict."""
    ops = sorted(ops, key=lambda o: (o.call, o.ret))
    n = len(ops)
    if n == 0:
        return True, None, 0
    segments: list[list[Op]] = []
    seg_start = 0
    max_ret = -math.inf
    for i, o in enumerate(ops):
        if i > seg_start and o.call > max_ret:
            segments.append(ops[seg_start:i])
            seg_start = i
        if o.ret > max_ret:
            max_ret = o.ret
    segments.append(ops[seg_start:])

    seeds: set = {_INIT}
    nodes = 0
    for si, seg in enumerate(segments):
        last = si == len(segments) - 1
        ok, finals, nodes = _search_segment(
            seg, seeds, node_budget, nodes,
            collect_finals=not last, total_ops=n)
        if not ok:
            first = seg[0]
            return False, (
                f"key {first.key!r}: no legal linearization of {n} ops "
                f"(segment of {len(seg)} starting {first.kind} "
                f"@ {first.call:.6f})"
            ), nodes
        seeds = finals
    return True, None, nodes


class History:
    """Collects ops (thread-safe append via list.append) and checks them."""

    def __init__(self):
        self.ops: list[Op] = []

    def record(self, client, kind, key, call, ret, **kw):
        self.ops.append(Op(client=client, kind=kind, key=key, call=call, ret=ret, **kw))

    # -------------------------------------------------------------- checks
    def _check_global_revisions(self):
        """Revisions are a global TSO: unique, and real-time ordered across
        keys (if A returned before B was called, rev(A) < rev(B))."""
        import bisect

        writes = [
            o for o in self.ops
            if o.kind != "get" and o.ok and o.rev > 0
        ]
        by_rev: dict[int, Op] = {}
        for o in writes:
            if o.rev in by_rev:
                return (
                    f"revision {o.rev} allocated twice "
                    f"({by_rev[o.rev].kind} {by_rev[o.rev].key!r} and {o.kind} {o.key!r})"
                )
            by_rev[o.rev] = o
        ends = sorted((o.ret, o.rev) for o in writes if o.ret != math.inf)
        end_times = [e[0] for e in ends]
        max_rev_prefix = []
        mx = 0
        for _, r in ends:
            mx = max(mx, r)
            max_rev_prefix.append(mx)
        for o in sorted(writes, key=lambda w: w.call):
            idx = bisect.bisect_left(end_times, o.call) - 1
            if idx >= 0 and max_rev_prefix[idx] >= o.rev:
                return (
                    f"real-time violation: {o.kind} {o.key!r} got rev {o.rev} "
                    f"but a write with rev >= {max_rev_prefix[idx]} had already returned "
                    f"before it was called"
                )
        return None

    def check(self, node_budget: int = 2_000_000, strict: bool = True) -> dict:
        """Check the whole history. Strict by default: a key whose search
        exhausts the node budget FAILS the check (no verdict is not a pass).
        Pass strict=False only for exploratory runs; the result then carries
        truncated_keys so the caller can still see what was unproven.

        The result always records nodes_searched (total) and max_key_nodes so
        soaks can size their histories to fit the budget with headroom."""
        v = self._check_global_revisions()
        if v is not None:
            return {"ok": False, "violation": v, "ops": len(self.ops)}
        per_key: dict[bytes, list[Op]] = {}
        for o in self.ops:
            per_key.setdefault(o.key, []).append(o)
        total_nodes = 0
        max_key_nodes = 0
        truncated: list[bytes] = []
        for key, ops in per_key.items():
            try:
                ok, why, nodes = _check_key(ops, node_budget=node_budget)
            except BudgetExhausted as e:
                if strict:
                    return {
                        "ok": False,
                        "violation": str(e),
                        "truncated": True,
                        "ops": len(self.ops),
                        "nodes_searched": total_nodes + node_budget,
                    }
                truncated.append(key)
                total_nodes += node_budget
                max_key_nodes = max(max_key_nodes, node_budget)
                continue
            total_nodes += nodes
            max_key_nodes = max(max_key_nodes, nodes)
            if not ok:
                return {
                    "ok": False,
                    "violation": why,
                    "ops": len(self.ops),
                    "nodes_searched": total_nodes,
                }
        return {
            "ok": True,
            "violation": None,
            "ops": len(self.ops),
            "keys": len(per_key),
            "nodes_searched": total_nodes,
            "max_key_nodes": max_key_nodes,
            "truncated_keys": truncated,
        }
