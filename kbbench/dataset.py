"""Stores made from ``--seed``.

A configuration's resources become logical MVCC records ``(user key,
revision, value)`` in revision order: the program's store is loaded from
them (``driver.load_store``) and the reference's model is built from the
same list (``reference.Model.load``), so both sides start from one input.
Values are slices of one seeded random payload, so a store of a million
rows is made in a few seconds and holds no per-row allocation beyond its
bytes.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

#: longest value any configuration asks for, and the slack a slice needs
PAYLOAD_BYTES = 1 << 16


@dataclass
class Resource:
    """One resource of a configuration: its prefix and key range, the keys
    the store starts with (sorted), and the value sizes it is written at."""

    name: str
    prefix: bytes
    end: bytes
    keys: list[bytes]
    value_bytes: tuple[int, int]
    namespaces: list[bytes] = field(default_factory=list)
    key_bytes: int = 0


@dataclass
class Dataset:
    records: list[tuple[bytes, int, bytes]]  # (user key, revision, value)
    top: int
    resources: dict[str, Resource]
    payload: bytes


def prefix_end(prefix: bytes) -> bytes:
    """The first key after every key that starts with ``prefix``."""
    p = bytearray(prefix)
    while p and p[-1] == 0xFF:
        p.pop()
    p[-1] += 1
    return bytes(p)


def value_of(payload: bytes, rng: random.Random, lo: int, hi: int,
             tag: bytes = b"") -> bytes:
    """A value of ``lo``..``hi`` bytes (uniform), a slice of ``payload``
    ending in ``tag``."""
    n = lo if lo == hi else rng.randint(lo, hi)
    n = max(n - len(tag), 0)
    off = rng.randrange(len(payload) - n)
    return payload[off:off + n] + tag


def random_suffix(rng: random.Random, n: int) -> bytes:
    return b"%0*x" % (n, rng.getrandbits(4 * n))


def resource_keys(spec: dict, rng: random.Random) -> Resource:
    prefix = spec["prefix"].encode()
    lo, hi = spec["value_bytes"]
    if "namespaces" in spec:
        namespaces = [b"test-%03d" % i for i in range(spec["namespaces"])]
        keys = [prefix + ns + b"/small-deployment-%03d-%05d" % (j // 30, j)
                for ns in namespaces for j in range(spec["per_namespace"])]
        return Resource(spec["name"], prefix, prefix_end(prefix), sorted(keys),
                        (lo, hi), namespaces=namespaces)
    if "key_bytes" in spec:
        width = spec["key_bytes"] - len(prefix)
        keys: set[bytes] = set()
        while len(keys) < spec["count"]:
            keys.add(prefix + random_suffix(rng, width))
        return Resource(spec["name"], prefix, prefix_end(prefix), sorted(keys),
                        (lo, hi), key_bytes=spec["key_bytes"])
    keys = [prefix + b"node-%05d" % i for i in range(spec["count"])]
    return Resource(spec["name"], prefix, prefix_end(prefix), keys, (lo, hi))


def build(config: dict, seed: int) -> Dataset:
    """The configuration's store at ``seed``: every object's versions, round
    by round (the first versions of all objects in a seeded order, then the
    second versions, ...), numbered from revision 1."""
    rng = random.Random(f"kbbench-dataset:{seed}")
    payload = rng.randbytes(PAYLOAD_BYTES)
    resources = {}
    for spec in config["resources"]:
        resources[spec["name"]] = resource_keys(spec, rng)
    records: list[tuple[bytes, int, bytes]] = []
    rev = 0
    rounds = max(spec["versions"] for spec in config["resources"])
    for v in range(rounds):
        for spec in config["resources"]:
            if v >= spec["versions"]:
                continue
            res = resources[spec["name"]]
            order = list(range(len(res.keys)))
            rng.shuffle(order)
            lo, hi = res.value_bytes
            for i in order:
                rev += 1
                records.append((res.keys[i], rev,
                                value_of(payload, rng, lo, hi)))
    return Dataset(records, rev, resources, payload)
