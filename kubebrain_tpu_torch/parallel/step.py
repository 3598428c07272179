"""J6: the full data-plane step over a ``(part, wat)`` mesh (counterpart of
``kubebrain_tpu/parallel/step.py:30-138``).

One call = everything the device does for the MVCC store per tick:

- the partition-sharded range scan: K1's wrapper per ``part`` slot on that
  slot's partitions, the visible rows counted per slot and summed on the
  host (the JAX step's ``psum`` over ``part``), and under a process group
  all-reduced over it (``multihost``);
- the partition-sharded compaction victim marking: K3's wrapper per
  ``part`` slot;
- the watcher-sharded fan-out mask: K5's wrapper per ``wat`` slot on that
  slot's watchers, every event replicated to it.

No kernel is new: the JAX step's ``shard_map`` becomes a loop over the
slots, each wrapper launching on its slot's device (on CPU tensors the
wrappers compute their plain versions). A ``part`` shard runs on the first
slot of its mesh row, a ``wat`` shard on the first slot of its column;
the JAX step computes each again on every slot that replicates it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import coder
from ..device import _host_pull
from ..ops import compact_kernels, fanout_kernels, scan_kernels
from ..ops import keys as keyops
from ..ops.scan import flip_sign, prepare_layout
from .mesh import Mesh, shard_rows


def _all_reduce(total: int, device: torch.device) -> int:
    """``total`` summed over the process group, if there is one of more
    than one process (NCCL reduces on the rank's card, gloo on the CPU)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() <= 1:
        return total
    on = device if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([total], dtype=torch.int64, device=on)
    dist.all_reduce(t)
    return int(t.item())


def make_data_plane_step(mesh):
    """The step over ``mesh`` (axes ``part`` and ``wat``): ``step(keys,
    revs, tomb, ttl, n_valid, start, end, unbounded, read_rev, compact_rev,
    ttl_cutoff, w_start, w_end, w_unbounded, w_min_rev, ev_keys, ev_revs,
    n_ev) → (vis bool[P, N], total int, victims bool[P, N], fmask bool[E,
    W])``.

    The block columns (kernel layout, ``ops/scan.py``) and the watcher
    columns (``ops/fanout.py``) are lists with one tensor per slot of their
    axis, on that slot; the query rows and the events are CPU tensors,
    replicated to each slot; the rest are Python values. ``vis``,
    ``victims`` and ``fmask`` are gathered on the mesh's first slot, the
    partitions being this process's."""
    mesh = Mesh.of(mesh)
    part_slots, wat_slots = mesh.slots("part"), mesh.slots("wat")

    def step(keys, revs, tomb, ttl, n_valid,
             start, end, unbounded, read_rev,
             compact_rev, ttl_cutoff,
             w_start, w_end, w_unbounded, w_min_rev,
             ev_keys, ev_revs, n_ev):
        vis, counts, victims = [], [], []
        for i, d in enumerate(part_slots):
            s, e = start.to(d), end.to(d)
            m, c = scan_kernels.visibility_mask_batch(
                keys[i], revs[i], tomb[i], n_valid[i], s, e,
                torch.tensor([int(bool(unbounded))], dtype=torch.int32,
                             device=d),
                torch.tensor([read_rev], dtype=torch.int64, device=d))
            v, _n = compact_kernels.victim_mask_batch(
                keys[i], revs[i], tomb[i], ttl[i], n_valid[i], s, e,
                unbounded, compact_rev, ttl_cutoff)
            vis.append(m)
            counts.append(c)
            victims.append(v)
        masks = [fanout_kernels.fanout_mask_range(
            ev_keys.to(d), ev_revs.to(d), n_ev, w_start[j], w_end[j],
            w_unbounded[j], w_min_rev[j]) for j, d in enumerate(wat_slots)]
        total = sum(int(_host_pull(c).sum()) for c in counts)
        total = _all_reduce(total, part_slots[0])
        first = part_slots[0]
        return (torch.cat([m.to(first) for m in vis]), total,
                torch.cat([v.to(first) for v in victims]),
                torch.cat([m.to(first) for m in masks], dim=1))

    return step


def example_arrays(n_parts: int, rows: int = 64, chunks: int = 16,
                   watchers: int = 8, events: int = 8, seed: int = 0) -> dict:
    """The host arrays of the JAX ``make_example_args`` (the same keys,
    revisions, seeded tombstones, queries, watchers and events), in the
    port's layout: flipped chunks, int64 revisions."""
    rng = np.random.RandomState(seed)
    width = chunks * 4
    all_keys, all_revs, all_tomb, nv = [], [], [], []
    rev = 0
    for p in range(n_parts):
        ks, rs = [], []
        for i in range(rows // 2):
            k = b"/registry/pods/p%02d-%04d" % (p, i)
            for _ in range(2):
                rev += 1
                ks.append(k)
                rs.append(rev)
        packed, _ = keyops.pack_keys(ks, width)
        pad = rows - len(ks)
        all_keys.append(np.pad(packed, ((0, pad), (0, 0))))
        all_revs.append(np.pad(np.array(rs, dtype=np.uint64), (0, pad)))
        all_tomb.append(rng.rand(rows) < 0.1)
        nv.append(len(ks))
    keys_t, revs, tomb8 = prepare_layout(
        np.stack(all_keys), np.stack(all_revs), np.stack(all_tomb))
    prefixes = [b"/registry/pods/p%02d" % (i % n_parts)
                for i in range(watchers)]
    ws, _ = keyops.pack_keys(prefixes, width)
    we, _ = keyops.pack_keys([coder.prefix_end(p) for p in prefixes], width)
    ev, _ = keyops.pack_keys([b"/registry/pods/p%02d-%04d" % (i % n_parts, i)
                              for i in range(events)], width)
    return {
        "keys": keys_t, "revs": revs, "tomb": tomb8,
        "ttl": np.zeros(tomb8.shape, dtype=np.int8),
        "n_valid": np.array(nv, dtype=np.int32),
        "start": flip_sign(keyops.pack_one(b"/registry/", width)),
        "end": flip_sign(keyops.pack_one(b"/registry0", width)),
        "unbounded": False, "read_rev": rev,
        "compact_rev": max(rev // 2, 1), "ttl_cutoff": 0,
        "w_start": flip_sign(ws), "w_end": flip_sign(we),
        "w_unbounded": np.zeros(watchers, dtype=bool),
        "w_min_rev": np.zeros(watchers, dtype=np.int64),
        "ev_keys": flip_sign(ev),
        "ev_revs": np.arange(1, events + 1, dtype=np.int64),
        "n_ev": events,
    }


def make_example_args(mesh, n_parts=None, rows=64, chunks=16, watchers=8,
                      events=8, seed=0) -> tuple:
    """Small, correctly sharded inputs for the step, in its argument
    order: :func:`example_arrays` of ``n_parts`` partitions (default one
    per ``part`` slot of the whole group), this process's share of them
    split over its ``part`` slots and the watchers over its ``wat`` slots."""
    mesh = Mesh.of(mesh)
    part, wat = mesh.shape["part"], mesh.shape["wat"]
    n_parts = n_parts or part
    if n_parts % part or watchers % wat:
        raise ValueError(f"{n_parts} partitions over {part} part slots, "
                         f"{watchers} watchers over {wat} wat slots")
    a = example_arrays(n_parts, rows, chunks, watchers, events, seed)
    local = n_parts // part * len(mesh.slots("part"))
    first = n_parts // part * mesh.part_offset

    def blocks(name):
        return shard_rows(mesh, a[name][first:first + local], "part")

    return (
        *(blocks(n) for n in ("keys", "revs", "tomb", "ttl", "n_valid")),
        torch.from_numpy(a["start"]), torch.from_numpy(a["end"]),
        a["unbounded"], a["read_rev"], a["compact_rev"], a["ttl_cutoff"],
        *(shard_rows(mesh, a[n], "wat")
          for n in ("w_start", "w_end", "w_unbounded", "w_min_rev")),
        torch.from_numpy(a["ev_keys"]), torch.from_numpy(a["ev_revs"]),
        a["n_ev"],
    )
