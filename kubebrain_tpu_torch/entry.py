"""The port's entry point for a single-card check: counterpart of
``entry()`` in the repository's ``__graft_entry__.py``.

``entry(device=None)`` returns the main-path scan step, the MVCC
range-scan visibility mask and its count over one sorted block (the
north-star hot loop), plus example arguments on the device built the way
the JAX ``entry()`` builds its own: 128 kube pod keys with two revisions
each, 64-byte keys, one ``/registry/`` range read at the head. The step
calls K1's wrapper (``ops/scan_kernels.visibility_mask_batch``), which
launches the kernel on a CUDA tensor and computes its plain version on a
CPU one. ``device=None`` means ``cuda`` and raises without a card.

``dryrun_multichip(n_devices, device=None)`` is the counterpart of the JAX
``dryrun_multichip``: J6 on a ``(part, wat)`` mesh, then the served phase
(``parallel/served.py``) at mesh sizes {1, n}, with its JSON tail
``multichip_rows_per_sec``. On ``cuda`` it needs ``n`` cards; on the CPU
its slots are the one CPU device's.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops import keys as keyops
from .ops import scan_kernels
from .ops.scan import flip_sign, prepare_layout


def scan_step(keys_t, revs, tomb, n_valid, start, end, unbounded, read_rev):
    """(mask bool[N], count int32): the rows of the one partition visible
    at ``read_rev`` inside [start, end), through K1."""
    mask, counts = scan_kernels.visibility_mask_batch(
        keys_t, revs, tomb, n_valid, start, end, unbounded, read_rev)
    return mask[0], counts.sum(dtype=torch.int32)


def entry(device=None):
    """``(scan_step, args)`` with ``args`` on ``device``."""
    dev = resolve_device(device)
    n, width = 256, 64
    ks, rs = [], []
    rev = 0
    for i in range(n // 2):
        k = b"/registry/pods/default/pod-%05d" % i
        for _ in range(2):
            rev += 1
            ks.append(k)
            rs.append(rev)
    packed, _ = keyops.pack_keys(ks, width)
    keys_t, revs, tomb = prepare_layout(
        packed[None], np.array(rs, dtype=np.uint64)[None],
        np.zeros((1, n), dtype=bool))

    def bound(key: bytes) -> torch.Tensor:
        return torch.from_numpy(flip_sign(keyops.pack_one(key, width))).to(dev)

    args = (
        torch.from_numpy(keys_t).to(dev), torch.from_numpy(revs).to(dev),
        torch.from_numpy(tomb).to(dev),
        torch.tensor([n], dtype=torch.int32, device=dev),
        bound(b"/registry/"), bound(b"/registry0"),
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.tensor([rev], dtype=torch.int64, device=dev),
    )
    return scan_step, args


def platform_info(device) -> dict:
    """Where a result was measured: ``gpu`` and the card's name, or
    ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return {"platform": "gpu",
                "device": torch.cuda.get_device_name(dev)}
    return {"platform": "cpu", "device": "cpu"}


def dryrun_multichip(n_devices: int, device=None) -> None:
    """J6 over ``n_devices`` slots (``wat`` 2 where ``n`` is even), the
    scan total checked positive; then real Range/Count traffic through the
    scheduler over the ``part``-sharded ``cuda`` engine at mesh sizes {1,
    n}, byte identity asserted, and one JSON line printed as the tail:
    ``multichip_rows_per_sec`` with its ``detail``."""
    import json

    from .parallel.mesh import make_mesh
    from .parallel.served import multichip_phase
    from .parallel.step import make_data_plane_step, make_example_args

    dev = resolve_device(device)
    wat = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices, axes=("part", "wat"),
                     shape=(n_devices // wat, wat), device=dev)
    step = make_data_plane_step(mesh)
    _vis, total, _victims, _fmask = step(*make_example_args(
        mesh, n_parts=mesh.shape["part"], watchers=max(8, wat * 4)))
    if total <= 0:
        raise AssertionError("sharded scan found no visible rows")

    mesh_sizes = [1, n_devices] if n_devices > 1 else [1]
    phase = multichip_phase(mesh_sizes, n_keys=4000, n_req=32, device=dev)
    top = str(mesh_sizes[-1])
    print(json.dumps({
        "metric": "multichip_rows_per_sec",
        "value": phase["rows_per_sec"][top],
        "unit": "rows/sec",
        "platform": platform_info(dev),
        "detail": {
            "mesh_sizes": phase["mesh_sizes"],
            "rows_per_sec": phase["rows_per_sec"],
            "scaling_vs_1dev": phase["scaling_vs_1dev"],
            "byte_identical": phase["byte_identical"],
            "batched_riders": phase["batched_riders"],
            "served_through_scheduler": True,
            "kernel": phase["kernel"],
        },
    }))
