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

The multi-card dry run (``dryrun_multichip``) waits for multi-GPU support
(ROADMAP item 10).
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
