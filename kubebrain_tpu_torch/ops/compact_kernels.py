"""Wrapper of the CUDA victim-mask kernel K3 (``csrc/compact_victims.cu``),
which replaces the Pallas kernel ``victim_mask_pallas`` of
``kubebrain_tpu/ops/compact_pallas.py``.

The wrapper decides by the device of the tensors it is given: on the CPU it
computes the plain PyTorch version (``ops/compact.py``); on a CUDA device it
launches the kernel on the current stream, or raises. It keeps a launch
counter, a plain integer (``victim_mask_batch.launches``), raised by one
where it launches the kernel and nowhere else.

Layout: keys_t int32[P, C, N] (chunk-major, sign-flipped, C <= 32),
revs int64[P, N], tomb and ttl int8[P, N], n_valid int32[P]; start/end
sign-flipped int32[C] bound rows; ``unbounded`` ignores ``end``;
``compact_rev`` and ``ttl_cutoff`` are Python ints (``ttl_cutoff`` 0 skips
the TTL verdict).

Precondition: the valid rows of each partition are sorted (by key, then
revision), as every mirror the engine publishes is. The kernel classifies
each tile of ``compact.TILE_ROWS`` rows from its first and last key
(``compact.victim_tile_classes`` is the same classification in plain
PyTorch); on unsorted rows its mask is undefined.
"""

from __future__ import annotations

import ctypes

import torch

from . import compact, launch_owner
from .scan_kernels import MAX_CHUNKS

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    from .._build import library

    lib = library("compact_victims")
    if not getattr(lib, "_kb_bound", False):
        lib.kb_victim_mask.argtypes = ([_P] * 7 + [_I, _L, _L] + [_I] * 3
                                       + [_P] * 3)
        lib.kb_victim_mask.restype = _I
        lib.kb_victim_tile_rows.argtypes = []
        lib.kb_victim_tile_rows.restype = _I
        if lib.kb_victim_tile_rows() != compact.TILE_ROWS:
            raise RuntimeError("victim kernel tile differs from "
                               "compact.TILE_ROWS")
        lib._kb_bound = True
    return lib


def _check_layout(keys_t, revs, tomb, ttl, n_valid, start, end):
    dev = keys_t.device
    p, c, n = keys_t.shape
    want = [
        (keys_t, torch.int32, (p, c, n)), (revs, torch.int64, (p, n)),
        (tomb, torch.int8, (p, n)), (ttl, torch.int8, (p, n)),
        (n_valid, torch.int32, (p,)), (start, torch.int32, (c,)),
        (end, torch.int32, (c,)),
    ]
    for t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"victim kernel wants {dtype}{list(shape)} contiguous on "
                f"{dev}, got {t.dtype}{list(t.shape)} on {t.device}")
    if c > MAX_CHUNKS:
        raise ValueError(f"victim kernel takes at most {MAX_CHUNKS} key "
                         f"chunks, got {c}")
    return p, c, n


def victim_mask_batch(keys_t, revs, tomb, ttl, n_valid, start, end,
                      unbounded: bool, compact_rev: int, ttl_cutoff: int):
    """K3: the compaction victims of every partition → (mask bool[P, N],
    counts int32[P]), in one launch (the contract of
    ``_victim_batch_pallas``, ``storage/tpu/engine.py:426``, with int64
    revisions in place of the 31-bit splits; the per-partition victim
    counts, which the JAX engine takes by a second reduction
    ``_victim_part_counts``, come from the same launch)."""
    if keys_t.device.type == "cpu":
        mask = compact.victim_mask(keys_t, revs, tomb, ttl, n_valid, start,
                                   end, unbounded, compact_rev, ttl_cutoff)
        return mask, mask.sum(dim=1, dtype=torch.int32)
    if keys_t.device.type != "cuda":
        raise ValueError(f"unsupported device {keys_t.device}")
    p, c, n = _check_layout(keys_t, revs, tomb, ttl, n_valid, start, end)
    if not 0 <= compact_rev < 2**63 or not 0 <= ttl_cutoff < 2**63:
        raise ValueError("revision out of range")
    dev = keys_t.device
    mask = torch.empty((p, n), dtype=torch.bool, device=dev)
    # counts[P], the tile ticket and one status word per tile, zeroed
    tiles = compact.n_tiles(n, compact.TILE_ROWS)
    scratch = torch.zeros(p + 1 + p * tiles, dtype=torch.int32, device=dev)
    counts = scratch[:p]
    if mask.numel() == 0:  # an empty mirror launches nothing
        return mask, counts
    err = _lib().kb_victim_mask(
        keys_t.data_ptr(), revs.data_ptr(), tomb.data_ptr(), ttl.data_ptr(),
        n_valid.data_ptr(), start.data_ptr(), end.data_ptr(), int(bool(unbounded)),
        int(compact_rev), int(ttl_cutoff), p, c, n, mask.data_ptr(),
        scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"victim kernel launch failed: CUDA error {err}")
    victim_mask_batch.launches += 1
    launch_owner.count("victim_mask")
    return mask, counts


victim_mask_batch.launches = 0


def reset_launch_counts() -> None:
    victim_mask_batch.launches = 0
