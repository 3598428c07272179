"""Wrappers of the CUDA visibility kernels K1 and K2
(``csrc/scan_visibility.cu``), which replace the Pallas kernels
``scan_mask_pallas`` and ``scan_mask_pallas_q`` of
``kubebrain_tpu/ops/scan_pallas.py``.

Each wrapper decides by the device of the tensors it is given: on the CPU
it computes the plain PyTorch version (``ops/scan.py``); on a CUDA device it
launches its kernel on the current stream, or raises. Each keeps a launch
counter, a plain integer (``visibility_mask_batch.launches``), raised by one
where it launches its kernel and nowhere else; the launch is counted there
under its owner too (``ops/launch_owner.py``).

Layout: keys_t int32[P, C, N] (chunk-major, sign-flipped, C <= 32),
revs int64[P, N], tomb int8[P, N], n_valid int32[P]; bounds are sign-flipped
int32 chunk rows, ``unbounded`` int32 flags (1 = ignore the end bound), read
revisions int64.

Precondition: the valid rows of each partition are non-decreasing in the
flipped chunk order (sorted by key, then revision), as every mirror the
engine publishes is. The kernel classifies each 256-row block per query from
its first and last key and reads the rows of a block only where a query's
range reaches into it (``scan.block_classes`` is the same classification in
plain PyTorch); on unsorted rows its mask is undefined.
"""

from __future__ import annotations

import ctypes

import torch

from . import launch_owner, scan

_P = ctypes.c_void_p
_I = ctypes.c_int

#: chunks per key the kernel takes (KEY_WIDTH = 128 bytes): it is compiled
#: for C <= 8 and for C <= 32
MAX_CHUNKS = 32


def _lib():
    from .._build import library

    lib = library("scan_visibility")
    if not getattr(lib, "_kb_bound", False):
        lib.kb_scan_mask.argtypes = [_P] * 8 + [_I] * 3 + [_P] * 3
        lib.kb_scan_mask.restype = _I
        lib.kb_scan_mask_q.argtypes = [_P] * 8 + [_I] * 4 + [_P] * 3
        lib.kb_scan_mask_q.restype = _I
        lib._kb_bound = True
    return lib


def _check_layout(keys_t, revs, tomb, n_valid, starts, ends, unbounded, read_revs):
    dev = keys_t.device
    p, c, n = keys_t.shape
    q = starts.shape[0]
    want = [
        (keys_t, torch.int32, (p, c, n)), (revs, torch.int64, (p, n)),
        (tomb, torch.int8, (p, n)), (n_valid, torch.int32, (p,)),
        (starts, torch.int32, (q, c)), (ends, torch.int32, (q, c)),
        (unbounded, torch.int32, (q,)), (read_revs, torch.int64, (q,)),
    ]
    for t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"visibility kernel wants {dtype}{list(shape)} contiguous on "
                f"{dev}, got {t.dtype}{list(t.shape)} on {t.device}")
    if c > MAX_CHUNKS:
        raise ValueError(f"visibility kernel takes at most {MAX_CHUNKS} key "
                         f"chunks, got {c}")
    return p, c, n, q


def _launch(fn, keys_t, revs, tomb, n_valid, starts, ends, unbounded,
            read_revs, with_q: bool):
    p, c, n, q = _check_layout(keys_t, revs, tomb, n_valid, starts, ends,
                               unbounded, read_revs)
    mask = torch.empty((q, p, n), dtype=torch.bool, device=keys_t.device)
    counts = torch.zeros((q, p), dtype=torch.int32, device=keys_t.device)
    stream = torch.cuda.current_stream(keys_t.device).cuda_stream
    dims = (p, c, n, q) if with_q else (p, c, n)
    err = fn(keys_t.data_ptr(), revs.data_ptr(), tomb.data_ptr(),
             n_valid.data_ptr(), starts.data_ptr(), ends.data_ptr(),
             unbounded.data_ptr(), read_revs.data_ptr(), *dims,
             mask.data_ptr(), counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"visibility kernel launch failed: CUDA error {err}")
    return mask, counts


def visibility_mask_batch(keys_t, revs, tomb, n_valid, start, end, unbounded,
                          read_rev):
    """K1: one query over every partition → (mask bool[P, N], counts int32[P]).

    start/end int32[C] flipped bounds, unbounded int32[1], read_rev int64[1]
    (the contract of ``_vis_batch_pallas``, ``storage/tpu/engine.py:222``).
    The valid rows of each partition must be sorted (module docstring)."""
    starts, ends = start.view(1, -1), end.view(1, -1)
    if keys_t.device.type == "cpu":
        mask = scan.visibility_mask(keys_t, revs, tomb, n_valid, starts, ends,
                                    unbounded, read_rev)[0]
        return mask, mask.sum(dim=1, dtype=torch.int32)
    if keys_t.device.type != "cuda":
        raise ValueError(f"unsupported device {keys_t.device}")
    mask, counts = _launch(_lib().kb_scan_mask, keys_t, revs, tomb, n_valid,
                           starts, ends, unbounded, read_rev, with_q=False)
    if mask.numel():  # an empty mirror launches nothing
        visibility_mask_batch.launches += 1
        launch_owner.count("scan_mask")
    return mask[0], counts[0]


visibility_mask_batch.launches = 0


def visibility_mask_batch_q(keys_t, revs, tomb, n_valid, starts, ends,
                            unbounded, read_revs):
    """K2: Q queries over every partition in one launch → (mask
    bool[Q, P, N], counts int32[Q, P]).

    starts/ends int32[Q, C], unbounded int32[Q], read_revs int64[Q] (the
    contract of ``_vis_batch_pallas_q``, ``storage/tpu/engine.py:237``; the
    engine pads Q to a power of two and callers slice ``[:len(specs)]``).
    The valid rows of each partition must be sorted (module docstring)."""
    if keys_t.device.type == "cpu":
        mask = scan.visibility_mask(keys_t, revs, tomb, n_valid, starts, ends,
                                    unbounded, read_revs)
        return mask, mask.sum(dim=2, dtype=torch.int32)
    if keys_t.device.type != "cuda":
        raise ValueError(f"unsupported device {keys_t.device}")
    mask, counts = _launch(_lib().kb_scan_mask_q, keys_t, revs, tomb, n_valid,
                           starts, ends, unbounded, read_revs, with_q=True)
    if mask.numel():  # an empty mirror launches nothing
        visibility_mask_batch_q.launches += 1
        launch_owner.count("scan_mask_q")
    return mask, counts


visibility_mask_batch_q.launches = 0


def reset_launch_counts() -> None:
    visibility_mask_batch.launches = 0
    visibility_mask_batch_q.launches = 0
