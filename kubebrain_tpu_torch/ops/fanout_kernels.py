"""Wrappers of the CUDA fan-out kernels (``csrc/fanout_match.cu``):

- K4 :func:`fanout_dispatch`: match, count and compaction of one drain
  block in one call, never writing the [W, E] mask. It replaces the XLA
  program ``fanout_dispatch`` + ``_compact`` over
  ``fanout_mask_range_wmajor`` (``kubebrain_tpu/fanout/dispatch.py:68``).
- K5 :func:`fanout_mask_range`: the legacy matcher's E-major mask
  (``kubebrain_tpu/ops/fanout.py:46``).

Each wrapper decides by the device of the tensors it is given: on the CPU
it computes the plain PyTorch version (``ops/fanout.py``); on a CUDA device
it launches its kernels on the current stream, or raises. Each keeps a
launch counter, a plain integer (``fanout_dispatch.launches``), raised by
one where it launches and nowhere else.

Layout: ev_keys int32[E, C] and w_start, w_end int32[W, C], sign-flipped
(C <= 256, keys of up to 1 KiB); ev_revs and w_min_rev int64; w_unbounded
bool[W]; ``n_ev`` (events ``>= n_ev`` are padding) and ``size`` Python
ints. Flat indices are int32 as in the JAX package, so W * E must stay
below 2**31 (the wrapper raises, on every device).
"""

from __future__ import annotations

import ctypes

import torch

from . import fanout

_P = ctypes.c_void_p
_I = ctypes.c_int

#: key chunks the kernels take: an event tile of 32 keys of 256 chunks
#: fills their shared memory
MAX_CHUNKS = 256


def _lib():
    from .._build import library

    lib = library("fanout_match")
    if not getattr(lib, "_kb_bound", False):
        lib.kb_fanout_dispatch.argtypes = ([_P, _P, _I, _I, _P, _P, _P, _P]
                                           + [_I] * 3 + [_P, _P, _P, _I, _P])
        lib.kb_fanout_dispatch.restype = _I
        lib.kb_fanout_mask.argtypes = ([_P, _P, _I, _I, _P, _P, _P, _P]
                                       + [_I] * 2 + [_P, _P])
        lib.kb_fanout_mask.restype = _I
        lib._kb_bound = True
    return lib


def _check_layout(ev_keys, ev_revs, n_ev, w_start, w_end, w_unbounded,
                  w_min_rev):
    dev = ev_keys.device
    e, c = ev_keys.shape
    w = w_start.shape[0]
    want = [
        (ev_keys, torch.int32, (e, c)), (ev_revs, torch.int64, (e,)),
        (w_start, torch.int32, (w, c)), (w_end, torch.int32, (w, c)),
        (w_unbounded, torch.bool, (w,)), (w_min_rev, torch.int64, (w,)),
    ]
    for t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"fan-out kernel wants {dtype}{list(shape)} contiguous on "
                f"{dev}, got {t.dtype}{list(t.shape)} on {t.device}")
    if not 0 < c <= MAX_CHUNKS:
        raise ValueError(f"fan-out kernels take 1 to {MAX_CHUNKS} key "
                         f"chunks, got {c}")
    if not 0 <= n_ev <= e:
        raise ValueError(f"n_ev {n_ev} outside [0, {e}]")
    return e, c, w


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def fanout_dispatch(ev_keys, ev_revs, n_ev: int, w_start, w_end, w_unbounded,
                    w_min_rev, size: int):
    """K4: one drain block against every watcher slot → ``(counts
    int32[W], idx int32[size])``, the contract of ``fanout_dispatch`` of
    the JAX package on one device: ``idx`` holds the ascending flat
    positions ``w * E + e`` (padded E) of the first ``size`` matches, then
    ``W * E``; ``counts.sum() > size`` means it was truncated."""
    fanout._check_flat(w_start.shape[0], ev_keys.shape[0])
    if ev_keys.device.type == "cpu":
        return fanout.fanout_dispatch_plain(ev_keys, ev_revs, n_ev, w_start,
                                            w_end, w_unbounded, w_min_rev,
                                            size)
    if ev_keys.device.type != "cuda":
        raise ValueError(f"unsupported device {ev_keys.device}")
    e, c, w = _check_layout(ev_keys, ev_revs, n_ev, w_start, w_end,
                            w_unbounded, w_min_rev)
    if size < 0:
        raise ValueError(f"size {size} < 0")
    dev = ev_keys.device
    counts = torch.empty(w, dtype=torch.int32, device=dev)
    idx = torch.empty(size, dtype=torch.int32, device=dev)
    if w == 0:  # no watcher slot: nothing to launch, every index is fill
        return counts, idx.zero_()
    # the block sums of the count pass, scanned in place, then the total
    n_blocks = -(-w // fanout.WATCHERS_PER_BLOCK)
    scratch = torch.empty(n_blocks + 1, dtype=torch.int32, device=dev)
    err = _lib().kb_fanout_dispatch(
        ev_keys.data_ptr(), ev_revs.data_ptr(), int(n_ev), e,
        w_start.data_ptr(), w_end.data_ptr(), w_unbounded.data_ptr(),
        w_min_rev.data_ptr(), w, c, size, counts.data_ptr(), idx.data_ptr(),
        scratch.data_ptr(), n_blocks, _stream(dev))
    if err != 0:
        raise RuntimeError(f"fan-out kernel launch failed: CUDA error {err}")
    fanout_dispatch.launches += 1
    return counts, idx


fanout_dispatch.launches = 0


def fanout_mask_range(ev_keys, ev_revs, n_ev: int, w_start, w_end,
                      w_unbounded, w_min_rev):
    """K5: the legacy matcher's E-major mask ``bool[E, W]``, rows
    ``e >= n_ev`` all False."""
    if ev_keys.device.type == "cpu":
        mask = fanout.fanout_mask_range(ev_keys, ev_revs, w_start, w_end,
                                        w_unbounded, w_min_rev)
        mask[n_ev:] = False
        return mask
    if ev_keys.device.type != "cuda":
        raise ValueError(f"unsupported device {ev_keys.device}")
    e, c, w = _check_layout(ev_keys, ev_revs, n_ev, w_start, w_end,
                            w_unbounded, w_min_rev)
    dev = ev_keys.device
    mask = torch.empty((e, w), dtype=torch.bool, device=dev)
    if mask.numel() == 0:
        return mask
    err = _lib().kb_fanout_mask(
        ev_keys.data_ptr(), ev_revs.data_ptr(), int(n_ev), e,
        w_start.data_ptr(), w_end.data_ptr(), w_unbounded.data_ptr(),
        w_min_rev.data_ptr(), w, c, mask.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fan-out mask kernel launch failed: CUDA error "
                           f"{err}")
    fanout_mask_range.launches += 1
    return mask


fanout_mask_range.launches = 0


def reset_launch_counts() -> None:
    fanout_dispatch.launches = 0
    fanout_mask_range.launches = 0
