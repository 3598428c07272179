"""Wrappers of the CUDA fan-out kernels (``csrc/fanout_match.cu``), which
match in the rank space of the watcher table's :class:`RankIndex`
(``ops/fanout.py``):

- K4 :func:`fanout_dispatch`: match, count and compaction of one drain
  block, never writing the [W, E] mask: the rank kernel, then one fused
  launch, from one call into the library. It replaces the XLA program
  ``fanout_dispatch`` + ``_compact`` over ``fanout_mask_range_wmajor``
  (``kubebrain_tpu/fanout/dispatch.py:68``).
- K5 :func:`fanout_mask_range`: the legacy matcher's E-major mask, the rank
  kernel and then the mask kernel (``kubebrain_tpu/ops/fanout.py:46``).

Each wrapper decides by the device of the tensors it is given: on the CPU
it computes the plain PyTorch version in rank space (``ops/fanout.py``: for
K4 the emulation of its kernels, :func:`fanout.fanout_dispatch_ranked`); on
a CUDA device it launches its kernels on the current stream, or raises.
Each keeps a launch counter, a plain integer (``fanout_dispatch.launches``),
raised by one where it launches and nowhere else.

Layout: ev_keys int32[E, C] and w_start, w_end int32[W, C], sign-flipped
(C <= 256, keys of up to 1 KiB); ev_revs and w_min_rev int64; w_unbounded
bool[W]; ``n_ev`` (events ``>= n_ev`` are padding) and ``size`` Python
ints; ``index`` the table's rank index at the same C (built from
w_start/w_end when None; the table checks its index when it builds it, the
wrappers only its width and slot count). Flat indices are int32 as in the
JAX package, so W * E must stay below 2**31 (the wrapper raises, on every
device).
"""

from __future__ import annotations

import ctypes

import torch

from . import fanout, launch_owner

_P = ctypes.c_void_p
_I = ctypes.c_int

#: key chunks the rank kernel takes: each warp keeps one event key in
#: shared memory
MAX_CHUNKS = 256


def _lib():
    from .._build import library

    lib = library("fanout_match")
    if not getattr(lib, "_kb_bound", False):
        lib.kb_fanout_dispatch.argtypes = ([_P, _P, _I, _I, _I, _P, _I]
                                           + [_P] * 4 + [_I, _I] + [_P] * 5)
        lib.kb_fanout_dispatch.restype = _I
        lib.kb_fanout_mask.argtypes = ([_P, _P, _I, _I, _I, _P, _I]
                                       + [_P] * 4 + [_I] + [_P] * 3)
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


def _cuda_index(ev_keys, w_start, w_end, index, c: int, w: int):
    if ev_keys.device.type != "cuda":
        raise ValueError(f"unsupported device {ev_keys.device}")
    if index is None:
        return fanout.rank_index_plain(w_start, w_end)
    if index.rows.shape[1] != c or index.rs.shape[0] != w:
        raise ValueError(f"a rank index of {index.rs.shape[0]} slots at "
                         f"C={index.rows.shape[1]} for {w} slots at C={c}")
    return index


def fanout_dispatch(ev_keys, ev_revs, n_ev: int, w_start, w_end, w_unbounded,
                    w_min_rev, size: int, index=None,
                    with_total: bool = False):
    """K4: one drain block against every watcher slot → ``(counts
    int32[W], idx int32[size])``, the contract of ``fanout_dispatch`` of
    the JAX package on one device: ``idx`` holds the ascending flat
    positions ``w * E + e`` (padded E) of the first ``size`` matches, then
    ``W * E``; ``counts.sum() > size`` means it was truncated. With
    ``with_total`` a third output, ``int32[1]``, holds that sum."""
    fanout._check_flat(w_start.shape[0], ev_keys.shape[0])
    if ev_keys.device.type == "cpu":
        counts, idx = fanout.fanout_dispatch_ranked(
            ev_keys, ev_revs, n_ev, w_start, w_end, w_unbounded, w_min_rev,
            size, index=index)
        if with_total:
            return counts, idx, counts.sum(dtype=torch.int32).view(1)
        return counts, idx
    e, c, w = _check_layout(ev_keys, ev_revs, n_ev, w_start, w_end,
                            w_unbounded, w_min_rev)
    index = _cuda_index(ev_keys, w_start, w_end, index, c, w)
    if size < 0:
        raise ValueError(f"size {size} < 0")
    # one allocation: the scratch (the ticket, the total's status word and
    # one status word per block, int64, zeroed by the rank kernel: every
    # block reads "unpublished" until it is written; the total is the low
    # half of its word), the events' ranks, the counts and idx
    n_scratch = 2 * (-(-w // fanout.WATCHERS_PER_BLOCK) + 2)
    buf = torch.empty(n_scratch + e + w + size, dtype=torch.int32,
                      device=ev_keys.device)
    total = buf[2:3]
    counts = buf[n_scratch + e:n_scratch + e + w]
    idx = buf[n_scratch + e + w:]
    if w == 0:  # no watcher slot: nothing to launch, every index is fill
        buf.zero_()
        return (counts, idx, total) if with_total else (counts, idx)
    ptr = buf.data_ptr()
    err = _lib().kb_fanout_dispatch(
        ev_keys.data_ptr(), ev_revs.data_ptr(), int(n_ev), e, c,
        index.rows.data_ptr(), index.rows.shape[0], index.rs.data_ptr(),
        index.re.data_ptr(), w_unbounded.data_ptr(), w_min_rev.data_ptr(), w,
        size, ptr + 4 * n_scratch, counts.data_ptr(), idx.data_ptr(), ptr,
        _stream(ev_keys.device))
    if err != 0:
        raise RuntimeError(f"fan-out kernel launch failed: CUDA error {err}")
    fanout_dispatch.launches += 1
    launch_owner.count("fanout_dispatch")
    return (counts, idx, total) if with_total else (counts, idx)


fanout_dispatch.launches = 0


def fanout_mask_range(ev_keys, ev_revs, n_ev: int, w_start, w_end,
                      w_unbounded, w_min_rev, index=None):
    """K5: the legacy matcher's E-major mask ``bool[E, W]``, rows
    ``e >= n_ev`` all False."""
    if ev_keys.device.type == "cpu":
        return fanout.fanout_mask_rank_plain(ev_keys, ev_revs, n_ev, w_start,
                                             w_end, w_unbounded, w_min_rev,
                                             index=index)
    e, c, w = _check_layout(ev_keys, ev_revs, n_ev, w_start, w_end,
                            w_unbounded, w_min_rev)
    index = _cuda_index(ev_keys, w_start, w_end, index, c, w)
    dev = ev_keys.device
    mask = torch.empty((e, w), dtype=torch.bool, device=dev)
    if mask.numel() == 0:
        return mask
    ranks = torch.empty(e, dtype=torch.int32, device=dev)
    err = _lib().kb_fanout_mask(
        ev_keys.data_ptr(), ev_revs.data_ptr(), int(n_ev), e, c,
        index.rows.data_ptr(), index.rows.shape[0], index.rs.data_ptr(),
        index.re.data_ptr(), w_unbounded.data_ptr(), w_min_rev.data_ptr(), w,
        ranks.data_ptr(), mask.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fan-out mask kernel launch failed: CUDA error "
                           f"{err}")
    fanout_mask_range.launches += 1
    launch_owner.count("fanout_mask_range")
    return mask


fanout_mask_range.launches = 0


def reset_launch_counts() -> None:
    fanout_dispatch.launches = 0
    fanout_mask_range.launches = 0
