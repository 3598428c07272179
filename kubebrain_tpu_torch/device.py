"""Device selection and the metered device→host transfer funnel.

``resolve_device`` is the one place an entry point turns its ``device``
argument into a ``torch.device``: ``None`` means ``cuda``, and a missing
card is an error, never a silent move to the CPU.

``_host_pull`` is the counterpart of ``storage/tpu/engine.py::_host_pull``:
every device→host copy on the scan path goes through it, metered in bytes,
so the transfer cost of serving is observable and tests can assert that it
scales with visible rows, never with the dataset.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``. Raises ``RuntimeError`` when a CUDA device is
    asked for (explicitly or by default) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


class TransferMeter:
    """Device→host byte accounting for the scan path."""

    __slots__ = ("_lock", "bytes", "pulls")

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes = 0
        self.pulls = 0

    def add(self, nbytes: int) -> None:
        with self._lock:
            self.bytes += int(nbytes)
            self.pulls += 1

    def snapshot(self) -> tuple[int, int]:
        with self._lock:
            return self.bytes, self.pulls


TRANSFER_METER = TransferMeter()


def _host_pull(x: torch.Tensor) -> np.ndarray:
    """THE device→host materialization funnel: waits for the kernels that
    produce ``x`` on the current stream, copies to host, meters the bytes."""
    arr = x.detach().cpu().numpy()
    TRANSFER_METER.add(arr.nbytes)
    return arr


def _pow2_bucket(want: int, n_flat: int) -> int:
    """Index-transfer size bucketed to a power of two, clamped to the row
    count (``storage/tpu/engine.py::_pow2_bucket``)."""
    bucket = 1
    while bucket < max(want, 1):
        bucket *= 2
    return min(bucket, n_flat)
