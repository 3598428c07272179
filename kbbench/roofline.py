"""The yardstick of the kernels' rooflines: the published peaks of one
NVIDIA H100 SXM (as ``chip_smoke.py`` states them) and the bytes and
compares a visibility scan needs."""

from __future__ import annotations

#: H100 SXM device memory rate, bytes/s (NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM 32-bit rate outside the tensor cores, operations/s
VECTOR_OPS_PER_S = 67e12
#: the visibility kernels K1 and K2 (``csrc/scan_visibility.cu``)
SCAN_KERNEL = "visibility_kernel"


def scan_need(rows: int, key_bytes: int) -> tuple[int, int]:
    """(bytes, compares) one Count needs over ``rows`` version rows inside
    its range whose keys take ``key_bytes`` each: each row's key, revision
    (8 bytes) and tombstone (1 byte) read once and the count (4 bytes)
    written; a next-key compare per 32-bit key chunk and a revision compare
    per row."""
    return rows * (key_bytes + 8 + 1) + 4, rows * (key_bytes // 4 + 1)


def least_seconds(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time: bytes over the memory rate or compares over the
    vector rate, whichever is larger, and which one it was."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / VECTOR_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "compares")
