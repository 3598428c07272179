"""Bytes pulled from the device to the host (``device.TRANSFER_METER``)
per Range or Count request completed in the window."""

from kubebrain_tpu_torch.device import TRANSFER_METER


def start(w):
    w.scratch["transfer0"] = TRANSFER_METER.snapshot()[0]


def read(w):
    if not w.reads:
        return None
    return (TRANSFER_METER.snapshot()[0] - w.scratch["transfer0"]) / w.reads
