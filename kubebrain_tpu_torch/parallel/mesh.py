"""Mesh construction and sharding helpers (counterpart of
``kubebrain_tpu/parallel/mesh.py:14-38``).

A :class:`Mesh` holds a numpy object array of ``torch.device`` slots with
one name per axis. On CUDA :func:`make_mesh` takes the first ``n`` visible
cards and raises past ``torch.cuda.device_count()``; on the CPU ``n``
slots of the one CPU device stand in for the JAX tests' virtual host
devices. An explicit slot list may name a device twice (two slots on one
card run back to back on its stream).

Under a process group (``multihost``) a mesh holds this process's slots
only; ``shape`` is the global shape and ``part_offset`` the first global
``part`` index this process holds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


class Mesh:
    def __init__(self, devices, axis_names=("part",), process_index: int = 0,
                 process_count: int = 1):
        arr = np.empty(np.shape(devices), dtype=object)
        for i, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[i] = torch.device(d)
        if arr.ndim != len(axis_names) or arr.size == 0:
            raise ValueError(f"a mesh of shape {arr.shape} for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.process_index = process_index
        self.process_count = process_count

    @classmethod
    def of(cls, mesh, axis: str = "part") -> "Mesh":
        """``mesh`` itself, or a flat list of slots as a one-axis mesh."""
        if isinstance(mesh, Mesh):
            return mesh
        return cls(list(mesh), (axis,))

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size over every process (JAX ``Mesh.shape``)."""
        out = dict(zip(self.axis_names, self.devices.shape))
        out[self.axis_names[0]] *= self.process_count
        return out

    @property
    def part_offset(self) -> int:
        """The first index of the first axis that this process holds."""
        return self.process_index * self.devices.shape[0]

    def slots(self, axis: str | None = None) -> list[torch.device]:
        """The slots along ``axis`` (default the first), at index 0 of
        every other axis: the devices a sharded column is split over."""
        a = self.axis_names.index(axis) if axis in self.axis_names else 0
        index = [0] * self.devices.ndim
        index[a] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: int | None = None, axes: tuple[str, ...] = ("part",),
              shape: tuple[int, ...] | None = None, device=None) -> Mesh:
    """``n_devices`` slots (default every visible card on CUDA, one on the
    CPU) reshaped to ``shape`` (default all on the first axis)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        avail = torch.cuda.device_count()
        n = avail if n_devices is None else n_devices
        if n > avail:
            raise ValueError(f"a mesh of {n} devices exceeds the {avail} "
                             f"visible device(s)")
        slots = [torch.device("cuda", i) for i in range(n)]
    else:
        slots = [dev] * (n_devices or 1)
    if shape is None:
        shape = (len(slots),) + (1,) * (len(axes) - 1)
    arr = np.empty(len(slots), dtype=object)
    arr[:] = slots
    return Mesh(arr.reshape(shape), axes)


def placement(device=None, mesh=None, axis: str = "part"
              ) -> tuple[torch.device, list[torch.device]]:
    """``(device, slots)`` of columns split over ``axis`` of ``mesh``: its
    slots along that axis, ``device`` defaulting to the first and every
    slot of that device's type; without a mesh, ``device`` alone. A CUDA
    slot without a card raises (``resolve_device``)."""
    if mesh is None:
        dev = resolve_device(device)
        return dev, [dev]
    slots = Mesh.of(mesh, axis).slots(axis)
    dev = slots[0] if device is None else resolve_device(device)
    if any(d.type != dev.type for d in slots):
        raise ValueError(f"mesh slots {[str(d) for d in slots]} are not all "
                         f"{dev.type} devices")
    resolve_device(slots[0])
    return dev, slots


def shard_rows(mesh, arr, axis: str = "part") -> list[torch.Tensor]:
    """``arr`` split along its leading axis into contiguous equal runs, one
    per slot of ``axis``, each on its slot."""
    slots = Mesh.of(mesh, axis).slots(axis)
    t = torch.as_tensor(arr)
    if t.shape[0] % len(slots):
        raise ValueError(f"{t.shape[0]} rows do not split over "
                         f"{len(slots)} slots")
    k = t.shape[0] // len(slots)
    return [t[i * k:(i + 1) * k].to(d, copy=True) for i, d in enumerate(slots)]


def replicate(mesh, arr, axis: str = "part") -> list[torch.Tensor]:
    """One copy of ``arr`` on every slot of ``axis``."""
    t = torch.as_tensor(arr)
    return [t.to(d, copy=True) for d in Mesh.of(mesh, axis).slots(axis)]
