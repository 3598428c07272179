"""Several processes: the process group and each process's mesh
(counterpart of ``kubebrain_tpu/parallel/multihost.py:25-54``).

The data plane's only cross-process traffic is J6's scan total
(``step.py``), all-reduced over a ``torch.distributed`` group; the control
plane (revision sync, election, forwarding) stays on gRPC/HTTP as in the
JAX package. Nothing on a machine tells a program of a cluster, so the
group is given its address, world size and rank. NCCL takes one card per
rank; the CPU path (gloo) stands in for it in the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .mesh import Mesh


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device=None) -> None:
    """Join the process group (a no-op for one process or fewer):
    ``coordinator_address`` ``host:port`` of rank 0's store, the world
    size and this process's rank; ``nccl`` for ``cuda`` (``device=None``),
    ``gloo`` for the CPU. Without an address, torch's ``env://`` variables
    name the group."""
    import torch.distributed as dist

    if num_processes is not None and num_processes <= 1:
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{coordinator_address}" if coordinator_address
                     else "env://"),
        world_size=num_processes if num_processes is not None else -1,
        rank=process_id if process_id is not None else -1)


def global_data_plane_mesh(wat_axis: int = 1, local_slots: int | None = None,
                           device=None) -> Mesh:
    """This process's slots of the group's ``(part, wat)`` mesh:
    ``local_slots`` (default ``wat_axis``) slots as ``local_slots //
    wat_axis`` rows of ``wat_axis``; on ``cuda`` the cards ``rank ·
    local_slots`` onwards (the processes of one host), on the CPU slots of
    the one CPU device. ``shape`` is the group's, ``part_offset`` this
    process's first ``part`` row."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    world = dist.get_world_size() if grouped else 1
    n = local_slots or wat_axis
    if n % wat_axis:
        raise ValueError(f"wat axis {wat_axis} must divide the {n} local "
                         f"slots")
    dev = resolve_device(device)
    if dev.type == "cuda":
        avail = torch.cuda.device_count()
        if (rank + 1) * n > avail:
            raise ValueError(f"rank {rank} needs cards {rank * n}.."
                             f"{(rank + 1) * n - 1}; {avail} visible")
        slots = [torch.device("cuda", rank * n + i) for i in range(n)]
    else:
        slots = [dev] * n
    arr = np.empty(n, dtype=object)
    arr[:] = slots
    return Mesh(arr.reshape(n // wat_axis, wat_axis), ("part", "wat"),
                process_index=rank, process_count=world)
