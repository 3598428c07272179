"""Device-mesh parallelism for the MVCC data plane (counterpart of
``kubebrain_tpu/parallel``).

A mesh is an array of device slots with named axes; each slot holds its own
tensors:

- ``part`` shards the key space: the ``cuda`` mirror's partitions split
  into contiguous runs, one per slot, at user-key borders, so K1-K3 run per
  slot with no cross-slot traffic; the per-partition counts are summed on
  the host (``psum`` in the JAX package);
- ``wat`` shards the watcher table: every slot matches every event against
  its own watcher slice (K4/K5) and the pairs merge back in watcher order.

Across processes (``multihost``) each process holds its own slots and the
scan total is all-reduced over a ``torch.distributed`` group.
"""

from .mesh import Mesh, make_mesh, replicate, shard_rows

__all__ = ["Mesh", "make_mesh", "replicate", "shard_rows"]
