"""Several processes over ``torch.distributed`` (``parallel/multihost.py``):
two processes of two CPU slots each join a gloo group and run J6 over
their share of the group's ``(part, wat)`` mesh; the scan totals, all-
reduced over the group, agree and equal the one-process total over four
slots and the JAX step's, computed by ``test_torch_step.jax_reference``
(counterpart of ``tests/test_multihost.py:33``).
The worker is this file's ``__main__``. Tolerance: exact (integers).

    python tests/test_torch_multihost.py RANK WORLD PORT WAT_AXIS
"""

import os
import re
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(rank: int, world: int, port: str, wat: int) -> int:
    sys.path.insert(0, ROOT)
    from kubebrain_tpu_torch.parallel.multihost import (
        global_data_plane_mesh, init_multihost)
    from kubebrain_tpu_torch.parallel.step import (
        make_data_plane_step, make_example_args)

    import torch.distributed as dist

    init_multihost(f"127.0.0.1:{port}", num_processes=world,
                   process_id=rank, device="cpu")
    try:
        mesh = global_data_plane_mesh(wat_axis=wat, local_slots=2,
                                      device="cpu")
        step = make_data_plane_step(mesh)
        vis, total, _victims, fmask = step(*make_example_args(
            mesh, n_parts=mesh.shape["part"], watchers=8))
        slots = mesh.shape["part"] * mesh.shape["wat"]
        print(f"MHRESULT rank={rank} slots={slots} parts={vis.shape[0]} "
              f"local={int(vis.sum())} total={total} "
              f"fmask={int(fmask.sum())}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                    int(sys.argv[4])))


import pytest  # noqa: E402

from kubebrain_tpu.parallel import step as jstep  # noqa: E402
from kubebrain_tpu_torch.parallel import multihost, step  # noqa: E402
from kubebrain_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

from test_torch_step import jax_mesh, jax_reference  # noqa: E402


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("wat", [2, 1])
def test_two_process_group_step(wat):
    """Two processes × two CPU slots: both see the group's four slots,
    their all-reduced totals agree and equal the one-process step over a
    four-slot mesh of the same shape and the JAX step's; each process's
    own visible rows sum to the total."""
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", port,
         str(wat)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        cwd=ROOT) for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        finally:
            p.kill()
        outs.append(out.decode())
        assert p.returncode == 0, out.decode()[-3000:]
    got = []
    for out in outs:
        m = re.search(r"MHRESULT rank=(\d) slots=(\d+) parts=(\d+) "
                      r"local=(\d+) total=(\d+) fmask=(\d+)", out)
        assert m, out[-3000:]
        got.append(tuple(int(x) for x in m.groups()))
    assert [g[1] for g in got] == [4, 4]
    totals = [g[4] for g in got]
    assert totals[0] == totals[1] > 0
    assert sum(g[3] for g in got) == totals[0]

    part = 4 // wat
    mesh = make_mesh(4, axes=("part", "wat"), shape=(part, wat), device="cpu")
    _v, one, _x, fmask = step.make_data_plane_step(mesh)(
        *step.make_example_args(mesh, n_parts=part, watchers=8))
    assert one == totals[0]
    assert all(g[5] == int(fmask.sum()) for g in got)
    _jv, j_total, _jx, j_fmask = jax_reference(jstep.make_example_args(
        jax_mesh(part, wat), n_parts=part, watchers=8))
    assert j_total == one
    assert int(j_fmask.sum()) == int(fmask.sum())


def test_one_process_needs_no_group():
    """One process or fewer is a no-op; without a group the mesh is this
    process's alone."""
    import torch.distributed as dist

    multihost.init_multihost("127.0.0.1:1", num_processes=1, process_id=0,
                             device="cpu")
    assert not dist.is_initialized()
    mesh = multihost.global_data_plane_mesh(wat_axis=2, local_slots=4,
                                            device="cpu")
    assert mesh.shape == {"part": 2, "wat": 2} and mesh.part_offset == 0
    with pytest.raises(ValueError, match="divide"):
        multihost.global_data_plane_mesh(wat_axis=3, local_slots=4,
                                         device="cpu")
