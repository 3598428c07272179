"""J6, the data-plane step (``kubebrain_tpu_torch/parallel/step.py``), held
against the JAX package on the CPU: the same seeded example arguments, the
visibility masks, the scan total, the victim masks and the fan-out mask.
Two JAX references: ``make_data_plane_step`` itself, under ``shard_map`` on
conftest's 8 virtual host devices (where this jax has ``jax.shard_map``),
and :func:`jax_reference`, the same step's one-device functions over the
gathered arrays, which runs on any jax. The port's step runs as per-slot
wrapper calls on CPU slots (the wrappers' plain versions). Tolerance:
exact (booleans and integers).
"""

import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import jax
from kubebrain_tpu.ops import compact as jcompact
from kubebrain_tpu.ops import fanout as jfanout
from kubebrain_tpu.ops import keys as jkeys
from kubebrain_tpu.ops import scan as jscan
from kubebrain_tpu.parallel import step as jstep
from kubebrain_tpu_torch.ops.scan import flip_sign
from kubebrain_tpu_torch.parallel import step as tstep
from kubebrain_tpu_torch.parallel.mesh import Mesh, make_mesh

needs_shard_map = pytest.mark.skipif(
    not hasattr(jax, "shard_map"),
    reason="the JAX step is built on jax.shard_map, which this jax lacks")


def jax_mesh(part, wat):
    return JMesh(np.array(jax.devices()[:part * wat]).reshape(part, wat),
                 ("part", "wat"))


def jax_reference(args) -> tuple:
    """``(vis, total, victims, fmask)`` of the JAX step on its example
    ``args``, from the one-device functions it runs on every shard
    (``kubebrain_tpu/parallel/step.py:56-64``) over the gathered arrays:
    each partition and each watcher is computed alone, so the gathered
    result is the sharded one, and the ``psum`` over ``part`` is the sum."""
    (keys, rh, rl, tomb, ttl, nv, start, end, unb, qhi, qlo, chi, clo, thi,
     tlo, ws, we, wu, whi, wlo, ek, ehi, elo) = args
    vis = np.asarray(jax.vmap(lambda k, a, b, t, n: jscan.visibility_mask(
        k, a, b, t, n, start, end, unb, qhi, qlo))(keys, rh, rl, tomb, nv))
    victims = jax.vmap(lambda k, a, b, t, x, n: jcompact.victim_mask(
        k, a, b, t, x, n, chi, clo, thi, tlo))(keys, rh, rl, tomb, ttl, nv)
    fmask = jfanout.fanout_mask_range(ek, ehi, elo, ws, we, wu, whi, wlo)
    return vis, int(vis.sum()), np.asarray(victims), np.asarray(fmask)


@pytest.mark.parametrize("n_parts,watchers,events,seed", [
    (4, 8, 8, 0), (8, 16, 12, 3)])
def test_example_args_equal_the_jax_ones(n_parts, watchers, events, seed):
    """The port's example arrays are the JAX ones in the port's layout:
    flipped chunk-major keys, joined int64 revisions, int8 flags."""
    j = jstep.make_example_args(jax_mesh(4, 2), n_parts=n_parts,
                                watchers=watchers, events=events, seed=seed)
    (keys, rh, rl, tomb, ttl, nv, start, end, unb, qhi, qlo, chi, clo, thi,
     tlo, ws, we, wu, whi, wlo, ek, ehi, elo) = j
    t = tstep.example_arrays(n_parts, watchers=watchers, events=events,
                             seed=seed)
    assert (t["keys"] == np.transpose(flip_sign(keys), (0, 2, 1))).all()
    assert (t["revs"] == jkeys.join_revs(rh, rl).astype(np.int64)).all()
    assert (t["tomb"] == tomb.astype(np.int8)).all()
    assert (t["ttl"] == ttl.astype(np.int8)).all()
    assert (t["n_valid"] == nv).all()
    assert (t["start"] == flip_sign(start)).all()
    assert (t["end"] == flip_sign(end)).all()
    assert t["unbounded"] == bool(unb)
    assert t["read_rev"] == int(jkeys.join_revs(qhi, qlo))
    assert t["compact_rev"] == int(jkeys.join_revs(chi, clo))
    assert t["ttl_cutoff"] == int(jkeys.join_revs(thi, tlo)) == 0
    assert (t["w_start"] == flip_sign(ws)).all()
    assert (t["w_end"] == flip_sign(we)).all()
    assert (t["w_unbounded"] == wu).all()
    assert (t["w_min_rev"] == jkeys.join_revs(whi, wlo).astype(np.int64)).all()
    assert (t["ev_keys"] == flip_sign(ek)).all()
    assert (t["ev_revs"] == jkeys.join_revs(ehi, elo).astype(np.int64)).all()


@needs_shard_map
@pytest.mark.parametrize("part,wat,n_parts", [(4, 2, 4), (4, 2, 8), (8, 1, 8),
                                              (2, 4, 2)])
def test_step_equals_the_jax_step(part, wat, n_parts):
    """vis, total, victims and fmask of the port's step on a (part, wat)
    mesh of CPU slots equal the JAX step's on the same shape."""
    jm = jax_mesh(part, wat)
    j_args = jstep.make_example_args(jm, n_parts=n_parts, watchers=16)
    j_vis, j_total, j_vic, j_fmask = jstep.make_data_plane_step(jm)(*j_args)
    mesh = make_mesh(part * wat, axes=("part", "wat"), shape=(part, wat),
                     device="cpu")
    vis, total, victims, fmask = tstep.make_data_plane_step(mesh)(
        *tstep.make_example_args(mesh, n_parts=n_parts, watchers=16))
    assert vis.dtype == victims.dtype == fmask.dtype == torch.bool
    assert (vis.numpy() == np.asarray(j_vis)).all()
    assert total == int(j_total) > 0
    assert (victims.numpy() == np.asarray(j_vic)).all()
    assert victims.any() and not victims.all()
    assert (fmask.numpy() == np.asarray(j_fmask)).all()
    assert fmask.any()


@pytest.mark.parametrize("part,wat,n_parts", [(4, 2, 4), (4, 2, 8), (8, 1, 8),
                                              (2, 4, 2)])
def test_step_equals_the_jax_functions(part, wat, n_parts):
    """vis, total, victims and fmask of the port's step on a (part, wat)
    mesh of CPU slots equal :func:`jax_reference` on the JAX example
    arguments of the same shape."""
    j_vis, j_total, j_vic, j_fmask = jax_reference(jstep.make_example_args(
        jax_mesh(part, wat), n_parts=n_parts, watchers=16))
    mesh = make_mesh(part * wat, axes=("part", "wat"), shape=(part, wat),
                     device="cpu")
    vis, total, victims, fmask = tstep.make_data_plane_step(mesh)(
        *tstep.make_example_args(mesh, n_parts=n_parts, watchers=16))
    assert (vis.numpy() == j_vis).all() and vis.shape == j_vis.shape
    assert total == j_total > 0
    assert (victims.numpy() == j_vic).all() and victims.shape == j_vic.shape
    assert victims.any() and not victims.all()
    assert (fmask.numpy() == j_fmask).all() and fmask.shape == j_fmask.shape
    assert fmask.any()


def test_step_over_slots_of_one_device_equals_one_slot():
    """A mesh may name a device twice: the step over a (2, 2) mesh of one
    device's slots equals the (1, 1) step on the same arguments."""
    one = Mesh(np.array([[torch.device("cpu")]], dtype=object),
               ("part", "wat"))
    four = make_mesh(4, axes=("part", "wat"), shape=(2, 2), device="cpu")
    a = tstep.make_data_plane_step(one)(
        *tstep.make_example_args(one, n_parts=4, watchers=8))
    b = tstep.make_data_plane_step(four)(
        *tstep.make_example_args(four, n_parts=4, watchers=8))
    assert torch.equal(a[0], b[0]) and a[1] == b[1]
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


def test_example_args_split_evenly():
    mesh = make_mesh(6, axes=("part", "wat"), shape=(3, 2), device="cpu")
    with pytest.raises(ValueError):
        tstep.make_example_args(mesh, n_parts=4)
    with pytest.raises(ValueError):
        tstep.make_example_args(mesh, watchers=7)


def test_shard_rows_and_replicate():
    """``shard_rows`` splits the leading axis into one contiguous run per
    slot of an axis and refuses an uneven split; ``replicate`` puts a copy
    on every slot."""
    from kubebrain_tpu_torch.parallel.mesh import replicate, shard_rows

    mesh = make_mesh(6, axes=("part", "wat"), shape=(3, 2), device="cpu")
    rows = np.arange(12).reshape(6, 2)
    parts = shard_rows(mesh, rows, "part")
    assert [p.tolist() for p in parts] == [rows[i * 2:(i + 1) * 2].tolist()
                                           for i in range(3)]
    assert [p.tolist() for p in shard_rows(mesh, rows, "wat")] == [
        rows[:3].tolist(), rows[3:].tolist()]
    with pytest.raises(ValueError):
        shard_rows(mesh, rows[:5], "part")
    copies = replicate(mesh, rows, "wat")
    assert len(copies) == 2 and all((c.numpy() == rows).all() for c in copies)
    copies[0][0, 0] = -1
    assert rows[0, 0] == 0 and copies[1][0, 0] == 0
