"""The port's plain PyTorch visibility scan (kubebrain_tpu_torch.ops.scan)
and its kernel wrappers on the CPU, against the JAX package's jnp scan and
its Pallas kernels K1/K2 run in interpret mode. Masks are booleans and
counts integers, so every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubebrain_tpu.ops import keys as jkeys
from kubebrain_tpu.ops import scan as jscan
from kubebrain_tpu.ops import scan_pallas as sp
from kubebrain_tpu.storage.tpu import encode as jencode
from kubebrain_tpu_torch.ops import keys as tkeys
from kubebrain_tpu_torch.ops import scan as tscan
from kubebrain_tpu_torch.ops import scan_kernels
from kubebrain_tpu_torch.storage.cuda import encode as tencode

TILE = sp.LANE_TILE


def corpus(seed, n_keys, revs_max, width=64, rev_base=0, chain=None):
    """Sorted (key, rev) version rows: random keys under /reg/, version
    chains of 1..revs_max-1 rows (or exactly ``chain``), 15% tombstones."""
    rng = np.random.RandomState(seed)
    keys = sorted({b"/reg/" + bytes(rng.randint(97, 123, rng.randint(2, 20),
                                                 dtype=np.uint8))
                   for _ in range(n_keys)})
    rows, rev = [], rev_base
    for k in keys:
        for _ in range(chain or rng.randint(1, revs_max)):
            rev += int(rng.randint(1, 3))
            rows.append((k, rev, rng.rand() < 0.15))
    u8 = np.zeros((len(rows), width), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, (k, _r, _t) in enumerate(rows):
        u8[i, : len(k)] = np.frombuffer(k, np.uint8)
        lens[i] = len(k)
    revs = np.array([r[1] for r in rows], dtype=np.uint64)
    tomb = np.array([r[2] for r in rows])
    return u8, lens, revs, tomb


def partitioned(chunks, revs, tomb, parts, n_pad):
    """Split rows into ``parts`` partitions at key boundaries, each padded
    to ``n_pad`` rows → (uint32[P, N, C], uint64[P, N], bool[P, N], int32[P])."""
    n, c = chunks.shape
    cuts = [0]
    for p in range(1, parts):
        pos = p * n // parts
        while 0 < pos < n and (chunks[pos] == chunks[pos - 1]).all():
            pos += 1
        cuts.append(max(pos, cuts[-1]))
    cuts.append(n)
    k = np.zeros((parts, n_pad, c), np.uint32)
    r = np.zeros((parts, n_pad), np.uint64)
    t = np.zeros((parts, n_pad), bool)
    nv = np.zeros(parts, np.int32)
    for p in range(parts):
        lo, hi = cuts[p], cuts[p + 1]
        k[p, : hi - lo], r[p, : hi - lo], t[p, : hi - lo] = \
            chunks[lo:hi], revs[lo:hi], tomb[lo:hi]
        nv[p] = hi - lo
    return k, r, t, nv


def bound_chunks(specs, width, encoding=None):
    """Bounds through each package's own packing: the two must agree."""
    out = []
    for s, e, _r in specs:
        if encoding is None:
            row_j = (jkeys.pack_one(jkeys.canonicalize_bound(s), width),
                     jkeys.pack_one(jkeys.canonicalize_bound(e) if e else b"", width))
            row_t = (tkeys.pack_one(tkeys.canonicalize_bound(s), width),
                     tkeys.pack_one(tkeys.canonicalize_bound(e) if e else b"", width))
        else:
            jenc, tenc = encoding
            row_j = tuple(jkeys.bytes_to_chunks(b[None])[0] for b in (
                jenc.encode_start_bound(jkeys.canonicalize_bound(s)),
                jenc.encode_end_bound(jkeys.canonicalize_bound(e)) if e
                else np.zeros(jenc.width, np.uint8)))
            row_t = tuple(tkeys.bytes_to_chunks(b[None])[0] for b in (
                tenc.encode_start_bound(tkeys.canonicalize_bound(s)),
                tenc.encode_end_bound(tkeys.canonicalize_bound(e)) if e
                else np.zeros(tenc.width, np.uint8)))
        assert all((a == b).all() for a, b in zip(row_j, row_t))
        out.append(row_j)
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def jnp_masks(keys, revs, tomb, nv, starts, ends, specs):
    """JAX jnp oracle: visibility_mask_queries per partition → [Q, P, N]."""
    hi, lo = jkeys.split_revs(revs.reshape(-1))
    hi, lo = hi.reshape(revs.shape), lo.reshape(revs.shape)
    qhi, qlo = jkeys.split_revs(np.array([r for _s, _e, r in specs], np.uint64))
    unb = np.array([not e for _s, e, _r in specs])
    out = [np.asarray(jscan.visibility_mask_queries(
        jnp.asarray(keys[p]), jnp.asarray(hi[p]), jnp.asarray(lo[p]),
        jnp.asarray(tomb[p]), jnp.asarray(nv[p]), jnp.asarray(starts),
        jnp.asarray(ends), jnp.asarray(unb), jnp.asarray(qhi), jnp.asarray(qlo)))
        for p in range(keys.shape[0])]
    return np.stack(out, axis=1)


def pallas_masks(keys, revs, tomb, nv, starts, ends, specs, single=False):
    """The Pallas kernels in interpret mode, per partition → [Q, P, N]."""
    qhi, qlo = sp.split_revs31(np.array([r for _s, _e, r in specs], np.uint64))
    unb = np.array([not e for _s, e, _r in specs], np.int32)
    s_f, e_f = sp.flip_sign(starts), sp.flip_sign(ends)
    out = []
    for p in range(keys.shape[0]):
        kt, rh, rl, t8, n = sp.prepare_blocks(keys[p], revs[p], tomb[p])
        args = (jnp.asarray(kt), jnp.asarray(rh), jnp.asarray(rl), jnp.asarray(t8),
                np.int32(nv[p]))
        if single:
            m = np.asarray(sp.scan_mask_pallas(
                *args, jnp.asarray(s_f[0]), jnp.asarray(e_f[0]), np.int32(unb[0]),
                np.int32(qhi[0]), np.int32(qlo[0]), interpret=True))[None]
        else:
            m = np.asarray(sp.scan_mask_pallas_q(
                *args, jnp.asarray(s_f), jnp.asarray(e_f), jnp.asarray(unb),
                jnp.asarray(qhi), jnp.asarray(qlo), interpret=True))
        out.append(m[:, :n])
    return np.stack(out, axis=1)


def port_masks(keys, revs, tomb, nv, starts, ends, specs):
    kt, rv, t8 = tscan.prepare_layout(keys, revs, tomb)
    return tscan.visibility_mask(
        torch.from_numpy(kt), torch.from_numpy(rv), torch.from_numpy(t8),
        torch.from_numpy(nv), torch.from_numpy(tscan.flip_sign(starts)),
        torch.from_numpy(tscan.flip_sign(ends)),
        torch.tensor([not e for _s, e, _r in specs]),
        torch.tensor([r for _s, _e, r in specs], dtype=torch.int64)).numpy()


def specs_for(revs):
    top = int(revs.max())
    return [
        (b"", b"", top),
        (b"/reg/f", b"/reg/q", top * 2 // 3),
        (b"/reg/zzzz", b"", top),
        (b"/reg/m\x00", b"/reg/t\x00", top // 3 or 1),   # NUL-canonicalized
        (b"/reg/", b"/reg0", int(revs.min())),
    ]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("parts", [1, 3])
def test_plain_matches_jnp_batched_over_partitions_and_queries(seed, parts):
    u8, _lens, revs, tomb = corpus(seed, 300, 5)
    chunks = jkeys.bytes_to_chunks(u8)
    keys, r, t, nv = partitioned(chunks, revs, tomb, parts, 1024)
    specs = specs_for(revs)
    starts, ends = bound_chunks(specs, 64)
    want = jnp_masks(keys, r, t, nv, starts, ends, specs)
    got = port_masks(keys, r, t, nv, starts, ends, specs)
    assert want.any() and (got == want).all()


@pytest.mark.parametrize("rev_base", [0, 2**31 - 5, 2**33])
def test_chains_across_tiles_match_pallas(rev_base):
    """Three-row chains straddle the 4096-row tile edges and ``n_valid`` is
    no multiple of the tile; revisions reach past 2^31."""
    u8, _lens, revs, tomb = corpus(11, 3100, 0, rev_base=rev_base, chain=3)
    chunks = jkeys.bytes_to_chunks(u8)
    n = len(revs)
    assert n > 2 * TILE and n % TILE
    keys, r, t, nv = partitioned(chunks, revs, tomb, 1, n + 37)
    specs = specs_for(revs)
    starts, ends = bound_chunks(specs, 64)
    got = port_masks(keys, r, t, nv, starts, ends, specs)
    assert (got == jnp_masks(keys, r, t, nv, starts, ends, specs)).all()
    assert (got == pallas_masks(keys, r, t, nv, starts, ends, specs)).all()
    assert (got[:1] == pallas_masks(keys, r, t, nv, starts, ends, specs[:1],
                                    single=True)).all()


@pytest.mark.parametrize("encoded", [False, True])
def test_raw_and_encoded_widths_match_pallas(encoded):
    u8, lens, revs, tomb = corpus(5, 400, 6, width=128)
    specs = specs_for(revs)
    encoding = None
    if encoded:
        jenc = jencode.build_encoding(u8, lens, raw_width=128)
        tenc = tencode.build_encoding(u8, lens, raw_width=128)
        assert jenc.boundaries == tenc.boundaries and jenc.strips == tenc.strips
        enc_j, _ = jenc.encode_keys(u8, lens)
        enc_t, _ = tenc.encode_keys(u8, lens)
        assert (enc_j == enc_t).all()
        u8, encoding = enc_j, (jenc, tenc)
    chunks = jkeys.bytes_to_chunks(u8)
    assert chunks.shape[1] == (jenc.chunks if encoded else 32)
    keys, r, t, nv = partitioned(chunks, revs, tomb, 2, 2048)
    starts, ends = bound_chunks(specs, 128, encoding)
    got = port_masks(keys, r, t, nv, starts, ends, specs)
    assert (got == jnp_masks(keys, r, t, nv, starts, ends, specs)).all()
    assert (got == pallas_masks(keys, r, t, nv, starts, ends, specs)).all()


def test_q_padded_to_pow2_matches_pallas_q_wrapper():
    """The K2 wrapper on CPU tensors, Q = 5 padded to 8 with copies of
    query 0 as the engine pads it: rows [:5] match the Pallas kernel, the
    padding copies match query 0, counts are the mask's row sums."""
    u8, _lens, revs, tomb = corpus(7, 250, 4)
    keys, r, t, nv = partitioned(jkeys.bytes_to_chunks(u8), revs, tomb, 2, 512)
    specs = specs_for(revs)
    padded = specs + [specs[0]] * 3
    starts, ends = bound_chunks(padded, 64)
    kt, rv, t8 = tscan.prepare_layout(keys, r, t)
    mask, counts = scan_kernels.visibility_mask_batch_q(
        torch.from_numpy(kt), torch.from_numpy(rv), torch.from_numpy(t8),
        torch.from_numpy(nv), torch.from_numpy(tscan.flip_sign(starts)),
        torch.from_numpy(tscan.flip_sign(ends)),
        torch.tensor([int(not e) for _s, e, _r in padded], dtype=torch.int32),
        torch.tensor([q[2] for q in padded], dtype=torch.int64))
    mask, counts = mask.numpy(), counts.numpy()
    assert mask.shape == (8, 2, 512) and counts.shape == (8, 2)
    want = pallas_masks(keys, r, t, nv, starts[:5], ends[:5], specs)
    assert (mask[:5] == want).all()
    assert (mask[5:] == mask[:1]).all()
    assert (counts == mask.sum(axis=2)).all()
    assert scan_kernels.visibility_mask_batch_q.launches == 0  # CPU: no kernel


def test_k1_wrapper_matches_jnp_and_counts():
    u8, _lens, revs, tomb = corpus(9, 200, 5)
    keys, r, t, nv = partitioned(jkeys.bytes_to_chunks(u8), revs, tomb, 3, 512)
    spec = [(b"/reg/c", b"/reg/w", int(revs.max()) // 2)]
    starts, ends = bound_chunks(spec, 64)
    kt, rv, t8 = tscan.prepare_layout(keys, r, t)
    mask, counts = scan_kernels.visibility_mask_batch(
        torch.from_numpy(kt), torch.from_numpy(rv), torch.from_numpy(t8),
        torch.from_numpy(nv), torch.from_numpy(tscan.flip_sign(starts[0])),
        torch.from_numpy(tscan.flip_sign(ends[0])),
        torch.tensor([0], dtype=torch.int32),
        torch.tensor([spec[0][2]], dtype=torch.int64))
    want = jnp_masks(keys, r, t, nv, starts, ends, spec)[0]
    assert mask.shape == (3, 512) and (mask.numpy() == want).all()
    assert (counts.numpy() == want.sum(axis=1)).all()
    assert scan_kernels.visibility_mask_batch.launches == 0  # CPU: no kernel


@pytest.mark.parametrize("seed", [1, 2])
def test_lex_less_matches_jnp(seed):
    rng = np.random.RandomState(seed)
    chunks = rng.randint(0, 4, size=(300, 6)).astype(np.uint32) * np.uint32(0x7FFFFFFF)
    bounds = rng.randint(0, 4, size=(4, 6)).astype(np.uint32) * np.uint32(0x7FFFFFFF)
    want = np.stack([np.asarray(jscan.lex_less(jnp.asarray(chunks), jnp.asarray(b)))
                     for b in bounds])
    kt = torch.from_numpy(np.ascontiguousarray(tscan.flip_sign(chunks).T[None]))
    got = tscan.lex_less(kt, torch.from_numpy(tscan.flip_sign(bounds)))[:, 0].numpy()
    assert (got == want).all()
