"""What the visibility kernels K1/K2 rely on since they classify blocks, on
the CPU.

(a) The precondition: after every way the port's ``cuda`` engine makes a
mirror (a build from the store, a stored-domain delta merge, the capacity
grow, a compaction), the valid rows of every partition are strictly
increasing in (flipped key chunks, revision) and no partition splits a key.

(b) The classification: ``ops/scan.block_classes`` classifies the kernel's
256-row blocks (255 owned, the look-ahead row included) and
``visibility_mask_blocked`` assembles the mask from it as the kernel does.
On sorted mirrors that mask equals the JAX package's jnp
``visibility_mask_queries`` for queries whose bounds fall exactly on the
block edges and on the other edge cases named below. Masks are booleans, so
every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubebrain_tpu.ops import keys as jkeys
from kubebrain_tpu.ops import scan as jscan
from kubebrain_tpu_torch.backend import Backend as TBackend
from kubebrain_tpu_torch.backend import BackendConfig as TConfig
from kubebrain_tpu_torch.backend import wait_for_revision
from kubebrain_tpu_torch.ops import keys as tkeys
from kubebrain_tpu_torch.ops import scan as tscan
from kubebrain_tpu_torch.ops import scan_kernels
from kubebrain_tpu_torch.storage import new_storage as t_new_storage
from kubebrain_tpu_torch.storage.cuda.engine import query_tensors

WIDTH = 64
OWN = tscan.BLOCK_OWNED


# ------------------------------------------------------- (a) sort invariant
def strictly_sorted(keys_t: np.ndarray, revs: np.ndarray, nv: int) -> bool:
    """Rows [0, nv) of one partition (keys int32[C, N] flipped, revs int64[N])
    are strictly increasing in (key chunks, revision)."""
    if nv < 2:
        return True
    k = keys_t[:, :nv].T
    a, b = k[:-1], k[1:]
    differ = a != b
    has = differ.any(axis=1)
    first = differ.argmax(axis=1)
    rows = np.arange(nv - 1)
    key_lt = has & (a[rows, first] < b[rows, first])
    return bool((key_lt | (~has & (revs[: nv - 1] < revs[1:nv]))).all())


def assert_kernel_precondition(mirror):
    keys = mirror.keys_dev.numpy()
    revs = mirror.revs_dev.numpy()
    nv = mirror.n_valid_dev.numpy()
    assert (nv == mirror.n_valid).all()
    edges = []
    for p in range(keys.shape[0]):
        assert strictly_sorted(keys[p], revs[p], int(nv[p])), f"partition {p}"
        if nv[p]:
            edges.append((keys[p][:, 0], keys[p][:, nv[p] - 1]))
    # partitions hold ascending key ranges and never split a version chain
    for (_f0, last), (first, _l1) in zip(edges, edges[1:]):
        differ = np.nonzero(last != first)[0]
        assert len(differ) and last[differ[0]] < first[differ[0]]


def assert_blocked_mask_exact(mirror):
    """On the engine's own mirror, the kernel's block-classified mask is the
    plain mask for a namespace query, a whole-prefix query at an older
    revision and an unbounded one."""
    top = int(mirror.revs_dev.max()) if mirror.rows else 1
    specs = [(b"/registry/pods/ns-1/", b"/registry/pods/ns-10", top),
             (b"/registry/", b"/registry0", max(1, top // 2)),
             (b"/registry/pods/ns-2/p", b"", top)]
    args = (mirror.keys_dev, mirror.revs_dev, mirror.tomb_dev,
            mirror.n_valid_dev, *port_query_tensors(mirror, specs))
    want = tscan.visibility_mask(*args)
    assert torch.equal(tscan.visibility_mask_blocked(*args), want)
    assert want.any()


def port_query_tensors(mirror, specs):
    return query_tensors(mirror.encoding, mirror.key_width, specs, "cpu")


def port_backend(encode, parts, merge_threshold=64):
    store = t_new_storage("cuda", inner="memkv", device="cpu",
                          encode_keys=encode, partitions=parts,
                          merge_threshold=merge_threshold)
    b = TBackend(store, TConfig(event_ring_capacity=16384))
    b.scanner._host_limit_threshold = 0
    return b, store


def churn(b, n_keys, tag=b"p"):
    """Chains, tombstoned keys and singletons over four namespaces; returns
    the last revision."""
    last = 0
    for i in range(n_keys):
        k = b"/registry/pods/ns-%d/%s%04d" % (i % 4, tag, i)
        r = b.create(k, b"v0")
        if i % 3 == 0:
            for j in range(2):
                r = b.update(k, b"v%d" % (j + 1), r)
        elif i % 3 == 1:
            r, _ = b.delete(k, r)
        last = max(last, r)
    assert wait_for_revision(b, last)
    return last


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("encode", [False, True], ids=["raw", "encoded"])
@pytest.mark.parametrize("stage", ["build", "merge", "grow", "compact"])
def test_every_published_mirror_is_sorted(stage, encode, parts):
    b, store = port_backend(encode, parts)
    try:
        last = churn(b, 150)
        sc = b.scanner
        sc.publish()
        assert sc.full_rebuild_total == 1
        assert (sc._mirror.encoding is not None) == encode
        assert sc._mirror.partitions == parts
        cap0 = sc._mirror.keys_host.shape[1]
        if stage == "merge":
            churn(b, 90, tag=b"m")
            sc.publish()
            assert sc.merge_count > 0 and sc._mirror.keys_host.shape[1] == cap0
        elif stage == "grow":
            for i in range(700):  # one partition outgrows its capacity
                last = b.create(b"/registry/pods/ns-3/zz%04d" % i, b"grow")
            assert wait_for_revision(b, last)
            sc.publish()
            assert sc.merge_count > 0 and sc._mirror.keys_host.shape[1] > cap0
        elif stage == "compact":
            churn(b, 30, tag=b"c")
            assert b.compact(last) == last
            assert sc.compact_count == 1 and sc.compact_victims_total > 0
        assert sc.full_rebuild_total == 1, "the stage must not rebuild"
        assert_kernel_precondition(sc._mirror)
        assert_blocked_mask_exact(sc._mirror)
    finally:
        b.close()
        store.close()


# ------------------------------------------------------- (b) classification
def ladder_key(p: int, r: int) -> bytes:
    return b"/reg/%d/k%05d" % (p, r)


#: rows 760..770 of each partition share one key: a version chain across
#: the block edge at row 765 (3·255)
CHAIN = (760, 771)


def ladder(parts: int, n_rows: int, n_valid):
    """P partitions of ``n_rows`` capacity whose first ``n_valid[p]`` rows
    each hold their own key ``ladder_key(p, r)``, except the version chain
    over ``CHAIN``. Revisions are a seeded shuffle (ascending inside the
    chain); 15% tombstones. Returns (keys uint32[P, N, C], revs, tomb, nv)."""
    rng = np.random.RandomState(parts * 1000 + n_rows)
    keys = np.zeros((parts, n_rows, WIDTH // 4), np.uint32)
    revs = np.zeros((parts, n_rows), np.uint64)
    tomb = np.zeros((parts, n_rows), bool)
    for p in range(parts):
        nv = n_valid[p]
        rows = [ladder_key(p, CHAIN[0] if CHAIN[0] <= r < CHAIN[1] else r)
                for r in range(nv)]
        if nv:
            keys[p, :nv] = tkeys.pack_keys(rows, WIDTH)[0]
        rv = rng.permutation(np.arange(1, nv + 1)) + p * 10_000
        lo, hi = CHAIN[0], min(CHAIN[1], nv)
        if hi > lo:
            rv[lo:hi] = np.sort(rv[lo:hi])
        revs[p, :nv] = rv
        tomb[p, :nv] = rng.rand(nv) < 0.15
    return keys, revs, tomb, np.asarray(n_valid, np.int32)


def packed_bounds(specs):
    starts = np.stack([jkeys.pack_one(jkeys.canonicalize_bound(s), WIDTH)
                       for s, _e, _r in specs])
    ends = np.stack([jkeys.pack_one(jkeys.canonicalize_bound(e) if e else b"",
                                    WIDTH) for _s, e, _r in specs])
    for (s, e, _r), srow, erow in zip(specs, starts, ends):  # packages agree
        assert (tkeys.pack_one(tkeys.canonicalize_bound(s), WIDTH) == srow).all()
        if e:
            assert (tkeys.pack_one(tkeys.canonicalize_bound(e), WIDTH) == erow).all()
    return starts, ends


def jnp_masks(keys, revs, tomb, nv, specs):
    """The JAX package's jnp scan, per partition → bool[Q, P, N]."""
    starts, ends = packed_bounds(specs)
    hi, lo = jkeys.split_revs(revs.reshape(-1))
    hi, lo = hi.reshape(revs.shape), lo.reshape(revs.shape)
    qhi, qlo = jkeys.split_revs(np.array([r for _s, _e, r in specs], np.uint64))
    unb = np.array([not e for _s, e, _r in specs])
    return np.stack([np.asarray(jscan.visibility_mask_queries(
        jnp.asarray(keys[p]), jnp.asarray(hi[p]), jnp.asarray(lo[p]),
        jnp.asarray(tomb[p]), jnp.asarray(nv[p]), jnp.asarray(starts),
        jnp.asarray(ends), jnp.asarray(unb), jnp.asarray(qhi),
        jnp.asarray(qlo))) for p in range(keys.shape[0])], axis=1)


def port_args(keys, revs, tomb, nv, specs):
    starts, ends = packed_bounds(specs)
    kt, rv, t8 = tscan.prepare_layout(keys, revs, tomb)
    return (torch.from_numpy(kt), torch.from_numpy(rv), torch.from_numpy(t8),
            torch.from_numpy(nv), torch.from_numpy(tscan.flip_sign(starts)),
            torch.from_numpy(tscan.flip_sign(ends)),
            torch.tensor([int(not e) for _s, e, _r in specs], dtype=torch.int32),
            torch.tensor([r for _s, _e, r in specs], dtype=torch.int64))


def assert_classes_sound(args):
    """OUTSIDE blocks hold no row in range and INSIDE blocks only rows in
    range, over every row each block reads, the look-ahead row included."""
    keys_t, _r, _t, nv, starts, ends, unb, _rr = args
    cls = tscan.block_classes(keys_t, nv, starts, ends, unb)
    exact = tscan.key_in_range(keys_t, starts, ends, unb)
    q, p, nb = cls.shape
    for b in range(nb):
        lo = b * OWN
        for pi in range(p):
            hi = min(lo + tscan.BLOCK_ROWS, int(nv[pi]))
            rows = exact[:, pi, lo:hi] if hi > lo else exact[:, pi, :0]
            for qi in range(q):
                c = int(cls[qi, pi, b])
                if c == tscan.OUTSIDE:
                    assert not rows[qi].any(), (qi, pi, b)
                elif c == tscan.INSIDE:
                    assert hi > lo and rows[qi].all(), (qi, pi, b)
    return cls


def edge_specs(qp: int, top: int):
    """Named edge queries over partition ``qp`` of a ladder."""
    k = lambda r: ladder_key(qp, r)
    chain_revs = top  # the chain's revisions are spread over the ladder's
    specs = {}
    for r in (254, 255, 256, 510):
        specs[f"start_at_row_{r}"] = (k(r), k(r + 100), top)
        specs[f"end_at_row_{r}"] = (k(r - 100), k(r), top)
    specs.update({
        "start_eq_end": (k(300), k(300), top),
        "start_past_every_key": (b"/reg/zzz", b"", top),
        "end_below_every_key": (b"", b"/reg/", top),
        "nul_bound_single_key": (k(255), k(255) + b"\0", top),
        "unbounded_end": (k(100), b"", top),
        "chain_across_block_edge": (k(700), k(800), chain_revs),
    })
    return specs


PARTS = [1, 3]
N_ROWS = 1024
EDGE_NAMES = list(edge_specs(0, 1))


def run_case(parts, n_valid, specs):
    keys, revs, tomb, nv = ladder(parts, N_ROWS, n_valid)
    args = port_args(keys, revs, tomb, nv, specs)
    want = jnp_masks(keys, revs, tomb, nv, specs)
    got = tscan.visibility_mask_blocked(*args).numpy()
    assert (got == want).all()
    assert (tscan.visibility_mask(*args).numpy() == want).all()
    return args, want, assert_classes_sound(args)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", EDGE_NAMES)
def test_blocked_mask_matches_jnp_on_edge_queries(name, parts):
    qp = parts // 2
    n_valid = [N_ROWS - 40] * parts
    top = int(ladder(parts, N_ROWS, n_valid)[1].max())
    spec = edge_specs(qp, top)[name]
    _args, want, cls = run_case(parts, n_valid, [spec])
    if name == "start_at_row_255":
        # block 0 reads row 255 only as its look-ahead row, and straddles
        assert cls[0, qp, 0] == tscan.STRADDLE and cls[0, qp, 1] == tscan.STRADDLE
    if name == "start_eq_end":
        # the block holding the key straddles and its compare finds nothing
        assert not want.any() and cls[0, qp, 1] == tscan.STRADDLE
    elif name in ("start_past_every_key", "end_below_every_key"):
        assert not want.any() and (cls == tscan.OUTSIDE).all()
    elif name != "chain_across_block_edge":
        assert want[0, qp].any()
    if name == "unbounded_end":
        assert (cls[0, qp, 1:4] == tscan.INSIDE).all()


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("read_rev", ["before", "inside", "after"])
def test_version_chain_across_block_edge(read_rev, parts):
    """Rows 760-770 are one key's chain over the edge at row 765: its
    visible version, if any, is the newest at or below the read revision,
    wherever the edge cuts the chain."""
    qp = parts // 2
    n_valid = [N_ROWS - 40] * parts
    revs = ladder(parts, N_ROWS, n_valid)[1][qp, CHAIN[0] : CHAIN[1]]
    rr = {"before": int(revs[0]) - 1, "inside": int(revs[5]),
          "after": int(revs[-1])}[read_rev]
    spec = (ladder_key(qp, CHAIN[0]), ladder_key(qp, CHAIN[0]) + b"\0", rr)
    _args, want, cls = run_case(parts, n_valid, [spec])
    assert cls[0, qp, 2] == tscan.STRADDLE and cls[0, qp, 3] == tscan.STRADDLE
    assert want.sum() <= 1


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("n_valid", [0, 700, 255, 256], ids=lambda n: f"nv{n}")
def test_n_valid_edges(n_valid, parts):
    """An empty partition and n_valid that is (not) a multiple of 255:
    blocks past n_valid are OUTSIDE and rows past it never visible."""
    qp = parts // 2
    nvs = [N_ROWS - 40] * parts
    nvs[qp] = n_valid
    top = int(ladder(parts, N_ROWS, nvs)[1].max()) + 1
    specs = [(b"", b"", top), (ladder_key(qp, 200), b"", top),
             (b"/reg/", ladder_key(qp, max(n_valid - 1, 0)), top)]
    args, want, cls = run_case(parts, nvs, specs)
    assert not want[:, qp, n_valid:].any()
    past = (n_valid + OWN - 1) // OWN
    assert (cls[:, qp, past:] == tscan.OUTSIDE).all()


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("q", [1, 8, 32])
def test_query_batch_with_pow2_padding(q, parts):
    """Q = 1, 8 and 32 edge queries padded to a power of two with copies of
    query 0, as the engine pads a batch."""
    qp = parts // 2
    n_valid = [N_ROWS - 40] * parts
    top = int(ladder(parts, N_ROWS, n_valid)[1].max())
    pool = list(edge_specs(qp, top).values())
    pool += [(ladder_key(qp, r), ladder_key(qp, r + 30), top // (1 + r % 3))
             for r in range(500, 1000, 100)]
    real = {1: 1, 8: 5, 32: len(pool)}[q]
    assert real <= q and len(pool) > 16
    specs = pool[:real] + [pool[0]] * (q - real)
    _args, want, _cls = run_case(parts, n_valid, specs)
    assert want.shape[:2] == (q, parts)
    assert (want[real:] == want[:1]).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_sorted_mirrors(seed):
    """Random sorted partitions with many duplicate keys and random bounds
    drawn from the keys themselves: blocked == plain == jnp."""
    rng = np.random.RandomState(seed)
    parts, n = 2, 900
    keys = np.zeros((parts, n, WIDTH // 4), np.uint32)
    nv = rng.randint(200, n, size=parts).astype(np.int32)
    pool = sorted({b"/reg/%d/%s" % (p, bytes(rng.randint(97, 100, 3, np.uint8)))
                   for p in range(parts) for _ in range(40)})
    for p in range(parts):
        mine = [k for k in pool if k.startswith(b"/reg/%d/" % p)]
        ks = sorted(rng.choice(len(mine), nv[p]))
        keys[p, : nv[p]] = tkeys.pack_keys([mine[i] for i in ks], WIDTH)[0]
    revs = np.zeros((parts, n), np.uint64)
    revs[:, :] = np.arange(1, n + 1)  # ascending inside every chain
    tomb = rng.rand(parts, n) < 0.2
    specs = []
    for _ in range(6):
        s, e = sorted(rng.choice(len(pool), 2))
        specs.append((pool[s], pool[e] if rng.rand() < 0.8 else b"",
                      int(rng.randint(1, n + 1))))
    args = port_args(keys, revs, tomb, nv, specs)
    want = jnp_masks(keys, revs, tomb, nv, specs)
    assert (tscan.visibility_mask_blocked(*args).numpy() == want).all()
    assert_classes_sound(args)


@pytest.mark.parametrize("chunks,ok", [(8, True), (32, True), (33, False)])
def test_kernel_layout_check_caps_the_chunks(chunks, ok):
    """The kernel is compiled for at most 32 chunks (128-byte keys): the
    wrapper's layout check refuses more instead of taking another path."""
    p, n, q = 1, 300, 2
    args = (torch.zeros((p, chunks, n), dtype=torch.int32),
            torch.zeros((p, n), dtype=torch.int64),
            torch.zeros((p, n), dtype=torch.int8),
            torch.zeros(p, dtype=torch.int32),
            torch.zeros((q, chunks), dtype=torch.int32),
            torch.zeros((q, chunks), dtype=torch.int32),
            torch.zeros(q, dtype=torch.int32), torch.zeros(q, dtype=torch.int64))
    if ok:
        assert scan_kernels._check_layout(*args) == (p, chunks, n, q)
    else:
        with pytest.raises(ValueError, match="at most 32 key chunks"):
            scan_kernels._check_layout(*args)
