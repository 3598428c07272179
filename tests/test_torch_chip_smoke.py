"""``chip_smoke.py``'s phases rehearsed on the CPU at a small size.

CPU tensors take the kernels' plain versions and launch nothing, so the
rehearsal counts a launch where a wrapper calls its plain version, on the
wrapper's own counter, and stubs the CUDA clock and synchronisation. What
it checks is the script's control flow: every comparison it makes against
the plain versions and the host ``Scanner``, the launch checks, and the
compaction against the twin store. It measures nothing on a device.

Run as a script, it rehearses at a chosen size and prints each phase's
host seconds (CPU numbers, not device metrics)::

    JAX_PLATFORMS=cpu python tests/test_torch_chip_smoke.py --keys 100000
"""

import argparse
import sys
import time
import types
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from kubebrain_tpu_torch.ops import compact as tcompact  # noqa: E402
from kubebrain_tpu_torch.ops import compact_kernels, scan_kernels  # noqa: E402
from kubebrain_tpu_torch.ops import scan as tscan  # noqa: E402

CPU = torch.device("cpu")


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the host clock."""

    def __init__(self, **_kw):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def cpu_shims(setattr_) -> None:
    """Install the rehearsal's stand-ins with ``setattr_(obj, name, value)``."""
    setattr_(torch.cuda, "synchronize", lambda *a: None)
    setattr_(torch.cuda, "Event", _HostEvent)
    setattr_(torch.cuda, "empty_cache", lambda: None)

    def victim_mask(*args):
        compact_kernels.victim_mask_batch.launches += 1
        return tcompact.victim_mask(*args)

    def visibility_mask(keys_t, revs, tomb, nv, starts, ends, unb, rrevs):
        # K1 passes one query; K2 two or more (scan_batch sends a single
        # device query to K1, and the script's K2 cases hold eight)
        wrapper = (scan_kernels.visibility_mask_batch if starts.shape[0] == 1
                   else scan_kernels.visibility_mask_batch_q)
        wrapper.launches += 1
        return tscan.visibility_mask(keys_t, revs, tomb, nv, starts, ends,
                                     unb, rrevs)

    setattr_(compact_kernels, "compact",
             types.SimpleNamespace(victim_mask=victim_mask))
    setattr_(scan_kernels, "scan",
             types.SimpleNamespace(visibility_mask=visibility_mask))


@pytest.fixture
def shims(monkeypatch):
    cpu_shims(monkeypatch.setattr)
    scan_kernels.reset_launch_counts()
    compact_kernels.reset_launch_counts()
    yield
    scan_kernels.reset_launch_counts()
    compact_kernels.reset_launch_counts()


def test_kernel_phases(shims):
    """Phases (b) and (d): every case agrees with the plain version and
    reports a bound; the long-chain case expires some chains whole."""
    layouts = chip_smoke.bench_layouts(300)
    bench = chip_smoke.kernel_phase(layouts, 4, CPU)
    victims = chip_smoke.victim_phase(layouts, 4, CPU)
    assert len(bench) == 4 and len(victims) == 7
    for m in [*bench.values(), *victims.values()]:
        assert m["max_abs_err"] == 0
    for m in bench.values():
        assert m["bound_by"] == "bytes" and m["bound_ms"] > 0
    assert victims[("raw", "long chains")]["victims"] > 0
    assert all(v["victims"] > 0 for v in victims.values())


@pytest.mark.parametrize("seed", [0, 1])
def test_main_path_and_compaction(shims, seed):
    """Phases (c) and (e) on one store: the reads equal the host scanner,
    the compaction equals the host scanner's on the twin, and every kernel
    of the path counts its launches."""
    n_keys = 2000
    store, top = chip_smoke.load_store(n_keys, seed, CPU)
    backend = chip_smoke.Backend(store, chip_smoke.BackendConfig())
    try:
        launches, cases = chip_smoke.serve_phase(backend, store, top, CPU)
        compacted = chip_smoke.compact_phase(backend, store, top, n_keys, CPU)
    finally:
        backend.close()
        store.close()
    assert min(launches.values()) > 0 and compacted["launches"] == 1
    assert compacted["case"]["max_abs_err"] == 0
    assert all(m["max_abs_err"] == 0 for m in cases.values())


@pytest.mark.parametrize("moved", [*chip_smoke.OFF_DEVICE_COUNTERS,
                                   "full_rebuild_total", "quarantined"])
def test_off_device_guard_fails(moved):
    """A failure that a retry absorbed, a degraded window or a rebuild from
    the store fails the run even when every answer was right."""
    scanner = types.SimpleNamespace(
        full_rebuild_total=1, _mirror_state="serving",
        **{k: 0 for k in chip_smoke.OFF_DEVICE_COUNTERS})
    chip_smoke.stayed_on_device(scanner, 1, "clean")
    if moved == "quarantined":
        scanner._mirror_state = moved
    else:
        setattr(scanner, moved, getattr(scanner, moved) + 1)
    with pytest.raises(AssertionError, match="left the device"):
        chip_smoke.stayed_on_device(scanner, 1, "faulty")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=100_000)
    ap.add_argument("--kernel-keys", type=int, default=2000)
    ap.add_argument("--kernel-revs", type=int, default=10)
    args = ap.parse_args()
    cpu_shims(setattr)
    t0 = time.perf_counter()
    layouts = chip_smoke.bench_layouts(args.kernel_keys)
    chip_smoke.kernel_phase(layouts, args.kernel_revs, CPU)
    chip_smoke.victim_phase(layouts, args.kernel_revs, CPU)
    t1 = time.perf_counter()
    store, top = chip_smoke.load_store(args.keys, args.seed, CPU)
    backend = chip_smoke.Backend(store, chip_smoke.BackendConfig())
    try:
        chip_smoke.serve_phase(backend, store, top, CPU)
        t2 = time.perf_counter()
        chip_smoke.compact_phase(backend, store, top, args.keys, CPU)
        t3 = time.perf_counter()
    finally:
        backend.close()
        store.close()
    print(f"host seconds on the CPU: kernel phases {t1 - t0}, load and serve "
          f"{t2 - t1}, compaction phase {t3 - t2}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
