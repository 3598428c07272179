"""The device mesh across cards, on a machine with two or more of them.

``chip_smoke.py`` runs its phase (l) on two slots of one card where the
machine has one card. This script runs what needs several:

(c) a ``cuda`` store of ``KEYS`` kube keys on ``cuda:0`` serving (c)'s
    requests, every answer held against the host scanner;
(l) ``chip_smoke.py``'s phase (l) after it, on two distinct cards: (c)'s
    reads on a mirror split over them, (l2)'s writes, dirty-slot publishes
    and compaction, (l3)'s split watcher table and (l4)'s J6, each held
    against the one-slot result;
(m) the ``cuda`` engine's default placement, one mirror slot per visible
    card (what the CLI serves with no ``--mesh-part``), beside a store on
    ``cuda:0`` loaded with the same rows: both serve (c)'s requests and
    writes against their host scanners, the default one's mirror must hold
    one slot on every card, then both compact at one revision and must
    leave equal stores and victims, K3 once per card.

    python3 chip_mesh.py

Exits 2 with fewer than two cards. Prints the cards' names and power
limits, each part's seconds and the kernel launches under (l)'s owner;
the last line is one JSON object with ``"ok": true``.
"""

import json
import subprocess
import sys
import time
import types

import torch

import chip_smoke as cs
from kubebrain_tpu_torch import _build
from kubebrain_tpu_torch.backend import Backend, BackendConfig
from kubebrain_tpu_torch.backend.scanner import Scanner
from kubebrain_tpu_torch.ops import launch_owner
from kubebrain_tpu_torch.storage import new_storage

#: (c)'s store here (``chip_smoke.py``'s holds 1,000,000 keys)
KEYS = 200_000
#: (m)'s store
WIDE_KEYS = 100_000
SEED = 0


def cards() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()


def every_card(n_keys: int, seed: int, slots: list) -> dict:
    """(m): the default placement, whose mirror must be split over
    ``slots`` (every card, in order), against one card on the same rows."""
    rows, top = cs.kube_dataset(n_keys, seed)
    stores = [new_storage("cuda", inner="memkv", device=cs.CARD,
                          ttl_supported=False),
              new_storage("cuda", inner="memkv", ttl_supported=False)]
    backends = []
    try:
        for st in stores:
            cs.load_rows(st.untracked(), rows, top)
            backends.append(Backend(st, BackendConfig()))
        plain, wide = backends
        wide.scanner.launch_owner = cs.MESH_OWNER
        for b in backends:
            b.scanner.publish()
        shards = wide.scanner._mirror.shards
        if [sh.device for sh in shards] != slots:
            raise AssertionError(f"(m) the default mirror's slots "
                                 f"{[str(sh.device) for sh in shards]} are "
                                 f"not {[str(d) for d in slots]}")
        rebuilds = wide.scanner.full_rebuild_total
        for b, what in ((plain, "(m) one card"), (wide, "(m) every card")):
            oracle = Scanner(b.store.untracked(),
                             get_compact_revision=lambda _s: 0)
            try:
                cs.serve_requests(b, oracle, top, what, reps=1)
            finally:
                oracle.close()
        launches = cs.mesh_compaction(plain, wide, "(m)")
        cs.stayed_on_device(wide.scanner, rebuilds, "(m)")
        return {"slots": len(shards), "rows": wide.scanner._mirror.rows,
                "launches": dict(launches)}
    finally:
        for b in backends:
            b.close()
        for st in stores:
            st.close()


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_mesh: needs two or more CUDA devices", file=sys.stderr)
        return 2
    seconds = {}
    t0 = time.perf_counter()
    _build.build_all()
    seconds["build"] = time.perf_counter() - t0
    for line in cards():
        cs.log(f"card: {line}")
    dev = cs.resolve_device(cs.CARD)

    t0 = time.perf_counter()
    store, top = cs.load_store(KEYS, SEED, dev)
    backend = Backend(store, BackendConfig())
    try:
        cs.serve_phase(backend, store, top, dev)
        seconds["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        meshed = cs.mesh_phase(backend, store, top, types.SimpleNamespace(
            seed=SEED, watchers=10_000, block_events=512), dev)
        seconds["l"] = time.perf_counter() - t0
    finally:
        backend.close()
        store.close()
    if meshed["what"] != "two cards":
        raise AssertionError(f"(l) ran on {meshed['what']}")

    t0 = time.perf_counter()
    launch_owner.take(cs.MESH_OWNER)
    wide = every_card(WIDE_KEYS, SEED, [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    seconds["m"] = time.perf_counter() - t0
    cs.log(f"seconds: {json.dumps(seconds)}")
    cs.log(json.dumps({"ok": True, "cards": torch.cuda.device_count(),
                       "mesh_launches": meshed["launches"],
                       "default_slots": wide["slots"],
                       "default_launches": wide["launches"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
