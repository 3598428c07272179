"""The port's leader election (``kubebrain_tpu_torch/backend/election.py``)
over the ``cuda`` engine on memkv and on native, with ``device="cpu"``:
counterparts of the election tests of ``tests/test_retry_election.py``.
The lock record lives in the host engine under the mirror, and the
election reads and writes it through the ``cuda`` engine's ``get``,
``put_if_not_exist`` and ``cas``."""

import time

import pytest

from kubebrain_tpu_torch.backend import Backend, BackendConfig, wait_for_revision
from kubebrain_tpu_torch.backend.election import LeaderElection, ResourceLock
from kubebrain_tpu_torch.storage import new_storage

INNER = ("memkv", "native")


def cuda_store(inner: str):
    return new_storage("cuda", inner=inner, device="cpu")


@pytest.mark.parametrize("inner", INNER)
def test_resource_lock_acquire_steal(inner):
    store = cuda_store(inner)
    lock_a = ResourceLock(store, "node-a")
    lock_b = ResourceLock(store, "node-b")
    ea = LeaderElection(lock_a, lease_seconds=0.3, renew_interval=0.05, retry_interval=0.02)
    eb = LeaderElection(lock_b, lease_seconds=0.3, renew_interval=0.05, retry_interval=0.02)
    assert ea.try_acquire_once()
    assert not eb.try_acquire_once()
    assert ea.leader_identity() == "node-a"
    # lease expires without renewal → b steals
    time.sleep(0.35)
    assert eb.try_acquire_once()
    assert eb.leader_identity() == "node-b"
    store.close()


@pytest.mark.parametrize("inner", INNER)
def test_election_campaign_callbacks(inner):
    store = cuda_store(inner)
    store_rev_seen = []
    ea = LeaderElection(
        ResourceLock(store, "node-a"),
        on_started_leading=lambda rev: store_rev_seen.append(rev),
        lease_seconds=0.5,
        renew_interval=0.05,
        retry_interval=0.02,
    )
    ea.campaign()
    assert ea.wait_for_leadership(2.0)
    assert store_rev_seen and store_rev_seen[0] >= 0
    ea.close()
    store.close()


@pytest.mark.parametrize("inner", INNER)
def test_lock_tso_seeds_revision(inner):
    """The lock record carries the engine clock so a new leader resumes
    revisions monotonically (election.go Describe → leader.go:96-107)."""
    store = cuda_store(inner)
    b = Backend(store, BackendConfig(event_ring_capacity=1024))
    b.create(b"/k", b"v")
    assert wait_for_revision(b, 1)
    lock = ResourceLock(store, "node-a")
    rec = lock.create()
    assert rec.tso >= 1
    b.close()
    store.close()


@pytest.mark.parametrize("inner", INNER)
def test_renew_error_drops_leadership(inner):
    """A non-CAS storage error during renewal makes the campaign report
    not-leader and fire on_stopped_leading, not kill the thread with
    _is_leader still set (split-brain)."""
    store = cuda_store(inner)
    stopped = []
    ea = LeaderElection(
        ResourceLock(store, "node-a"),
        on_stopped_leading=lambda: stopped.append(True),
        lease_seconds=0.5,
        renew_interval=0.03,
        retry_interval=0.02,
    )
    ea.campaign()
    assert ea.wait_for_leadership(2.0)
    # sabotage the lock: every storage op now raises an unexpected error
    real_get = store.get
    store.get = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("engine down"))
    deadline = time.monotonic() + 3.0
    while ea.is_leader() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not ea.is_leader(), "leadership must drop when renewal cannot be proven"
    assert stopped, "on_stopped_leading must fire"
    store.get = real_get
    ea.close()
    store.close()
