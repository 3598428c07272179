"""``ops/launch_owner.py``: kernel launches counted under the owner the
calling thread names, so that a leader's and a follower's launches in one
process stay apart. On the CPU the wrappers take their plain versions and
launch nothing, so these tests count through :func:`launch_owner.count`
as the wrappers do where they launch."""

import threading

import pytest

from kubebrain_tpu_torch.fanout import DeviceFanout
from kubebrain_tpu_torch.ops import launch_owner
from kubebrain_tpu_torch.ops.fanout import FanoutMatcher
from kubebrain_tpu_torch.storage.cuda.engine import TorchScanner


@pytest.fixture(autouse=True)
def _clean():
    for owner in ("a", "b"):
        launch_owner.take(owner)
    yield
    for owner in ("a", "b"):
        launch_owner.take(owner)


def test_counts_only_under_a_named_owner_and_take_clears():
    launch_owner.count("scan_mask")  # no owner: counted under nobody
    with launch_owner.owned_by("a"):
        launch_owner.count("scan_mask")
        launch_owner.count("scan_mask")
        with launch_owner.owned_by("b"):
            launch_owner.count("victim_mask")
        with launch_owner.owned_by(None):
            launch_owner.count("scan_mask")
        launch_owner.count("fanout_dispatch")
    launch_owner.count("scan_mask")
    assert launch_owner.take("a") == {"scan_mask": 2, "fanout_dispatch": 1}
    assert launch_owner.take("b") == {"victim_mask": 1}
    assert launch_owner.take("a") == {}


def test_an_owner_is_the_calling_threads_own():
    """A thread that named no owner counts nothing, however many launches
    another thread makes under its owner at the same time."""
    start = threading.Barrier(3)

    def run(owner, n):
        start.wait()
        with launch_owner.owned_by(owner):
            for _ in range(n):
                launch_owner.count("scan_mask_q")

    threads = [threading.Thread(target=run, args=("a", 5000)),
               threading.Thread(target=run, args=(None, 7000)),
               threading.Thread(target=run, args=("b", 3000))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert launch_owner.take("a") == {"scan_mask_q": 5000}
    assert launch_owner.take("b") == {"scan_mask_q": 3000}


@pytest.mark.parametrize("cls", [TorchScanner, DeviceFanout, FanoutMatcher])
def test_engines_count_under_nobody_by_default(cls):
    assert cls.launch_owner is None
