"""The collector's passes in the window, as a run's host line reads them."""

from __future__ import annotations

import gc

from kbbench import hostinfo


def test_collections_count_the_passes_while_open():
    c = hostinfo.Collections()
    c.open()
    try:
        gc.collect()
        gc.collect(0)
    finally:
        c.close()
    gc.collect()
    assert c.counts[2] == 1 and c.counts[0] >= 1
    assert len(c.full_ms) == 1 and c.full_ms[0] >= 0
    assert c not in gc.callbacks
    assert "full ones pausing" in c.line()

