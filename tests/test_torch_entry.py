"""The port's ``entry()`` (``kubebrain_tpu_torch/entry.py``) against the
JAX ``entry()`` of ``__graft_entry__.py``: the same scan step on the same
example data, on the CPU (K1's plain version), gives the same mask and
count; without a card the default device raises."""

import numpy as np
import pytest
import torch

import __graft_entry__
from kubebrain_tpu_torch.entry import entry


def test_entry_equals_the_jax_entry():
    step, args = entry("cpu")
    mask, count = step(*args)
    jstep, jargs = __graft_entry__.entry()
    jmask, jcount = jstep(*jargs)
    assert mask.dtype == torch.bool and count.dtype == torch.int32
    assert mask.numpy().tolist() == np.asarray(jmask).tolist()
    assert int(count) == int(jcount) == 128
    assert all(t.device.type == "cpu" for t in args)


def test_entry_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
