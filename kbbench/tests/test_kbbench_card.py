"""A run of every cell on the card at the tiny size; skips without one."""

from __future__ import annotations

import contextlib
import io
import json

import pytest
import torch

from kbbench import run


@pytest.mark.parametrize("cell", ["k8s-cl2-5k.relist",
                                  "kb-upstream-rw.insert-read",
                                  "kb-upstream-rw.insert-read-peak",
                                  "k8s-cl2-5k.churn"])
def test_cell_on_the_card(tiny, cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on the card only")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", "101", "--seconds", "2",
                       "--trace", "1", "--manifest",
                       str(tiny / "BENCHMARK.json")])
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0


def test_no_card_no_result(tiny, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "k8s-cl2-5k.relist", "--seed", "1",
                   "--seconds", "1", "--trace", "0", "--manifest",
                   str(tiny / "BENCHMARK.json")])
    assert rc == 2
    assert capsys.readouterr().out == ""
