"""The same ``--seed`` gives the same store and the same requests."""

from __future__ import annotations

import json

from kbbench import dataset, driver
from kbbench.control import ControlBackend


def config(tree, name):
    return json.loads((tree / "kbbench" / "configs" / f"{name}.json").read_text())


def traffic(tree, name):
    return json.loads((tree / "kbbench" / "traffic" / f"{name}.json").read_text())


def test_store_is_a_function_of_the_seed(tiny):
    for name in ("k8s-cl2-5k", "kb-upstream-rw"):
        a = dataset.build(config(tiny, name), 2**31 + 11)
        b = dataset.build(config(tiny, name), 2**31 + 11)
        c = dataset.build(config(tiny, name), 2**31 + 12)
        assert a.records == b.records and a.top == b.top
        assert a.records != c.records
        revs = [r for _k, r, _v in a.records]
        assert revs == list(range(1, a.top + 1))


def test_full_size_counts_as_the_configuration_states():
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    conf = json.loads((root / "kbbench/configs/k8s-cl2-5k.json").read_text())
    want = sum(r["versions"] * r.get("count", r.get("namespaces", 0)
                                     * r.get("per_namespace", 0))
               for r in conf["resources"])
    assert want == 475_000


def requests(tree, cell_traffic, cell_config, seed):
    """Each client's first writes (key, value) and its first draws, made
    against the control so no timing enters."""
    ds = dataset.build(config(tree, cell_config), seed)
    run = driver.Run(ControlBackend(ds), ds, config(tree, cell_config),
                     traffic(tree, cell_traffic), seed)
    for c in run.clients:
        for _ in range(12):
            c.step()
    for w in run.watchers:
        w.close()
    return [[(a[0], a[1], a[2]) for a in c.acked] for c in run.clients]


def test_requests_are_a_function_of_the_seed(tiny):
    for mix, conf in (("relist", "k8s-cl2-5k"), ("churn", "k8s-cl2-5k"),
                      ("insert-read", "kb-upstream-rw")):
        a = requests(tiny, mix, conf, 5_000_000_017)
        b = requests(tiny, mix, conf, 5_000_000_017)
        c = requests(tiny, mix, conf, 5_000_000_018)
        assert a == b and a != c
        assert any(a)


def test_request_shares_count_pages(tiny):
    ds = dataset.build(config(tiny, "k8s-cl2-5k"), 1)
    shares = driver.request_shares(traffic(tiny, "relist"), ds)
    assert abs(sum(w for _op, w in shares) - 1.0) < 1e-9
    walk = next(w for op, w in shares if op["op"] == "list_walk")
    pages = 60 // 25 + 1
    count = next(w for op, w in shares if op["op"] == "count")
    assert abs(walk * pages / count - 0.70 / 0.02) < 1e-6
