"""``BENCHMARK.json`` against the benchmark's contract: names and units,
the files each entry names, which cells report which metrics, the bounds
and the window's length against a full check's time."""

from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_command_and_paths():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["command"] == ["python3", "kbbench/run.py"]
    assert MANIFEST["paths"] == ["kbbench"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 << 10


def test_names_units_and_text_fields():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200
                    assert "\n" not in entry[text] and "\t" not in entry[text]
    for section in ("configs", "workloads"):
        got = [n for s, n in names if s == section]
        assert len(got) == len(set(got))
    metrics = [e["name"] for e in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_every_config_has_a_cell_and_its_files():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for conf in MANIFEST["configs"]:
        assert conf["name"] in used
        path = ROOT / conf["file"]
        assert conf["file"].startswith("kbbench/")
        body = json.loads(path.read_text())
        assert body["name"] == conf["name"] and body["source"] == conf["source"]
        assert sorted(conf["reduced"]) == sorted(body["reduced"])
        assert all(NAME.match(k) for k in conf["reduced"])
    for cell in MANIFEST["workloads"]:
        assert cell["chips"] == 1
        assert (ROOT / "kbbench" / "traffic" / f"{cell['traffic']}.json").exists()
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_moves_and_cells():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "kbbench" / "metrics" / f"{m['name']}.py").exists()
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        reported = [m for m in MANIFEST["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])


def test_a_layer_names_one_layer():
    by_prefix = {}
    for m in MANIFEST["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values()), by_prefix


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200



#: the end-to-end metrics meant for the cells named here; the capacity
#: cell is kept for a later cell and is in the tiny copy only
MEANT = {"kb-upstream-rw.insert-read": {"ops_per_s", "setup_s"}}
KEPT_MEANT = {"kb-upstream-rw.insert-read-peak": {"ops_per_s", "setup_s"}}


def test_each_cell_reports_the_end_to_end_metrics_meant_for_it(tiny):
    """The cells named above report just their metrics; any other cell
    reports ``setup_s``, at least one more, and at most one rate, a metric
    whose ``workloads`` list names the cell."""
    from kbbench import run

    for path, meant in ((ROOT / "BENCHMARK.json", MEANT),
                        (tiny / "BENCHMARK.json", {**MEANT, **KEPT_MEANT})):
        manifest = json.loads(path.read_text())
        cells = {w["name"] for w in manifest["workloads"]}
        for m in manifest["end_to_end"]:
            assert set(m.get("workloads", cells)) <= cells, m["name"]
        for cell in cells:
            got = run.load_cell(str(path), cell)
            names = {m["name"] for m in got.e2e}
            assert {m["moves"] for m in got.layer} <= names
            if cell in meant:
                assert names == meant[cell], cell
                continue
            assert "setup_s" in names and len(names) >= 2, cell
            rates = [m for m in got.e2e if m["unit"] == "ops/s"]
            assert len(rates) <= 1, cell
            assert all(cell in m["workloads"] for m in rates), cell


def test_the_capacity_cell_runs_on_the_cpu(tiny):
    from conftest import KEPT_PEAK, run_cell

    res = run_cell(tiny, KEPT_PEAK, seed=2**33 + 1)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"ops_per_s", "setup_s"}
    assert res["metrics"]["ops_per_s"]["value"] > 0
    assert res["metrics"]["ops_per_s"]["unit"] == "ops/s"
    traced = run_cell(tiny, KEPT_PEAK, seed=2**33 + 2, trace=1)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"] == {}
