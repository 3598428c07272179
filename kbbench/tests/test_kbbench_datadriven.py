"""A configuration, a traffic mix and a per-layer metric added as new files
with new manifest entries run with no edit to any file already there."""

from __future__ import annotations

import json

from conftest import run_cell


def test_new_config_mix_and_metric_are_found_by_name(tiny):
    manifest = json.loads((tiny / "BENCHMARK.json").read_text())
    conf = json.loads((tiny / "kbbench/configs/k8s-cl2-5k.json").read_text())
    conf["name"] = "k8s-small"
    conf["resources"] = [dict(r) for r in conf["resources"]]
    conf["resources"][0]["namespaces"] = 2
    (tiny / "kbbench/configs/k8s-small.json").write_text(json.dumps(conf))
    mix = {"name": "count-heavy", "loop": "closed", "clients": 3,
           "ops": [{"op": "count", "resource": "pods", "share": 0.5},
                   {"op": "update", "resource": "nodes", "share": 0.5}],
           "watchers": [{"resource": "nodes", "count": 2}],
           "compaction": False, "warmup_ops_per_client": 1,
           "check_share": 1.0, "readback": 20}
    (tiny / "kbbench/traffic/count-heavy.json").write_text(json.dumps(mix))
    (tiny / "kbbench/metrics/sched.coalesced_share.py").write_text(
        '"""Share of reads that joined a queued leader, %."""\n\n\n'
        "def read(w):\n"
        "    return 100.0 * w.scratch.get('seen', 0) if w.reads else None\n\n\n"
        "def start(w):\n"
        "    w.scratch['seen'] = 0.0\n")
    manifest["configs"].append({
        "name": "k8s-small", "source": conf["source"],
        "file": "kbbench/configs/k8s-small.json", "reduced": conf["reduced"],
        "why": "a test"})
    manifest["workloads"].append({
        "name": "k8s-small.count-heavy", "config": "k8s-small",
        "traffic": "count-heavy", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "ops_per_s":
            m["workloads"].append("k8s-small.count-heavy")
    manifest["per_layer"].append({
        "name": "sched.coalesced_share", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "request scheduler",
        "moves": "ops_per_s", "workloads": ["k8s-small.count-heavy"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(manifest))

    res = run_cell(tiny, "k8s-small.count-heavy")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {
        m["name"] for m in manifest["end_to_end"]
        if "k8s-small.count-heavy" in m.get("workloads",
                                            ["k8s-small.count-heavy"])}
    assert "ops_per_s" in res["metrics"]
    traced = run_cell(tiny, "k8s-small.count-heavy", trace=1)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["sched.coalesced_share"]["value"] == 0.0
    assert set(traced["metrics"]) == {"sched.coalesced_share"}
