"""The manifest: every configuration, traffic mix and metric that
BENCHMARK.json names is found by its name, and new ones are new files."""

from __future__ import annotations

import json
import os
import re

from conftest import ROOT
from port_bench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_has_its_file():
    bench = manifest.load()
    for c in bench["configs"]:
        cfg = manifest.config(bench, c["name"])
        assert cfg["limits"] and isinstance(cfg["settings"], dict)
        assert os.path.isfile(os.path.join(
            ROOT, "port_bench", "generators",
            cfg["graph"]["generator"] + ".py"))
        assert os.path.isfile(os.path.join(ROOT, cfg["reference"]["file"]))
        assert c["file"].startswith(bench["paths"][0] + "/")
    for w in bench["workloads"]:
        assert manifest.config(bench, w["config"])
        mix = manifest.traffic(w["traffic"])
        assert mix["keyframes"]["per_s"] > 0
        for trace in (False, True):
            for m in manifest.metrics(bench, w["name"], trace):
                assert callable(manifest.reader(m["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert callable(manifest.reader(m["name"]))


def test_contract_shape():
    bench = manifest.load()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        cell = w["name"]
        assert w["chips"] == 1 and len(w["why"]) <= 200
        ends = [m["name"] for m in manifest.metrics(bench, cell, False)]
        assert "setup_s" in ends and len(ends) >= 2
        assert manifest.metrics(bench, cell, True)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_new_files_are_picked_up(tmp_path):
    """A configuration, a mix and a metric added as new files, with new
    manifest entries, are found with no edit to any file that exists."""
    root = str(tmp_path)
    bench = manifest.load()
    cfg_file = bench["configs"][0]["file"]
    os.makedirs(os.path.join(root, "port_bench", "configs"))
    os.makedirs(os.path.join(root, "port_bench", "traffic"))
    os.makedirs(os.path.join(root, "port_bench", "metrics"))
    with open(os.path.join(ROOT, cfg_file)) as f:
        cfg = json.load(f)
    cfg["graph"]["args"]["n_loops"] = 9000
    with open(os.path.join(root, "port_bench/configs/new_cfg.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "port_bench/traffic/new_mix.json"), "w") as f:
        json.dump({"keyframes": {"per_s": 5},
                   "pose_queries": {"per_s": 100}}, f)
    with open(os.path.join(root, "port_bench/metrics/new_metric.py"),
              "w") as f:
        f.write("def read(rec):\n    return rec['x'] * 2\n")
    bench["configs"].append({**bench["configs"][0], "name": "new_cfg",
                             "file": "port_bench/configs/new_cfg.json"})
    bench["workloads"].append({"name": "new_cell", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "solver loop",
                               "moves": "loop_latency_p95_ms",
                               "workloads": ["new_cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    got = manifest.load(root)
    assert manifest.config(got, "new_cfg", root)["graph"]["args"][
        "n_loops"] == 9000
    base = os.path.join(root, "port_bench")
    assert manifest.traffic("new_mix", base)["keyframes"]["per_s"] == 5
    assert manifest.reader("new_metric", base)({"x": 21}) == 42
    names = [m["name"] for m in manifest.metrics(got, "new_cell", True)]
    assert "new_metric" in names
    assert "new_metric" not in [
        m["name"] for m in manifest.metrics(got, got["workloads"][0]["name"],
                                            True)]
