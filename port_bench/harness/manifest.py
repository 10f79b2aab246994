"""The benchmark's manifest, BENCHMARK.json at the root of the checkout,
and the files it names.

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own, found by name:

  port_bench/configs/<config>.json   the configuration: its graph (the
                                     generator's name and arguments), the
                                     program's settings (Config overrides),
                                     the formulation, the reference file
                                     and the limits of the comparison
  port_bench/generators/<name>.py    generate(seed, **args) -> Graph, with
                                     the graph's events
  the configuration's reference.file the plain reference (harness/check.py
                                     states what it answers)
  port_bench/traffic/<mix>.json      the arrivals and their rates
  port_bench/metrics/<metric>.py     the reader of one metric: read(rec)

so that a new cell, mix or metric is new files and new manifest entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "port_bench")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration's manifest entry merged over its file."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return {**json.load(f), **c}
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, base: str = BENCH_DIR) -> dict:
    with open(os.path.join(base, "traffic", name + ".json")) as f:
        return json.load(f)


def module(path: str):
    """The Python file at `path`, loaded as a module of its own. It is
    entered in sys.modules under a name made from its path, as a dataclass
    in it needs."""
    name = "port_bench_file_" + re.sub(r"\W", "_", os.path.abspath(path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, base: str = BENCH_DIR):
    """The read(rec) function of metric `name`, from its own file."""
    return module(os.path.join(base, "metrics", name + ".py")).read


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports: its end-to-end metrics with
    --trace 0, its per-layer metrics with --trace 1. An end-to-end metric
    without a workloads key is every cell's; a per-layer one, every cell's
    that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if _applies(m, cell, reported)]
