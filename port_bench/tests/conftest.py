"""Fixtures of the benchmark's own tests (python -m pytest port_bench/tests
from the root of the repository).

`tiny_root` is a checkout-shaped directory that holds a BENCHMARK.json with
one cell, `tiny_revisit`: the first configuration's file with the graph
cut to 600 nodes and 1,000 loop edges, under the repository's
generators, reference, traffic mixes and metric readers. The program serves it on the CPU (device="cpu")
in a few seconds per solve. Tests marked `card` need an NVIDIA card and
skip, deciding inside the test, where torch sees none.
"""

from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CELL = "tiny_revisit"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_tiny_root(path: str, limits: dict | None = None) -> str:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    first = bench["configs"][0]
    with open(os.path.join(ROOT, first["file"])) as f:
        cfg = json.load(f)
    cfg["graph"]["args"] = {"n_nodes": 600, "n_loops": 1000}
    cfg["prefix"] = {"seed": 0, "nodes": 420, "chunk": 50, "tail": 6,
                     "tail_batches": 2}
    cfg["bucket"] = [1024, 1024]
    if limits is not None:
        cfg["limits"] = limits
    os.makedirs(os.path.join(path, "port_bench", "configs"), exist_ok=True)
    with open(os.path.join(path, "port_bench", "configs", "tiny.json"),
              "w") as f:
        json.dump(cfg, f)
    for d in ("generators", "reference", "traffic", "metrics"):
        link = os.path.join(path, "port_bench", d)
        if not os.path.exists(link):
            os.symlink(os.path.join(ROOT, "port_bench", d), link)
    cell = {**bench["workloads"][0], "name": TINY_CELL, "config": "tiny"}
    bench["configs"] = [{**first, "name": "tiny",
                         "file": "port_bench/configs/tiny.json"}]
    bench["workloads"] = [cell]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [TINY_CELL]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))
