"""A configuration that brings every hook as files of its own, with no
edit to a file of the harness: a generator with a kidnap and an unkidnap,
overrides of the program's settings, a mix and a reference of its own. It
runs through run.main on the CPU."""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import os
import re

import numpy as np
import pytest

from conftest import ROOT, make_tiny_root
from port_bench import run
from port_bench.harness import generators, manifest, stream

CELL = "tiny_worlds_12hz"
SEED = 4_000_000_007
KIDNAP_AFTER, UNKIDNAP_BEFORE = 452, 457

GENERATOR = '''
"""Two worlds: the circle graph with the VIO lost after node kidnap_after
and restarted, in a frame of its own, at node unkidnap_before."""
import dataclasses
import os

import numpy as np

from port_bench.harness import generators, nse3


def generate(seed, n_nodes, n_loops, kidnap_after, unkidnap_before):
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    g = generators.generate({"generator": "circle_graph",
                             "args": {"n_nodes": n_nodes,
                                      "n_loops": n_loops}}, seed, base)
    j = unkidnap_before
    qi, ti = nse3.pose_inv(g.vio_q[j], g.vio_t[j])
    q, t = g.vio_q.copy(), g.vio_t.copy()
    q[j:], t[j:] = nse3.pose_mul(np.broadcast_to(qi, q[j:].shape),
                                 np.broadcast_to(ti, t[j:].shape),
                                 g.vio_q[j:], g.vio_t[j:])
    q[j:] /= np.linalg.norm(q[j:], axis=-1, keepdims=True)
    events = [
        generators.Event(kidnap_after, True, {"kind": "kidnap_indicator",
                                              "frame_id": "kidnapped"}),
        generators.Event(unkidnap_before, False,
                         {"kind": "kidnap_indicator",
                          "frame_id": "unkidnapped"})]
    return dataclasses.replace(g, vio_q=q, vio_t=t, events=events)
'''

REFERENCE = '''
"""A stand-in reference: it notes what each judged answer asked, and
answers with posegraph.py's one-world arithmetic over every edge."""
import json
import os

from port_bench.reference import posegraph

SEEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "seen.jsonl")


def trigger_start(cfg, g, answer):
    with open(SEEN, "a") as f:
        f.write(json.dumps({
            "node_len": answer["node_len"],
            "events": [[e.node, e.after, e.message] for e in g.events],
            "uncounted": int((~g.loop_counted).sum())}) + "\\n")
    return posegraph.start(g.vio_q, g.vio_t, answer["node_len"],
                           answer["edge_len"], answer["prev"],
                           cfg["formulation"]["switch_init"])


trigger_problem = posegraph.trigger_problem
trigger_solve = posegraph.trigger_solve
cost = posegraph.cost
'''


def _hooks_root(path: str, kidnap_after: int = KIDNAP_AFTER,
                unkidnap_before: int = UNKIDNAP_BEFORE) -> str:
    """The tiny root, and beside it a configuration that names its own
    generator, settings, mix and reference: new files and new manifest
    entries only."""
    make_tiny_root(path)
    pb = os.path.join(path, "port_bench")
    for d in ("generators", "traffic", "reference"):
        os.unlink(os.path.join(pb, d))
        os.makedirs(os.path.join(pb, d))
    os.symlink(os.path.join(ROOT, "port_bench", "generators",
                            "circle_graph.py"),
               os.path.join(pb, "generators", "circle_graph.py"))
    with open(os.path.join(pb, "generators", "two_worlds.py"), "w") as f:
        f.write(GENERATOR)
    with open(os.path.join(pb, "reference", "two_worlds.py"), "w") as f:
        f.write(REFERENCE)
    with open(os.path.join(pb, "traffic", "worlds_12hz.json"), "w") as f:
        json.dump({"keyframes": {"per_s": 12}, "pose_queries": {"per_s": 200},
                   "lead_s": 2.0}, f)
    with open(os.path.join(pb, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["graph"] = {"generator": "two_worlds",
                    "args": {"n_nodes": 600, "n_loops": 1000,
                             "kidnap_after": kidnap_after,
                             "unkidnap_before": unkidnap_before}}
    cfg["settings"] = {"stream": {"trigger_poll_hz": 4.0}}
    cfg["reference"]["file"] = "port_bench/reference/two_worlds.py"
    with open(os.path.join(pb, "configs", "tiny_worlds.json"), "w") as f:
        json.dump(cfg, f)
    bench = manifest.load(path)
    bench["configs"].append({**bench["configs"][0], "name": "tiny_worlds",
                             "file": "port_bench/configs/tiny_worlds.json"})
    bench["workloads"] = [{**bench["workloads"][0], "name": CELL,
                           "config": "tiny_worlds",
                           "traffic": "worlds_12hz"}]
    bench["configs"] = bench["configs"][1:]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


def test_ingest_applies_events_through_the_programs_messages(tmp_path):
    from solve_keyframe_pose_graph_tpu_torch.graph.native import make_store
    root = _hooks_root(str(tmp_path))
    bench = manifest.load(root)
    cfg = manifest.config(bench, "tiny_worlds", root)
    mix = manifest.traffic("worlds_12hz", os.path.join(root, "port_bench"))
    sch = stream.prepare(cfg, mix, SEED, 3.0, os.path.join(root,
                                                           "port_bench"))
    store = make_store(1024, native=False)
    stream.ingest(store, sch, 0, UNKIDNAP_BEFORE + 3)
    assert store.n_kidnaps() == 1 and store.n_worlds() == 2
    w = store.node_worlds()
    assert w[KIDNAP_AFTER] == 0 and w[UNKIDNAP_BEFORE] == 1
    assert (w[KIDNAP_AFTER + 1:UNKIDNAP_BEFORE] < 0).all()


def test_a_configuration_of_new_files_runs(tmp_path):
    root = _hooks_root(str(tmp_path))
    seen = {}

    def patch(server):
        seen["server"] = server

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                       "3", "--trace", "0"], device="cpu", root=root,
                      patch=patch)
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    res = json.loads(lines[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert set(res["metrics"]) == {"loop_latency_p95_ms", "setup_s"}

    # the settings reached the program; the events, its store
    server = seen["server"]
    assert server.engine.config.stream.trigger_poll_hz == 4.0
    assert server.store.n_kidnaps() == 1 and server.store.n_worlds() == 2

    # the loop edges with an endpoint in the dead zone are sent and
    # stored, and not due
    [path] = [re.sub(r"^\[record\] path=", "", s) for s in lines
              if s.startswith("[record] path=")]
    with gzip.open(path, "rt") as f:
        rec = json.load(f)["record"]
    os.unlink(path)
    bench = manifest.load(root)
    sch = stream.prepare(manifest.config(bench, "tiny_worlds", root),
                         manifest.traffic("worlds_12hz",
                                          os.path.join(root, "port_bench")),
                         SEED, 3.0, os.path.join(root, "port_bench"))
    g = sch.g
    order = generators.stream_order(g)
    later = np.max(g.loop_pairs[order], axis=1)
    in_window = np.isin(later, sch.kf_nodes[sch.kf_due >= 0])
    counted = g.loop_counted[order]
    assert (in_window & ~counted).any()
    assert rec["edges"]["index"] == np.flatnonzero(in_window
                                                   & counted).tolist()
    assert server.store.edge_len == len(g.loop_pairs[later <= sch.kf_nodes[
        -1]])

    # the mix's own rate: 12 keyframes a second over 2 + 3 s
    due = np.array(rec["keyframes"]["due"])
    assert len(due) == 60 and np.allclose(np.diff(due), 1 / 12)

    # the configuration's own reference judged the answers, with the
    # graph's events and flags before it
    with open(os.path.join(root, "port_bench", "reference",
                           "seen.jsonl")) as f:
        asked = [json.loads(s) for s in f]
    assert asked and all(len(a["events"]) == 2 and a["uncounted"] > 0
                         for a in asked)


@pytest.mark.parametrize("kidnap_after,unkidnap_before,where", [
    (330, 360, "head chunk"),       # the chunk ending with node 349
    (421, 424, "tail batch"),       # the first batch ends with node 422
    (470, 590, "window"),           # open at the window's last keyframe
])
def test_a_kidnap_open_where_set_up_waits_is_refused(
        tmp_path, kidnap_after, unkidnap_before, where):
    """Set-up waits for a solve at each head chunk's and tail batch's end,
    the drain at the window's; the program does not solve while kidnapped,
    so prepare refuses such a graph at once, naming the cut."""
    root = _hooks_root(str(tmp_path), kidnap_after, unkidnap_before)
    bench = manifest.load(root)
    cfg = manifest.config(bench, "tiny_worlds", root)
    mix = manifest.traffic("worlds_12hz", os.path.join(root, "port_bench"))
    with pytest.raises(ValueError, match=f"end of the {where}"):
        stream.prepare(cfg, mix, SEED, 3.0, os.path.join(root, "port_bench"))
