"""The kidnap deployment (configs/kidnap5k_10kloops.json): where its worlds
begin and merge, the plain reference of its trigger (reference/worlds.py)
against the program's engine with each of three faults put in, and the
cell run small on the CPU through run.main."""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import os

import numpy as np
import pytest

from conftest import ROOT, make_tiny_root
from port_bench import run
from port_bench.harness import generators, manifest, stream
from port_bench.reference import worlds
from port_bench.tests import worlds_drive

CELL = "stream5k_kidnap"
SEED = 2_147_483_659


def _first_contacts(g, n_edges: int) -> list:
    """(edge's later node, world a, world b) of every first contact among
    the first n_edges loop edges in stream order."""
    w = worlds.node_worlds(g, g.n_nodes)
    order = generators.stream_order(g)
    reg = worlds.Worlds(int(w.max()) + 1)
    out = []
    for j in range(n_edges):
        before = len(reg.rel)
        worlds.contacts(g, w, order, reg, j, j + 1)
        if len(reg.rel) > before:
            a, b = (int(v) for v in g.loop_pairs[order[j]])
            out.append((max(a, b), int(w[a]), int(w[b])))
    return out


def test_the_deployments_worlds_merge_where_its_file_says():
    """Five worlds; in the session worlds 3 and 0 meet in the first solve
    and world 1 joins at node ~3,530, world 2 staying a set of its own;
    in the window a blackout at node 4,510 and two merges before the
    midpoint: world 4 on its first edges, world 2 (~310 nodes) at node
    4,630. No kidnap is open where set-up or the drain waits."""
    bench = manifest.load(ROOT)
    cfg = manifest.config(bench, "kidnap5k_10kloops", ROOT)
    mix = manifest.traffic("revisit_10hz")
    sch = stream.prepare(cfg, mix, SEED, 51.0)
    g = sch.g
    w = worlds.node_worlds(g, g.n_nodes)
    assert w.max() == 4 and sch.first == 4410
    starts = [int(np.flatnonzero(w == k)[0]) for k in range(5)]
    assert starts == [0, 1030, 2130, 2470, 4540]
    assert (w[4510:4540] < 0).all() and (w[1000:1030] < 0).all()
    assert (np.flatnonzero(w == 2)[[0, -1]] == [2130, 2439]).all()

    order = generators.stream_order(g)
    later = np.max(g.loop_pairs[order], axis=1)
    first_solve = int(np.sum(later < sch.cuts[0]))
    meets = _first_contacts(g, len(order))
    assert meets[0][1:] in ((3, 0), (0, 3)) and meets[0][0] < sch.cuts[0]
    assert 3520 <= meets[1][0] <= 3540 and set(meets[1][1:]) == {1, 3}
    window = [m for m in meets if m[0] >= sch.first]
    assert [set(m[1:]) for m in window] == [{4, 1}, {4, 2}]
    assert window[0][0] in range(4540, 4560)
    assert window[1][0] in range(4630, 4640)
    mid = sch.first + int(10 * (2.0 + 51.0 / 2))
    assert all(m[0] < mid for m in window) and len(meets) == 4
    assert first_solve > 0

    # every world but 2 is one set at the window's start
    reg = worlds.trigger(g, sch.first, int(np.sum(later < sch.first))).reg
    assert len({reg.find(k) for k in range(4)}) == 2
    assert reg.find(2) == 2


def test_the_reference_anchors_each_set_root_world():
    g = worlds_drive.graph()
    n = 230
    tr = worlds.trigger(g, n, int(np.sum(np.max(
        g.loop_pairs, axis=1) < n)))
    anchors = worlds.priors(g, tr, n)
    assert [(k, i) for k, i, _ in anchors] == [(0, 0), (1, 90)]
    assert anchors[0][2] == pytest.approx(max(1.1, np.log(60) / 2))
    assert anchors[1][2] == pytest.approx(max(1.1, np.log(40) / 2))


def _skip_rebase(eng):
    inner = eng._set_initial_guesses

    def guesses(node_len, node_worlds):
        eng._changes_to_setid.clear()
        return inner(node_len, node_worlds)

    eng._set_initial_guesses = guesses


def _drop_unmerged_prior(eng):
    inner = eng._prepare_solve

    def prepare(node_len, edge_len, node_worlds, idx, q, t, w):
        keep = [k for k, i in enumerate(idx) if i == 0]
        return inner(node_len, edge_len, node_worlds, [idx[k] for k in keep],
                     [q[k] for k in keep], [t[k] for k in keep],
                     [w[k] for k in keep])

    eng._prepare_solve = prepare


def _count_dead_edges(eng):
    inner = eng._build

    def build(*args):
        args = list(args)
        args[15] = np.ones_like(args[15])           # loop_valid
        return inner(*args)

    eng._build = build


@pytest.mark.parametrize("fault,cuts,fails", [
    (_skip_rebase, (230, 305), "start"),
    (_drop_unmerged_prior, (230,), "priors"),
    (_count_dead_edges, (230, 305), "masks"),
], ids=["rebase-skipped", "unmerged-prior-dropped", "dead-edge-counted"])
def test_a_fault_in_the_world_path_fails_the_judge(fault, cuts, fails):
    """Each fault, put into the engine, fails the judgement of the trigger
    where it acts (worlds_drive.judge), by the part that sees it."""
    rows = worlds_drive.drive(cuts, fault)
    assert fails in rows[-1]["faults"], rows[-1]["faults"]


def _kidnap_root(path: str) -> str:
    """The tiny root with the kidnap configuration cut to 600 nodes:
    worlds from nodes 110, 210, 250 in the session and 451 in the
    window, blackouts of 10."""
    make_tiny_root(path)
    with open(os.path.join(ROOT, "port_bench", "configs",
                           "kidnap5k_10kloops.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(path, "port_bench", "configs", "tiny.json")) as f:
        tiny = json.load(f)
    cfg.update(prefix=tiny["prefix"], bucket=tiny["bucket"])
    cfg["graph"]["args"] = {"n_nodes": 600, "n_loops": 1000,
                            "kidnaps": [99, 199, 239, 440], "blackout": 10}
    with open(os.path.join(path, "port_bench", "configs",
                           "tiny_kidnap.json"), "w") as f:
        json.dump(cfg, f)
    bench = manifest.load(path)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        full = json.load(f)
    bench["configs"] = [{**bench["configs"][0], "name": "tiny_kidnap",
                         "file": "port_bench/configs/tiny_kidnap.json"}]
    bench["workloads"] = [{**bench["workloads"][0], "name": CELL,
                           "config": "tiny_kidnap"}]
    bench["per_layer"] = full["per_layer"]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


def test_the_kidnap_cell_runs_small_on_the_cpu(tmp_path):
    """The cell's path end to end: the kidnap events over the socket, a
    window merge, and the reference judging; the world readers read the
    rows. (Whether a poll falls in the 1 s blackout depends on the CPU's
    solve time; worlds_drive refuses one deterministically.)"""
    root = _kidnap_root(str(tmp_path))
    seen = {}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                       "3", "--trace", "0"], device="cpu", root=root,
                      patch=lambda server: seen.update(server=server))
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    res = json.loads(lines[-1])
    assert res["correct"], res["checks"]
    server = seen["server"]
    eng = server.engine
    assert server.store.n_worlds() == 5 and server.store.n_kidnaps() == 4
    assert server.store.worlds.n_sets() == 2         # world 2 apart
    rows = [r for r in eng.solve_stats if "first_contacts" in r]
    assert rows[0]["worlds"] == 4 and rows[0]["first_contacts"] == 1
    assert rows[0]["priors"] == 3
    merges = [r for r in rows if r["first_contacts"]]
    assert len(merges) == 3 and merges[-1]["worlds"] == 5

    [path] = [s.split("=", 1)[1] for s in lines
              if s.startswith("[record] path=")]
    with gzip.open(path, "rt") as f:
        rec = json.load(f)["record"]
    os.unlink(path)
    readers = {m: manifest.reader(m, os.path.join(root, "port_bench"))
               for m in ("world_host_ms", "merge_solve_ms")}
    assert readers["world_host_ms"](rec) > 0
    window = [r for r in rec["triggers"] if r["fired"]
              and rec["t0"] <= r["ret"] < rec["t_end"]
              and r["stats"]["first_contacts"]]
    got = readers["merge_solve_ms"](rec)
    assert (got is None) == (not window)
