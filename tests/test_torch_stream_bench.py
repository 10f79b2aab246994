"""PyTorch port: bench_stream_torch.py, the port's counterpart of the engine
rows of benchmarks/run_baseline.py, on the CPU.

The harness runs its rows only on a CUDA card. Here, at small sizes:
(a) its feed makes the calls that run_baseline.py's loops make, in the
same order, the distress index re-armed alike, against literal copies of
those loops on a recording store; (b) one small streaming row through the
port's engine and the JAX engine, both fed by the harness, trigger for
trigger; (c) the cover row's arithmetic, with no solve; (d) the
statistics and the gates; (e) the refusal to run without a card.

(b) runs test_torch_engine's fp64 small-bucket config on
circle_graph(240, 40, seed=1), a trigger every 30 nodes: four triggers and
the settle trigger, in the buckets (128, 32), (256, 32) and (256, 64),
where both packages take the same LM and CG counts and their chi^2 agree
to 1e-12.
The graph is chosen well determined, as ROADMAP.md asks of parity tests:
on circle_graph(160, 30, seed=1) polled every 20 nodes the counts agree
too, but chi^2 differs by up to 1.1e-4 relative, because those
10-iteration solves stop short of their minimum, where sums taken in
another order move the cost."""

import dataclasses as dc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import bench_stream_torch as bst
from solve_keyframe_pose_graph_tpu import config as jconfig
from solve_keyframe_pose_graph_tpu.graph.store import GraphStore as JaxStore
from solve_keyframe_pose_graph_tpu.solver.engine import (
    SolverEngine as JaxEngine,
)
from solve_keyframe_pose_graph_tpu_torch.config import Config
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.solver.engine import (
    SolverEngine, _warmup_pairs,
)
from solve_keyframe_pose_graph_tpu_torch.utils.timing import PhaseTimer

from test_torch_engine import _config
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Recorder:
    """A store and an engine in one, recording what reaches them: the
    store's add_node, add_loop_edge and kidnap_indicator, and the engine's
    trigger (with the escalate_rejects it was called under) and drain. A
    poll fires when loop edges arrived since the last one that fired,
    except every `refuse`-th poll (refused, as while an escalation runs),
    so that a forced trigger is re-armed now and then."""

    def __init__(self, refuse: int = 3):
        self.calls = []
        self.config = Config()
        self.timer = PhaseTimer()
        self.solve_stats = []
        self.trigger_id = 0
        self.node_len = self.edge_len = 0
        self._fired_edges = self._polls = 0
        self._refuse = refuse

    def add_node(self, t_ns, q, t):
        self.calls.append(("add_node", t_ns, tuple(q), tuple(t)))
        self.node_len += 1

    def add_loop_edge(self, t_a, t_b, q, t, w):
        self.calls.append(("add_loop_edge", t_a, t_b, tuple(q), tuple(t), w))
        self.edge_len += 1

    def kidnap_indicator(self, t_ns, frame_id):
        self.calls.append(("kidnap_indicator", t_ns, frame_id))

    def trigger(self):
        self._polls += 1
        self.calls.append(("trigger", self.config.solver.escalate_rejects))
        fire = (self.edge_len > self._fired_edges
                and self._polls % self._refuse != 0)
        if fire:
            self._fired_edges = self.edge_len
            self.trigger_id += 1
            self.solve_stats.append({"trigger": self.trigger_id,
                                     "trigger_wall_ms": 1.0})
        return fire

    def drain(self):
        self.calls.append(("drain",))


def _reference_streaming(eng, store, g, trigger_every, pace_ms=0.0,
                         inject_distress_at=0):
    """run_baseline.py:266-323, literally; only its per-trigger detail
    (the JAX package's executable count and phase deltas) is left out."""
    t0 = 1_000_000_000
    dtn = 100_000_000
    edge_by_later = {}
    for k in range(g.n_loops):
        a, b = map(int, g.loop_pairs[k])
        edge_by_later.setdefault(max(a, b), []).append(k)
    walls = []
    for i in range(g.n_nodes):
        store.add_node(t0 + i * dtn, g.vio_q[i], g.vio_t[i])
        for k in edge_by_later.get(i, []):
            a, b = map(int, g.loop_pairs[k])
            store.add_loop_edge(t0 + a * dtn, t0 + b * dtn,
                                g.loop_q[k], g.loop_t[k], float(g.loop_w[k]))
        if i % trigger_every == 0:
            if pace_ms:
                time.sleep(pace_ms / 1e3)
            inject = (inject_distress_at
                      and len(walls) + 1 == inject_distress_at)
            if inject:
                saved_cfg = eng.config
                eng.config = dc.replace(
                    saved_cfg, solver=dc.replace(saved_cfg.solver,
                                                 escalate_rejects=0))
            tt = time.perf_counter()
            fired = eng.trigger()
            if fired:
                w = (time.perf_counter() - tt) * 1e3
                walls.append(w)
            if inject:
                eng.config = saved_cfg
    eng.drain()
    eng.trigger()        # settle edges that accumulated while escalating
    eng.drain()
    return walls


def _reference_multiworld(eng, store, g, kidnaps, every=50):
    """run_baseline.py:510-529, literally, its kidnap schedule passed in."""
    t0 = 1_000_000_000
    dtn = 100_000_000
    edge_by_later = {}
    for k in range(g.n_loops):
        a, b = map(int, g.loop_pairs[k])
        edge_by_later.setdefault(max(a, b), []).append(k)
    walls = []
    for i in range(g.n_nodes):
        if i in kidnaps:
            store.kidnap_indicator(
                t0 + i * dtn - dtn // 2,
                "kidnapped" if kidnaps[i] else "unkidnapped")
        store.add_node(t0 + i * dtn, g.vio_q[i], g.vio_t[i])
        for k in edge_by_later.get(i, []):
            a, b = map(int, g.loop_pairs[k])
            store.add_loop_edge(t0 + a * dtn, t0 + b * dtn,
                                g.loop_q[k], g.loop_t[k], float(g.loop_w[k]))
        if i % every == 0 and eng.trigger():
            walls.append(eng.solve_stats[-1]["trigger_wall_ms"])
    eng.trigger()
    return walls


# run_baseline.py:514's schedule scaled from 1,500 nodes to 300
SMALL_KIDNAPS = {100: True, 104: False, 200: True, 206: False}


@pytest.mark.parametrize("every,inject_at", [(20, 0), (10, 2), (10, 4)])
def test_streaming_feed_makes_the_reference_calls(every, inject_at):
    g = synthetic.circle_graph(n_nodes=300, n_loops=60, seed=1)
    ref = Recorder()
    walls = _reference_streaming(ref, ref, g, every,
                                 inject_distress_at=inject_at)
    got = Recorder()
    spec = dict(every=every, pace_ms=0.0, inject_at=inject_at)
    fired, settled, _ = bst.stream(got, got, g, spec)
    assert got.calls == ref.calls
    assert len(fired) == len(walls) >= 4
    assert [p["trigger"] for p in fired] == list(range(1, len(fired) + 1))
    forced = [c for c in got.calls if c == ("trigger", 0)]
    if inject_at:
        # the forced poll fires exactly once; a refused one re-arms it
        assert [p["injected"] for p in fired].count(True) == 1
        assert fired[inject_at - 1]["injected"]
        assert len(forced) >= 1
    else:
        assert not forced
    assert got.calls[-3:] == [("drain",), ("trigger", 3), ("drain",)]


def test_distress_index_is_rearmed_on_a_refused_poll():
    """With every second poll refused, the poll that would be the second
    fired trigger is refused first: both loops force the next poll too."""
    g = synthetic.circle_graph(n_nodes=300, n_loops=60, seed=1)
    ref, got = Recorder(refuse=2), Recorder(refuse=2)
    _reference_streaming(ref, ref, g, 10, inject_distress_at=2)
    bst.stream(got, got, g, dict(every=10, pace_ms=0.0, inject_at=2))
    assert got.calls == ref.calls
    assert got.calls.count(("trigger", 0)) >= 2


def test_multiworld_feed_makes_the_reference_calls():
    g = synthetic.circle_graph(n_nodes=300, n_loops=60, seed=4)
    ref, got = Recorder(), Recorder()
    walls = _reference_multiworld(ref, ref, g, SMALL_KIDNAPS)
    fired = bst.multiworld(got, got, g, dict(every=50,
                                             kidnaps=SMALL_KIDNAPS))
    assert got.calls == ref.calls
    assert len(fired) == len(walls) >= 2
    assert sum(c[0] == "kidnap_indicator" for c in got.calls) == 4
    # the full row's schedule is run_baseline.py:514's
    assert bst.ROWS["multiworld_1500"]["kidnaps"] == {
        500: True, 520: False, 1000: True, 1030: False}


def test_row_keys_and_specs_match_run_baseline():
    assert list(bst.ROWS) == [
        "startup_10k", "streaming_2k_400",
        "streaming_2k_400_warm", "streaming_10k_2000_warm",
        "streaming_2k_400_warm_paced",
        "streaming_30k_3000_warm_paced_distress",
        "streaming_2k_400_warm_paced_distress", "multiworld_1500",
        "cover_2k_4000"]
    assert bst.ONLY_KEYS == (
        "startup", "streaming", "streaming_warm",
        "streaming_10k", "streaming_paced", "streaming_30k",
        "streaming_distress", "multiworld", "cover")
    s = bst.ROWS["streaming_30k_3000_warm_paced_distress"]
    assert (s["nodes"], s["loops"], s["every"], s["pace_ms"],
            s["inject_at"], s["seed"]) == (30000, 3000, 500, 2000.0, 5, 1)
    s = bst.ROWS["streaming_2k_400_warm_paced_distress"]
    assert (s["every"], s["pace_ms"], s["inject_at"]) == (50, 150.0, 10)
    assert bst.ROWS["streaming_10k_2000_warm"]["every"] == 100
    cap = Config().capacity
    # the trigger counts of the JAX rows (benchmarks/results.json)
    for key, n in (("streaming_2k_400", 19), ("streaming_10k_2000_warm", 50)):
        s = bst.ROWS[key]
        g = synthetic.circle_graph(n_nodes=s["nodes"], n_loops=s["loops"],
                                   seed=s["seed"])
        assert len(bst.cover_plan(g, s["every"], [], cap)) == n, key


def _port_and_jax_rows():
    g = synthetic.circle_graph(n_nodes=240, n_loops=40, seed=1)
    spec = dict(every=30, pace_ms=0.0, inject_at=0)
    jstore = JaxStore()
    jeng = JaxEngine(jstore, _config(jconfig))
    bst.stream(jeng, jstore, g, spec)
    rec = bst.stream_row("streaming_2k_400", "cpu", _config(), nodes=240,
                         loops=40, every=30)
    return rec, [r for r in jeng.solve_stats if "trigger_wall_ms" in r]


def test_small_row_matches_the_jax_engine():
    """(b): trigger for trigger, the same sizes, LM and CG counts, and
    chi^2 within 1e-6 (tests/test_torch_engine.py's bar)."""
    rec, ref = _port_and_jax_rows()
    rows = rec["trigger_rows"]
    assert len(rows) == len(ref) == rec["triggers"] + 1 == 5
    for got, want in zip(rows, ref):
        for k in ("node_len", "edge_len", "lm_iterations", "cg_iterations"):
            assert got[k] == want[k], k
        np.testing.assert_allclose(got["final_cost"], want["final_cost"],
                                   rtol=1e-6, atol=1e-12)
    # what the row reports of itself on the CPU
    assert rec["final_chi2"] == rows[-1]["final_cost"]
    assert [b[2] for b in rec["boxes"]] == [[128, 32]] + [[256, 32]] * 3 + [
        [256, 64]]
    assert [b[3] for b in rec["boxes"]] == [b[2] for b in rec["boxes"]]
    assert rec["covered"] == 0 and rec["trigger_captures"] == 0
    assert rec["settled"] and len(rec["walls_ms"]) == rec["triggers"]
    assert rec["launches"] == {"band_matvec": 0, "gj_inv": 0}
    assert rec["launches_want"]["gj_inv"] == 3 * sum(
        r["lm_iterations"] for r in rows)
    assert set(rec["phase_ms_mean"]) >= {"device_solve", "problem_build",
                                         "write_back", "trigger_total"}


def test_cover_plan_doubles_n_cap_at_2048_4096():
    """(c): cover_2k_4000's triggers and boxes, with no solve."""
    s = bst.ROWS["cover_2k_4000"]
    cap = Config().capacity
    g = synthetic.circle_graph(n_nodes=s["nodes"], n_loops=s["loops"],
                               seed=s["seed"])
    (n, e), prop = bst.COVER_WARMUP["A"]
    ladder = _warmup_pairs(cap, n, e, prop)
    assert len(ladder) == 11 and (2048, 4096) not in ladder
    plan = bst.cover_plan(g, s["every"], ladder, cap)
    doubled = [p for p in plan if p[3] == [2048, 4096]]
    assert [p[0] for p in doubled] == list(range(1550, 2000, 50))
    assert doubled[0][2] == 2261
    assert all(p[4] == [4096, 4096] for p in doubled)
    # the only other covered trigger keeps its n_cap
    assert [p[:5] for p in plan if p[3] != p[4] and p[3] != [2048, 4096]] \
        == [[1050, 1051, 220, [2048, 256], [2048, 512]]]
    (n, e), prop = bst.COVER_WARMUP["B"]
    every_bucket = _warmup_pairs(cap, n, e, prop)
    assert len(every_bucket) == 10
    plan_b = bst.cover_plan(g, s["every"], every_bucket, cap)
    assert [p[:3] for p in plan_b] == [p[:3] for p in plan]
    assert all(p[3] == p[4] for p in plan_b)
    # past every warmed bucket, a trigger keeps its own
    g = synthetic.circle_graph(n_nodes=300, n_loops=60, seed=1)
    assert all(p[3] == p[4] for p in bst.cover_plan(g, 50, [(128, 32)],
                                                    cap))


def test_cover_row_on_the_cpu_follows_its_plan():
    """A small cover row through the port's eager engine: each trigger in
    the box that cover_plan gives it, and the row's gates but the card's
    launch count hold."""
    rec = bst.cover_row("A", "cpu", _config(), nodes=260, loops=300)
    assert [p[1:] for p in rec["plan"]] == rec["boxes"]
    # at these capacities the ladder leaves (256, 512) out
    assert rec["covered"] == 1 and rec["boxes"][-1][2:] == [[256, 512],
                                                            [512, 512]]
    gates = bst.row_gates("cover_2k_4000:A", rec)
    assert gates == dict(launches=False, trigger_captures=True, boxes=True,
                         chi2=True)


def _stream_rec(**kw):
    rec = dict(final_chi2=0.1427, trigger_captures=0,
               launches={"band_matvec": 30, "gj_inv": 9},
               launches_want={"band_matvec": 30, "gj_inv": 9},
               forced_escalation={"trigger": 10, "applied": True},
               served_after_landing=0, settle_after_landing=True)
    rec.update(kw)
    return rec


def test_wall_statistics_and_spread():
    walls = [10.0, 30.0, 20.0, 50.0, 40.0, 100.0]
    st = bst.wall_stats(walls)
    assert st == dict(trigger_host_ms_median=35.0,
                      trigger_host_ms_p90=75.0, trigger_host_ms_max=100.0,
                      steady_state_ms_median=50.0)
    assert bst.spread([3.0, None, 1.0, 2.0]) == dict(
        median=2.0, p25=1.5, p75=2.5, min=1.0, max=3.0, all=[3.0, 1.0, 2.0])
    assert bst.spread([None]) is None
    assert bst.row_key(2000, 400) == "streaming_2k_400"
    assert bst.row_key(30000, 3000, True, 2000.0, 5) == \
        "streaming_30k_3000_warm_paced_distress"
    assert bst.row_key(2000, 400, True, 150.0) == \
        "streaming_2k_400_warm_paced"


def test_gates():
    """(d): the chi^2 bar is 2% of the JAX row's; a warmed row captures
    nothing; launches are what the counts imply; a distress row's
    escalation applies and a trigger follows it."""
    key = "streaming_2k_400_warm_paced_distress"
    ref = bst.ROWS[key]["chi2_jax"]
    assert all(bst.row_gates(key, _stream_rec()).values())
    for chi2, ok in ((1.0199 * ref, True), (1.0201 * ref, False),
                     (0.9801 * ref, True), (0.9799 * ref, False),
                     (math.nan, False), (math.inf, False), (None, False)):
        assert bst.row_gates(key, _stream_rec(final_chi2=chi2))["chi2"] == ok
    bad = {
        "trigger_captures": dict(trigger_captures=1),
        "launches": dict(launches={"band_matvec": 29, "gj_inv": 9}),
        "forced_escalation_applied": dict(forced_escalation={"applied":
                                                             False}),
        "served_after_landing": dict(settle_after_landing=False),
    }
    for gate, kw in bad.items():
        got = bst.row_gates(key, _stream_rec(**kw))
        assert [k for k, v in got.items() if not v] == [gate], gate
    assert bst.row_gates(key, _stream_rec(
        settle_after_landing=False, served_after_landing=2))[
        "served_after_landing"]
    assert not bst.row_gates(key, _stream_rec(forced_escalation=None))[
        "forced_escalation_applied"]
    # a cold row captures on its trigger path, and has no distress gates
    assert set(bst.row_gates("streaming_2k_400",
                             _stream_rec(trigger_captures=4))) == {
        "launches", "chi2"}
    mw = _stream_rec(final_chi2=0.0301, worlds=3, sets=1)
    assert all(bst.row_gates("multiworld_1500", mw).values())
    assert not bst.row_gates("multiworld_1500", dict(mw, sets=2))["worlds"]
    assert bst.row_gates("streaming_2k_400", {"error": "exit 1"}) == {
        "ran": False}
    # the cover row's two sides fire the same triggers; streaming rows
    # have no gate across rows
    side = _stream_rec(boxes=[[100, 20, [128, 32], [256, 32]]])
    recs = {"streaming_2k_400": [_stream_rec(final_chi2=0.14265)] * 3,
            "cover_2k_4000:A": [side], "cover_2k_4000:B": [side]}
    assert bst.cross_gates(recs) == {"cover_same_triggers": True}
    recs["cover_2k_4000:B"] = [_stream_rec(
        boxes=[[101, 20, [128, 32], [128, 32]]])]
    assert not any(bst.cross_gates(recs).values())


@pytest.mark.parametrize("argv,says", [
    (["--procs", "1"], "torch.cuda.is_available() is false"),
    (["--device", "cpu"], "runs on a CUDA device only"),
    (["--only", "multiworld", "--child", "multiworld_1500"],
     "torch.cuda.is_available() is false"),
])
def test_harness_refuses_to_run_without_a_card(argv, says):
    """(e): no card here: the harness exits non-zero before any row and
    prints no result line (there is no CPU path)."""
    out = subprocess.run([sys.executable, "bench_stream_torch.py", *argv],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert says in out.stderr, out.stderr[-2000:]
    for line in out.stdout.splitlines():
        try:
            assert "metric" not in json.loads(line), line
        except json.JSONDecodeError:
            pass
    assert "[proc]" not in out.stdout
