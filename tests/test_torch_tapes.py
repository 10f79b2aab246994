"""PyTorch port: the host helpers that came with the engine rows' harness
(bench_stream_torch.py) against their JAX originals, on the CPU: the
JSON-lines event tape (graph/messages.py save_tape, load_tape,
replay_tape), the synthetic graph's canonical .g2o (graph/g2o.py
synthetic_to_g2o), the trajectory error (graph/synthetic.py ate_rmse) and
the phase timer's JSON report (utils/timing.py PhaseTimer.report_json)."""

import json

import numpy as np
import pytest

from solve_keyframe_pose_graph_tpu.graph import g2o as jg2o
from solve_keyframe_pose_graph_tpu.graph import messages as jmsg
from solve_keyframe_pose_graph_tpu.graph import store as jstore
from solve_keyframe_pose_graph_tpu.graph import synthetic as jsyn
from solve_keyframe_pose_graph_tpu.utils import timing as jtiming
from solve_keyframe_pose_graph_tpu_torch.graph import g2o as tg2o
from solve_keyframe_pose_graph_tpu_torch.graph import messages as tmsg
from solve_keyframe_pose_graph_tpu_torch.graph import store as tstore
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic as tsyn
from solve_keyframe_pose_graph_tpu_torch.utils import timing as ttiming

from test_torch_host_parity import S, _assert_tree_equal, _store_state

T0 = 1000 * S


def _tape(m):
    """A tape of every message kind, built with messages module `m`: 60
    nodes (every seventh with a covariance) around a kidnap / unkidnap
    pair, loop edges inside each world and one across, an extrinsic and an
    IMU pose (which changes no store)."""
    rng = np.random.default_rng(7)
    out, stamps = [], []
    for i in range(60):
        t = T0 + i * S
        if i == 25:
            out.append(m.KidnapIndicatorMsg(t - S // 2, "kidnapped"))
        if i == 31:
            out.append(m.KidnapIndicatorMsg(t - S // 2, "unkidnapped"))
        q = rng.normal(size=4)
        out.append(m.NodePoseMsg(t, q / np.linalg.norm(q), rng.normal(size=3),
                                 np.eye(6) * (i + 1) if i % 7 == 0 else None))
        stamps.append(t)
    for a, b in ((20, 3), (24, 10), (55, 40), (59, 5)):
        q = rng.normal(size=4)
        out.append(m.LoopEdgeMsg(stamps[a], stamps[b], q / np.linalg.norm(q),
                                 rng.normal(size=3),
                                 float(rng.uniform(0.5, 1.0)),
                                 f"edge {a}-{b}"))
    out.append(m.ExtrinsicMsg(T0, np.array([0.0, 0.0, 0.1, 1.0]),
                              np.array([0.05, 0.0, 0.02])))
    out.append(m.ImuPropagateMsg(T0 + 60 * S, np.array([0.0, 0.0, 0.0, 1.0]),
                                 np.zeros(3)))
    return out


def test_tape_round_trip_matches_reference(tmp_path):
    """Both packages write the same tape byte for byte; each reads the
    other's, and replaying it gives both stores the same state."""
    paths = {k: str(tmp_path / f"{k}.jsonl") for k in ("jax", "port")}
    jmsg.save_tape(paths["jax"], _tape(jmsg))
    tmsg.save_tape(paths["port"], _tape(tmsg))
    text = open(paths["port"]).read()
    assert text == open(paths["jax"]).read()
    assert len(text.splitlines()) == 60 + 2 + 4 + 2

    got = tmsg.load_tape(paths["jax"])
    ref = jmsg.load_tape(paths["port"])
    assert [type(m).__name__ for m in got] == [type(m).__name__ for m in ref]
    assert [m.to_json() for m in got] == [m.to_json() for m in ref]
    stores = (tstore.GraphStore(16), jstore.GraphStore(16))
    tmsg.replay_tape(got, stores[0])
    jmsg.replay_tape(ref, stores[1])
    states = [_store_state(s, tmp_path, tag)
              for s, tag in zip(stores, ("port", "jax"))]
    _assert_tree_equal(states[0], states[1])
    assert stores[0].node_len == 60 and stores[0].edge_len == 4
    assert stores[0].n_worlds() == 2


@pytest.mark.parametrize("seed,n,loops,outliers", [
    (1, 300, 60, 0.2), (4, 97, 13, 0.0)])
def test_synthetic_to_g2o_matches_reference(seed, n, loops, outliers,
                                            tmp_path):
    """One synthetic graph written as .g2o by both packages: the same
    bytes, and the same graph read back."""
    kw = dict(n_nodes=n, n_loops=loops, seed=seed, outlier_fraction=outliers)
    tg = tg2o.synthetic_to_g2o(tsyn.circle_graph(**kw))
    jg = jg2o.synthetic_to_g2o(jsyn.circle_graph(**kw))
    _assert_tree_equal(tg, jg)
    assert tg.n_edges == n - 1 + loops
    paths = [str(tmp_path / f"{k}.g2o") for k in ("jax", "port")]
    jg2o.save_g2o(paths[0], jg)
    tg2o.save_g2o(paths[1], tg)
    assert open(paths[1], "rb").read() == open(paths[0], "rb").read()
    _assert_tree_equal(tg2o.load_g2o(paths[1]), jg2o.load_g2o(paths[0]))


@pytest.mark.parametrize("align_first", [True, False])
def test_ate_rmse_matches_reference(align_first):
    g = tsyn.circle_graph(n_nodes=200, n_loops=20, seed=2)
    rng = np.random.default_rng(3)
    t_est = g.vio_t + rng.normal(scale=0.1, size=g.vio_t.shape)
    args = (g.vio_q, t_est, g.gt_q, g.gt_t)
    got = tsyn.ate_rmse(*args, align_first=align_first)
    assert got == jsyn.ate_rmse(*args, align_first=align_first)
    assert got > 0.0
    assert tsyn.ate_rmse(g.gt_q, g.gt_t, g.gt_q, g.gt_t,
                         align_first=align_first) < 1e-12


def test_phase_timer_report_json_matches_reference():
    """The same recorded phases report the same JSON document."""
    timers = (ttiming.PhaseTimer(), jtiming.PhaseTimer())
    for timer in timers:
        for name, dt in (("build", 0.25), ("solve", 1.5), ("build", 0.5)):
            timer.totals[name] += dt
            timer.counts[name] += 1
            timer.last[name] = dt
    got = timers[0].report_json()
    assert got == timers[1].report_json()
    doc = json.loads(got)
    assert doc["build"] == {"total_s": 0.75, "count": 2, "mean_ms": 375.0,
                            "last_ms": 500.0}
    with timers[0].phase("write_back"):
        pass
    assert json.loads(timers[0].report_json())["write_back"]["count"] == 1
