"""The frozen generator and the arrival schedules repeat exactly for a
seed, and the generator draws the program's circle graph."""

from __future__ import annotations

import json

import numpy as np

from port_bench.harness import generators, nse3, traffic

SEED = 3_141_592_653_589     # more than 32 bits, as the driver's are


def _fields(g):
    return [g.gt_q, g.gt_t, g.vio_q, g.vio_t, g.loop_pairs, g.loop_q,
            g.loop_t, g.loop_w, g.loop_is_outlier]


def test_generator_repeats_for_a_seed():
    spec = {"generator": "circle_graph",
            "args": {"n_nodes": 300, "n_loops": 500}}
    a = generators.generate(spec, SEED)
    b = generators.generate(spec, SEED)
    c = generators.generate(spec, SEED + 1)
    for x, y in zip(_fields(a), _fields(b)):
        assert np.array_equal(x, y)
    assert not np.array_equal(a.vio_t, c.vio_t)


def test_generator_is_the_programs_circle_graph():
    from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
    a = generators.circle_graph(400, 700, seed=SEED)
    b = synthetic.circle_graph(400, 700, seed=SEED)
    for x, y in zip(_fields(a), [b.gt_q, b.gt_t, b.vio_q, b.vio_t,
                                 b.loop_pairs, b.loop_q, b.loop_t, b.loop_w,
                                 b.loop_is_outlier]):
        assert np.array_equal(x, y)


MIX = {"keyframes": {"per_s": 10}, "pose_queries": {"per_s": 200},
       "lead_s": 2.0}


def test_arrivals_repeat():
    a = traffic.keyframe_due(MIX, 30)
    assert np.array_equal(a, traffic.keyframe_due(MIX, 30))
    assert len(a) == 300 and a[0] == 0.0 and np.allclose(np.diff(a), 0.1)
    q = traffic.pose_due(MIX, 30)
    assert len(q) == 6000 and np.allclose(np.diff(q), 1 / 200)


def test_keyframes_are_stamped_as_they_arrive():
    g = generators.circle_graph(50, 60, seed=SEED)
    dt = traffic.stamp_ns(MIX)
    assert dt == 100_000_000
    stamps = [json.loads(traffic.node_line(g, i, dt))["t_ns"]
              for i in range(3)]
    assert np.diff(stamps).tolist() == [dt, dt]
    assert traffic.stamp_ns({"keyframes": {"per_s": 15}}) == 66_666_667


def test_pose_queries_ask_at_the_current_keyframe():
    kf_due = traffic.keyframe_due(MIX, 3.0) - 2.0      # a 2 s lead-in
    nodes = 4400 + np.arange(len(kf_due))
    q_due = traffic.pose_due(MIX, 1.0)
    at = traffic.pose_nodes(kf_due, nodes, q_due)
    # the query at 0.0 s asks at the keyframe due then; 0.095 s still at
    # it; 0.1 s at the next
    assert at[0] == 4420 and at[19] == 4420 and at[20] == 4421
    assert at[-1] == 4429
    g = generators.circle_graph(50, 60, seed=SEED)
    line = json.loads(traffic.pose_line(g, 7, 100_000_000))
    assert line["t_ns"] == traffic.T0_NS + 7 * 100_000_000
    assert line["t"] == g.vio_t[7].tolist()


def test_session_is_every_runs_and_the_traffic_the_seeds():
    spec = {"generator": "circle_graph",
            "args": {"n_nodes": 300, "n_loops": 500}}
    first = 220
    a = generators.session(spec, 0, SEED, first)
    b = generators.session(spec, 0, SEED + 1, first)
    s0 = generators.generate(spec, 0)
    later = lambda g: np.max(g.loop_pairs, axis=1)
    for g in (a, b):
        assert np.array_equal(g.vio_t[:first], s0.vio_t[:first])
        assert np.array_equal(g.loop_pairs[later(g) < first],
                              s0.loop_pairs[later(s0) < first])
    assert not np.array_equal(a.vio_t[first:], b.vio_t[first:])
    assert not np.array_equal(a.loop_t[later(a) >= first],
                              b.loop_t[later(b) >= first])
    # the seed's odometry, chained on from the session's last node
    own = generators.generate(spec, SEED)
    for u in (first, first + 30):
        want = nse3.pose_relative(own.vio_q[first - 1], own.vio_t[first - 1],
                                  own.vio_q[u], own.vio_t[u])
        got = nse3.pose_relative(a.vio_q[first - 1], a.vio_t[first - 1],
                                 a.vio_q[u], a.vio_t[u])
        assert np.allclose(got[1], want[1]) and np.allclose(
            abs(np.sum(got[0] * want[0])), 1.0)


def test_stream_order_is_the_wire_order():
    g = generators.circle_graph(200, 300, seed=SEED)
    order = generators.stream_order(g)
    by_later = traffic.edges_by_later(g)
    wire = [k for i in range(g.n_nodes) for k in by_later.get(i, ())]
    assert list(order) == wire
