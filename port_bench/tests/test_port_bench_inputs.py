"""The frozen generator and the arrival schedules repeat exactly for a
seed, the generator draws the program's circle graph, and a graph's
events and counted edges reach the stream."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

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


def _circle(n_nodes, n_loops, seed=SEED):
    return generators.generate({"generator": "circle_graph",
                                "args": {"n_nodes": n_nodes,
                                         "n_loops": n_loops}}, seed)


def test_generator_is_the_programs_circle_graph():
    from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
    a = _circle(400, 700)
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
    g = _circle(50, 60)
    dt = traffic.stamp_ns(MIX)
    assert dt == 100_000_000
    stamps = [json.loads(traffic.node_line(g, i, dt))["t_ns"]
              for i in range(3)]
    assert np.diff(stamps).tolist() == [dt, dt]
    assert stamps[0] == traffic.T0_NS
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
    g = _circle(50, 60)
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
    g = _circle(200, 300)
    order = generators.stream_order(g)
    by_later = traffic.edges_by_later(g)
    wire = [k for i in range(g.n_nodes) for k in by_later.get(i, ())]
    assert list(order) == wire


def _kidnapped(g, after, before):
    """g with a kidnap after node `after` and an unkidnap before node
    `before`."""
    return dataclasses.replace(
        g, events=[generators.Event(after, True,
                                    {"kind": "kidnap_indicator",
                                     "frame_id": "kidnapped"}),
                   generators.Event(before, False,
                                    {"kind": "kidnap_indicator",
                                     "frame_id": "unkidnapped"})])


def test_events_are_sent_around_their_nodes():
    g = _kidnapped(_circle(200, 300), 150, 160)
    by_later = traffic.edges_by_later(g)
    dt = traffic.stamp_ns(MIX)
    lines = [json.loads(s) for s in traffic.keyframe_lines(g, 150, by_later,
                                                          dt)]
    assert [m["kind"] for m in lines] == (
        ["node_pose"] + ["loop_edge"] * len(by_later.get(150, ()))
        + ["kidnap_indicator"])
    assert lines[-1] == {"kind": "kidnap_indicator", "frame_id": "kidnapped",
                         "t_ns": traffic.T0_NS + 150 * dt + 1}
    lines = [json.loads(s) for s in traffic.keyframe_lines(g, 160, by_later,
                                                          dt)]
    assert lines[0] == {"kind": "kidnap_indicator",
                        "frame_id": "unkidnapped",
                        "t_ns": traffic.T0_NS + 160 * dt - 1}
    assert lines[1]["kind"] == "node_pose"
    assert [json.loads(s)["kind"] for s in traffic.keyframe_lines(
        g, 155, by_later, dt)][0] == "node_pose"


@pytest.mark.parametrize("events", [
    [(150, True, "kidnapped"), (160, False, "unkidnapped")],
    [(150, False, "kidnapped"), (150, True, "unkidnapped"),
     (170, True, "kidnapped"), (190, False, "unkidnapped")],
    [(40, True, "kidnapped"), (60, False, "unkidnapped"),
     (180, True, "kidnapped")],
])
def test_counted_edges_are_the_programs_dead_zones(events):
    """The loop edges the harness counts are those whose endpoints the
    program's store puts in a world, not in a dead zone, once the stream
    is in."""
    from solve_keyframe_pose_graph_tpu_torch.graph.native import make_store
    g = dataclasses.replace(_circle(200, 300), events=[
        generators.Event(n, after, {"kind": "kidnap_indicator",
                                    "frame_id": f})
        for n, after, f in events])
    by_later = traffic.edges_by_later(g)
    dt = traffic.stamp_ns(MIX)
    from solve_keyframe_pose_graph_tpu_torch.graph.messages import (
        message_from_json)
    store = make_store(256, native=False)
    for i in range(g.n_nodes):
        for line in traffic.keyframe_lines(g, i, by_later, dt):
            message_from_json(json.loads(line)).apply(store)
    dead = store.node_worlds() < 0
    assert np.array_equal(g.kidnapped()[:, 0], dead)
    assert dead.any() and not dead.all()
    a, b = g.loop_pairs[:, 0], g.loop_pairs[:, 1]
    assert np.array_equal(g.loop_counted, ~(dead[a] | dead[b]))
    assert not g.loop_counted.all()
    # a graph with no events counts every edge
    assert _circle(50, 60).loop_counted.all()


def test_a_repeated_kidnap_state_is_refused():
    g = dataclasses.replace(_circle(50, 60), events=[
        generators.Event(n, True, {"kind": "kidnap_indicator",
                                   "frame_id": "kidnapped"})
        for n in (10, 20)])
    with pytest.raises(ValueError, match="repeats"):
        g.kidnapped()


def test_session_carries_events():
    spec = {"generator": "circle_graph",
            "args": {"n_nodes": 300, "n_loops": 500}}
    first = 220
    # the session's kidnap and the traffic's unkidnap
    a = _kidnapped(generators.generate(spec, 0), 200, 230)
    b = _kidnapped(generators.generate(spec, SEED), 210, 240)
    orig = generators.generate
    try:
        generators.generate = (lambda s, seed, base=None:
                               a if seed == 0 else b)
        g = generators.session(spec, 0, SEED, first)
    finally:
        generators.generate = orig
    assert [(e.node, e.message["frame_id"]) for e in g.events] == [
        (200, "kidnapped"), (240, "unkidnapped")]
    dead = g.kidnapped()[:, 0]
    assert np.flatnonzero(dead).tolist() == list(range(201, 240))
