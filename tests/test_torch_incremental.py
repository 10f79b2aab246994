"""PyTorch port: the incremental problem builder (solver/incremental.py) and
the engine that uses it.

The builder must return, at every step of a growing stream, a Problem
bitwise equal to the port's from-scratch build_problem_np, and field by field
equal to the JAX package's IncrementalBuilder. It must never change a
Problem it returned earlier: a background escalation or a repacked view
may still be reading it. Through the engine, incremental and
full builds give bitwise the same poses, and the incremental port engine
agrees with the incremental JAX engine as the full-build engines do."""

import dataclasses

import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu import config as jconfig
from solve_keyframe_pose_graph_tpu.graph import synthetic
from solve_keyframe_pose_graph_tpu.solver.engine import (
    SolverEngine as JaxEngine,
)
from solve_keyframe_pose_graph_tpu.solver.incremental import (
    IncrementalBuilder as JaxBuilder,
)
from solve_keyframe_pose_graph_tpu_torch import config as tconfig
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine
from solve_keyframe_pose_graph_tpu_torch.solver.incremental import (
    IncrementalBuilder,
)
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, build_problem_np, repack_problem,
)
from solve_keyframe_pose_graph_tpu_torch.utils import nse3

from test_engine import S, T0, yaw_quat
from test_torch_engine import _Both, _config
from test_torch_threads import one_torch_thread  # noqa: F401


def _inputs(g, n, e, node_valid=None, loop_valid=None, switch=None,
            node_free=None):
    """tests/test_incremental_build.py's inputs (fp32, n_cap 1024)."""
    return dict(
        q=g.vio_q[:n] + 0.0, t=g.vio_t[:n] + 0.0,
        vio_q=g.vio_q[:n], vio_t=g.vio_t[:n],
        node_valid=np.ones(n, bool) if node_valid is None else node_valid,
        loop_pairs=g.loop_pairs[:e], loop_q=g.loop_q[:e],
        loop_t=g.loop_t[:e], loop_w=g.loop_w[:e],
        loop_valid=np.ones(e, bool) if loop_valid is None else loop_valid,
        switch=np.full(e, 0.99) if switch is None else switch,
        prior_idx=np.array([0]), prior_q=g.vio_q[:1], prior_t=g.vio_t[:1],
        prior_w=np.array([1.1]), node_free=node_free,
        n_cap=1024, e_cap=256, p_cap=16, dtype=np.float32)


class _Builders:
    """The port's and the JAX package's builders fed the same inputs; each
    Problem is checked against the port's full build and the JAX one."""

    def __init__(self):
        self.port, self.jax = IncrementalBuilder(), JaxBuilder()

    def build(self, **kw):
        got = self.port.build(device="cpu", **kw)
        full = build_problem_np(device="cpu", **kw)
        ref = self.jax.build(**kw)
        for f in FIELDS:
            a = getattr(got, f)
            assert a.dtype == getattr(full, f).dtype, f
            assert torch.equal(a, getattr(full, f)), f
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f)
        assert (self.port.full_builds, self.port.delta_builds) == \
            (self.jax.full_builds, self.jax.delta_builds)
        return got


def test_incremental_bitwise_equals_scratch_over_stream():
    g = synthetic.circle_graph(n_nodes=700, n_loops=90, seed=11)
    b = _Builders()
    rng = np.random.default_rng(0)
    steps = [(150, 10), (151, 10), (400, 37), (555, 61), (700, 90)]
    for n, e in steps:
        kw = _inputs(g, n, e)
        kw["q"] = kw["q"] + rng.normal(scale=1e-3, size=kw["q"].shape)
        kw["switch"] = np.full(e, 0.9)
        b.build(**kw)
    assert b.port.full_builds == 1
    assert b.port.delta_builds == len(steps) - 1


def test_incremental_handles_dead_zones_and_guard_fallback():
    g = synthetic.circle_graph(n_nodes=400, n_loops=40, seed=3)
    b = _Builders()
    nv1 = np.ones(200, bool); nv1[120:140] = False
    b.build(**_inputs(g, 200, 12, node_valid=nv1))
    # append-only growth that keeps the dead zone: the delta path
    nv2 = np.ones(400, bool); nv2[120:140] = False
    b.build(**_inputs(g, 400, 40, node_valid=nv2))
    assert b.port.delta_builds == 1
    # an edge masked after the fact (ablation): the guards take a full build
    lv3 = np.ones(40, bool); lv3[5] = False
    b.build(**_inputs(g, 400, 40, node_valid=nv2, loop_valid=lv3))
    assert b.port.full_builds == 2
    # a frozen prefix (checkpoint restore) changes only the free mask, a
    # state leaf: the delta path stays valid
    nf = np.zeros(400, bool); nf[:100] = True
    b.build(**_inputs(g, 400, 40, node_valid=nv2, loop_valid=lv3,
                      node_free=~nf))
    assert b.port.delta_builds == 2


def test_incremental_capacity_rebucket_falls_back():
    g = synthetic.circle_graph(n_nodes=300, n_loops=30, seed=5)
    b = _Builders()
    b.build(**_inputs(g, 200, 20))
    kw = _inputs(g, 300, 30)
    kw["n_cap"] = 2048                      # bucket doubled
    b.build(**kw)
    assert b.port.full_builds == 2
    # the device is part of the key too
    port = IncrementalBuilder()
    port.build(device="cpu", **_inputs(g, 200, 20))
    port.build(device=torch.device("cpu"), **_inputs(g, 300, 30))
    assert (port.full_builds, port.delta_builds) == (1, 1)


def test_a_later_build_leaves_earlier_problems_unchanged():
    """A Problem (and a repacked view of it) is bitwise unchanged after the
    next build takes the delta path; only what changed is new."""
    g = synthetic.circle_graph(n_nodes=600, n_loops=80, seed=2)
    port = IncrementalBuilder()
    first = port.build(device="cpu", **_inputs(g, 300, 30))
    view = repack_problem(first, 300, 30, granularity=64)
    snap = {f: getattr(first, f).clone() for f in FIELDS}
    snap_view = {f: getattr(view, f).clone() for f in FIELDS}
    nxt = port.build(device="cpu", **_inputs(g, 600, 79))
    assert port.delta_builds == 1
    for f in FIELDS:
        assert torch.equal(getattr(first, f), snap[f]), f
        assert torch.equal(getattr(view, f), snap_view[f]), f
        assert getattr(nxt, f).data_ptr() != getattr(first, f).data_ptr(), f
    assert float(first.node_mask.sum()) == 300
    assert float(nxt.node_mask.sum()) == 600
    # a build that adds no node shares the odometry leaves it did not change
    same = port.build(device="cpu", **_inputs(g, 600, 80))
    assert same.odo_q is nxt.odo_q and same.loop_q is not nxt.loop_q


def _cfg(c=tconfig, incremental=True):
    """The engine tests' config (test_torch_engine._config) with the
    incremental build on or off, first buckets with room for a delta (128
    nodes, 64 edges: a delta that does not fit takes the full build), and 4
    LM iterations per solve, to keep the CPU solves short."""
    cfg = _config(c)
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, max_lm_iterations=4),
        stream=dataclasses.replace(cfg.stream,
                                   incremental_build=incremental),
        capacity=dataclasses.replace(cfg.capacity, initial_nodes=256,
                                     initial_edges=128))


class _Pair(_Both):
    """Two port engines on the CPU, one with the incremental build and one
    with the full build, fed the same store calls."""

    def __init__(self):
        self.stores = (GraphStore(), GraphStore())
        self.inc = SolverEngine(self.stores[0], _cfg(), device="cpu")
        self.full = SolverEngine(self.stores[1], _cfg(incremental=False),
                                 device="cpu")

    def trigger(self) -> bool:
        fired = (self.inc.trigger(), self.full.trigger())
        assert fired[0] == fired[1]
        return fired[0]

    def check_poses(self):
        n = self.stores[0].node_len
        inc, full = self.inc, self.full
        assert np.array_equal(inc._opt_q[:n], full._opt_q[:n])
        assert np.array_equal(inc._opt_t[:n], full._opt_t[:n])
        assert np.array_equal(inc._switch, full._switch)
        for a, b in zip(inc.solve_stats, full.solve_stats):
            for k in ("initial_cost", "final_cost", "lm_iterations",
                      "cg_iterations"):
                assert a[k] == b[k], k


def _stream(b):
    """tests/test_engine.py's streaming-growth scenario."""
    rng = np.random.default_rng(0)
    drift = np.cumsum(rng.normal(scale=0.02, size=(120, 3)), axis=0)
    for i in range(120):
        b.add_node(T0 + i * S, nse3.quat_identity(),
                   np.array([float(i), 0, 0]) + drift[i])
        if i > 0 and i % 30 == 0:
            b.add_loop_edge(T0 + i * S, T0 + (i - 20) * S,
                            nse3.quat_identity(), np.array([20.0, 0, 0]),
                            1.0)
            assert b.trigger()
            b.check_poses()


def _kidnap_merge(b):
    """tests/test_engine.py's multi-world kidnap and merge scenario."""
    n0 = 40
    for i in range(n0):
        b.add_node(T0 + i * S, nse3.quat_identity(), [float(i), 0, 0])
    b.add_loop_edge(T0 + 30 * S, T0 + 10 * S, nse3.quat_identity(),
                    [-20.0, 0, 0], 1.0)
    assert b.trigger()
    b.kidnap_indicator(T0 + int((n0 + 0.5) * S), "kidnapped")
    for k in range(6):
        b.add_node(T0 + int((n0 + 1 + k * 0.5) * S), nse3.quat_identity(),
                   [100.0 + k, -50.0, 0])
    b.kidnap_indicator(T0 + int((n0 + 4.5) * S), "unkidnapped")
    q_w01 = yaw_quat(np.pi / 2)
    t_w01 = np.array([5.0, 7.0, 0.0])
    w1 = [b.add_node(T0 + (n0 + 5 + j) * S, nse3.quat_identity(),
                     [float(j), 0, 0]) for j in range(30)]
    q_a, t_a = nse3.pose_mul(q_w01, t_w01, nse3.quat_identity(),
                             [10.0, 0, 0])
    qi, ti = nse3.pose_inv(nse3.quat_identity(), np.array([20.0, 0, 0]))
    q_bta, t_bta = nse3.pose_mul(qi, ti, q_a, t_a)
    b.add_loop_edge(T0 + (n0 + 15) * S, T0 + 20 * S, q_bta, t_bta, 1.0)
    assert b.trigger()
    b.check_poses()
    # a second loop inside world 1 after the merge: the delta path again
    b.add_loop_edge(T0 + (n0 + 30) * S, T0 + (n0 + 10) * S,
                    nse3.quat_identity(), [-20.0, 0, 0], 1.0)
    assert b.trigger()
    b.check_poses()
    return w1


@pytest.mark.parametrize("scenario", [_stream, _kidnap_merge])
def test_engine_incremental_equals_full_build(scenario):
    b = _Pair()
    scenario(b)
    inc = [r for r in b.inc.solve_stats if "trigger_wall_ms" in r]
    full = [r for r in b.full.solve_stats if "trigger_wall_ms" in r]
    assert len(inc) == 3
    assert [r["delta_builds"] for r in inc] == [0, 1, 2]
    assert all(r["full_builds"] == 1 for r in inc)
    assert [r["full_builds"] for r in full] == list(range(1, len(full) + 1))
    assert all(r["delta_builds"] == 0 for r in full)
    assert all(r["problem_build_ms"] > 0 for r in inc + full)


def test_incremental_engines_match_reference():
    """The streaming scenario through the JAX engine and the port's, both
    with stream.incremental_build (the default)."""
    b = _Both()
    b.jax = JaxEngine(b.stores[0], _cfg(jconfig))
    b.port = SolverEngine(b.stores[1], _cfg(), device="cpu")
    _stream(b)
    assert b.port.solve_stats[-1]["delta_builds"] == 2
    assert b.jax._inc_builder.delta_builds == 2
