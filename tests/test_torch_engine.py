"""PyTorch port: the streaming engine's synchronous trigger path, replaying
the trigger-gating, streaming-growth and multi-world-kidnap scenarios of
tests/test_engine.py through both engines.

Both run fp64 on the CPU with the same solver settings; the JAX engine is
set to the port's formulation (scatter loop matvec, AoS band build, the full
problem build) and to no fp64 escalation. Every optimized pose must agree
to 1e-8 of its scale, and every trigger must fire in both."""

import dataclasses

import numpy as np
import pytest

from solve_keyframe_pose_graph_tpu.config import (
    Config, IOConfig, SolverConfig, StreamConfig,
)
from solve_keyframe_pose_graph_tpu.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu.solver.engine import (
    SolverEngine as JaxEngine,
)
from solve_keyframe_pose_graph_tpu.utils import nse3
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine

from test_engine import S, T0, yaw_quat
from test_torch_threads import one_torch_thread  # noqa: F401


def _config():
    return Config(
        solver=SolverConfig(dtype="float64", adaptive_fp64=False,
                            loop_impl="scatter", band_impl="aos"),
        stream=StreamConfig(async_dispatch=False, incremental_build=False),
        io=IOConfig(compile_cache_dir=""))


class _Both:
    """One store per engine, fed the same calls."""

    def __init__(self):
        self.stores = (GraphStore(), GraphStore())
        self.jax = JaxEngine(self.stores[0], _config())
        self.port = SolverEngine(self.stores[1], _config(), device="cpu")

    def __getattr__(self, name):          # store calls go to both stores
        def call(*args, **kw):
            out = [getattr(s, name)(*args, **kw) for s in self.stores]
            assert out[0] == out[1] or (
                out[0] is None and out[1] is None), name
            return out[0]
        return call

    def trigger(self) -> bool:
        fired = (self.jax.trigger(), self.port.trigger())
        assert fired[0] == fired[1]
        return fired[0]

    def check_poses(self):
        n = self.stores[0].node_len
        assert self.port.n_opt_variables() == self.jax.n_opt_variables()
        assert self.port.solved_until == self.jax.solved_until
        ref = np.array([np.concatenate(self.jax.get_node_pose(i))
                        for i in range(self.jax.n_opt_variables())])
        got = np.array([np.concatenate(self.port.get_node_pose(i))
                        for i in range(self.port.n_opt_variables())])
        if n:
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-8 * max(np.abs(ref).max(), 1))
        for js, ts in zip(self.jax.solve_stats, self.port.solve_stats):
            for k in ("trigger", "node_len", "edge_len", "lm_iterations",
                      "successful_steps", "cg_iterations"):
                assert ts[k] == js[k], k
            np.testing.assert_allclose(ts["final_cost"], js["final_cost"],
                                       rtol=1e-6, atol=1e-12)
            assert ts["final_cost"] <= ts["initial_cost"]


def test_trigger_gating_matches_reference():
    b = _Both()
    assert not b.trigger()
    b.add_node(T0, nse3.quat_identity(), [0, 0, 0])
    b.add_node(T0 + S, nse3.quat_identity(), [1, 0, 0])
    assert not b.trigger()
    b.add_loop_edge(T0 + S, T0, nse3.quat_identity(), [-1.05, 0, 0], 1.0)
    assert b.trigger()
    assert b.port.solved_until == 1
    assert not b.trigger()
    b.mark_as_kidnapped(T0 + 2 * S)
    b.mark_as_unkidnapped(T0 + 3 * S)
    b.add_node(T0 + 4 * S, nse3.quat_identity(), [0, 0, 0])
    b.mark_as_kidnapped(T0 + 5 * S)
    b.add_loop_edge(T0 + S, T0, nse3.quat_identity(), [-1, 0, 0], 1.0)
    assert not b.trigger()
    b.mark_as_unkidnapped(T0 + 6 * S)
    assert b.trigger()
    b.check_poses()
    assert not b.port.collect() and not b.port.drain()


def test_streaming_growth_matches_reference():
    rng = np.random.default_rng(0)
    b = _Both()
    N = 120
    drift = np.cumsum(rng.normal(scale=0.02, size=(N, 3)), axis=0)
    for i in range(N):
        b.add_node(T0 + i * S, nse3.quat_identity(),
                   np.array([float(i), 0, 0]) + drift[i])
        if i > 0 and i % 30 == 0:
            b.add_loop_edge(T0 + i * S, T0 + (i - 20) * S,
                            nse3.quat_identity(), np.array([20.0, 0, 0]),
                            1.0)
            assert b.trigger()
            assert b.port.solved_until == i
            b.check_poses()
    assert b.port.trigger_id == 3


def test_multiworld_kidnap_merge_matches_reference():
    b = _Both()
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
    w1_nodes = [b.add_node(T0 + (n0 + 5 + j) * S, nse3.quat_identity(),
                           [float(j), 0, 0]) for j in range(30)]
    a, bb = w1_nodes[10], 20
    q_a_w0, t_a_w0 = nse3.pose_mul(q_w01, t_w01, nse3.quat_identity(),
                                   [10.0, 0, 0])
    qi, ti = nse3.pose_inv(nse3.quat_identity(), np.array([20.0, 0, 0]))
    q_bta, t_bta = nse3.pose_mul(qi, ti, q_a_w0, t_a_w0)
    b.add_loop_edge(T0 + (n0 + 15) * S, T0 + bb * S, q_bta, t_bta, 1.0)
    assert b.trigger()
    assert b.stores[1].worlds.find_setID_of_world_i(1) == 0
    b.check_poses()
    for j, idx in enumerate(w1_nodes):
        _, t_gt = nse3.pose_mul(q_w01, t_w01, nse3.quat_identity(),
                                [float(j), 0, 0])
        np.testing.assert_allclose(b.port.get_node_pose(idx)[1], t_gt,
                                   atol=0.2)


def test_load_state_freezes_restored_nodes_as_reference():
    """Checkpoint restore: restored poses are frozen (the reference marks
    them constant) while the live session solves around them."""
    b = _Both()
    rng = np.random.default_rng(3)
    n_old = 30
    q_old = np.tile(nse3.quat_identity(), (n_old, 1))
    t_old = np.stack([np.arange(n_old, dtype=float),
                      rng.normal(scale=0.01, size=n_old),
                      np.zeros(n_old)], -1)
    for eng in (b.jax, b.port):
        eng.load_state(q_old, t_old)
    for i in range(60):
        b.add_node(T0 + i * S, nse3.quat_identity(),
                   [float(i) + 0.03 * i, 0.0, 0.0])
    b.add_loop_edge(T0 + 55 * S, T0 + 15 * S, nse3.quat_identity(),
                    [-40.0, 0, 0], 1.0)
    assert b.trigger()
    b.check_poses()
    for i in range(n_old):
        np.testing.assert_array_equal(b.port.get_node_pose(i)[1], t_old[i])


def test_distressed_solve_is_logged_not_escalated(caplog):
    """The fp64 rung is not ported: a solve that needs escalation keeps its
    result, records its distress count and says so at WARNING."""
    store = GraphStore()
    cfg = dataclasses.replace(
        _config(), solver=SolverConfig(dtype="float32", escalate_rejects=0))
    eng = SolverEngine(store, cfg)
    for i in range(40):
        store.add_node(T0 + i * S, nse3.quat_identity(), [float(i), 0, 0])
    store.add_loop_edge(T0 + 30 * S, T0 + 5 * S, nse3.quat_identity(),
                        [-25.05, 0, 0], 1.0)
    with caplog.at_level("WARNING"):
        assert eng.trigger()
    row = eng.solve_stats[-1]
    assert "distress_rejects" in row and row["final_cost"] <= row["initial_cost"]
    assert any("without fp64 escalation" in r.message for r in caplog.records)
    with pytest.raises(IndexError):
        eng.get_node_pose(40)
