"""PyTorch port: Composer assembly and checkpoints against the JAX package.

The scenarios of tests/test_composer.py run through a JAX session (engine +
Composer) and a port session fed the same calls, fp64 on the CPU in the
port's formulation (as tests/test_torch_engine.py). Composed trajectories
agree to 1e-8 of their scale, the port's own vectorized assembly agrees
with its literal per-node loop to 1e-12, and a port checkpoint restores
into both packages alike."""

import json

import numpy as np

from solve_keyframe_pose_graph_tpu.compose.composer import (
    Composer as JaxComposer,
)
from solve_keyframe_pose_graph_tpu import config as jconfig
from solve_keyframe_pose_graph_tpu.graph.store import GraphStore as JaxStore
from solve_keyframe_pose_graph_tpu.solver.engine import (
    SolverEngine as JaxEngine,
)
from solve_keyframe_pose_graph_tpu_torch.compose.composer import Composer
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine
from solve_keyframe_pose_graph_tpu_torch.utils import nse3

from test_composer import S, T0, _assert_comp_equal
from test_torch_engine import _config
from test_torch_threads import one_torch_thread  # noqa: F401


class _Sessions:
    """A JAX and a port session (store, engine, Composer), fed alike."""

    def __init__(self):
        self.stores = (JaxStore(), GraphStore())
        self.engines = (JaxEngine(self.stores[0], _config(jconfig)),
                        SolverEngine(self.stores[1], _config(), device="cpu"))
        self.composers = (JaxComposer(self.stores[0], self.engines[0]),
                          Composer(self.stores[1], self.engines[1]))

    def __getattr__(self, name):          # store calls go to both stores
        def call(*args, **kw):
            out = [getattr(s, name)(*args, **kw) for s in self.stores]
            return out[1]
        return call

    def trigger(self):
        fired = [e.trigger() for e in self.engines]
        assert fired[0] == fired[1]
        return fired[1]

    def check(self):
        ref, got = (c.assemble() for c in self.composers)
        np.testing.assert_array_equal(got.world_of, ref.world_of)
        assert got.per_world == ref.per_world
        assert got.solved_until == ref.solved_until
        assert got.latest_pose_worldid == ref.latest_pose_worldid
        assert got.version == ref.version
        scale = max(np.abs(ref.t).max(), 1.0)
        np.testing.assert_allclose(got.t, ref.t, rtol=0, atol=1e-8 * scale)
        np.testing.assert_allclose(got.q, ref.q, rtol=0, atol=1e-8)
        port = self.composers[1]
        _assert_comp_equal(port._assemble_vectorized(), port._assemble_loop())
        return got


def _session(n=60, loop_at=40):
    b = _Sessions()
    rng = np.random.default_rng(1)
    drift = np.cumsum(rng.normal(scale=0.01, size=(n, 3)), axis=0)
    for i in range(n):
        b.add_node(T0 + i * S, nse3.quat_identity(),
                   np.array([float(i), 0, 0]) + drift[i])
        if i == loop_at:
            b.add_loop_edge(T0 + i * S, T0 + (i - 30) * S,
                            nse3.quat_identity(), [30.0, 0, 0], 1.0)
            assert b.trigger()
    return b


def test_assembly_regimes_match_reference():
    """test_composer.py scenarios A-D: solved prefix and extrapolated
    suffix, a dead zone, a second world merged by a loop edge, and more
    nodes after the solve."""
    b = _session()
    assert b.check().solved_until == 40
    b.kidnap_indicator(T0 + int(60.5 * S), "kidnapped")
    for k in range(3):
        b.add_node(T0 + int((61 + k) * S), nse3.quat_identity(),
                   [500.0 + k * 2, 100, 0])
    assert -1 in b.check().per_world
    b.kidnap_indicator(T0 + int(64.5 * S), "unkidnapped")
    for k in range(12):
        b.add_node(T0 + int((65 + k) * S), nse3.quat_identity(),
                   [float(30 + k), 1.0, 0])
    b.add_loop_edge(T0 + int(68 * S), T0 + int(33 * S),
                    nse3.quat_identity(), [0.2, 0.1, 0], 1.0)
    assert b.trigger()
    b.check()
    for k in range(5):
        b.add_node(T0 + int((80 + k) * S), nse3.quat_identity(),
                   [float(45 + k), 1.0, 0])
    b.check()


def test_imu_propagate_matches_reference():
    b = _session()
    b.set_extrinsic(nse3.quat_identity(), [0.1, 0.0, 0.05])
    b.check()
    q_imu = nse3.quat_normalize(np.array([0.0, 0.1, 0.0, 1.0]))
    t_imu = np.array([61.0, 0.2, 0.1])
    ref, got = (c.imu_propagate(q_imu, t_imu) for c in b.composers)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-8 * 60)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-8)


def test_checkpoint_round_trip_matches_reference(tmp_path):
    """The port writes the reference's solved_posegraph.json schema; the
    file restores into a fresh port session and a fresh JAX session alike,
    and the live session then solves around the frozen map in both."""
    b = _session()
    paths = [c.save_state_to_disk(str(tmp_path / name))
             for c, name in zip(b.composers, ("jax", "port"))]
    saved = [json.load(open(p)) for p in paths]
    assert saved[1].keys() == saved[0].keys()
    assert saved[1]["KidnapTimestamps"] == saved[0]["KidnapTimestamps"]
    assert saved[1]["WorldsData"] == saved[0]["WorldsData"]
    for a, r in zip(saved[1]["SolvedPoseGraph"], saved[0]["SolvedPoseGraph"]):
        assert {k: a[k] for k in a if k != "w_T_c"} == \
            {k: r[k] for k in r if k != "w_T_c"}
    assert all(s.current_kidnap_status for s in b.stores)

    fresh = _Sessions()
    for c in fresh.composers:
        assert c.load_state_from_disk(str(tmp_path / "port"))
    n = b.stores[1].node_len
    assert all(s.node_len == n for s in fresh.stores)
    assert fresh.engines[1].solved_until == n - 1
    assert fresh.engines[1]._opt_frozen[:n].all()
    comp_saved = b.composers[1].latest
    for i in (0, 20, 50):
        np.testing.assert_allclose(fresh.engines[1].get_node_pose(i)[1],
                                   comp_saved.t[i], atol=1e-9)

    t_end = b.stores[1].node_timestamp(n - 1)
    fresh.mark_as_unkidnapped_and_signal_start_of_world(t_end + 10 * S)
    i_new = fresh.add_node(t_end + 11 * S, nse3.quat_identity(), [0, 0, 0])
    st = fresh.stores[1]
    assert st.which_world_is_this(st.node_timestamp(i_new)) == 1
    frozen_before = fresh.engines[1]._opt_t[:10].copy()
    qe, te = nse3.pose_inv(*st.node_pose(30))
    q_rel, t_rel = nse3.pose_mul(qe, te, *st.node_pose(i_new))
    fresh.add_loop_edge(st.node_timestamp(i_new), st.node_timestamp(30),
                        q_rel, t_rel, 1.0)
    assert fresh.trigger()
    assert st.worlds.find_setID_of_world_i(1) == 0
    np.testing.assert_array_equal(fresh.engines[1]._opt_t[:10],
                                  frozen_before)
    fresh.check()


def test_random_schedules_match_reference():
    """test_composer.py's random kidnap/loop schedules (three of them)."""
    rng = np.random.default_rng(42)
    for _ in range(3):
        b = _Sessions()
        t = T0
        kidnapped = False
        i = 0
        n_target = int(rng.integers(40, 90))
        while i < n_target:
            r = rng.random()
            if r < 0.06 and i > 10:
                b.kidnap_indicator(t, "unkidnapped" if kidnapped
                                   else "kidnapped")
                kidnapped = not kidnapped
                t += S
                continue
            b.add_node(t, nse3.quat_identity(),
                       [float(i), rng.normal() * 0.1, 0])
            st = b.stores[1]
            if not kidnapped and r > 0.9 and i > 15 and st.node_len > 12:
                j = int(rng.integers(0, st.node_len - 10))
                b.add_loop_edge(
                    t, st.node_timestamp(j), nse3.quat_identity(),
                    np.asarray(st.node_pose(st.node_len - 1)[1])
                    - np.asarray(st.node_pose(j)[1]), 1.0)
                b.trigger()
            t += S
            i += 1
        b.check()
