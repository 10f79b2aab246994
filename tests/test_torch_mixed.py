"""PyTorch port: the mixed-precision rung (lm_solve(precision="mixed"),
mixed_resolve) and the device escalation ladder (escalate_resolve) against
the JAX package on the CPU.

The mixed rung assembles, keeps its state and decides in fp64 around an
fp32 reduction, factorization and CG. The JAX side runs its XLA matvec
under x64 and the port its plain K1: two fp32 CG loops whose sums run in
different orders, so the bars are fp32 bars, on a graph whose final chi^2
is set by its measurement noise. On the circle graph at the synthetic
default noise the final chi^2 (~3e-4) is at the level the fp32 step's
rounding reaches, and two fp32 CG loops land 1e-5 to 1e-4 apart in it; at
translation noise 0.3 (odometry) and 0.15 (loops) chi^2 is ~0.25 and the
two land within 1e-7. On it: equal LM, accepted-step and CG counts, chi^2
within 1e-6 relative, q, t and switch in fp64 in both and within 1e-3 of
their scale (the fp32 steps move the poses along flat directions). The
fp64 rung is held, with exact CG forcing, to 1e-9 in chi^2 as in
tests/test_torch_escalation.py. On the CPU, escalate_resolve's statistics
carry the mixed rung's wall and counts."""

import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu.ops import lm as jlm
from solve_keyframe_pose_graph_tpu.solver import problem as jprob
from solve_keyframe_pose_graph_tpu_torch import config as tconfig
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
from solve_keyframe_pose_graph_tpu_torch.parallel import (
    make_mesh, shard_problem,
)
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, problem_astype, problem_from_arrays,
)
from solve_keyframe_pose_graph_tpu_torch.utils import nse3

from test_engine import S, T0
from test_torch_threads import one_torch_thread  # noqa: F401

PRODUCT = dict(max_iterations=10, preconditioner="band+coarse", bcr_levels=2,
               max_cg_iterations=45)
# the JAX side in the port's formulation
JAX_FORM = dict(loop_impl="scatter", band_impl="aos")
NOISY = dict(odo_trans_noise=0.3, loop_trans_noise=0.15)


def _inputs(n=256, loops=32, seed=0, n_cap=256, e_cap=32, outliers=0.2,
            **noise):
    g = synthetic.circle_graph(n_nodes=n, n_loops=loops, seed=seed,
                               outlier_fraction=outliers, **noise)
    return dict(
        q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
        node_valid=np.ones(n, bool), loop_pairs=g.loop_pairs,
        loop_q=g.loop_q, loop_t=g.loop_t, loop_w=g.loop_w,
        loop_valid=np.ones(loops, bool), switch=np.full(loops, 0.99),
        prior_idx=np.array([0]), prior_q=g.vio_q[:1], prior_t=g.vio_t[:1],
        prior_w=np.array([1.1]), n_cap=n_cap, e_cap=e_cap, p_cap=4)


def _problems(**graph):
    """The same fp32 Problem for the JAX package and the port (CPU)."""
    jp = jprob.build_problem_np(dtype=np.float32, **_inputs(**graph))
    tp = problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")
    return jp, tp


def _counts(res):
    return tuple(int(getattr(res, k)) for k in (
        "iterations", "successful_steps", "total_cg_iterations",
        "distress_rejects"))


def assert_fp32_bars(got, want, rtol=1e-6):
    assert _counts(got) == _counts(want)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=rtol)
    for name in ("q", "t", "switch"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype == np.float64, name
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-3 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)


@pytest.fixture(scope="module")
def noisy():
    return _problems(**NOISY)


def test_mixed_rung_matches_reference(noisy):
    """The device ladder of both packages on a healthy graph at the
    product threshold (3 overshoot rejections) keeps the mixed rung; its
    result is mixed_resolve's, held to the fp32 bars. The reference's own
    check (tests/test_precision.py) also holds: the mixed solve lands
    within 5e-3 of the native fp32 solve, its parameter state and costs in
    fp64."""
    jp, tp = noisy
    want, ref_rung = jlm.escalate_resolve(jp, dict(PRODUCT, **JAX_FORM), 3,
                                          fp64_backend="tpu")
    got, rung, stats = tlm.escalate_resolve(tp, PRODUCT, 3,
                                            fp64_backend="tpu")
    assert rung == ref_rung == "mixed"
    assert_fp32_bars(got, want)
    assert (stats["mixed_lm_iterations"], stats["mixed_cg_iterations"]) == \
        (int(got.iterations), int(got.total_cg_iterations))
    assert stats["total_s"] >= stats["mixed_s"] > 0
    alone = tlm.mixed_resolve(tp, PRODUCT)
    for name in ("q", "t", "switch", "final_cost"):
        assert torch.equal(getattr(alone, name), getattr(got, name)), name
    assert got.final_cost.dtype == got.initial_cost.dtype == torch.float64
    assert float(got.final_cost) < 1e-3 * float(got.initial_cost)
    native = tlm.lm_solve(tp, **PRODUCT)
    assert native.q.dtype == torch.float32
    assert float(got.final_cost) <= 1.02 * float(native.final_cost) + 1e-9
    np.testing.assert_allclose(float(got.final_cost),
                               float(native.final_cost), rtol=5e-3)


def test_mixed_on_an_fp64_problem_is_native():
    p64 = problem_astype(_problems()[1], torch.float64)
    kw = dict(PRODUCT, max_iterations=3)
    a = tlm.lm_solve(p64, precision="mixed", **kw)
    b = tlm.lm_solve(p64, **kw)
    for name in ("q", "t", "switch", "final_cost", "total_cg_iterations"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_forced_ladder_climbs_to_fp64_as_reference():
    """Escalation forced on the device ladder: both packages run the mixed
    rung and then the fp64 rung. With exact CG forcing (which the mixed
    rung takes too) on tests/test_torch_escalation.py's 48-node graph,
    whose fp64 CG converges within the rung's cap, chi^2 agrees to 1e-9."""
    jp, tp = _problems(n=48, loops=8, seed=3, n_cap=48, e_cap=8)
    kw = dict(PRODUCT, coarse_group=16, cg_tolerance=1e-12)
    want, ref_rung = jlm.escalate_resolve(jp, dict(kw, **JAX_FORM), 0,
                                          fp64_backend="tpu")
    got, rung, stats = tlm.escalate_resolve(tp, kw, 0, fp64_backend="tpu")
    assert rung == ref_rung == "fp64"
    assert got.q.dtype == torch.float64
    assert stats["mixed_lm_iterations"] >= 1
    assert stats["mixed_cg_iterations"] >= stats["mixed_lm_iterations"]
    assert stats["total_s"] > stats["mixed_s"] > 0
    assert int(got.successful_steps) == int(want.successful_steps)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=1e-9)


def test_four_dof_ladder_matches_reference():
    """The host rung serves the 6-DOF family only, so a 4-DOF escalation
    under "auto" takes the device ladder in both packages: not forced it
    keeps the mixed rung, forced it climbs to fp64 (chi^2 to 1e-9 of
    max(1, chi^2), with exact CG forcing). The 4-DOF minimum of these graphs is ~0 (a switched
    loop leaves an odometry tree), where relative chi^2 says nothing, so
    the mixed rung is held to the 4-DOF criterion of chip_smoke.py phase
    12: chi^2 at most 1e-9 of the initial, in both, with equal LM and
    accepted-step counts."""
    jp, tp = _problems(n=64, loops=8, n_cap=64, e_cap=8, outliers=0.0,
                       **NOISY)
    kw = dict(PRODUCT, residual_mode="4dof", max_iterations=6,
              coarse_group=16, cg_tolerance=1e-12)
    for rejects, want_rung in ((3, "mixed"), (0, "fp64")):
        want, ref_rung = jlm.escalate_resolve(jp, dict(kw, **JAX_FORM),
                                              rejects, fp64_backend="auto")
        got, rung, stats = tlm.escalate_resolve(tp, kw, rejects,
                                                fp64_backend="auto")
        assert rung == ref_rung == want_rung
        assert got.q.dtype == torch.float64
        assert stats["mixed_lm_iterations"] >= 1
        if rung == "mixed":
            assert _counts(got)[:2] == _counts(want)[:2]
            for res in (got, want):
                assert float(res.final_cost) <= 1e-9 * float(
                    res.initial_cost)
        else:           # the certificate's bar, at a minimum of ~0
            c, c1 = float(got.final_cost), float(want.final_cost)
            assert abs(c - c1) <= 1e-9 * max(1.0, abs(c1)), (c, c1)


def test_mixed_on_a_mesh_matches_one_device(noisy):
    """ShardedOps in mixed precision: fp64 sub-Problems (the same halo and
    ghost layout), their assembly partials summed in fp64, fp32 CG on the
    shards. The sums of the fp32 CG run in another order than on one
    device, so the 4-shard solve is held to the fp32 bars above, not to
    the fp64 certificate of tests/test_torch_sharded_lm.py."""
    _, tp = noisy
    want = tlm.mixed_resolve(tp, PRODUCT)
    sp = shard_problem(tp, make_mesh(devices=["cpu"] * 4))
    got = tlm.mixed_resolve(sp, PRODUCT)
    assert got.q.shape == want.q.shape
    assert_fp32_bars(got, want)


def test_engine_on_a_mesh_takes_the_same_rung():
    """A forced inline escalation on the device ladder, from an engine on
    4 CPU shards and from an unmeshed one: the same rung, the mixed rung's
    counts in the row's rung_stats, and poses within the fp32 bars."""
    rows, poses = [], []
    for P in (1, 4):
        cfg = tconfig.Config(
            solver=tconfig.SolverConfig(escalate_rejects=0,
                                        fp64_backend="tpu",
                                        max_lm_iterations=4),
            stream=tconfig.StreamConfig(async_dispatch=False,
                                        background_escalation=False),
            capacity=tconfig.CapacityConfig(initial_nodes=64,
                                            initial_edges=8),
            mesh=tconfig.MeshConfig(n_devices=P))
        store = GraphStore()
        eng = SolverEngine(store, cfg, device="cpu")
        assert (eng.mesh is None) == (P == 1)
        rng = np.random.default_rng(7)
        for i in range(48):
            store.add_node(T0 + i * S, nse3.quat_identity(),
                           [float(i), rng.normal() * 0.05, 0])
        store.add_loop_edge(T0 + 40 * S, T0 + 5 * S, nse3.quat_identity(),
                            np.asarray(store.node_pose(40)[1])
                            - np.asarray(store.node_pose(5)[1]) + 0.05, 1.0)
        assert eng.trigger()
        rows.append(eng.solve_stats[-1])
        poses.append(eng._opt_t[:48].copy())
    assert rows[0]["fp64_escalated"] == rows[1]["fp64_escalated"] == "fp64"
    for r in rows:
        st = r["rung_stats"]
        assert st["mixed_lm_iterations"] >= 1 and st["total_s"] > 0
    np.testing.assert_allclose(poses[1], poses[0], rtol=0,
                               atol=1e-3 * np.abs(poses[0]).max())
