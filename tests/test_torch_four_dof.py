"""PyTorch port: the 4-DOF residual family (yaw-weighted Euler rows,
CeresResidues.h:252-422) against the JAX package at fp64 on the CPU.

Tolerances: 1e-12 relative for the rotation matrix, the Euler angles and the
residuals (the same arithmetic); 1e-10 for the autodiff Jacobians and the
assembled blocks (forward-mode autodiff and the per-node sums run in a
different order in the two packages). A whole 4-DOF solve takes the same LM
and CG counts, and its chi^2 is held to 1e-6 relative and its switches to
1e-8. The reference side is jitted: its eager autodiff costs more than its
compile."""

import jax
import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu.graph import synthetic as jsynthetic
from solve_keyframe_pose_graph_tpu.ops import gn as jgn
from solve_keyframe_pose_graph_tpu.ops import lm as jlm
from solve_keyframe_pose_graph_tpu.ops import residuals as jres
from solve_keyframe_pose_graph_tpu.ops import se3 as jse3
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic as tsynthetic
from solve_keyframe_pose_graph_tpu_torch.ops import gn as tgn
from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
from solve_keyframe_pose_graph_tpu_torch.ops import residuals as tres
from solve_keyframe_pose_graph_tpu_torch.ops import se3 as tse3
from solve_keyframe_pose_graph_tpu_torch.solver import cpu_rung as trung
from solve_keyframe_pose_graph_tpu_torch.solver import problem as tprob
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, problem_from_arrays,
)

from test_lm_solver import build_circle_problem
from test_torch_residuals_gn import _both, _edge_inputs, _problems, _quats
from test_torch_residuals_gn import close
from test_torch_threads import one_torch_thread  # noqa: F401


def _ypr_quats(ypr_deg):
    """Unit quaternions (xyzw) of yaw-pitch-roll angles in degrees."""
    y, p, r = (np.radians(np.asarray(ypr_deg)[:, k]) / 2 for k in range(3))
    cy, sy, cp, sp, cr, sr = (np.cos(y), np.sin(y), np.cos(p), np.sin(p),
                              np.cos(r), np.sin(r))
    return np.stack([cy * cp * sr - sy * sp * cr,
                     cy * sp * cr + sy * cp * sr,
                     sy * cp * cr - cy * sp * sr,
                     cy * cp * cr + sy * sp * sr], axis=-1)


def test_rotation_and_euler_angles_match_reference(rng):
    # random rotations, and pitches within 1e-4 degrees of +-90, where yaw
    # and roll come from near-degenerate atan2 arguments
    near = rng.uniform(-180, 180, size=(16, 3))
    near[:, 1] = np.repeat([89.9999, -89.9999, 89.99999, -89.99999], 4)
    q = np.concatenate([_quats(rng, 64), _ypr_quats(near)])
    J, T = _both(q)
    R_t = tse3.quat_to_rot(T[0])
    close(R_t, jax.jit(jse3.quat_to_rot)(J[0]), rtol=1e-12)
    # one R into both: near +-90 degrees of pitch, yaw and roll move by
    # ~1e-7 degrees for a last-bit change of R
    J, T = _both(R_t.numpy())
    close(tse3.rot_to_ypr_deg(T[0]), jse3.rot_to_ypr_deg(J[0]), rtol=1e-12)
    # the angles of the near-vertical rotations come back as built
    ypr = tse3.rot_to_ypr_deg(R_t)[64:].numpy()
    np.testing.assert_allclose(ypr[:, 1], near[:, 1], atol=1e-6)


def test_four_dof_residuals_match_reference(rng):
    J, T = _edge_inputs(rng)
    jq1, jt1, jq2, jt2, js, joq, jot, jw = J
    tq1, tt1, tq2, tt2, ts, toq, tot, tw = T
    close(tres.four_dof_residual(tq1, tt1, tq2, tt2, toq, tot, tw),
          jax.jit(jres.four_dof_residual)(jq1, jt1, jq2, jt2, joq, jot, jw),
          rtol=1e-12)
    close(tres.four_dof_switch_residual(tq1, tt1, tq2, tt2, ts, toq, tot, tw),
          jax.jit(jres.four_dof_switch_residual)(jq1, jt1, jq2, jt2, js, joq,
                                                 jot, jw),
          rtol=1e-12)


def test_jacobian_evaluators_match_reference(rng):
    """The autodiff evaluators (torch.func.vmap of jacfwd against jax.vmap
    of jacfwd) and the closed-form prior Jacobian. The edges are small
    random poses; then identical endpoints, where the box-plus takes its
    guarded small-angle branch."""
    J, T = _edge_inputs(rng)
    jq1, jt1, jq2, jt2, js, joq, jot, jw = J
    tq1, tt1, tq2, tt2, ts, toq, tot, tw = T
    for got, ref in (
            (tres.four_dof_residual_jac(tq1, tt1, tq2, tt2, toq, tot, tw),
             jax.jit(jres.four_dof_residual_jac)(jq1, jt1, jq2, jt2, joq,
                                                 jot, jw)),
            (tres.four_dof_switch_residual_jac(tq1, tt1, tq2, tt2, ts, toq,
                                               tot, tw),
             jax.jit(jres.four_dof_switch_residual_jac)(
                 jq1, jt1, jq2, jt2, js, joq, jot, jw)),
            (tres.node_prior_residual_jac(tq1, tt1, toq, tot, tw),
             jax.jit(jres.node_prior_residual_jac)(jq1, jt1, joq, jot,
                                                   jw))):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert bool(torch.isfinite(a).all())
            close(a, b)
    # identical endpoints and an identity observation: every tangent finite
    n = 8
    q = torch.tensor(_quats(rng, n))
    t = torch.tensor(rng.normal(size=(n, 3)))
    ident = torch.zeros((n, 4), dtype=torch.float64)
    ident[:, 3] = 1.0
    zero3 = torch.zeros((n, 3), dtype=torch.float64)
    out = tres.four_dof_switch_residual_jac(q, t, q, t, torch.ones(n),
                                            ident, zero3, torch.ones(n))
    assert all(bool(torch.isfinite(x).all()) for x in out)
    # fp32 in, fp32 out (a 0-dim tensor times a Python float gets a float64
    # tangent under jacfwd; the residuals avoid that form)
    f32 = [x.float() for x in T]
    for out in (tres.four_dof_residual_jac(*f32[:4], *f32[5:]),
                tres.four_dof_switch_residual_jac(*f32),
                tres.node_prior_residual_jac(*f32[:2], *f32[5:])):
        assert all(x.dtype == torch.float32 for x in out)


def test_assemble_4dof_and_cost_match_reference():
    """Every GNBlocksT field on a circle problem with dead-zone nodes,
    frozen nodes, masked loop edges and priors."""
    jp, tp = _problems(outliers=0.3, seed=9, n=200, n_loops=40)
    jb = jax.jit(jgn.assemble_4dof_t)(jp, jp.q, jp.t, jp.switch)
    tb = tgn.assemble_4dof_t(tp, tp.q, tp.t, tp.switch)
    for name in ("cost", "D", "B", "Aba", "cb", "ca", "ds", "g_n", "g_s"):
        close(getattr(tb, name), getattr(jb, name))
    close(tgn.evaluate_cost_4dof(tp, tp.q, tp.t, tp.switch),
          jax.jit(jgn.evaluate_cost_4dof)(jp, jp.q, jp.t, jp.switch))
    close(tgn.evaluate_cost_4dof(tp, tp.q, tp.t, tp.switch), tb.cost)


@pytest.fixture(scope="module")
def four_dof_solves():
    """The JAX package's own 4-DOF end-to-end problem
    (tests/test_lm_solver.py::test_four_dof_mode_end_to_end: 150 nodes, 25
    loops, seed 9, lm_solve's defaults) solved by both packages."""
    g, jp = build_circle_problem(n=150, n_loops=25, seed=9)
    tp = problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")
    kw = dict(max_iterations=10, residual_mode="4dof")
    ref = jlm.lm_solve(jp, loop_impl="scatter", band_impl="aos", **kw)
    return g, ref, tlm.lm_solve(tp, **kw)


def test_four_dof_lm_solve_matches_reference(four_dof_solves):
    _, ref, got = four_dof_solves
    for name in ("iterations", "successful_steps", "total_cg_iterations",
                 "distress_rejects", "converged"):
        assert int(getattr(got, name)) == int(getattr(ref, name)), name
    for name in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=1e-6)
    # the poses are not compared: the 4-DOF cost is nearly flat along some
    # pose directions at this minimum (the two solutions' translations
    # differ by ~5e-4 of their scale where their chi^2 agree to 1e-6)
    np.testing.assert_allclose(got.switch.numpy(), np.asarray(ref.switch),
                               rtol=0, atol=1e-8)


def test_four_dof_end_to_end_criterion(four_dof_solves):
    """The JAX package's criterion, replayed through the port: the cost
    falls below 1% of the initial and the ATE below 0.7 x the VIO's."""
    g, _, res = four_dof_solves
    assert float(res.final_cost) < 0.01 * float(res.initial_cost)
    n = g.n_nodes
    ate_before = tsynthetic.ate_rmse(g.vio_q, g.vio_t, g.gt_q, g.gt_t)
    ate_after = tsynthetic.ate_rmse(res.q[:n].numpy(), res.t[:n].numpy(),
                                    g.gt_q, g.gt_t)
    assert ate_after < 0.7 * ate_before


def test_four_dof_escalation_takes_the_device_rung():
    """The host rung serves the 6-DOF switched family only. Under "auto" a
    4-DOF escalation takes the device ladder: with escalation forced, the
    mixed rung and then the fp64 lm_solve on the problem's own device (here
    the CPU), which gives exactly fp64_resolve's result; under "cpu" it
    raises. (The ladder's labels against the reference's:
    tests/test_torch_mixed.py.)"""
    g = jsynthetic.circle_graph(n_nodes=48, n_loops=8, seed=3,
                                outlier_fraction=0.2)
    prob = tprob.build_problem_np(
        q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
        node_valid=np.ones(48, bool), loop_pairs=g.loop_pairs,
        loop_q=g.loop_q, loop_t=g.loop_t, loop_w=g.loop_w,
        loop_valid=np.ones(8, bool), switch=np.full(8, 0.99),
        prior_idx=np.array([0]), prior_q=g.vio_q[:1], prior_t=g.vio_t[:1],
        prior_w=np.array([1.1]), n_cap=64, e_cap=8, p_cap=2,
        dtype=np.float32, device="cpu")
    kw = dict(max_iterations=3, preconditioner="band+coarse",
              coarse_group=16, residual_mode="4dof")
    assert not trung.available(kw)
    got, rung, stats = tlm.escalate_resolve(prob, kw, 0, fp64_backend="auto")
    assert rung == "fp64" and stats["total_s"] > 0
    assert got.q.dtype == torch.float64
    want = tlm.fp64_resolve(prob, kw)
    for name in ("q", "t", "switch", "final_cost", "total_cg_iterations"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert float(got.final_cost) < float(got.initial_cost)
    with pytest.raises(RuntimeError, match="unavailable"):
        tlm.escalate_resolve(prob, kw, 0, fp64_backend="cpu")
