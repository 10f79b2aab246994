"""PyTorch port: SE(3) helpers, 6-DOF residuals and block products, and the
Gauss-Newton main-path subset, held against the JAX package at fp64 on the
CPU. Tolerance: 1e-10 relative (the same math, only the summation order
may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu.graph import synthetic
from solve_keyframe_pose_graph_tpu.ops import gn as jgn
from solve_keyframe_pose_graph_tpu.ops import residuals as jres
from solve_keyframe_pose_graph_tpu.ops import se3 as jse3
from solve_keyframe_pose_graph_tpu.solver.problem import build_problem_np
from solve_keyframe_pose_graph_tpu_torch.ops import gn as tgn
from solve_keyframe_pose_graph_tpu_torch.ops import residuals as tres
from solve_keyframe_pose_graph_tpu_torch.ops import se3 as tse3
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, problem_from_arrays,
)

from test_torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-10


def close(got, ref, rtol=RTOL):
    """|got - ref| <= rtol * max|ref| elementwise (relative to the scale)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-300) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def test_se3_helpers_match_reference(rng):
    n = 64
    q1, q2 = _quats(rng, n), _quats(rng, n)
    t1, t2 = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    delta = rng.normal(scale=0.3, size=(n, 3))
    delta[:4] *= 1e-8                                  # the small branch
    J, T = _both(q1, t1, q2, t2, delta)
    close(tse3.quat_mul(T[0], T[2]), jse3.quat_mul(J[0], J[2]))
    close(tse3.quat_conj(T[0]), jse3.quat_conj(J[0]))
    close(tse3.quat_normalize(2.0 * T[0]), jse3.quat_normalize(2.0 * J[0]))
    close(tse3.quat_rotate(T[0], T[1]), jse3.quat_rotate(J[0], J[1]))
    close(tse3.quat_box_plus(T[0], T[4]), jse3.quat_box_plus(J[0], J[4]))
    for a, b in zip(tse3.pose_relative(*T[:4]), jse3.pose_relative(*J[:4])):
        close(a, b)


def _edge_inputs(rng, n=96):
    q1, q2, oq = _quats(rng, n), _quats(rng, n), _quats(rng, n)
    t1, t2, ot = (rng.normal(size=(n, 3)) for _ in range(3))
    s = rng.uniform(0.1, 1.0, size=n)
    w = rng.uniform(0.5, 1.5, size=n)
    return _both(q1, t1, q2, t2, s, oq, ot, w)


def test_residual_functions_match_reference(rng):
    J, T = _edge_inputs(rng)
    jq1, jt1, jq2, jt2, js, joq, jot, jw = J
    tq1, tt1, tq2, tt2, ts, toq, tot, tw = T
    close(tres.six_dof_residual(tq1, tt1, tq2, tt2, toq, tot, tw),
          jres.six_dof_residual(jq1, jt1, jq2, jt2, joq, jot, jw))
    close(tres.six_dof_switch_residual(tq1, tt1, tq2, tt2, ts, toq, tot, tw),
          jres.six_dof_switch_residual(jq1, jt1, jq2, jt2, js, joq, jot, jw))
    close(tres.node_prior_residual(tq1, tt1, toq, tot, tw),
          jres.node_prior_residual(jq1, jt1, joq, jot, jw))


def test_block_products_match_reference(rng):
    J, T = _edge_inputs(rng)
    jq1, jt1, jq2, jt2, js, joq, jot, jw = J
    tq1, tt1, tq2, tt2, ts, toq, tot, tw = T
    pairs = [
        (tres.six_dof_block_products_t(tq1, tt1, tq2, tt2, toq, tot, tw),
         jres.six_dof_block_products_t(jq1, jt1, jq2, jt2, joq, jot, jw)),
        (tres.six_dof_switch_block_products_t(tq1, tt1, tq2, tt2, ts, toq,
                                              tot, tw),
         jres.six_dof_switch_block_products_t(jq1, jt1, jq2, jt2, js, joq,
                                              jot, jw)),
        (tres.node_prior_block_products_t(tq1, tt1, toq, tot, tw),
         jres.node_prior_block_products_t(jq1, jt1, joq, jot, jw)),
    ]
    for got, ref in pairs:
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            close(a, b)


def _problems(outliers=0.3, seed=5, n=150, n_loops=24):
    g = synthetic.circle_graph(n_nodes=n, n_loops=n_loops,
                               outlier_fraction=outliers, seed=seed)
    valid = np.ones(n, bool)
    valid[70:72] = False
    free = np.ones(n, bool)
    free[:6] = False
    rng = np.random.default_rng(seed)
    jp = build_problem_np(
        q=g.gt_q, t=g.vio_t + rng.normal(scale=0.05, size=g.vio_t.shape),
        vio_q=g.vio_q, vio_t=g.vio_t, node_valid=valid,
        loop_pairs=g.loop_pairs, loop_q=g.loop_q, loop_t=g.loop_t,
        loop_w=g.loop_w, loop_valid=np.arange(n_loops) % 5 != 0,
        switch=rng.uniform(0.3, 0.99, n_loops), prior_idx=np.array([0]),
        prior_q=g.vio_q[:1], prior_t=g.vio_t[:1], prior_w=np.array([1.5]),
        node_free=free, n_cap=256, e_cap=64, p_cap=2, dtype=np.float64)
    tp = problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")
    return jp, tp


@pytest.mark.parametrize("use_switch", [True, False])
def test_evaluate_cost_matches_reference(use_switch):
    jp, tp = _problems()
    close(tgn.evaluate_cost(tp, tp.q, tp.t, tp.switch, use_switch),
          jgn.evaluate_cost(jp, jp.q, jp.t, jp.switch, use_switch))


def _blocks(use_switch):
    jp, tp = _problems()
    jb = jgn.assemble_t(jp, jp.q, jp.t, jp.switch, use_switch=use_switch)
    tb = tgn.assemble_t(tp, tp.q, tp.t, tp.switch, use_switch=use_switch)
    return jp, tp, jb, tb


@pytest.mark.parametrize("use_switch", [True, False])
def test_assemble_t_matches_reference(use_switch):
    _, _, jb, tb = _blocks(use_switch)
    for name in ("cost", "D", "B", "Aba", "cb", "ca", "ds", "g_n", "g_s"):
        close(getattr(tb, name), getattr(jb, name))


def _scales(rng, nc, ec):
    return (rng.uniform(0.2, 1.0, (6, nc)), rng.uniform(0.2, 1.0, ec),
            rng.uniform(1e-4, 1e-2, (6, nc)), rng.uniform(1e-4, 1e-2, ec))


def _reduced(use_switch, rng):
    jp, tp, jb, tb = _blocks(use_switch)
    sc = _scales(rng, tp.n_cap, tp.e_cap)
    jr = jgn.schur_reduce_t(jb, jp, *[jnp.asarray(a) for a in sc])
    tr = tgn.schur_reduce_t(tb, tp, *[torch.from_numpy(a) for a in sc])
    return jp, tp, jr, tr


@pytest.mark.parametrize("use_switch", [True, False])
def test_schur_reduce_t_matches_reference(use_switch, rng):
    _, _, jr, tr = _reduced(use_switch, rng)
    for name in ("Dh", "Bh", "Aba_h", "rhs_n", "chb", "cha", "ds_inv",
                 "rhs_s"):
        close(getattr(tr, name), getattr(jr, name))


@pytest.mark.parametrize("use_switch", [True, False])
def test_matvecs_and_switch_recovery_match_reference(use_switch, rng):
    jp, tp, jr, tr = _reduced(use_switch, rng)
    x = rng.normal(size=(6, tp.n_cap))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    close(tgn.loop_matvec_t(tr, tp, tx), jgn.loop_matvec_t(jr, jp, jx))
    close(tgn.band_matvec_t(tr.Dh, tr.Bh, tx),
          jgn.band_matvec_t(jr, jp, jx))
    close(tgn.reduced_matvec_t(tr, tp, tx),
          jgn.reduced_matvec_t(jr, jp, jx, impl="xla"))
    close(tgn.recover_switches_t(tr, tp, tx),
          jgn.recover_switches_t(jr, jp, jx))
    close(tgn.t_blocks_to_aos(tr.Aba_h), jgn.t_blocks_to_aos(jr.Aba_h))


def test_scatter_loop_rows_matches_index_add(rng):
    """The fixed-order loop scatter equals index_add_ over every edge slot
    (masked and padding edges carry zero rows, and it leaves them out)."""
    _, tp = _problems()
    m = tp.loop_mask[:, None]
    vb, va = (torch.from_numpy(rng.normal(size=(tp.e_cap, 36))) * m
              for _ in range(2))
    want = torch.zeros((tp.n_cap, 36), dtype=torch.float64)
    want.index_add_(0, tp.loop_b, vb).index_add_(0, tp.loop_a, va)
    close(tgn.scatter_loop_rows(tp, vb, va), want, rtol=1e-14)
    rows = tp.loop_rows_by_node
    assert len(rows.order) == int(rows.lengths.sum()) == 2 * tp.e_cap
    assert int(rows.lengths[:rows.n].sum()) == 2 * int(tp.loop_mask.sum())
    assert int(tp.loop_mask.sum()) < tp.e_cap
