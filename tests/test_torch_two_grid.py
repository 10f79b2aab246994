"""PyTorch port: the multiplicative two-grid preconditioner ("band*coarse":
a coarse correction, a band smoothing step and a second coarse correction)
against the JAX package at fp64 on the CPU, and the JAX package's own
two-level checks (tests/test_coarse.py) replayed through the port.

A whole band*coarse solve takes the same LM and CG counts as the
reference's, chi^2 within 1e-6 relative; the operator is symmetric to 1e-8
and positive semi-definite."""

import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu.ops import lm as jlm
from solve_keyframe_pose_graph_tpu_torch.ops import band as tband
from solve_keyframe_pose_graph_tpu_torch.ops import band_matvec
from solve_keyframe_pose_graph_tpu_torch.ops import coarse as tcoarse
from solve_keyframe_pose_graph_tpu_torch.ops import gn as tgn
from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
from solve_keyframe_pose_graph_tpu_torch.ops import smallinv
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, problem_from_arrays,
)

from test_lm_solver import build_circle_problem
from test_torch_threads import one_torch_thread  # noqa: F401

PRODUCT = dict(max_iterations=10, bcr_levels=2, max_cg_iterations=45)


def _port(jp):
    return problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                               "cpu")


@pytest.fixture(scope="module")
def two_grid_solves():
    """One band*coarse solve by each package at the product settings; the
    port's band-part matvecs (kernel K1 on the card) are counted."""
    _, jp = build_circle_problem(n=200, n_loops=40, outlier_fraction=0.3)
    kw = dict(PRODUCT, preconditioner="band*coarse", coarse_group=16)
    ref = jlm.lm_solve(jp, loop_impl="scatter", band_impl="aos", **kw)
    calls = []
    real = band_matvec.band_matvec
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(band_matvec, "band_matvec",
                   lambda *a: calls.append(1) or real(*a))
        got = tlm.lm_solve(_port(jp), **kw)
    return ref, got, len(calls)


def test_two_grid_lm_solve_matches_reference(two_grid_solves):
    ref, got, _ = two_grid_solves
    for name in ("iterations", "successful_steps", "total_cg_iterations",
                 "distress_rejects", "converged"):
        assert int(getattr(got, name)) == int(getattr(ref, name)), name
    for name in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=1e-6)
    assert float(got.final_cost) < 0.05 * float(got.initial_cost)


def test_two_grid_runs_three_matvecs_per_cg_iteration(two_grid_solves):
    """CG's own matvec per iteration of its fixed cap, and two inside each
    preconditioner application (one before the loop, one per iteration):
    what chip_smoke.expected_launches counts for K1 on this path."""
    _, got, calls = two_grid_solves
    cap = PRODUCT["max_cg_iterations"]
    assert calls == int(got.iterations) * (cap + 2 * (cap + 1))


def _reduced(tp, radius=1e4):
    """The first LM iteration's scaled, damped, switch-eliminated system."""
    blocks = tgn.assemble_t(tp, tp.q, tp.t, tp.switch)
    out = []
    for d in (blocks.D[list(tgn.DIAG36)], blocks.ds):
        s = 1.0 / (1.0 + torch.sqrt(torch.clamp(d, min=0)))
        out.append((s, torch.clamp(d * s * s, 1e-6, 1e32) / radius))
    (sn, ln), (ss, ls) = out
    return tgn.schur_reduce_t(blocks, tp, sn, ss, ln, ls)


def test_two_grid_operator_is_symmetric_psd(rng):
    """tests/test_coarse.py::test_two_level_preconditioners_symmetric_psd
    through the port: the coarse correction and the two-grid cycle, with
    the reference's block-jacobi smoother and with the port's own band
    (BCR) smoother, are symmetric and PSD on the free subspace."""
    _, jp = build_circle_problem(n=60, n_loops=12, seed=7)
    tp = _port(jp)
    red = _reduced(tp)
    group = 8
    Hc_inv = tcoarse.build_coarse_inverse(red, tp, group)
    free = tp.free_mask.numpy()

    def coarse(r):
        return tcoarse.coarse_apply(Hc_inv, tp.free_mask, r, group)

    def mv(p):
        return tgn.reduced_matvec_t(red, tp, p)

    Minv = smallinv.gauss_jordan_inv(tgn.t_blocks_to_aos(red.Dh))

    def jacobi(v):
        return torch.einsum("uij,uj->ui", Minv, v.T).T

    F = tp.fanout
    A, C, _ = tband.build_band_system(
        tgn.t_blocks_to_aos(red.Dh),
        torch.stack([tgn.t_blocks_to_aos(red.Bh[f]) for f in range(F)]), F)
    fac = tband.bcr_factorize(A, C, group=F, max_levels=2)

    def band(v):
        return tband.band_precond_apply(fac, v.T).T

    ops = (coarse,
           lambda r: tcoarse.two_grid_apply(jacobi, coarse, mv, r),
           lambda r: tcoarse.two_grid_apply(band, coarse, mv, r))
    for op in ops:
        a = torch.tensor(rng.normal(size=(6, tp.n_cap)) * free[None, :])
        b = torch.tensor(rng.normal(size=(6, tp.n_cap)) * free[None, :])
        lhs = float(torch.sum(op(a) * b))
        rhs = float(torch.sum(a * op(b)))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-8, atol=1e-10)
        assert float(torch.sum(a * op(a))) >= -1e-10
    # the two-grid's result feeds K1 (via CG's direction), which takes
    # contiguous input
    assert all(op(a).is_contiguous() for op in ops[1:])


@pytest.fixture(scope="module")
def band_solve():
    _, jp = build_circle_problem(n=200, n_loops=40, seed=3)
    return jp, tlm.lm_solve(_port(jp), max_iterations=10,
                            preconditioner="band")


@pytest.mark.parametrize("precond", ["band+coarse", "band*coarse"])
def test_two_level_matches_band_quality(band_solve, precond):
    """tests/test_coarse.py::test_lm_two_level_matches_band_quality through
    the port: the two-level solves reach the plain band solve's cost in
    comparable CG work, and padded nodes stay exactly at their inputs."""
    jp, res_band = band_solve
    tp = _port(jp)
    res_2l = tlm.lm_solve(tp, max_iterations=10, preconditioner=precond,
                          coarse_group=16)
    assert float(res_2l.final_cost) <= 1.05 * float(res_band.final_cost)
    assert int(res_2l.total_cg_iterations) <= 1.15 * int(
        res_band.total_cg_iterations)
    nm = tp.node_mask.numpy() < 0.5
    np.testing.assert_array_equal(res_2l.q.numpy()[nm], tp.q.numpy()[nm])
    np.testing.assert_array_equal(res_2l.t.numpy()[nm], tp.t.numpy()[nm])
