"""PyTorch port: band BCR preconditioner, coarse correction and PCG against
the JAX package at fp64 on the CPU. Tolerance 1e-10 relative per op (the
same math, only the summation order differs), except 1e-9 for the coarse
inverse (a dense Cholesky and triangular solve from two different LAPACK
implementations, refined by Newton steps) and 1e-9 / 1e-8 for the PCG x / r
(rounding compounds over tens of iterations); PCG must also take the same
number of iterations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu.ops import band as jband
from solve_keyframe_pose_graph_tpu.ops import coarse as jcoarse
from solve_keyframe_pose_graph_tpu.ops import gn as jgn
from solve_keyframe_pose_graph_tpu.ops import pcg as jpcg
from solve_keyframe_pose_graph_tpu_torch.ops import band as tband
from solve_keyframe_pose_graph_tpu_torch.ops import coarse as tcoarse
from solve_keyframe_pose_graph_tpu_torch.ops import gn as tgn
from solve_keyframe_pose_graph_tpu_torch.ops import pcg as tpcg

from test_torch_residuals_gn import _problems, close
from test_torch_threads import one_torch_thread  # noqa: F401


def _lm_scales(jb, radius=1e4):
    """The first LM iteration's jacobi scaling and damping (lm.py)."""
    diag_n = np.asarray(jb.D)[0::7]
    diag_s = np.asarray(jb.ds)
    out = []
    for d in (diag_n, diag_s):
        s = 1.0 / (1.0 + np.sqrt(np.maximum(d, 0)))
        out.append((s, np.clip(d * s * s, 1e-6, 1e32) / radius))
    (sn, ln), (ss, ls) = out
    return sn, ss, ln, ls


@pytest.fixture(scope="module")
def reduced():
    """A scaled, damped, switch-eliminated system from both packages."""
    jp, tp = _problems(outliers=0.3, seed=9, n=200, n_loops=40)
    jb = jgn.assemble_t(jp, jp.q, jp.t, jp.switch)
    tb = tgn.assemble_t(tp, tp.q, tp.t, tp.switch)
    sc = _lm_scales(jb)
    jr = jgn.schur_reduce_t(jb, jp, *[jnp.asarray(a) for a in sc])
    tr = tgn.schur_reduce_t(tb, tp, *[torch.from_numpy(a) for a in sc])
    return jp, tp, jr, tr


def _band_systems(reduced):
    jp, tp, jr, tr = reduced
    F = tp.fanout
    jA, jC, jn = jband.build_band_system(
        jgn.t_blocks_to_aos(jr.Dh),
        jnp.stack([jgn.t_blocks_to_aos(jr.Bh[f]) for f in range(F)]), F)
    tA, tC, tn = tband.build_band_system(
        tgn.t_blocks_to_aos(tr.Dh),
        torch.stack([tgn.t_blocks_to_aos(tr.Bh[f]) for f in range(F)]), F)
    return (jA, jC, jn), (tA, tC, tn)


def test_build_band_system_matches_reference(reduced):
    (jA, jC, jn), (tA, tC, tn) = _band_systems(reduced)
    assert tn == jn
    close(tA, jA)
    close(tC, jC)


@pytest.mark.parametrize("levels", [2, None])
def test_bcr_factorize_and_apply_match_reference(reduced, levels, rng):
    (jA, jC, _), (tA, tC, _) = _band_systems(reduced)
    F = reduced[1].fanout
    jf = jband.bcr_factorize(jA, jC, group=F, max_levels=levels)
    tf = tband.bcr_factorize(tA, tC, group=F, max_levels=levels)
    assert len(tf.levels) == len(jf.levels) and tf.n_pad == jf.n_pad
    for tl, jl in zip(tf.levels, jf.levels):
        for a, b in zip(tl, jl):
            close(a, b)
    close(tf.root_inv, jf.root_inv)
    r = rng.normal(size=(reduced[1].n_cap, 6))
    close(tband.band_precond_apply(tf, torch.from_numpy(r)),
          jband.band_precond_apply(jf, jnp.asarray(r)))


@pytest.mark.parametrize("group", [16, 64])
def test_coarse_inverse_and_apply_match_reference(reduced, group, rng):
    jp, tp, jr, tr = reduced
    jH = jcoarse.build_coarse_inverse(jr, jp, group)
    tH = tcoarse.build_coarse_inverse(tr, tp, group)
    close(tH, jH, rtol=1e-9)
    r = rng.normal(size=(6, tp.n_cap))
    close(tcoarse.coarse_apply(tH, tp.free_mask, torch.from_numpy(r), group),
          jcoarse.coarse_apply(jH, jp.free_mask, jnp.asarray(r), group),
          rtol=1e-9)


def test_auto_coarse_group_copies_match_reference():
    b = np.array([10, 200, 300, 5, 7])
    a = np.array([0, 100, 310, 60, 9])
    m = np.array([1, 1, 0, 1, 1.0])
    assert (tcoarse.median_loop_offset(b, a, m)
            == jcoarse.median_loop_offset(b, a, m))
    assert tcoarse.median_loop_offset(b[:0], a[:0]) is None
    for n_cap in (512, 8192, 32768, 65536):
        for med in (None, 3.0, 40.0, 2500.0):
            assert (tcoarse.auto_coarse_group(n_cap, med)
                    == jcoarse.auto_coarse_group(n_cap, med))


@pytest.mark.parametrize("q_tol", [0.0, 0.01])
def test_pcg_nodes_matches_reference(reduced, q_tol):
    """Same preconditioned system through both PCGs: equal iteration count,
    x and final r (the port runs its cap with a done mask)."""
    jp, tp, jr, tr = reduced
    (jA, jC, _), (tA, tC, _) = _band_systems(reduced)
    F = tp.fanout
    jf = jband.bcr_factorize(jA, jC, group=F, max_levels=2)
    tf = tband.bcr_factorize(tA, tC, group=F, max_levels=2)
    jsol = jpcg.pcg_nodes(
        lambda p: jgn.reduced_matvec_t(jr, jp, p),
        lambda r: jband.band_precond_apply(jf, r.T).T, jr.rhs_n,
        max_iterations=80, r_tolerance=5e-4, q_tolerance=q_tol)
    tsol = tpcg.pcg_nodes(
        lambda p: tgn.reduced_matvec_t(tr, tp, p),
        lambda r: tband.band_precond_apply(tf, r.T).T.contiguous(),
        tr.rhs_n, max_iterations=80, r_tolerance=5e-4, q_tolerance=q_tol)
    assert int(tsol.iterations) == int(jsol.iterations)
    assert 1 < int(tsol.iterations) < 80
    close(tsol.x, jsol.x, rtol=1e-9)
    close(tsol.r, jsol.r, rtol=1e-8)
    np.testing.assert_allclose(float(tsol.rel_residual),
                               float(jsol.rel_residual), rtol=1e-6)
