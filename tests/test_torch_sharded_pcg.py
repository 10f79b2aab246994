"""PyTorch port: parallel/sharded_pcg.pcg_sharded against the JAX
package's pcg_sharded, on tests/test_sharded_pcg.py's reduced system built
through both packages in fp64, on 8 CPU shards (the JAX side on its
8-device CPU mesh), with and without the coarse level.

The two must agree with each other to 1e-9 of the solution's scale at 100
iterations, and the port's must meet the JAX test's own checks at its 400
iterations: the solution's relative residual in the single-device reduced
matvec below 1e-4 and, band-only, the single-device PCG solution within
5e-3 (tests/test_sharded_pcg.py holds the JAX one to them). Past ~150 iterations CG on this system has lost orthogonality
and two fp64 runs whose sums differ only in order drift apart (1e-5 at 400
iterations), whichever package runs them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from solve_keyframe_pose_graph_tpu.ops import gn as jgn
from solve_keyframe_pose_graph_tpu.parallel import make_mesh as jax_mesh
from solve_keyframe_pose_graph_tpu.parallel.sharded_pcg import (
    pcg_sharded as jax_pcg_sharded,
)
from solve_keyframe_pose_graph_tpu_torch.ops import band as band_ops
from solve_keyframe_pose_graph_tpu_torch.ops import gn as tgn
from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
from solve_keyframe_pose_graph_tpu_torch.ops import pcg as tpcg
from solve_keyframe_pose_graph_tpu_torch.parallel import make_mesh
from solve_keyframe_pose_graph_tpu_torch.parallel.sharded_pcg import (
    pcg_sharded,
)
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, problem_from_arrays,
)

from test_torch_threads import one_torch_thread  # noqa: F401


def _systems():
    """test_sharded_pcg._reduced_system's inputs in fp64, reduced by each
    package: (jax problem, jax system, port problem, port system)."""
    jp = ge._make_problem(n_nodes=256, n_loops=32, n_cap=256, e_cap=32,
                          dtype=np.float64)
    blocks = jgn.assemble_t(jp, jp.q, jp.t, jp.switch)
    diag_n = blocks.D[jnp.arange(0, 36, 7)]
    scale_n = 1.0 / (1.0 + jnp.sqrt(jnp.maximum(diag_n, 0)))
    scale_s = 1.0 / (1.0 + jnp.sqrt(jnp.maximum(blocks.ds, 0)))
    lm_n = jnp.clip(diag_n * scale_n**2, 1e-6, 1e32) / 1e4
    lm_s = jnp.clip(blocks.ds * scale_s**2, 1e-6, 1e32) / 1e4
    jred = jgn.schur_reduce_t(blocks, jp, scale_n, scale_s, lm_n, lm_s)

    tp = problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")
    tb = tgn.assemble_t(tp, tp.q, tp.t, tp.switch)
    sc = tlm.jacobi_scales(tb.D, tb.ds, torch.tensor(1e4, dtype=tp.dtype))
    tred = tgn.schur_reduce_t(tb, tp, *sc)
    np.testing.assert_allclose(tred.Dh.numpy(), np.asarray(jred.Dh),
                               rtol=0, atol=1e-12)
    return jp, jred, tp, tred


@pytest.mark.parametrize("coarse_group", [0, 8])
def test_pcg_sharded_matches_the_jax_one(coarse_group):
    jp, jred, tp, tred = _systems()
    free = coarse_group > 0
    kw = dict(r_tolerance=1e-8, fanout=5, coarse_group=coarse_group)
    xj = np.asarray(jax_pcg_sharded(
        jred.Dh, jred.Bh, jred.Aba_h, jp.loop_b, jp.loop_a, jred.rhs_n,
        mesh=jax_mesh(8), free_mask=jp.free_mask if free else None,
        max_iterations=100, **kw))

    def port(max_iterations):
        return pcg_sharded(
            tred.Dh, tred.Bh, tred.Aba_h, tp.loop_b, tp.loop_a, tred.rhs_n,
            mesh=make_mesh(devices=["cpu"] * 8),
            free_mask=tp.free_mask if free else None,
            max_iterations=max_iterations, **kw)

    np.testing.assert_allclose(port(100).numpy(), xj, rtol=0,
                               atol=1e-9 * np.abs(xj).max())

    # the JAX test's own checks (its pcg_sharded meets them there)
    x = port(400)
    rhs = tred.rhs_n
    resid = tgn.reduced_matvec_t(tred, tp, x) - rhs
    assert float(resid.norm() / rhs.norm()) < 1e-4
    if not coarse_group:
        fac = tlm.band_factor(tred.Dh, tred.Bh, None)
        sol = tpcg.pcg_nodes(
            lambda p: tgn.reduced_matvec_t(tred, tp, p),
            lambda r: band_ops.band_precond_apply(fac, r.T).T.contiguous(),
            rhs, max_iterations=400, r_tolerance=1e-8, q_tolerance=0.0)
        np.testing.assert_allclose(x.numpy(), sol.x.numpy(), atol=5e-3)


def test_coarse_group_must_divide_the_shard_width():
    _, _, tp, tred = _systems()
    with pytest.raises(ValueError, match="coarse_group must divide"):
        pcg_sharded(tred.Dh, tred.Bh, tred.Aba_h, tp.loop_b, tp.loop_a,
                    tred.rhs_n, mesh=make_mesh(devices=["cpu"] * 8),
                    coarse_group=24)
