"""PyTorch port: whole LM solves against the JAX package at fp64 on the CPU.

The JAX side runs loop_impl="scatter", band_impl="aos" (on the CPU its band
matvec is the XLA form): the same formulation as the port. At fp64 accept /
reject decisions do not flip, so iteration, accepted-step and CG counts must
be equal and chi^2 within 1e-6 relative; the solution within 1e-6 of its
scale."""

import dataclasses

import numpy as np
import pytest

from solve_keyframe_pose_graph_tpu import config as jconfig
from solve_keyframe_pose_graph_tpu.ops import lm as jlm
from solve_keyframe_pose_graph_tpu_torch import config as tconfig
from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, problem_from_arrays,
)

from test_lm_solver import build_circle_problem
from test_torch_threads import one_torch_thread  # noqa: F401

PRODUCT = dict(max_iterations=10, bcr_levels=2, max_cg_iterations=45)


@pytest.mark.parametrize("preconditioner,outliers", [
    ("band+coarse", 0.0), ("band+coarse", 0.3), ("band", 0.0),
    ("band", 0.3), ("jacobi", 0.3)])
def test_lm_solve_matches_reference(preconditioner, outliers):
    g, jp = build_circle_problem(n=300, n_loops=40,
                                 outlier_fraction=outliers)
    tp = problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")
    kw = dict(PRODUCT, preconditioner=preconditioner)
    ref = jlm.lm_solve(jp, loop_impl="scatter", band_impl="aos", **kw)
    got = tlm.lm_solve(tp, **kw)

    for name in ("iterations", "successful_steps", "total_cg_iterations",
                 "distress_rejects", "converged"):
        assert int(getattr(got, name)) == int(getattr(ref, name)), name
    for name in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=1e-6)
    assert float(got.final_cost) < 0.05 * float(got.initial_cost)
    for name in ("q", "t", "switch"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())
    if outliers:
        sw = got.switch.numpy()[: g.n_loops]
        assert sw[g.loop_is_outlier].mean() < sw[~g.loop_is_outlier].mean()


def test_lm_solve_without_switches_matches_reference():
    _, jp = build_circle_problem(n=200, n_loops=30, seed=5)
    tp = problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")
    kw = dict(PRODUCT, preconditioner="band+coarse", use_switch=False)
    ref = jlm.lm_solve(jp, loop_impl="scatter", band_impl="aos", **kw)
    got = tlm.lm_solve(tp, **kw)
    assert int(got.iterations) == int(ref.iterations)
    assert int(got.total_cg_iterations) == int(ref.total_cg_iterations)
    np.testing.assert_allclose(float(got.final_cost), float(ref.final_cost),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.switch.numpy(), np.asarray(ref.switch))


def test_lm_solve_rejects_unported_options():
    """An unknown precision is refused, naming the allowed ones (the
    reference treats any value but "mixed" as "native")."""
    _, jp = build_circle_problem(n=64, n_loops=4)
    tp = problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")
    for bad in (dict(precision="double"), dict(precision="fp32")):
        with pytest.raises(ValueError, match="'native', 'mixed'"):
            tlm.lm_solve(tp, **bad)


def test_cfg_lm_kwargs_and_needs_escalation_match_reference():
    cfg = tconfig.SolverConfig()
    ref = jlm.cfg_lm_kwargs(jconfig.SolverConfig())
    got = tlm.cfg_lm_kwargs(cfg)
    dropped = {"loop_impl", "band_impl", "tile_k"}
    assert set(ref) - set(got) == dropped
    assert {k: ref[k] for k in got} == got
    cfg2 = dataclasses.replace(cfg, preconditioner="band", coarse_group=32)
    assert tlm.cfg_lm_kwargs(cfg2, use_switch=False)["use_switch"] is False
    assert tlm.cfg_lm_kwargs(cfg2)["coarse_group"] == 32

    _, jp = build_circle_problem(n=64, n_loops=4)
    tp = problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")
    res = tlm.lm_solve(tp, max_iterations=2)
    for k in (0, 1, 3):
        for conv, rejects in ((True, 5), (False, 5), (False, 0)):
            r = res._replace(converged=np.bool_(conv),
                             distress_rejects=np.int32(rejects))
            assert tlm.needs_escalation(r, k) == jlm.needs_escalation(r, k)
