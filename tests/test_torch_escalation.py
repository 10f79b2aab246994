"""PyTorch port: the fp64 escalation ladder against the JAX package.

The same numpy-seeded problems go through the reference's and the port's
host fp64 rung (exact steps: chi^2 to 1e-9 relative, poses to 1e-8) and
device fp64 rung (with exact CG forcing: chi^2 to 1e-9, poses to 1e-8; at
the rung's own forcing chi^2 to 1e-6). The reference's device ladder runs
its mixed-precision rung first, which the port does not carry; with
escalation forced it then lands on fp64_resolve, which is what the port's
device rung is held against."""

import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu.graph import synthetic
from solve_keyframe_pose_graph_tpu.ops import lm as jlm
from solve_keyframe_pose_graph_tpu.solver import cpu_rung as jrung
from solve_keyframe_pose_graph_tpu.solver import problem as jprob
from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
from solve_keyframe_pose_graph_tpu_torch.solver import cpu_rung as trung
from solve_keyframe_pose_graph_tpu_torch.solver import problem as tprob

from test_torch_threads import one_torch_thread  # noqa: F401

LM_KW = dict(max_iterations=10, preconditioner="band+coarse",
             coarse_group=16, max_cg_iterations=45, cg_tolerance=1e-2)


def _inputs(n=96, loops=12, n_cap=None, e_cap=None, seed=3):
    g = synthetic.circle_graph(n_nodes=n, n_loops=loops, seed=seed,
                               outlier_fraction=0.2)
    return dict(
        q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
        node_valid=np.ones(n, bool), loop_pairs=g.loop_pairs,
        loop_q=g.loop_q, loop_t=g.loop_t, loop_w=g.loop_w,
        loop_valid=np.ones(loops, bool), switch=np.full(loops, 0.99),
        prior_idx=np.array([0]), prior_q=g.vio_q[:1], prior_t=g.vio_t[:1],
        prior_w=np.array([1.1]), n_cap=n_cap or n, e_cap=e_cap or loops,
        p_cap=4)


@pytest.fixture(scope="module")
def rungs_ready():
    if not (jrung.available() and trung.available()):
        pytest.skip("host fp64 rung unavailable (libkpg_ldl.so / scipy)")


def _scale(a):
    return max(float(np.abs(a).max()), 1.0)


def test_available_gates_residual_family(rungs_ready):
    assert trung.available(dict(residual_mode="6dof", use_switch=True))
    assert not trung.available(dict(residual_mode="4dof"))
    assert not trung.available(dict(use_switch=False))


def test_lm_solve_native_matches_reference(rungs_ready):
    kw = _inputs()
    ref = jrung.lm_solve_native(
        jrung._host_problem64(jprob.build_problem_np(dtype=np.float64,
                                                     **kw)), LM_KW)
    got = trung.lm_solve_native(
        trung.host_problem64(tprob.build_problem_np(dtype=np.float64, **kw)),
        LM_KW)
    for name in ("iterations", "successful_steps", "distress_rejects",
                 "converged"):
        assert int(getattr(got, name)) == int(getattr(ref, name)), name
    for name in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=1e-9)
    assert float(got.final_cost) < float(got.initial_cost)
    for name in ("q", "t", "switch"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), r, rtol=0,
                                   atol=1e-8 * _scale(r), err_msg=name)


def test_lm_solve_native_rejects_device_or_fp32_problem(rungs_ready):
    p32 = tprob.build_problem_np(dtype=np.float32, **_inputs())
    with pytest.raises(ValueError, match="CPU float64"):
        trung.lm_solve_native(p32, LM_KW)


@pytest.mark.parametrize("backend", ["auto", "cpu"])
def test_escalate_resolve_host_rung_matches_reference(rungs_ready, backend):
    """The host rung from an oversized fp32 bucket: repacked to the live
    lengths, padded back to the caller's capacities, same answer as the
    reference's host rung."""
    kw = _inputs(n=80, loops=10, n_cap=2048, e_cap=256)
    ref, ref_rung = jlm.escalate_resolve(
        jprob.build_problem_np(dtype=np.float32, **kw), LM_KW, 0,
        fp64_backend="cpu")
    prob = tprob.build_problem_np(dtype=np.float32, **kw)
    got, rung, stats = tlm.escalate_resolve(prob, LM_KW, 0,
                                            fp64_backend=backend)
    assert rung == ref_rung == "fp64-cpu"
    assert (stats["n_cap"], stats["e_cap"]) == (80, 10)
    assert stats["total_s"] >= stats["fetch_s"] >= 0
    assert tuple(got.q.shape) == (2048, 4) and tuple(got.switch.shape) == (256,)
    np.testing.assert_array_equal(got.q[80:].numpy(),
                                  prob.q[80:].double().numpy())
    np.testing.assert_allclose(float(got.final_cost), float(ref.final_cost),
                               rtol=1e-9)
    for name in ("q", "t", "switch"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), r, rtol=0,
                                   atol=1e-8 * _scale(r), err_msg=name)


def test_escalate_resolve_device_rung_matches_reference(monkeypatch):
    """fp64_backend="tpu" is the device rung in the port: lm_solve in fp64
    on the problem's device, repacked as the reference repacks (1024-
    multiples covering the live lengths), near-exact CG. Held against the
    reference's fp64_resolve on a problem that fits one 1024 block, so
    neither repacks: with exact forcing (1e-12) the steps, chi^2 (1e-9) and
    poses (1e-8) agree; at the rung's own forcing, which it must clamp to
    1e-5 with a 100-iteration cap, chi^2 is held to 1e-6. The port's repack
    and padding are then checked from a larger bucket."""
    kw = _inputs(n=48, loops=8)
    exact = dict(LM_KW, cg_tolerance=1e-12)
    ref = jlm.fp64_resolve(
        jprob.build_problem_np(dtype=np.float32, **kw),
        dict(exact, loop_impl="scatter", band_impl="aos"))
    seen = []
    solve = tlm.lm_solve

    def spy(problem, **lm_kw):
        seen.append(lm_kw)
        return solve(problem, **lm_kw)

    monkeypatch.setattr(tlm, "lm_solve", spy)
    runs = []
    for lm_kw in (LM_KW, exact):
        got, rung, stats = tlm.escalate_resolve(
            tprob.build_problem_np(dtype=np.float32, **kw), lm_kw, 0,
            fp64_backend="tpu")
        assert rung == "fp64" and stats["total_s"] > 0
        assert got.q.dtype == torch.float64
        runs.append(got)
    assert (seen[0]["cg_tolerance"], seen[0]["max_cg_iterations"]) == \
        (1e-5, 100)
    assert seen[1]["cg_tolerance"] == 1e-12
    forced, got = runs
    assert int(got.successful_steps) == int(ref.successful_steps)
    np.testing.assert_allclose(float(got.final_cost), float(ref.final_cost),
                               rtol=1e-9)
    np.testing.assert_allclose(float(forced.final_cost),
                               float(ref.final_cost), rtol=1e-6)
    for name in ("q", "t", "switch"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), r, rtol=0,
                                   atol=1e-8 * _scale(r), err_msg=name)

    short = dict(LM_KW, max_iterations=1)
    big = tprob.build_problem_np(dtype=np.float32,
                                 **dict(kw, n_cap=2048, e_cap=32))
    padded = tlm.fp64_resolve(big, short)
    assert tuple(padded.q.shape) == (2048, 4)
    assert tuple(padded.switch.shape) == (32,)
    np.testing.assert_array_equal(padded.t[1024:].numpy(),
                                  big.t[1024:].double().numpy())
    block = tlm.fp64_resolve(tprob.build_problem_np(
        dtype=np.float32, **dict(kw, n_cap=1024, e_cap=32)), short)
    for name in ("q", "t", "switch"):
        alone = getattr(block, name)
        np.testing.assert_array_equal(
            getattr(padded, name)[:alone.shape[0]].numpy(), alone.numpy(),
            err_msg=name)


def test_lm_solve_adaptive_escalates_only_on_distress(rungs_ready):
    prob = tprob.build_problem_np(dtype=np.float32, **_inputs())
    res, escalated = tlm.lm_solve_adaptive(prob, escalate_rejects=0,
                                           **LM_KW)
    assert escalated == "fp64-cpu" and res.q.dtype == torch.float64
    # a healthy fp32 solve of this graph does not escalate at the product
    # threshold, and an fp64 problem never does
    _, escalated = tlm.lm_solve_adaptive(prob, escalate_rejects=3, **LM_KW)
    assert escalated is False
    p64 = tprob.problem_astype(prob, torch.float64)
    assert tlm.lm_solve_adaptive(p64, escalate_rejects=0,
                                 **LM_KW)[1] is False


def test_escalate_resolve_policy_errors(monkeypatch):
    prob = tprob.build_problem_np(dtype=np.float32, **_inputs())
    with pytest.raises(ValueError, match="fp64_backend"):
        tlm.escalate_resolve(prob, LM_KW, 0, fp64_backend="gpu")
    monkeypatch.setattr(trung, "available", lambda lm_kw=None: False)
    with pytest.raises(RuntimeError, match="unavailable"):
        tlm.escalate_resolve(prob, LM_KW, 0, fp64_backend="cpu")


def test_host_rung_failure_is_logged_then_device_rung(monkeypatch, caplog):
    """Unlike the reference (lm.py:939), "auto" does not swallow a host-rung
    failure: it is logged at WARNING before the device rung runs."""
    prob = tprob.build_problem_np(dtype=np.float32, **_inputs(n=40, loops=6))
    monkeypatch.setattr(trung, "available", lambda lm_kw=None: True)

    def boom(*a, **k):
        raise RuntimeError("factorization exploded")

    monkeypatch.setattr(trung, "cpu_fp64_resolve", boom)
    kw = dict(LM_KW, max_iterations=2)
    with caplog.at_level("WARNING"):
        _, rung, _ = tlm.escalate_resolve(prob, kw, 0, fp64_backend="auto")
    assert rung == "fp64"
    assert any("host fp64 rung failed" in r.message and r.exc_info
               for r in caplog.records)
    with pytest.raises(RuntimeError, match="exploded"):
        tlm.escalate_resolve(prob, kw, 0, fp64_backend="cpu")


def test_solve_problem_follows_config(rungs_ready):
    from solve_keyframe_pose_graph_tpu.config import SolverConfig

    prob = tprob.build_problem_np(dtype=np.float32, **_inputs())
    cfg = SolverConfig(escalate_rejects=0, preconditioner="band")
    res, escalated = tlm.solve_problem_adaptive(prob, cfg)
    assert escalated == "fp64-cpu"
    plain = tlm.solve_problem(prob, SolverConfig(adaptive_fp64=False,
                                                 preconditioner="band"))
    assert plain.q.dtype == torch.float32
    assert float(res.final_cost) <= float(plain.final_cost) * (1 + 1e-3)
