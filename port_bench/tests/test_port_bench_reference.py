"""The plain reference against the program's eager CPU path at a tiny
size, its TF32 rounding, and that it imports nothing of the program."""

from __future__ import annotations

import ast
import glob
import math
import os

import numpy as np
import pytest

from conftest import ROOT
from port_bench.harness import generators
from port_bench.reference import posegraph

N, E = 300, 500
# the product's LM settings (its Config().solver)
LM = dict(max_iterations=10, function_tolerance=1e-6,
          parameter_tolerance=1e-8, initial_radius=1e4)


def _graph():
    return generators.generate({"generator": "circle_graph",
                                "args": {"n_nodes": N, "n_loops": E}},
                               2_718_281_828_459)


def _program_problem(g, q, t, s):
    from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
        build_problem_np)
    return build_problem_np(
        q=q, t=t, vio_q=g.vio_q, vio_t=g.vio_t, node_valid=np.ones(N, bool),
        loop_pairs=g.loop_pairs, loop_q=g.loop_q, loop_t=g.loop_t,
        loop_w=g.loop_w, loop_valid=np.ones(E, bool), switch=s,
        prior_idx=np.array([0]), prior_q=g.vio_q[:1], prior_t=g.vio_t[:1],
        prior_w=np.array([max(1.1, math.log(N) / 2)]), n_cap=512, e_cap=512,
        p_cap=1, dtype=np.float64, device="cpu")


def _reference_problem(g):
    return posegraph.build_problem(
        g.vio_q, g.vio_t, g.loop_pairs[:, 0], g.loop_pairs[:, 1], g.loop_q,
        g.loop_t, fanout=5, decay=0.9, yaw_sigma2=6.0)


def test_cost_is_the_programs():
    from solve_keyframe_pose_graph_tpu_torch.ops import gn
    g = _graph()
    rng = np.random.default_rng(5)
    q = posegraph.nse3.quat_normalize(
        g.vio_q + rng.normal(scale=0.01, size=g.vio_q.shape))
    t = g.vio_t + rng.normal(scale=0.05, size=g.vio_t.shape)
    s = rng.uniform(0.2, 1.0, E)
    prob = _program_problem(g, q, t, s)
    want = float(gn.evaluate_cost(prob, prob.q, prob.t, prob.switch))
    got = posegraph.cost(_reference_problem(g), q, t, s)
    assert got == pytest.approx(want, rel=1e-12)


def test_solve_lands_with_the_programs_eager_solve():
    """From the VIO poses, ten LM iterations each: the reference's exact
    steps and the program's truncated PCG steps (fp64, CPU) land on costs
    within 5% of each other (2.9% on this 300-node graph), both a thousand
    times below the start."""
    from solve_keyframe_pose_graph_tpu_torch.ops.lm import lm_solve
    g = _graph()
    s0 = np.full(E, 0.99)
    prob = _program_problem(g, g.vio_q, g.vio_t, s0)
    res = lm_solve(prob, max_iterations=10, max_cg_iterations=45,
                   cg_tolerance=1e-2, preconditioner="band+coarse",
                   bcr_levels=2)
    p = _reference_problem(g)
    ref = posegraph.solve(p, g.vio_q, g.vio_t, s0, **LM)
    start = posegraph.cost(p, g.vio_q, g.vio_t, s0)
    prog = posegraph.cost(p, res.q[:N].numpy(), res.t[:N].numpy(),
                          res.switch[:E].numpy())
    assert prog == pytest.approx(float(res.final_cost), rel=1e-9)
    assert prog == pytest.approx(ref.cost, rel=0.05)
    assert ref.cost < 1e-3 * start


def test_ground_truth_start_rejects_the_outliers():
    g = _graph()
    p = _reference_problem(g)
    ref = posegraph.solve(p, g.gt_q, g.gt_t, np.full(E, 0.99), **LM)
    out = g.loop_is_outlier
    assert ref.s[out].max() < 0.01 and ref.s[~out].min() > 0.9
    assert ref.accepted == ref.iterations


def test_second_node_jacobian_is_the_complex_steps():
    """The second node's Jacobians, from the rigid-motion invariance, are
    those of the complex step in that node's own tangent."""
    g = _graph()
    p = _reference_problem(g)
    rng = np.random.default_rng(0)
    q = posegraph.nse3.quat_normalize(
        g.vio_q + rng.normal(scale=0.05, size=g.vio_q.shape))
    t = g.vio_t + rng.normal(scale=0.3, size=g.vio_t.shape)
    s = rng.uniform(0.2, 1.0, E)
    lin = posegraph.linearize(p, q, t, s)

    def direct(fn, q1, t1, q2, t2, *extra):
        c1 = [q1.astype(complex), t1.astype(complex)]
        ex = [e.astype(complex) for e in extra]
        cols = []
        for k in range(6):
            a, b = posegraph._perturb(q2.astype(complex),
                                      t2.astype(complex), k)
            cols.append(fn(*c1, a, b, *ex).imag / posegraph._H)
        return np.stack(cols, -1)

    want_o = direct(lambda *a: posegraph._odo_res(p, *a), q[p.odo_i],
                    t[p.odo_i], q[p.odo_j], t[p.odo_j])
    want_l = direct(lambda *a: posegraph._loop_res(p, *a), q[p.loop_b],
                    t[p.loop_b], q[p.loop_a], t[p.loop_a], s)
    assert np.allclose(lin.Jo2, want_o, rtol=0, atol=1e-12)
    assert np.allclose(lin.Jl2, want_l, rtol=0, atol=1e-12)


def test_start_chains_new_nodes_by_odometry():
    """The start of a later solve keeps the previous result and chains
    each newer node from the newest solved one by its VIO odometry; the
    first solve starts at the VIO poses."""
    g = _graph()
    q, t, s = posegraph.start(g.vio_q, g.vio_t, 40, 30)
    assert np.allclose(q, g.vio_q[:40]) and np.allclose(t, g.vio_t[:40])
    assert np.all(s == 0.99)
    rng = np.random.default_rng(11)
    pq = posegraph.nse3.quat_normalize(
        g.vio_q[:25] + rng.normal(scale=0.05, size=(25, 4)))
    pt = g.vio_t[:25] + rng.normal(scale=0.5, size=(25, 3))
    ps = rng.uniform(0, 1, 20)
    q, t, s = posegraph.start(g.vio_q, g.vio_t, 40, 30, (pq, pt, ps))
    assert np.array_equal(q[:25], pq) and np.array_equal(t[:25], pt)
    assert np.array_equal(s[:20], ps) and np.all(s[20:] == 0.99)
    # the relative pose of each new node to the newest solved one is the
    # VIO one
    for u in (25, 31, 39):
        want = posegraph.nse3.pose_relative(g.vio_q[24], g.vio_t[24],
                                            g.vio_q[u], g.vio_t[u])
        got = posegraph.nse3.pose_relative(q[24], t[24], q[u], t[u])
        assert np.allclose(abs(np.dot(got[0], want[0])), 1.0)
        assert np.allclose(got[1], want[1])


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 20.001, -3.3e-5])
    r = posegraph.round_tf32(x)
    assert r[0] == 1.0 and r[2] == 1.0 + 2 ** -10
    assert r[1] in (1.0, 1.0 + 2 ** -10)
    assert np.all(np.abs(r - x) <= np.abs(x) * 2 ** -11)


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "port_bench", "reference",
                                       "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] in ("__future__", "dataclasses",
                                           "math", "numpy", "scipy",
                                           "port_bench"), (path, n)
                assert not n.startswith("port_bench") or n in (
                    "port_bench.harness"), (path, n)
