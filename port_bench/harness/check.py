"""The comparison that decides `correct`.

What is judged: the answers of the served solver loop. A run draws
`reference.answers` times in the window from its seed; the first solve
that the solver thread calls after each is judged, and with
`reference.judge_first` the session's first solve as well. An answer is
the trajectory and switch weights that the trigger wrote back (the
engine's last_result); where the trigger's fp32 solve showed distress and
the engine re-solved it up the escalation ladder in the background, the
re-solve's, which the engine writes back in its place.

The plain reference (port_bench/reference/posegraph.py) works out the
trigger's graph from the generated stream itself: the first node_len
keyframes and the first edge_len loop edges in stream order, the odometry
from the VIO poses, the prior's weight. It works out the trigger's start
itself too (posegraph.start): for the first solve, the VIO poses and the
initial switches; for a later one, the result that the solve before it
wrote back, each newer node chained by odometry from the newest solved
one, each newer edge at the initial switch. That previous result is the
one thing it takes from the program: where the stream's earlier solves
left the trajectory, which it could only follow step by step. From that
start it runs the configuration's Levenberg-Marquardt with exact steps in
float64. So the comparison covers the trigger's initial guesses for new
nodes and switches, its prior, the problem build, the captured LM with
PCG, the preconditioner, K1 and K2, and the write-back; it does not cover
the world mapping of kidnapped sessions, which a one-world stream never
exercises. Both answers are evaluated by the reference's float64 cost.

Numbers compared, each against its limit in the configuration's file:
  chi2_gap      the largest, over the judged answers of the window, of
                the program's cost over the reference's, less 1;
  first_gap     for the session's first solve, the program's cost less
                the reference's, over the cost of the start: the share of
                the start's cost that the program left beyond the
                reference. Ten steps from the VIO poses take both costs to
                about 1e-9 of the start's, where float32 rounding, not the
                solve, sets their ratio, so chi2_gap cannot judge it.
Numbers printed beside them, not compared (PERF.md says why):
  pose_gap_m    the largest distance between a node's position in the
                two answers;
  switch_flips  the edges whose switch is above 0.5 in one answer and not
                in the other.
"""

from __future__ import annotations

import time

import numpy as np

from port_bench.harness import generators
from port_bench.reference import posegraph


def reference_problem(cfg: dict, g, n: int, e: int, prior=None,
                      precision: str = "fp64") -> posegraph.Problem:
    fml = cfg["formulation"]
    order = generators.stream_order(g)[:e]
    return posegraph.build_problem(
        g.vio_q[:n], g.vio_t[:n], g.loop_pairs[order, 0],
        g.loop_pairs[order, 1], g.loop_q[order], g.loop_t[order],
        fanout=fml["fanout"], decay=fml["decay"],
        yaw_sigma2=fml["yaw_sigma2"], prior=prior,
        rounding=posegraph.ROUNDING[precision])


def reference_solve(cfg: dict, p: posegraph.Problem, q0, t0, s0,
                    precision: str = "fp64") -> posegraph.Solution:
    lm = cfg["formulation"]["lm"]
    return posegraph.solve(
        p, q0, t0, s0, max_iterations=lm["max_iterations"],
        function_tolerance=lm["function_tolerance"],
        parameter_tolerance=lm["parameter_tolerance"],
        initial_radius=lm["initial_radius"], precision=precision)


def numbers(p: posegraph.Problem, ref: posegraph.Solution, q, t, s,
            start_cost: float) -> dict:
    c = posegraph.cost(p, q, t, s)
    return {
        "chi2_gap": c / ref.cost - 1.0,
        "start_gap": (c - ref.cost) / start_cost,
        "pose_gap_m": float(np.max(np.linalg.norm(
            np.asarray(t) - ref.t, axis=-1))),
        "switch_flips": int(np.sum((np.asarray(s) > 0.5) != (ref.s > 0.5))),
        "chi2": c, "chi2_reference": ref.cost,
        "reference_iterations": ref.iterations,
    }


def step(cfg: dict, g, answer: dict, precision: str = "fp64") -> dict:
    """The reference's solve from the start it works out for the answer's
    trigger (in `precision`), and the numbers of the program's answer
    against it; with precision "tf32", those of the reference's own TF32
    answer against the float64 one (the control)."""
    n, e = answer["node_len"], answer["edge_len"]
    q0, t0, s0 = posegraph.start(g.vio_q, g.vio_t, n, e, answer["prev"],
                                 cfg["formulation"]["switch_init"])
    prior = (q0[0], t0[0])
    t = time.monotonic()
    p = reference_problem(cfg, g, n, e, prior)
    start_cost = posegraph.cost(p, q0, t0, s0)
    ref = reference_solve(cfg, p, q0, t0, s0)
    if precision == "fp64":
        out = numbers(p, ref, *answer["res"], start_cost)
    else:
        p_low = reference_problem(cfg, g, n, e, prior, precision)
        low = reference_solve(cfg, p_low, q0, t0, s0, precision)
        out = numbers(p, ref, low.q, low.t, low.s, start_cost)
    out.update(node_len=n, edge_len=e, first=answer["first"],
               reference_s=time.monotonic() - t, start_chi2=start_cost)
    return out


def judged(cfg: dict, rec: dict) -> list:
    """The answers the comparison judges."""
    first = bool(cfg["reference"].get("judge_first"))
    return [a for a in rec["answers"] if first or not a["first"]]


def compare(cfg: dict, rec: dict) -> dict:
    """The judged answers' numbers, each number the largest over them."""
    per = [dict(step(cfg, rec["graph"], a), escalated=a["escalated"])
           for a in judged(cfg, rec)]
    out = {"answers": len(per), "per_answer": per}
    later = [x for x in per if not x["first"]]
    for k in ("chi2_gap", "pose_gap_m", "switch_flips"):
        out[k] = max((x[k] for x in later), default=None)
    out["first_gap"] = max((x["start_gap"] for x in per if x["first"]),
                           default=None)
    return out


def verdict(cfg: dict, nums: dict) -> dict:
    """{name: (value, limit, within)} of the numbers compared; a number
    that no answer gave is not within."""
    return {k: (nums[k], lim, nums[k] is not None and bool(nums[k] <= lim))
            for k, lim in cfg["limits"].items()}
