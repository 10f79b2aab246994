"""The comparison that decides `correct`.

What is judged: the answers of the served solver loop. A run draws
`reference.answers` times in the window from its seed; the first solve
that the solver thread calls after each is judged, and with
`reference.judge_first` the session's first solve as well. An answer is
the trajectory and switch weights that the trigger wrote back (the
engine's last_result); where the trigger's fp32 solve showed distress and
the engine re-solved it up the escalation ladder in the background, the
re-solve's, which the engine writes back in its place.

The plain reference is the Python file that the configuration's
reference.file names, relative to the checkout's root. It imports nothing
of the program. check.py asks it, for each judged answer, through four
functions, where `g` is the run's graph (generators.Graph: its stream, its
events and which loop edges it counts) and `answer` the judged answer
(node_len, edge_len, first, and prev: (q, t, s) that the solve before it
wrote back, None for the session's first):

  trigger_start(cfg, g, answer) -> (q, t, s)
      the state the answer's trigger starts from, worked out by the
      reference;
  trigger_problem(cfg, g, n, e, start, precision) -> problem
      the trigger's problem over the stream's first n keyframes and first
      e loop edges, anchored as the start says; precision "fp64", or
      "tf32" for the control (every input rounded to TF32);
  trigger_solve(cfg, problem, start, precision) -> solution
      the configuration's solve from the start; the solution has q, t, s,
      cost and iterations;
  cost(problem, q, t, s) -> float
      the problem's cost at a state, in float64.

reference/posegraph.py serves one world: it works out the trigger's graph
from the generated stream itself (the first node_len keyframes and the
first edge_len loop edges in stream order, the odometry from the VIO
poses, the prior's weight) and the trigger's start (posegraph.start): for
the first solve, the VIO poses and the initial switches; for a later one,
the result that the solve before it wrote back, each newer node chained by
odometry from the newest solved one, each newer edge at the initial
switch. That previous result is the one thing it takes from the program:
where the stream's earlier solves left the trajectory, which it could only
follow step by step. From that start it runs the configuration's
Levenberg-Marquardt with exact steps in float64. So the comparison covers
the trigger's initial guesses for new nodes and switches, its prior, the
problem build, the captured LM with PCG, the preconditioner, K1 and K2,
and the write-back; it does not cover the world mapping of kidnapped
sessions, which it refuses (a graph with events). Both answers are
evaluated by the reference's float64 cost.

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

import os
import time

import numpy as np

from port_bench.harness import manifest


def reference(cfg: dict, root: str = manifest.ROOT):
    """The configuration's reference module, from its reference.file."""
    return manifest.module(os.path.join(root, cfg["reference"]["file"]))


def numbers(ref_mod, p, ref, q, t, s, start_cost: float) -> dict:
    c = ref_mod.cost(p, q, t, s)
    return {
        "chi2_gap": c / ref.cost - 1.0,
        "start_gap": (c - ref.cost) / start_cost,
        "pose_gap_m": float(np.max(np.linalg.norm(
            np.asarray(t) - ref.t, axis=-1))),
        "switch_flips": int(np.sum((np.asarray(s) > 0.5) != (ref.s > 0.5))),
        "chi2": c, "chi2_reference": ref.cost,
        "reference_iterations": ref.iterations,
    }


def step(cfg: dict, ref_mod, g, answer: dict,
         precision: str = "fp64") -> dict:
    """The reference's solve from the start it works out for the answer's
    trigger, and the numbers of the program's answer against it; with
    precision "tf32", those of the reference's own TF32 answer from the
    same start against the float64 one (the control)."""
    n, e = answer["node_len"], answer["edge_len"]
    start = ref_mod.trigger_start(cfg, g, answer)
    t = time.monotonic()
    p = ref_mod.trigger_problem(cfg, g, n, e, start, "fp64")
    start_cost = ref_mod.cost(p, *start)
    ref = ref_mod.trigger_solve(cfg, p, start, "fp64")
    if precision == "fp64":
        out = numbers(ref_mod, p, ref, *answer["res"], start_cost)
    else:
        p_low = ref_mod.trigger_problem(cfg, g, n, e, start, precision)
        low = ref_mod.trigger_solve(cfg, p_low, start, precision)
        out = numbers(ref_mod, p, ref, low.q, low.t, low.s, start_cost)
    out.update(node_len=n, edge_len=e, first=answer["first"],
               reference_s=time.monotonic() - t, start_chi2=start_cost)
    return out


def judged(cfg: dict, rec: dict) -> list:
    """The answers the comparison judges."""
    first = bool(cfg["reference"].get("judge_first"))
    return [a for a in rec["answers"] if first or not a["first"]]


def compare(cfg: dict, rec: dict, ref_mod) -> dict:
    """The judged answers' numbers, each number the largest over them, by
    the configuration's reference module (reference(cfg, root))."""
    per = [dict(step(cfg, ref_mod, rec["graph"], a), escalated=a["escalated"])
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
