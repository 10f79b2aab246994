"""Quality certification of the port on every certification instance of the
repository, held to references that do not come from the port.

    python -m solve_keyframe_pose_graph_tpu_torch.certify [--device cuda]
        [--out results.json] [name ...]

The bar (`ok`) has two parts. First, the benchmark harness's problem of
each instance, built through the port and solved by its product solve
(lm_solve with the adaptive fp64 escalation, at the product defaults),
lands within 2% of BASELINE.md's fp64 exact-step reference chi^2 for that
problem (HARNESS_REF). The harness
problem is the one `benchmarks/exp_warm_robust.py` solved and
`benchmarks/cpu_reference.py --native-ldl` gave the reference for: the
`.g2o` file's odometry-integrated initial guesses, power-of-two capacities,
one soft anchor of weight 1.1 on node 0, switches at 0.99, fp32, and the
structure-aware coarse group.

Second, the port CLI's batch `solve` of the same file at the product
defaults lands within 2% of the JAX package's CLI on it (JAX_CLI). The
CLI's engine anchors the first node with weight max(1.1, log(1 + n) / 2),
4.26 at 5,000 nodes, so its problem differs from the harness's and can
settle in another minimum (bench_seed1: 1.652 against 38.81). A secondary
column gives the gap to the same port CLI with every solve re-solved inline
on the host fp64 rung (escalate_rejects=0, fp64_backend="cpu"): a
comparison of the port with itself.

Each row also carries both fp64 rungs forced on the harness problem
(`rung_ab`), the A/B behind fp64_backend="auto"'s choice of the host rung.
Prints one JSON line per instance and exits non-zero if any instance misses
the bar.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

from solve_keyframe_pose_graph_tpu.config import Config
from solve_keyframe_pose_graph_tpu.graph import g2o as g2o_io

# fp64 exact-step reference chi^2 of the benchmark harness's problem per
# instance (BASELINE.md "Robustness certification", computed by the JAX
# package's benchmarks/cpu_reference.py --native-ldl)
HARNESS_REF = {
    "bench_seed0": 0.4038, "bench_seed1": 38.81, "bench_seed2": 74.29,
    "bench_seed3": 1.6825, "bench_seed4": 7.173, "bench_seed5": 10.44,
    "bench_seed6": 457.9, "bench_seed7": 1.0225,
    "sphere2500-analog": 0.6689, "torus-analog": 5.4512,
    "manhattan3500-analog": 2.3427,
}
# final chi^2 of the JAX package's CLI on each file: `kpg-solve solve
# --input benchmarks/graphs/<name>.g2o --output out.json` at the default
# Config with JAX_PLATFORMS=cpu, on an x86-64 CPU host (bench_seed1, 2 and
# 4-7 escalated to its host fp64 rung)
JAX_CLI = {
    "bench_seed0": 0.40179261565208435, "bench_seed1": 1.6521215250723837,
    "bench_seed2": 71.41791587994936, "bench_seed3": 1.6899933815002441,
    "bench_seed4": 7.275386214451209, "bench_seed5": 10.654781356148739,
    "bench_seed6": 458.7561699466324, "bench_seed7": 1.0225027266280213,
    "sphere2500-analog": 0.6765004396438599,
    "torus-analog": 5.529951572418213,
    "manhattan3500-analog": 2.3782615661621094,
}
QUALITY = 0.02
GRAPHS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "graphs")


def harness_problem(path: str, device):
    """The benchmark harness's Problem of the .g2o file at `path` (fp32),
    built by the port as benchmarks/run_baseline.py:problem_from_inputs
    builds it, and its structure-aware coarse group."""
    from solve_keyframe_pose_graph_tpu_torch.ops import coarse
    from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
        build_problem_np,
    )

    inp = g2o_io.g2o_to_problem_inputs(g2o_io.load_g2o(path))
    n, e = len(inp["vio_q"]), len(inp["loop_pairs"])

    def cap(x):
        c = 256
        while c < x:
            c *= 2
        return c

    prob = build_problem_np(
        q=inp["vio_q"], t=inp["vio_t"], vio_q=inp["vio_q"],
        vio_t=inp["vio_t"], node_valid=np.ones(n, bool),
        loop_pairs=inp["loop_pairs"], loop_q=inp["loop_q"],
        loop_t=inp["loop_t"], loop_w=inp["loop_w"],
        loop_valid=np.ones(e, bool), switch=np.full(e, 0.99),
        prior_idx=np.array([0]), prior_q=inp["vio_q"][:1],
        prior_t=inp["vio_t"][:1], prior_w=np.array([1.1]),
        n_cap=cap(n), e_cap=cap(e), p_cap=8, dtype=np.float32,
        device=device)
    pairs = np.asarray(inp["loop_pairs"])
    group = coarse.auto_coarse_group(
        prob.n_cap, coarse.median_loop_offset(pairs[:, 1], pairs[:, 0]))
    return prob, group


def _harness_kw(name: str, device) -> tuple:
    """(harness problem of instance `name`, the product's lm_solve kwargs
    with its coarse group)."""
    from solve_keyframe_pose_graph_tpu_torch.ops import lm

    prob, group = harness_problem(os.path.join(GRAPHS, f"{name}.g2o"),
                                  device)
    return prob, dict(lm.cfg_lm_kwargs(Config().solver), coarse_group=group)


def harness_solve(name: str, device) -> dict:
    """The port's product solve of the harness problem: chi^2, the
    escalation rung (or None) and the wall time."""
    from solve_keyframe_pose_graph_tpu_torch.ops import lm

    prob, kw = _harness_kw(name, device)
    solver = Config().solver
    t0 = time.perf_counter()
    res, rung = lm.lm_solve_adaptive(
        prob, escalate_rejects=solver.escalate_rejects,
        fp64_backend=solver.fp64_backend, **kw)
    chi2 = float(res.final_cost)
    return {"chi2": chi2, "rung": rung or None,
            "wall_s": time.perf_counter() - t0}


def rung_ab(name: str, device) -> dict:
    """Both fp64 rungs on the harness problem with escalation forced: the
    chi^2, its gap to HARNESS_REF and the wall time of each, by rung (the
    A/B that decides which rung fp64_backend="auto" should take on a
    GPU)."""
    from solve_keyframe_pose_graph_tpu_torch.ops import lm

    prob, kw = _harness_kw(name, device)
    out = {}
    for backend in ("cpu", "tpu"):
        t0 = time.perf_counter()
        res, rung, _ = lm.escalate_resolve(prob, kw, 0, fp64_backend=backend)
        chi2 = float(res.final_cost)
        out[rung] = {"chi2": chi2, "gap": chi2 / HARNESS_REF[name] - 1.0,
                     "wall_s": time.perf_counter() - t0}
    return out


def exact_config() -> Config:
    """The product Config with every solve re-solved inline on the host
    fp64 rung (exact steps)."""
    cfg = Config()
    return dataclasses.replace(
        cfg,
        solver=dataclasses.replace(cfg.solver, adaptive_fp64=True,
                                   escalate_rejects=0, fp64_backend="cpu"),
        stream=dataclasses.replace(cfg.stream, background_escalation=False))


def cli_solve(name: str, device: str, tmp: str, config: str = "") -> tuple:
    """The port CLI's `solve` of one instance in this process. Returns
    (final chi^2, the engine's solve_stats rows, wall seconds)."""
    from solve_keyframe_pose_graph_tpu_torch import cli

    out = os.path.join(tmp, f"{name}.json")
    argv = ["solve", "--input", os.path.join(GRAPHS, f"{name}.g2o"),
            "--output", out, "--device", device]
    if config:
        argv += ["--config", config]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{name}: cli solve returned {rc}")
    with open(out) as f:
        sol = json.load(f)
    return float(sol["last_solve"]["final_cost"]), sol["solve_stats"], wall


def exact_cli_solve(name: str, device: str, tmp: str) -> tuple:
    """cli_solve with the exact_config (the secondary, self reference)."""
    path = os.path.join(tmp, "exact_config.json")
    with open(path, "w") as f:
        f.write(exact_config().to_json())
    chi2, rows, wall = cli_solve(name, device, tmp, path)
    if rows[0].get("fp64_escalated") != "fp64-cpu":
        raise RuntimeError(f"{name}: the exact reference did not run on the "
                           f"host fp64 rung: {rows[0]}")
    return chi2, wall


def cli_row(chi2: float, rows: list, wall: float, exact: float,
            exact_wall: float) -> dict:
    """The CLI columns of a certification row."""
    esc = [r for r in rows if r.get("background_escalation")]
    return {
        "cli_chi2": chi2, "cli_exact_chi2": exact,
        "cli_gap": chi2 / exact - 1.0,
        "cli_rung": esc[-1].get("escalated_rung") if esc else None,
        "fp32_chi2": rows[0]["final_cost"],
        "fp32_accepted": rows[0]["successful_steps"],
        "fp32_iterations": rows[0]["lm_iterations"],
        "distress_rejects": rows[0]["distress_rejects"],
        "nodes": rows[0]["node_len"], "edges": rows[0]["edge_len"],
        "trigger_wall_ms": rows[0]["trigger_wall_ms"],
        "escalation_wall_ms": (esc[-1].get("escalation_wall_ms")
                               if esc else None),
        "cli_wall_s": wall, "exact_cli_wall_s": exact_wall,
    }


def certify(name: str, device: str, tmp: str) -> dict:
    ref, jax_cli = HARNESS_REF[name], JAX_CLI[name]
    h = harness_solve(name, device)
    chi2, rows, wall = cli_solve(name, device, tmp)
    exact, exact_wall = exact_cli_solve(name, device, tmp)
    return {
        "instance": name, "chi2": h["chi2"], "ref": ref,
        "gap": h["chi2"] / ref - 1.0,
        "ok": (abs(h["chi2"] - ref) <= QUALITY * ref
               and abs(chi2 - jax_cli) <= QUALITY * jax_cli),
        "rung": h["rung"], "wall_s": h["wall_s"],
        "jax_cli_chi2": jax_cli, "jax_cli_gap": chi2 / jax_cli - 1.0,
        **cli_row(chi2, rows, wall, exact, exact_wall),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="certify")
    ap.add_argument("names", nargs="*", default=list(HARNESS_REF))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    rows = []
    with tempfile.TemporaryDirectory(prefix="kpg-cert") as tmp:
        for name in args.names:
            row = certify(name, args.device, tmp)
            row["rung_ab"] = rung_ab(name, args.device)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    bad = [r["instance"] for r in rows if not r["ok"]]
    print(json.dumps({"certified": len(rows) - len(bad), "of": len(rows),
                      "outside_2pct": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
