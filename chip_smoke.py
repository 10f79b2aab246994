#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root)

Phases, one printed line each (or a few):
  1. device: requires CUDA and prints the card's name and power limit;
  2. build: compiles both hand-written kernels from csrc/ with nvcc;
  3. kernel K1 (band matvec) against its plain PyTorch version on the card,
     at N = 8192 and a ragged N = 5000, F = 5, fp32 and fp64, with times;
  4. kernel K2 (batched SPD inverse) against its plain version and an fp64
     torch.linalg.inv, at n = 1024 and 512, d = 30, with times;
  5. the port's main path: one lm_solve at the product defaults on the
     5,000-node / 10,000-loop-edge circle graph (the bench graph), with both
     kernels' launch counts, chi^2 (also re-evaluated in fp64) against the
     fp64 exact-step reference, the LM and CG counts and the median time per
     solve; then the same solver on a small graph on the card and on the
     CPU, which must agree;
  6. the streaming engine answering four triggers of a 2,000-node stream;
  7. escalation: the phase-5 bench problem (fp32) through escalate_resolve
     with escalation forced, on the host fp64 rung ("auto") and on the
     device rung (K1 and K2 in fp64), each landing within 2% of the fp64
     reference chi^2, with wall times;
  8. cli-solve: the port CLI's `solve` at the product defaults on
     bench_seed0 and bench_seed1 (5,000 nodes, 10,000 loop edges, 20%
     outliers), its launch counts equal to what its solve_stats rows
     imply, within 2% of the JAX package's CLI on the same file
     (certify.JAX_CLI) and of its own exact-step solve; then the
     benchmark harness's problem of each file through the port's product
     solve, within 2% of BASELINE.md's fp64 exact-step reference (0.4038
     and 38.81; certify.py);
  9. replay: a seeded 5,000-node stream with two kidnaps (three worlds
     merged by inter-world loop edges) through the CLI's `replay` with a
     checkpoint, again with --async-dispatch (same final poses), then
     `replay --load-dir` restoring the checkpoint;
 10. serve: the port server on a Unix socket in a thread, on the bounded
     native store; a client streams 2,000 nodes, their loop edges and a
     kidnap/unkidnap pair, asks every query kind and shuts it down.
Each path of phases 5 and 7-10 is run with the kernels' launch counts set to
0 just before it and read just after (phase 8's exact-step self-reference
runs outside them). Then a JSON line with each kernel's
numbers (launches summed over those paths, and by path), the card line
again, and last {"ok": true, "device": {...}}. Any failed check raises and
exits non-zero before that last line; there is no CPU fallback.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import socket
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from solve_keyframe_pose_graph_tpu_torch import certify, cli
from solve_keyframe_pose_graph_tpu_torch.graph import (
    messages, native, store as store_mod, synthetic,
)
from solve_keyframe_pose_graph_tpu_torch.ops import _kernels, band_matvec, gn
from solve_keyframe_pose_graph_tpu_torch.ops import lm as lm_ops
from solve_keyframe_pose_graph_tpu_torch.ops import smallinv
from solve_keyframe_pose_graph_tpu_torch.ops.lm import lm_solve
from solve_keyframe_pose_graph_tpu_torch.runtime_server import (
    PoseGraphServer,
)
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    build_problem_np, problem_astype,
)
from solve_keyframe_pose_graph_tpu_torch.utils import nse3

CHI2_REF = 0.4038          # fp64 exact-step reference chi^2 of the bench graph
PRODUCT = dict(max_iterations=10, preconditioner="band+coarse", bcr_levels=2,
               max_cg_iterations=45)
REPO = os.path.dirname(os.path.abspath(__file__))
# the two bench instances of phase 8 (5,000 nodes, 10,000 loop edges)
BENCH = ("bench_seed0", "bench_seed1")
QUALITY = 0.02             # the quality bar: within 2% of the reference
WRAPPERS = {"band_matvec": band_matvec.band_matvec, "gj_inv": smallinv.gj_inv}
PATH_LAUNCHES: dict = {}   # path -> {kernel: launches in that path's run}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def event_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median over `reps` calls of CUDA-event time per call, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@contextlib.contextmanager
def counted(path: str):
    """Run one path of the program with the launch counts set to 0 just
    before it, and record them just after (all its threads joined)."""
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    torch.cuda.synchronize()
    PATH_LAUNCHES[path] = {k: w.launches for k, w in WRAPPERS.items()}


def within_quality(chi2: float, ref: float) -> bool:
    return math.isfinite(chi2) and abs(chi2 - ref) <= QUALITY * ref


def run_cli(argv: list) -> str:
    """cli.main in this process; returns what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv} returned {rc}:\n{out.getvalue()}")
    return out.getvalue()


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|), in float64."""
    diff = float((got.double() - ref.double()).abs().max())
    return diff, diff / float(ref.double().abs().max())


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs one NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, nvidia_smi=repr(card))
    return card


def phase_build() -> None:
    for name, entries in (("band_matvec", band_matvec._ENTRIES),
                          ("gj_inv", smallinv._ENTRIES)):
        t0 = time.perf_counter()
        path = _kernels.build(name)
        _kernels.load(name, entries)
        say("build", kernel=name, seconds=f"{time.perf_counter() - t0:.2f}",
            library=path)


def phase_k1(dev) -> dict:
    rng = np.random.default_rng(1)
    out = {}
    for N in (8192, 5000):
        for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            D, B, x = (torch.tensor(rng.normal(size=s), dtype=dt, device=dev)
                       for s in ((36, N), (5, 36, N), (6, N)))
            y = band_matvec.band_matvec(D, B, x)
            ref = band_matvec.band_matvec_plain(D, B, x)
            torch.cuda.synchronize()
            abs_err, rel = rel_err(y, ref)
            if not rel <= tol:
                raise AssertionError(
                    f"K1 disagrees at N={N} {dt}: rel err {rel} > {tol}")
            ms = event_ms(lambda: band_matvec.band_matvec(D, B, x))
            plain_ms = event_ms(lambda: band_matvec.band_matvec_plain(D, B, x))
            say("k1", N=N, dtype=str(dt).split(".")[1], max_rel_err=rel,
                max_abs_err=abs_err, tol=tol, kernel_ms=ms,
                plain_ms=plain_ms)
            if N == 8192 and dt == torch.float32:
                out = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
    return out


def phase_k2(dev) -> dict:
    rng = np.random.default_rng(2)
    out = {}
    d = 30
    for n in (1024, 512):
        G = rng.normal(size=(n, d, d))
        A64 = torch.tensor(G @ np.swapaxes(G, -1, -2) / d + 0.5 * np.eye(d),
                           device=dev)
        exact = torch.linalg.inv(A64)
        for dt, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
            A = A64.to(dt)
            X = smallinv.gj_inv(A)
            P = smallinv.block_gj_inv(A)
            torch.cuda.synchronize()
            _, rel = rel_err(X, exact)
            abs_plain, rel_plain = rel_err(X, P)
            if not (rel <= tol and rel_plain <= tol):
                raise AssertionError(
                    f"K2 disagrees at n={n} {dt}: rel err {rel} vs fp64 "
                    f"inverse, {rel_plain} vs plain, tol {tol}")
            ms = event_ms(lambda: smallinv.gj_inv(A))
            plain_ms = event_ms(lambda: smallinv.block_gj_inv(A))
            say("k2", n=n, d=d, dtype=str(dt).split(".")[1],
                max_rel_err_vs_fp64_inv=rel, max_rel_err_vs_plain=rel_plain,
                tol=tol, kernel_ms=ms, plain_ms=plain_ms)
            if n == 1024 and dt == torch.float32:
                out = dict(max_abs_err=abs_plain, ms=ms, plain_ms=plain_ms)
    return out


def circle_problem(n, n_loops, n_cap, e_cap, dtype, device, outliers=0.2,
                   prior_w=1.1):
    g = synthetic.circle_graph(n_nodes=n, n_loops=n_loops, seed=0,
                               outlier_fraction=outliers)
    return build_problem_np(
        q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
        node_valid=np.ones(n, bool), loop_pairs=g.loop_pairs,
        loop_q=g.loop_q, loop_t=g.loop_t, loop_w=g.loop_w,
        loop_valid=np.ones(n_loops, bool), switch=np.full(n_loops, 0.99),
        prior_idx=np.array([0]), prior_q=g.vio_q[:1], prior_t=g.vio_t[:1],
        prior_w=np.array([prior_w]), n_cap=n_cap, e_cap=e_cap, p_cap=8,
        dtype=dtype, device=device)


def phase_solve(dev, card: str) -> dict:
    t0 = time.perf_counter()
    prob = circle_problem(5000, 10000, 8192, 16384, np.float32, dev)
    torch.cuda.synchronize()
    say("solve", build_s=f"{time.perf_counter() - t0:.2f}",
        n_cap=prob.n_cap, e_cap=prob.e_cap, p_cap=prob.p_cap,
        dtype="float32", **PRODUCT)

    # the counted run: every launch between these two reads is the main path's
    with counted("lm_solve"):
        res = lm_solve(prob, **PRODUCT)
    launches = PATH_LAUNCHES["lm_solve"]
    if not all(launches.values()):
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    chi2 = float(res.final_cost)
    if not (math.isfinite(chi2) and chi2 <= 1.02 * CHI2_REF):
        raise AssertionError(f"chi^2 {chi2} is not finite and <= 1.02 x "
                             f"{CHI2_REF}")
    # the same chi^2 evaluated independently of the assembly, in fp64
    chi2_64 = float(gn.evaluate_cost(
        problem_astype(prob, torch.float64), res.q.double(), res.t.double(),
        res.switch.double()))
    if not abs(chi2_64 - chi2) <= 1e-3 * chi2_64:
        raise AssertionError(f"assembled chi^2 {chi2} vs fp64 re-evaluation "
                             f"{chi2_64}")
    for name in ("q", "t", "switch"):
        v = getattr(res, name)
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite {name} in the solution")
    if tuple(res.q.shape) != (8192, 4) or tuple(res.t.shape) != (8192, 3):
        raise AssertionError(f"solution shapes {tuple(res.q.shape)}, "
                             f"{tuple(res.t.shape)}")

    lm_solve(prob, **PRODUCT)                    # second warm-up
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lm_solve(prob, **PRODUCT)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    say("solve", chi2=chi2, chi2_fp64_eval=chi2_64, chi2_ref=CHI2_REF,
        initial_cost=float(res.initial_cost),
        lm_iterations=int(res.iterations),
        accepted=int(res.successful_steps),
        cg_iterations=int(res.total_cg_iterations),
        distress_rejects=int(res.distress_rejects),
        launches=json.dumps(launches, separators=(",", ":")),
        median_ms_per_solve=float(np.median(times)),
        all_ms=json.dumps([round(t, 3) for t in times]), card=repr(card))

    # the same solver on a small graph, on the card (fp64, through both
    # kernels) and on the CPU (plain versions): the results must agree
    g, c = (lm_solve(circle_problem(300, 40, 512, 64, np.float64, d,
                                    outliers=0.3, prior_w=2.0), **PRODUCT)
            for d in (dev, "cpu"))
    counts_equal = all(int(getattr(g, k)) == int(getattr(c, k))
                       for k in ("iterations", "successful_steps",
                                 "total_cg_iterations"))
    rel = abs(float(g.final_cost) - float(c.final_cost)) / float(c.final_cost)
    t_err = float((g.t.cpu() - c.t).abs().max())
    if not (counts_equal and rel <= 1e-6 and t_err <= 1e-6):
        raise AssertionError(
            f"small graph: cuda vs cpu chi^2 rel diff {rel}, max |dt| "
            f"{t_err}, counts equal {counts_equal}")
    say("solve-small", cuda_chi2=float(g.final_cost),
        cpu_chi2=float(c.final_cost), rel_diff=rel, max_abs_dt=t_err,
        cg_iterations=int(g.total_cg_iterations))
    return launches


def phase_engine(dev) -> None:
    g = synthetic.circle_graph(n_nodes=2000, n_loops=1000, seed=1)
    store = native.make_store()
    eng = SolverEngine(store, device=dev)
    t0, dt = 1_000_000_000, 100_000_000
    order = np.argsort(g.loop_pairs[:, 0], kind="stable")
    n_added = 0
    for chunk, edges in enumerate(np.array_split(order, 4)):
        last = (g.n_nodes if chunk == 3
                else int(g.loop_pairs[edges, 0].max()) + 1)
        for i in range(n_added, last):
            store.add_node(t0 + i * dt, g.vio_q[i], g.vio_t[i])
        n_added = last
        for k in edges:
            a, b = map(int, g.loop_pairs[k])
            store.add_loop_edge_by_index(a, b, g.loop_q[k], g.loop_t[k],
                                         float(g.loop_w[k]))
        if not eng.trigger():
            raise AssertionError(f"trigger {chunk} did not fire")
        st = eng.solve_stats[-1]
        if not st["final_cost"] < st["initial_cost"]:
            raise AssertionError(f"trigger {chunk} did not lower the cost: "
                                 f"{st}")
        say("engine", trigger=st["trigger"], node_len=st["node_len"],
            edge_len=st["edge_len"], initial_cost=st["initial_cost"],
            final_cost=st["final_cost"], lm_iterations=st["lm_iterations"],
            cg_iterations=st["cg_iterations"],
            distress_rejects=st["distress_rejects"],
            trigger_wall_ms=round(st["trigger_wall_ms"], 3))
    poses = np.array([np.concatenate(eng.get_node_pose(i))
                      for i in range(store.node_len)])
    if not np.isfinite(poses).all():
        raise AssertionError("non-finite solved poses")


def phase_escalation(dev, card: str) -> None:
    """Both fp64 rungs on the phase-5 bench problem, escalation forced."""
    threads = min(8, os.cpu_count() or 1)
    torch.set_num_threads(threads)        # the host rung's CPU thread pool
    prob = circle_problem(5000, 10000, 8192, 16384, np.float32, dev)
    for backend, want in (("auto", "fp64-cpu"), ("tpu", "fp64")):
        path = f"escalation-{want}"
        with counted(path):
            t0 = time.perf_counter()
            res, rung, stats = lm_ops.escalate_resolve(
                prob, PRODUCT, 0, fp64_backend=backend)
            chi2 = float(res.final_cost)
            wall = time.perf_counter() - t0
        if rung != want:
            raise AssertionError(f"fp64_backend={backend!r} took rung "
                                 f"{rung!r}, expected {want!r}")
        if not within_quality(chi2, CHI2_REF):
            raise AssertionError(f"{rung} rung chi^2 {chi2} not within "
                                 f"{QUALITY:.0%} of {CHI2_REF}")
        if res.q.dtype != torch.float64 or res.q.shape[0] != prob.n_cap:
            raise AssertionError(f"{rung}: result {res.q.dtype} "
                                 f"{tuple(res.q.shape)}")
        n = PATH_LAUNCHES[path]
        if rung == "fp64" and not all(n.values()):
            raise AssertionError(f"the device rung did not run both kernels "
                                 f"in fp64: {n}")
        say("escalation", backend=backend, rung=rung, chi2=chi2,
            chi2_ref=CHI2_REF, gap=f"{chi2 / CHI2_REF - 1:+.4%}",
            wall_s=round(wall, 4),
            rung_stats=json.dumps({k: (round(v, 4) if isinstance(v, float)
                                       else v) for k, v in stats.items()}),
            lm_iterations=int(res.iterations),
            accepted=int(res.successful_steps),
            cg_iterations=int(res.total_cg_iterations),
            launches=json.dumps(n, separators=(",", ":")),
            torch_threads=threads, card=repr(card))


def expected_launches(rows: list, cg_cap: int = 45,
                      cg_cap_fp64: int = 100, per_factor: int = 3) -> dict:
    """K1 and K2 launches of the CLI solve that wrote `rows`: one K1 per CG
    iteration of the fixed cap and `per_factor` K2 (bcr_levels + 1) per LM
    iteration, for the fp32 trigger solves and any device-rung re-solve; the
    host rung launches nothing."""
    k1 = k2 = 0
    for r in rows:
        if "trigger_wall_ms" in r:
            k1 += cg_cap * r["lm_iterations"]
        elif r.get("escalated_rung") == "fp64":
            k1 += cg_cap_fp64 * r["lm_iterations"]
        else:
            continue
        k2 += per_factor * r["lm_iterations"]
    return {"band_matvec": k1, "gj_inv": k2}


def phase_cli_solve(tmp: str, card: str) -> None:
    """The port CLI's batch solve at the product defaults on two bench
    instances; then the benchmark harness's problem of each through the
    port's product solve, held to BASELINE.md's fp64 exact-step reference
    (certify.py). Each run is counted on its own; the CLI's exact-step
    self-reference runs uncounted."""
    for name in BENCH:
        path = f"cli-solve-{name}"
        with counted(path):
            chi2, rows, wall = certify.cli_solve(name, "cuda", tmp)
        exact, exact_wall = certify.exact_cli_solve(name, "cuda", tmp)
        row = certify.cli_row(chi2, rows, wall, exact, exact_wall)
        want = expected_launches(rows)
        if PATH_LAUNCHES[path] != want or not all(want.values()):
            raise AssertionError(f"{name}: the CLI solve launched "
                                 f"{PATH_LAUNCHES[path]}, its rows say "
                                 f"{want}")
        jax_cli = certify.JAX_CLI[name]
        if not (within_quality(chi2, jax_cli) and within_quality(chi2, exact)):
            raise AssertionError(f"{name}: CLI chi^2 {chi2} not within "
                                 f"{QUALITY:.0%} of the JAX package's CLI "
                                 f"{jax_cli} and of its exact-step solve "
                                 f"{exact}")
        if row["nodes"] != 5000 or row["edges"] != 10000:
            raise AssertionError(f"{name}: solved {row['nodes']} nodes, "
                                 f"{row['edges']} edges")
        say("cli-solve", instance=name, chi2=chi2, jax_cli_chi2=jax_cli,
            jax_cli_gap=f"{chi2 / jax_cli - 1:+.4%}", exact_chi2=exact,
            exact_gap=f"{row['cli_gap']:+.4%}", rung=row["cli_rung"] or "none",
            fp32_chi2=row["fp32_chi2"],
            distress_rejects=row["distress_rejects"],
            trigger_wall_ms=round(row["trigger_wall_ms"], 3),
            escalation_wall_ms=round(row["escalation_wall_ms"] or 0.0, 3),
            cli_wall_s=round(wall, 3), exact_cli_wall_s=round(exact_wall, 3),
            launches=json.dumps(PATH_LAUNCHES[path], separators=(",", ":")),
            card=repr(card))

        path = f"harness-{name}"
        with counted(path):
            h = certify.harness_solve(name, "cuda")
        ref = certify.HARNESS_REF[name]
        if not within_quality(h["chi2"], ref):
            raise AssertionError(f"{name}: harness problem chi^2 {h['chi2']} "
                                 f"(rung {h['rung']}) not within "
                                 f"{QUALITY:.0%} of BASELINE.md's {ref}")
        if not all(PATH_LAUNCHES[path].values()):
            raise AssertionError(f"{name}: a kernel never ran: "
                                 f"{PATH_LAUNCHES[path]}")
        say("harness", instance=name, chi2=h["chi2"], ref=ref,
            gap=f"{h['chi2'] / ref - 1:+.4%}", rung=h["rung"] or "none",
            wall_s=round(h["wall_s"], 3),
            launches=json.dumps(PATH_LAUNCHES[path], separators=(",", ":")),
            card=repr(card))


def make_stream(path: str, n: int = 5000, n_loops: int = 2500,
                seed: int = 11) -> dict:
    """A recorded stream with two kidnaps: 20 nodes from 32% and from 66%
    of the stream fall in dead zones, after each of which the VIO restarts
    in a new, randomly placed frame (three worlds). The circle's loop edges
    are physical relative poses, so the ones that cross worlds merge them.
    Saved in the reference's log_posegraph.json schema."""
    g = synthetic.circle_graph(n_nodes=n, n_loops=n_loops, seed=seed,
                               outlier_fraction=0.1)
    rng = np.random.default_rng(seed)
    rec = store_mod.GraphStore(initial_capacity=n)
    t0, dt = 1_000_000_000, 100_000_000
    q_w = np.array([0.0, 0.0, 0.0, 1.0])
    t_w = np.zeros(3)
    gone = (n * 8 // 25, n * 33 // 50)
    for i in range(n):
        if i in gone:
            rec.kidnap_indicator(t0 + i * dt - dt // 2, "kidnapped")
        if i in (gone[0] + 20, gone[1] + 20):
            rec.kidnap_indicator(t0 + i * dt - dt // 2, "unkidnapped")
            yaw = rng.uniform(-np.pi, np.pi)
            q_w = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
            t_w = rng.normal(scale=30.0, size=3) * [1, 1, 0.1]
        q, t = nse3.pose_mul(q_w, t_w, g.vio_q[i], g.vio_t[i])
        rec.add_node(t0 + i * dt, q, t)
    for k in range(n_loops):
        a, b = map(int, g.loop_pairs[k])
        rec.add_loop_edge_by_index(a, b, g.loop_q[k], g.loop_t[k],
                                   float(g.loop_w[k]))
    rec.save_as_json(path)
    return {"events": n + n_loops + 4, "t_end": t0 + n * dt, "dt": dt}


def phase_replay(tmp: str, card: str) -> None:
    stream = os.path.join(tmp, "stream.json")
    info = make_stream(stream)
    every = str(info["events"] // 10)
    finals = {}
    for mode, extra in (("sync", []), ("async", ["--async-dispatch"])):
        out = os.path.join(tmp, f"replay_{mode}.json")
        ckpt = os.path.join(tmp, f"ckpt_{mode}")
        path = f"replay-{mode}"
        with counted(path):
            t0 = time.perf_counter()
            run_cli(["replay", "--input", stream, "--output", out,
                     "--trigger-every", every, "--save-dir", ckpt,
                     "--device", "cuda", *extra])
            wall = time.perf_counter() - t0
        sol = json.load(open(out))
        stats = sol["solve_stats"]
        rows = [r for r in stats if "trigger_wall_ms" in r]
        bad = [r for r in rows if not r["final_cost"] <= r["initial_cost"]]
        bad += [r for r in stats if r.get("background_escalation")
                and not r.get("final_cost", math.inf)
                <= r.get("initial_cost", -math.inf)]
        if len(rows) < 5 or bad:
            raise AssertionError(f"replay {mode}: {len(rows)} triggers; "
                                 f"cost not lowered in {bad}")
        saved = json.load(open(os.path.join(ckpt, "solved_posegraph.json")))
        sets = {nd["setID_of_worldID"] for nd in saved["SolvedPoseGraph"]
                if nd["worldID"] >= 0}
        worlds = {nd["worldID"] for nd in saved["SolvedPoseGraph"]}
        if len(sets) != 1 or not {0, 1, 2} <= worlds:
            raise AssertionError(f"replay {mode}: worlds {worlds} end in "
                                 f"sets {sets}, expected one set")
        T = np.array([[float(v) for v in n["w_T_c"].split(";")[r].split(",")]
                      for n in sol["nodes"] for r in range(3)])
        finals[mode] = T
        ms = [r["trigger_wall_ms"] for r in rows]
        say("replay", mode=mode, triggers=len(rows),
            escalations=sum(1 for r in stats
                            if r.get("background_escalation")),
            final_chi2=rows[-1]["final_cost"],
            median_trigger_wall_ms=round(float(np.median(ms)), 3),
            p90_trigger_wall_ms=round(float(np.percentile(ms, 90)), 3),
            replay_wall_s=round(wall, 3),
            launches=json.dumps(PATH_LAUNCHES[path], separators=(",", ":")),
            card=repr(card))
    diff = float(np.abs(finals["async"] - finals["sync"]).max())
    scale = float(np.abs(finals["sync"]).max())
    if not diff <= 1e-4 * scale:
        raise AssertionError(f"async replay differs from sync by {diff} "
                             f"(scale {scale})")

    # restore the checkpoint into a fresh pipeline; the continuation's
    # nodes queue behind the end-of-world mark the save wrote
    cont = store_mod.GraphStore()
    for i in range(200):
        cont.add_node(info["t_end"] + (i + 10) * info["dt"],
                      [0.0, 0.0, 0.0, 1.0], [float(i), 0.0, 0.0])
    cont_path = os.path.join(tmp, "continuation.json")
    cont.save_as_json(cont_path)
    out = os.path.join(tmp, "replay_loaded.json")
    text = run_cli(["replay", "--input", cont_path, "--output", out,
                    "--load-dir", os.path.join(tmp, "ckpt_sync"),
                    "--device", "cuda"])
    if "load_state_from_disk" not in text or "-> True" not in text:
        raise AssertionError(f"checkpoint did not re-load:\n{text}")
    # the restored map, composed, is the saved run's composed trajectory
    # (outside the kidnap dead zones, whose poses are not solved)
    saved = json.load(open(os.path.join(tmp, "ckpt_sync",
                                        "solved_posegraph.json")))
    live = np.array([nd["worldID"] >= 0 for nd in saved["SolvedPoseGraph"]])
    n0 = len(live)
    nodes = json.load(open(out))["nodes"]
    got = np.array([[float(r.split(",")[3]) for r in
                     nd["w_T_c"].split(";")[:3]] for nd in nodes[:n0]])
    want = finals["sync"].reshape(-1, 3, 4)[:n0, :, 3]
    err = float(np.abs(got - want)[live].max())
    if not (err <= 1e-9 * scale and len(nodes) == n0 + 200):
        raise AssertionError(f"restored map: max |dt| {err}, "
                             f"{len(nodes)} nodes")
    say("replay", async_vs_sync_max_abs_diff=diff, pose_scale=scale,
        restored_nodes=n0, restored_max_abs_dt=err, card=repr(card))


def phase_serve(dev, tmp: str, card: str, n: int = 2000) -> None:
    g = synthetic.circle_graph(n_nodes=n, n_loops=n // 2, seed=5)
    gone = (n * 3 // 5, n * 3 // 5 + 10)
    sock_path = os.path.join(tmp, "kpg.sock")
    store = native.make_store()
    if not isinstance(store, native.NativeGraphStore):
        raise AssertionError("the native store did not build")
    t0, dtn = 1_000_000_000, 100_000_000
    with counted("serve"):
        server = PoseGraphServer(store, save_dir=os.path.join(tmp, "srv"),
                                 device=dev)
        th = threading.Thread(target=server.serve,
                              kwargs=dict(socket_path=sock_path,
                                          poll_hz=20.0), daemon=True)
        th.start()
        for _ in range(200):
            if os.path.exists(sock_path):
                break
            time.sleep(0.05)
        client = socket.socket(socket.AF_UNIX)
        client.connect(sock_path)
        f = client.makefile("rw")

        def send(msg):
            f.write(json.dumps(msg.to_json()) + "\n")

        def ask(**q):
            f.write(json.dumps(dict(kind="query", **q)) + "\n")
            f.flush()
            return json.loads(f.readline())

        order = np.argsort(g.loop_pairs.max(axis=1), kind="stable")
        k = 0
        for i in range(g.n_nodes):
            if i in gone:
                send(messages.KidnapIndicatorMsg(
                    t0 + i * dtn - dtn // 2,
                    "kidnapped" if i == gone[0] else "unkidnapped"))
            send(messages.NodePoseMsg(t0 + i * dtn, g.vio_q[i], g.vio_t[i]))
            while k < len(order) and g.loop_pairs[order[k]].max() <= i:
                e = order[k]
                a, b = map(int, g.loop_pairs[e])
                send(messages.LoopEdgeMsg(t0 + a * dtn, t0 + b * dtn,
                                          g.loop_q[e], g.loop_t[e],
                                          float(g.loop_w[e])))
                k += 1
            if i % 100 == 99:
                f.flush()
        f.flush()
        t_sent = time.perf_counter()
        st = {}
        while time.perf_counter() - t_sent < 300:
            st = ask(what="status")
            if st["nodes"] == g.n_nodes and \
                    st["solved_until"] == g.n_nodes - 1:
                break
            time.sleep(0.05)
        catch_up = time.perf_counter() - t_sent
        if st.get("solved_until") != g.n_nodes - 1:
            raise AssertionError(f"server did not catch up: {st}")
        traj = ask(what="trajectory")
        pose = ask(what="pose")
        path = ask(what="path", frame="camera")
        wt = ask(what="world_transform", m=0, n=1)
        send(messages.ExtrinsicMsg(t0, [0.0, 0.0, 0.0, 1.0],
                                   [0.05, 0.0, 0.02]))
        f.flush()
        time.sleep(0.1)
        send(messages.ImuPropagateMsg(t0 + 3000 * dtn, [0.0, 0.0, 0.0, 1.0],
                                      [1.0, 0.0, 0.0]))
        f.flush()
        imu = json.loads(f.readline())
        f.write(json.dumps({"kind": "shutdown"}) + "\n")
        f.flush()
        bye = json.loads(f.readline())
        client.close()
        th.join(timeout=300)
    ok = (traj["n"] == g.n_nodes and len(traj["t"]) == g.n_nodes
          and np.isfinite(np.asarray(traj["t"])).all()
          and pose["ok"] and len(pose["t"]) == 3
          and path["n"] == g.n_nodes - 10 and wt["ok"]
          and imu["ok"] and bye.get("shutdown") and not th.is_alive()
          and os.path.exists(os.path.join(tmp, "srv",
                                          "solved_posegraph.json"))
          and all(PATH_LAUNCHES["serve"].values()))
    if not ok:
        raise AssertionError(f"serve: trajectory n={traj.get('n')}, "
                             f"pose={pose}, path n={path.get('n')}, "
                             f"world_transform={wt.get('ok')}, imu={imu}, "
                             f"shutdown={bye}, alive={th.is_alive()}, "
                             f"launches={PATH_LAUNCHES['serve']}")
    ms = [r["trigger_wall_ms"] for r in server.engine.solve_stats
          if "trigger_wall_ms" in r]
    say("serve", nodes=g.n_nodes, edges=st["edges"], worlds=st["worlds"],
        triggers=st["triggers"], catch_up_s=round(catch_up, 3),
        median_trigger_wall_ms=round(float(np.median(ms)), 3),
        final_chi2=st["last_solve"]["final_cost"],
        launches=json.dumps(PATH_LAUNCHES["serve"], separators=(",", ":")),
        card=repr(card))


def main() -> None:
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    phase_solve(dev, card)
    phase_engine(dev)
    phase_escalation(dev, card)
    with tempfile.TemporaryDirectory(prefix="kpg") as tmp:
        phase_cli_solve(tmp, card)
        phase_replay(tmp, card)
        phase_serve(dev, tmp, card)
    by_path = {k: {p: n[k] for p, n in PATH_LAUNCHES.items()}
               for k in WRAPPERS}
    kernels = [
        dict(name="band_matvec", route="cuda",
             source="solve_keyframe_pose_graph_tpu_torch/csrc/band_matvec.cu",
             replaces="solve_keyframe_pose_graph_tpu/ops/pallas_band.py:77",
             launches=sum(by_path["band_matvec"].values()),
             launches_by_path=by_path["band_matvec"], **k1),
        dict(name="gj_inv", route="cuda",
             source="solve_keyframe_pose_graph_tpu_torch/csrc/gj_inv.cu",
             replaces="solve_keyframe_pose_graph_tpu/ops/smallinv.py:74",
             launches=sum(by_path["gj_inv"].values()),
             launches_by_path=by_path["gj_inv"], **k2),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
