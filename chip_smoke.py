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
  6. the streaming engine answering four triggers of a 2,000-node stream.
Then a JSON line with each kernel's numbers, the card line again, and last
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero
before that last line; there is no CPU fallback.
"""

from __future__ import annotations

import json
import math
import subprocess
import time

import numpy as np
import torch

from solve_keyframe_pose_graph_tpu_torch.graph import native, synthetic
from solve_keyframe_pose_graph_tpu_torch.ops import _kernels, band_matvec, gn
from solve_keyframe_pose_graph_tpu_torch.ops import smallinv
from solve_keyframe_pose_graph_tpu_torch.ops.lm import lm_solve
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    build_problem_np, problem_astype,
)

CHI2_REF = 0.4038          # fp64 exact-step reference chi^2 of the bench graph
PRODUCT = dict(max_iterations=10, preconditioner="band+coarse", bcr_levels=2,
               max_cg_iterations=45)


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
    band_matvec.band_matvec.launches = 0
    smallinv.gj_inv.launches = 0
    res = lm_solve(prob, **PRODUCT)
    torch.cuda.synchronize()
    launches = {"band_matvec": band_matvec.band_matvec.launches,
                "gj_inv": smallinv.gj_inv.launches}
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


def main() -> None:
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    launches = phase_solve(dev, card)
    phase_engine(dev)
    kernels = [
        dict(name="band_matvec", route="cuda",
             source="solve_keyframe_pose_graph_tpu_torch/csrc/band_matvec.cu",
             replaces="solve_keyframe_pose_graph_tpu/ops/pallas_band.py:77",
             launches=launches["band_matvec"], **k1),
        dict(name="gj_inv", route="cuda",
             source="solve_keyframe_pose_graph_tpu_torch/csrc/gj_inv.cu",
             replaces="solve_keyframe_pose_graph_tpu/ops/smallinv.py:74",
             launches=launches["gj_inv"], **k2),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
