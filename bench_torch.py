#!/usr/bin/env python3
"""Headline bench of the PyTorch/CUDA port: the product lm_solve on one
NVIDIA GPU, in a process of its own.

    python3 bench_torch.py [--seed 0] [--nodes 5000] [--loops 10000]
                           [--warmup 2] [--reps 20] [--device cuda]

The counterpart of bench.py, the JAX package's TPU bench: the same graph,
circle_graph(nodes, loops, seed) (20% outlier loop edges) at capacities of
the next powers of two (n_cap 8192, e_cap 16384 at the default size), p_cap
8, one prior of weight 1.1 on node 0 and switches at 0.99, built in fp32 on
the card; and the same product configuration (10 LM iterations, the
band+coarse preconditioner, bcr_levels 2, CG capped at 45, the coarse group
on auto: chip_smoke.PRODUCT). `--nodes 30000 --loops 30000` is the
reference's capacity ceiling at n_cap = e_cap = 32768.

Each rep is one lm_solve and the read of its chi^2, timed with CUDA events
around the host's issue of the whole solve (the card idles while it waits
for the host's launches, so its busy time alone would hide what the solve
costs). lm_solve launches the composed solve executable of the problem's
bucket once (ops/graphs.py: the LM and CG loops end on the card): the
first warm-up captures its pieces, and its build's costs (the eager
warm-up of each piece, the four captures, the composition of the
executables, the memory pools) are in the result line's `capture`; a rep
that captured again would fail the bench. Beside each rep it records, on the host, the perf_counter wall, the
issuing thread's CPU time (time.thread_time; it counts a spin-wait at a
synchronisation as busy, and the time it waited for a CPU or the device
not), the garbage collections and their time (gc.callbacks; the
collector stays on, as users run it), the host's time inside the
solve's launch span (ops/graphs.py, utils/timing.py: the copy of the
problem in and the cap's fill as well as the one launch call of a solve;
None on the eager path, which launches no executable) and the
allocator's reserved memory; and, just before the rep, two fixed probes
of the host's speed:
a pure-Python loop (ms) and the host's time to issue one tiny CUDA
launch (us, over 500). The result line gives the correlation of the
reps' times with each. gc.collect()
runs once before the timed reps; nvidia-smi samples the SM clock, power
draw and temperature just before and just after them.

Checks (any failure exits non-zero before the result line): every solve,
warm-ups and the traced one included, gives the same chi^2 bit for bit and
the same LM, accepted and CG counts; each rep launches K1 and K2 as often as
its LM and CG counts imply (K1 once per CG iteration that ran, 318 at
5k/10k; K2 30 for 10 LM iterations) and captures
nothing; the chi^2 is
finite and agrees with its fp64 re-evaluation to 1e-3 relative; at seed 0
it is at most 1.02 x the reference (0.4038 at 5k/10k, the fp64 exact-step
reference; 5.9532 at 30k/30k, the JAX package's). At other seeds the
reference, where there is one (certify.HARNESS_REF for seeds 0-7 at
5k/10k), is printed beside the chi^2 and not gated.

After the timed reps one more solve runs under torch.profiler
(chip_smoke.device_profile): device time, the card's idle share of that
solve's wall, the device operations, K1 and K2 and the top kernels. The
K1 and K2 launches that it sees on the card must be those that the
counters counted (they add each piece's captured launches per run). It is
kept apart from the timed numbers; its wall minus the median is the
profiler's cost, so the idle share is also given against the median.

Output: a line per warm-up and per rep, the clock samples and the traced
run, each with a [tag]; then the card's name and power limit; last one JSON
object: metric (lm_solve_5k10k_ms at the default size), value (the median
ms), unit, backend, card, power_limit_w, reps, p25, p75, min, max, all_ms,
chi2, chi2_fp64_eval, chi2_ref, seed, the LM, accepted and CG counts,
k1_launches and k2_launches (per rep, counted), k1_launches_traced and
k2_launches_traced (seen by the profiler in the traced solve), device_ms, idle_share, capture
(the graph build's warmup_s, capture_s, instantiate_s and pool_bytes) and
host (CPU model, the CPUs this process may run on, torch's thread count);
then the
spread's context (the medians of the thread time and of both probes;
corr: Pearson correlations of the reps' ms with the host records and
probes) and seconds since main() began (main_s).

There is no CPU path: without CUDA, or given another device, it exits
non-zero before any solve. The kernels build from the repository's sources
at first use (ops/_kernels.py), during the first warm-up.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke
from chip_smoke import PRODUCT, QUALITY, WRAPPERS
from solve_keyframe_pose_graph_tpu_torch.certify import HARNESS_REF
from solve_keyframe_pose_graph_tpu_torch.ops import graphs
from solve_keyframe_pose_graph_tpu_torch.ops.lm import lm_solve
from solve_keyframe_pose_graph_tpu_torch.utils import timing

FP64_AGREEMENT = 1e-3       # chi^2 against its fp64 re-evaluation, relative


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def metric_name(nodes: int, loops: int) -> str:
    """lm_solve_5k10k_ms for 5,000 nodes and 10,000 loop edges."""
    return f"lm_solve_{nodes / 1000:g}k{loops / 1000:g}k_ms"


def chi2_ref(seed: int, nodes: int, loops: int):
    """The reference chi^2 of this instance, or None where there is none."""
    if (nodes, loops) == (5000, 10000):
        return HARNESS_REF.get(f"bench_seed{seed}")
    if (nodes, loops, seed) == (30000, 30000, 0):
        return chip_smoke.CHI2_CAP
    return None


def chi2_bar(seed: int, nodes: int, loops: int):
    """The most chi^2 may be: 1.02 x the reference at seed 0; None (no
    bar) at other seeds, whose references are reported only."""
    ref = chi2_ref(seed, nodes, loops)
    return None if seed != 0 or ref is None else (1 + QUALITY) * ref


def chi2_passes(chi2: float, bar) -> bool:
    return math.isfinite(chi2) and (bar is None or chi2 <= bar)


def summary(ms: list) -> dict:
    """Median, quartiles (linear interpolation), min and max."""
    p25, p50, p75 = np.percentile(ms, [25, 50, 75])
    return dict(median=float(p50), p25=float(p25), p75=float(p75),
                min=float(min(ms)), max=float(max(ms)))


PROBE_LOOP = 50_000         # iterations of the pure-Python probe
PROBE_LAUNCHES = 500       # tiny CUDA launches of the issue probe


def probes(dev) -> dict:
    """The host's speed just now: a fixed pure-Python loop (ms), and the
    host's time to issue one tiny kernel on the card (us per launch)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(PROBE_LOOP):
        acc += i * i
    python_ms = (time.perf_counter() - t0) * 1e3
    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(PROBE_LAUNCHES):
        x.add_(1.0)
    launch_us = (time.perf_counter() - t0) * 1e6 / PROBE_LAUNCHES
    torch.cuda.synchronize(dev)
    return dict(python_probe_ms=python_ms, launch_probe_us=launch_us)


def correlations(recs: list) -> dict:
    """Pearson correlation of the reps' ms with each host record."""
    ms = np.array([r["ms"] for r in recs])
    out = {}
    for key in ("thread_ms", "gc_ms", "replay_host_ms", "python_probe_ms",
                "launch_probe_us"):
        v = np.array([r[key] for r in recs], dtype=float)
        ok = len(ms) > 2 and ms.std() > 0 and v.std() > 0
        out[key] = float(np.corrcoef(ms, v)[0, 1]) if ok else None
    return out


class GcClock:
    """Collections by generation and their time, fed by gc.callbacks."""

    def __init__(self):
        self.counts = [0, 0, 0]
        self.seconds = 0.0
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.counts[info["generation"]] += 1


def cpu_model():
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


def gpu_sample(index: int) -> dict:
    fields = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu,pstate"
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", f"--query-gpu={fields}",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return dict(zip(fields.split(","),
                    (v.strip() for v in out.stdout.split(","))))


def fail(msg: str) -> None:
    raise SystemExit(f"bench_torch: {msg}")


def cuda_device(name: str) -> torch.device:
    """The card to run on; refuses any other device, and a missing card."""
    dev = torch.device(name)
    if dev.type != "cuda":
        fail(f"--device {name}: the bench runs on a CUDA device only")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; the bench needs an "
             "NVIDIA GPU and has no CPU path")
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        fail(f"--device {name}: {torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", index)


def build(nodes: int, loops: int, seed: int, dtype, device):
    """The bench's Problem (bench.py's graph and capacities)."""
    return chip_smoke.circle_problem(nodes, loops, next_pow2(nodes),
                                     next_pow2(loops), dtype, device,
                                     seed=seed)


def solve(prob) -> tuple:
    """One product solve, read back: (result, chi^2)."""
    res = lm_solve(prob, **PRODUCT)
    return res, float(res.final_cost)


def fingerprint(res, chi2: float) -> tuple:
    return (chi2.hex(), int(res.iterations), int(res.successful_steps),
            int(res.total_cg_iterations))


def timed_rep(prob, dev, clock: GcClock) -> tuple:
    """One solve under CUDA events with its host-side record."""
    probe = probes(dev)
    for w in WRAPPERS.values():
        w.launches = 0
    gc_counts, gc_s = list(clock.counts), clock.seconds
    spans = timing.Record(time.monotonic())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    w0, c0 = time.perf_counter(), time.thread_time()
    start.record()
    with timing.recording(spans):
        res, chi2 = solve(prob)
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - w0) * 1e3
    cpu = (time.thread_time() - c0) * 1e3
    rec = dict(ms=start.elapsed_time(end), wall_ms=wall, thread_ms=cpu,
               thread_share=cpu / wall,
               gc=[a - b for a, b in zip(clock.counts, gc_counts)],
               gc_ms=(clock.seconds - gc_s) * 1e3,
               replay_host_ms=spans.total_ms("launch"),
               reserved_mb=torch.cuda.memory_reserved(dev) / 2 ** 20,
               **probe, launches={k: w.launches for k, w in WRAPPERS.items()})
    return res, chi2, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--loops", type=int, default=10000)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda or cuda:N")
    args = ap.parse_args(argv)
    t_main = time.perf_counter()

    def at() -> float:
        return round(time.perf_counter() - t_main, 3)

    if args.reps < 1 or args.warmup < 1:
        fail("--reps and --warmup must be at least 1")
    dev = cuda_device(args.device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line(dev.index)
    name, _, limit = card.partition(",")
    host = dict(cpu_model=cpu_model(), affinity=len(os.sched_getaffinity(0)),
                torch_threads=torch.get_num_threads())

    chip_smoke.prime_profiler(dev)       # before the solve's composition
    t0 = time.perf_counter()
    prob = build(args.nodes, args.loops, args.seed, np.float32, dev)
    torch.cuda.synchronize()
    chip_smoke.say("setup", build_s=round(time.perf_counter() - t0, 3),
                   nodes=args.nodes, loops=args.loops, seed=args.seed,
                   n_cap=prob.n_cap, e_cap=prob.e_cap, p_cap=prob.p_cap,
                   dtype="float32", **PRODUCT, host=json.dumps(host),
                   card=repr(card), at_s=at())

    seen = set()
    warmup_ms = []
    built = len(graphs.LOG)
    for i in range(args.warmup):             # the first builds the kernels
                                             # and captures the graphs
        t0 = time.perf_counter()
        res, chi2 = solve(prob)
        warmup_ms.append((time.perf_counter() - t0) * 1e3)
        seen.add(fingerprint(res, chi2))
        chip_smoke.say("warmup", i=i, wall_ms=round(warmup_ms[-1], 3),
                       chi2=chi2,
                       reserved_mb=torch.cuda.memory_reserved(dev) / 2 ** 20,
                       at_s=at())

    builds = graphs.LOG[built:]
    if len(builds) != 1:
        fail(f"the warm-ups built {len(builds)} graph programs, not 1")
    capture = {k: builds[0][k] for k in (
        "warmup_s", "capture_s", "instantiate_s", "pool_bytes")}
    chip_smoke.say("capture", **capture, at_s=at())
    clock = GcClock()
    gc.collect()
    before = gpu_sample(dev.index)
    chip_smoke.say("clocks", when="before", **before, at_s=at())
    gc.callbacks.append(clock)
    recs = []
    try:
        for i in range(args.reps):
            res, chi2, rec = timed_rep(prob, dev, clock)
            want = chip_smoke.solve_launches(res, PRODUCT["max_cg_iterations"])
            if rec["launches"] != want or not all(want.values()):
                fail(f"rep {i} launched {rec['launches']}; its LM and CG "
                     f"counts imply {want}")
            seen.add(fingerprint(res, chi2))
            recs.append(rec)
            print("[rep] " + json.dumps(dict(rep=i, **rec)), flush=True)
    finally:
        gc.callbacks.remove(clock)
    after = gpu_sample(dev.index)
    chip_smoke.say("clocks", when="after", **after, at_s=at())
    if len(graphs.LOG) != built + 1:
        fail(f"the reps captured {len(graphs.LOG) - built - 1} programs")

    traced = []
    prof = chip_smoke.device_profile(lambda: traced.append(solve(prob)))
    seen.add(fingerprint(*traced[-1]))
    if len(seen) != 1:
        fail(f"the solves differ (chi^2 hex, LM, accepted, CG): {seen}")
    for v in (res.q, res.t, res.switch):
        if not bool(torch.isfinite(v).all()):
            fail("a non-finite solution")
    if tuple(res.q.shape) != (prob.n_cap, 4):
        fail(f"solution shape {tuple(res.q.shape)}")
    chi2_64 = chip_smoke.fp64_chi2(prob, res)
    if not abs(chi2_64 - chi2) <= FP64_AGREEMENT * abs(chi2_64):
        fail(f"chi^2 {chi2} against its fp64 re-evaluation {chi2_64}")
    ref = chi2_ref(args.seed, args.nodes, args.loops)
    bar = chi2_bar(args.seed, args.nodes, args.loops)
    if not chi2_passes(chi2, bar):
        fail(f"chi^2 {chi2} above the bar {bar} (reference {ref})")

    # the counters add each piece's captured launches per run of it; the
    # profiler sees the launches that ran on the card
    want = chip_smoke.solve_launches(traced[-1][0],
                                     PRODUCT["max_cg_iterations"])
    seen_launches = {"band_matvec": prof["k1"]["launches"],
                     "gj_inv": prof["k2"]["launches"]}
    if (seen_launches != {k: want[k] for k in seen_launches}
            or want != recs[-1]["launches"]):
        fail(f"the traced solve ran {seen_launches} launches on the card; "
             f"its LM and CG counts imply {want}, and the counters counted "
             f"{recs[-1]['launches']} in the last rep")
    ms = [r["ms"] for r in recs]
    stats = summary(ms)
    chip_smoke.say("traced", **{k: (json.dumps(v, separators=(",", ":"))
                                    if isinstance(v, (dict, list)) else v)
                                for k, v in prof.items()},
                   overhead_ms=prof["profiled_wall_ms"] - stats["median"],
                   at_s=at())
    print(card, flush=True)
    print(json.dumps(dict(
        metric=metric_name(args.nodes, args.loops), value=stats["median"],
        unit="ms", backend="cuda", card=name.strip(),
        power_limit_w=float(limit.strip().split()[0]), reps=args.reps,
        p25=stats["p25"], p75=stats["p75"], min=stats["min"],
        max=stats["max"], all_ms=ms, chi2=chi2, chi2_fp64_eval=chi2_64,
        chi2_ref=ref, chi2_bar=bar, seed=args.seed, nodes=args.nodes,
        loops=args.loops, lm_iterations=int(res.iterations),
        accepted=int(res.successful_steps),
        cg_iterations=int(res.total_cg_iterations),
        k1_launches=recs[-1]["launches"]["band_matvec"],
        k2_launches=recs[-1]["launches"]["gj_inv"],
        k1_launches_traced=seen_launches["band_matvec"],
        k2_launches_traced=seen_launches["gj_inv"],
        device_ms=prof["device_ms"], idle_share=prof["idle_share"],
        idle_share_of_median=1.0 - prof["device_ms"] / stats["median"],
        traced_wall_ms=prof["profiled_wall_ms"],
        thread_ms_median=float(np.median([r["thread_ms"] for r in recs])),
        **{k + "_median": float(np.median([r[k] for r in recs]))
           for k in ("python_probe_ms", "launch_probe_us")},
        gc_ms_total=sum(r["gc_ms"] for r in recs), warmup_ms=warmup_ms,
        capture=capture, host=host, corr=correlations(recs), main_s=at())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
