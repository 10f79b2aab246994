#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root)

Phases, one printed line each (or a few):
  1. device: requires CUDA and prints the card's name and power limit and
     its memory state, and opens cuBLAS and cuSOLVER before anything else
     (waiting up to 120 s while another process holds the card's memory),
     then one torch.profiler session (prime_profiler);
  2. build: compiles both hand-written kernels and the loops' library
     (csrc/graph_loops.cu) from csrc/ with nvcc, all started together;
  3. kernel K1 (band matvec) against its plain PyTorch version on the card,
     at N = 32768 (the capacity ceiling of phase 15), 8192 (the main path),
     5120, 5000 (not a multiple of the tile) and 4099 (not a multiple of 4:
     the one-element-copy path), F = 1, 5 and 8, fp32 and fp64, with times
     (also with the L2 cache flushed at the two path shapes), the bound and
     its share;
  4. kernel K2 (batched SPD inverse) against its plain version and an fp64
     torch.linalg.inv, at d = 12, 30, 36, 64 and n = 4096 (phase 15's first
     K2 call), 1024, 512, 1, fp32 and fp64, with times, the bound and
     torch.linalg.inv's time; then the strided odd blocks A[1::2]
     of a 2048 and an 8192 batch read in place: equal to the contiguous
     call, and best_inv hands the view's own pointer to one launch,
     allocating nothing beyond the output;
  4b. precond: the preconditioner apply's kernels (csrc/bcr_apply.cu)
     against their plain twin on the main path's operands (the circle
     graph's reduced system at its start) at the 5k and 30k buckets, at
     odometry fanout 5 (the product's, d = 30) and 1 (d = 6), fp32 and
     fp64, bcr_levels 2 (the product's), 0, 1 and None, with and without
     the coarse term, the result row-major and node-major (the mesh's),
     each apply's launches as launches_per_apply says; at fanout 5,
     bcr_levels 2 and row-major the time per apply (by events, and replayed
     from a CUDA graph as a solve runs it, also after a read that evicts
     the L2 cache) beside the factor's bytes bound and the plain twin's;
     then a graphed 5k/10k product solve and its mixed rung, each
     launching the apply's fp32 entry points once per CG and LM
     iteration;
  5. the port's main path: one lm_solve at the product defaults on the
     5,000-node / 10,000-loop-edge circle graph (the bench graph), with both
     kernels' launch counts, chi^2 (also re-evaluated in fp64) against the
     fp64 exact-step reference, the LM and CG counts and the median time per
     solve; then the same solver on a small graph on the card and on the
     CPU, which must agree. On the card lm_solve launches the composed
     solve executable of the problem's bucket once (ops/graphs.py: its LM
     and CG loops in conditional WHILE nodes, csrc/graph_loops.cu), its
     pieces captured by its first call, so every phase from here on times
     graphed solves; the main path's solve must be one launch of it and
     one host read;
  6. the streaming engine answering four triggers of a 2,000-node stream,
     after warmup() (which loads the host fp64 rung on its own thread),
     each trigger escalated (forced) to the host rung in the background:
     the first escalation's wall beside its rung's own total_s;
  7. escalation: the mixed rung on the phase-5 bench problem
     (lm_solve(precision="mixed"): fp64 assembly, cost and state, K1 and K2
     in fp32, every launch of the fp32 entry points), within 2% of the
     fp64 reference chi^2 and 5e-3 of phase 5's fp32 chi^2, with the median
     time per solve; then the problem (fp32) through escalate_resolve with
     escalation forced, on the host fp64 rung ("auto") and on the device
     ladder ("tpu": the mixed rung, then the fp64 rung with K1 and K2 in
     fp64, launches split by precision as the rung statistics imply),
     each landing within 2% of the fp64 reference chi^2, with wall times;
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
     checkpoint, then `replay --load-dir` restoring the checkpoint;
 10. serve: the port server on a Unix socket in a thread, on the bounded
     native store; a client streams 2,000 nodes, their loop edges and a
     kidnap/unkidnap pair, asks every query kind and shuts it down;
 11. two-grid: lm_solve with the multiplicative band*coarse preconditioner
     on the phase-5 bench problem, fp32, within 2% of the fp64 reference
     chi^2, with the median time per solve;
 12. four-dof: lm_solve with the 4-DOF residual family at the product
     defaults on the same problem, fp32: the final chi^2 at most 1e-9 of
     the initial, the share of switches below 0.5, the median time per
     solve; a 300-node 4-DOF graph in fp64 on the card and on the CPU,
     which must agree to 1e-9 in chi^2; and the bench problem through
     escalate_resolve with escalation forced under "auto", which for this
     family must take the device ladder (the mixed rung, then the fp64
     rung);
 13. incremental: phase 9's stream through the CLI's `replay --config`
     with stream.incremental_build on and off: the same final poses and
     switches, bit for bit, delta builds only when on, and the median
     problem-build time per trigger both ways;
 14. mesh: the solve over a mesh of shards that all sit on this card
     (parallel/), through the composed executables as on one device
     (ops/graphs.py serves such a mesh; each line says its route,
     graphs or eager): (a) the phase-5 problem at the product defaults on
     4 shards, fp32: the eager mesh solve (lm._lm_solve_eager), then the
     graphed mesh in its solve form (one launch, one host read) and its
     step form (an init and a step per LM iteration under a dispatch
     lock), each bit for bit the eager one; K1 launched 4 times per CG
     iteration that ran (eager: of the cap) and K2 3 times per LM
     iteration; within 2% of the fp64 reference and 1e-3 of the
     single-device chi^2 of this run; the graphed mesh, the eager mesh
     and the single device timed in turns (3 reps), then one more graphed
     solve under the profiler (device time, idle share); (b) the
     __graft_entry__.dryrun_multichip certificate on the card: the same
     graph in fp64 on 8 shards (band+coarse, coarse_group 64, bcr_levels
     2, 2 LM / 8 CG), graphed and bit for bit its eager form, against
     the unsharded fp64 solve, to 1e-9 in chi^2, q and switches and 1e-8
     in t, with equal counts; (c) pcg_sharded on phase 5's first reduced
     system on 8 shards, its solution's relative residual in the
     single-device reduced matvec below 1e-4, and the sharded halo matvec
     (K1) against the single-device reduced_matvec_t (K1); (d) phase 9's
     stream through SolverEngine on 4 shards of the card, after
     warmup(5000, 2500, proportional=False) of the mesh's buckets
     (re-sharding every trigger, the full build, the graphed solve, the
     write-back from the gathered result) against the unmeshed engine of this run, warmed the same
     way, in fp64: 0 captures on the mesh's trigger path, the same
     triggers and LM counts, poses within 1e-8 of their scale, and the
     trigger walls of both; (e) the phase-5 problem (fp32) on
     4 shards through escalate_resolve's device ladder with a dispatch
     lock (the mixed rung on the shards, then the fp64 rung sharded again
     over the mesh, each in the step form) against the unmeshed ladder,
     within 1e-3 in chi^2. With two or more cards (a) also runs across
     distinct cards, eagerly (a conditional node's body runs on one
     device);
 15. capacity: the reference's ceiling of 30,000 nodes and 30,000 loop
     edges (circle graph, n_cap = e_cap = 32768, fp32) through lm_solve at
     the product defaults (coarse group 128, K1 at N = 32768, K2 on 4096,
     2048 and 2048 blocks): chi^2 within 2% of the JAX package's 5.9532
     and within 1e-4 of its fp64 re-evaluation, 10 LM iterations, every
     launch on the fp32 entry points, the median and spread of 5 timed
     solves, the peak memory, and one more counted solve under
     torch.profiler (device time by kernel, the card's idle share of the
     wall), bit for bit the first; then the device
     ladder forced on it (the mixed rung, then the fp64 rung), its launches
     split by precision, its chi^2 no worse than the mixed rung's;
 16. capacity_stream: a 30,000-node / 3,000-loop circle graph streamed
     node by node into SolverEngine at the default Config (after warmup),
     a trigger polled every 1,000 nodes after a 2 s pause, the
     escalation ladder forced on the first trigger from node 20,000 (the
     32768 bucket), then drain, one settle trigger and drain: the forced
     escalation lands on the host fp64 rung, applied, at least one trigger
     is served after it, the settle chi^2 is within 1e-4 of its fp64
     re-evaluation; trigger walls, build times at and between bucket
     doubles, the peak memory, the trigger captures and the triggers that
     the bucket cover moved out of their exact bucket (the warmup is the
     proportional ladder, which leaves buckets out);
 17. bench: `bench_torch.py --reps 5` in a process of its own, as a user
     runs it: it exits 0, its last line parses, its chi^2 is within the
     bar (<= 1.02 x 0.4038), each rep launched K1 318 (one per CG
     iteration that ran) and K2 30 times, and
     it names this card; its result line is printed on a [bench] line;
 18. graphs: the composed solve against the eager loop
     (lm._lm_solve_eager): (a) the phase-5 problem through its Program
     (built afresh) in both forms, the solve executable (one launch, one
     host read) and the step executable per LM iteration under a dispatch
     lock (1 + LM iterations launches, LM iterations + 2 host reads),
     against the eager solve: every result field bit for bit, K1 318 /
     K2 30 per graphed solve (450 / 30 eager), the build's warm-up,
     capture and composition ms and pool MB, 5 reps of each of the three
     in turns, then one more counted solve under the profiler, bit for
     bit the eager one; (b) the same at 30k/30k;
     (c) phase 9's stream through SolverEngine, eager and then graphed
     after warmup(5000, 10000, proportional=False): 0 captures on the
     trigger path, the same poses, switches and counts, trigger median
     and p90 of both; then the bucket cover: the stream graphed after
     warmup(5000, 2500), the proportional ladder of its sizes (11
     buckets where the product has 28), each trigger in its exact bucket
     or the smallest captured one that holds it (read through a wrapper
     on lm_solve), 0 captures on the trigger path, bit for bit an eager
     twin given the same warmup call; the warmup's buckets, wall and
     pools, each covered trigger's solve ms against its exact-box solve
     in the full-product run and the capture and composition that bucket
     cost there, trigger median, p90 and max of both runs;
     (d) phase 7's mixed rung as (a), K1 and K2 in fp32;
     (e) band*coarse and (f) 4-DOF as (a), 3 reps;
 19. stream_rows: `bench_stream_torch.py --only streaming_warm,
     multiworld,cover --procs 1` in processes of its own, as a user runs
     it (the engine rows of benchmarks/run_baseline.py and the bucket
     cover's): it exits 0 with every gate of its rows held (chi^2 within
     2% of the JAX rows', 0 trigger captures after warmup, launches as the
     LM and CG counts imply, 3 worlds in 1 set, the cover's boxes as
     planned), its last line parses, names this card and holds the three
     rows; their trigger median and p90, chi^2, and the cover's solve ms
     in (4096, 4096) against (2048, 4096) go on a [stream-rows] line.
Phase 14 runs after phase 16: in one process each torch.profiler session
over composed executables after the first misread more of their kernels
(PERF.md), and phase 15's profiled solve is the one that PERF.md's
capacity figures come from.
`--only k1,k2` (any of the phase names in PHASES) runs a subset and prints
no result line. Each path of phases 5, 7-16 and 18 is run with the kernels'
launch counts set to 0 just before it and read just after (a graphed
solve adds what each piece's capture launched times the runs of the
piece that the device counted, and raises unless those are init once,
pre and post per LM iteration and cg_iter per CG iteration; the eager
warm-up of each piece with which a Program's build begins launches for
real and is counted, and the checks below set it aside: PATH_WARMUP).
The device counts each piece's runs, and lm_solve fails unless they are
what the result's LM and CG counts say; the profiler is a second
witness: each profiled graphed solve (phases 15 and 18 in this process,
each a counted run; phase 17's bench in its own; phase 19's harness
counts its rows in their processes) is held to the K1 and
K2 launches that the counters counted, the result line's
`launches_measured` holds what it saw (PROFILED) and
`profiler_disagrees` where that differed (DISAGREED: printed, not
failed, see check_profiled); phase 17's bench counts its own reps in its
process; phase 8's
exact-step self-reference, phase 12's CPU solve and phase 14's unsharded
references run outside them); where
the code fixes a path's launches by its LM and CG counts, they must match
(expected_launches, solve_launches, ladder_launches: K1 once per CG
iteration that ran on a graphed solve, one card's or a one-card mesh's
(once per shard), and per CG iteration of the cap on an eager one (the
eager references, a mesh over distinct cards); the preconditioner
apply's launches_per_apply once per CG and per LM iteration, once per
card on a mesh, once per shard in pcg_sharded). Then a JSON line with each kernel's
numbers (launches summed over those paths, and by path), the card line
again, and last {"ok": true, "device": {...}}. Any failed check raises and
exits non-zero before that last line; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import itertools
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from solve_keyframe_pose_graph_tpu_torch import certify, cli
from solve_keyframe_pose_graph_tpu_torch.compose.composer import Composer
from solve_keyframe_pose_graph_tpu_torch.config import Config
from solve_keyframe_pose_graph_tpu_torch.graph import (
    messages, native, store as store_mod, synthetic,
)
from solve_keyframe_pose_graph_tpu_torch.ops import _kernels, band_matvec, gn
from solve_keyframe_pose_graph_tpu_torch.ops import bcr_apply
from solve_keyframe_pose_graph_tpu_torch.ops import coarse as coarse_ops
from solve_keyframe_pose_graph_tpu_torch.ops import graph_loops, graphs
from solve_keyframe_pose_graph_tpu_torch.ops import lm as lm_ops
from solve_keyframe_pose_graph_tpu_torch.ops import smallinv
from solve_keyframe_pose_graph_tpu_torch.ops.lm import lm_solve
from solve_keyframe_pose_graph_tpu_torch.parallel import (
    make_mesh, shard_problem, unshard,
)
from solve_keyframe_pose_graph_tpu_torch.parallel.sharded_lm import (
    HaloMatvec,
)
from solve_keyframe_pose_graph_tpu_torch.parallel.sharded_pcg import (
    pcg_sharded, split_nodes,
)
from solve_keyframe_pose_graph_tpu_torch.parallel.sharding import (
    edge_layout,
)
from solve_keyframe_pose_graph_tpu_torch.runtime_server import (
    PoseGraphServer,
)
from solve_keyframe_pose_graph_tpu_torch.solver import native_ldl
from solve_keyframe_pose_graph_tpu_torch.solver.engine import (
    SolverEngine, _bucket,
)
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
WRAPPERS = {"band_matvec": band_matvec.band_matvec, "gj_inv": smallinv.gj_inv,
            "precond_apply": bcr_apply.precond_apply}
# the wrapper that counts each C entry point's launches, by entry prefix
ENTRY_WRAPPER = {"kpg_band_matvec_": "band_matvec", "kpg_gj_inv_": "gj_inv",
                 "kpg_bcr_apply_": "precond_apply"}
# launches of one preconditioner application at PRODUCT (bcr_levels 2): two
# per reduction level and the coarse aggregate sums; band*coarse's two-grid
# applies the band part alone, once
PER_APPLY = 2 * PRODUCT["bcr_levels"] + 1
PER_APPLY_TWO_GRID = 2 * PRODUCT["bcr_levels"]
PATH_LAUNCHES: dict = {}   # path -> {kernel: launches in that path's run}
PATH_WARMUP: dict = {}     # path -> {C entry point: launches of the eager
                           # step with which each graph capture in that
                           # run began (graphs.WARMUP_LAUNCHES)}
PROFILED: dict = {}        # path -> {kernel: launches the profiler saw in
                           # one replayed solve of the path}
DISAGREED: dict = {}       # path -> what the profiler saw and the counters
                           # counted, where they differ (check_profiled)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line(index=None) -> str:
    """nvidia-smi's name and power limit: of every card, or of one."""
    which = [] if index is None else [f"--id={index}"]
    out = subprocess.run(
        ["nvidia-smi", *which, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def event_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median over `reps` calls of the device time per call, after warmup:
    CUDA events around one call, queued behind a GPU sleep that outlasts
    the host's time to enqueue the call, so that the interval holds the
    call's device work and not the host's launch overhead (which, at a
    few microseconds of kernel, would otherwise be most of it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4e9 * host_s) + 200_000     # >= 2x the enqueue at <= 2 GHz
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
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
    before it, and record them just after (all its threads joined), with
    the launches of the eager warm-up steps of the graphs it captured."""
    for w in WRAPPERS.values():
        w.launches = 0
    warm = dict(graphs.WARMUP_LAUNCHES)
    yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    PATH_LAUNCHES[path] = {k: w.launches for k, w in WRAPPERS.items()}
    PATH_WARMUP[path] = {e: n - warm.get(e, 0)
                         for e, n in graphs.WARMUP_LAUNCHES.items()
                         if n - warm.get(e, 0)}


def kernel_of(entry: str) -> str:
    """The wrapper (WRAPPERS key) that counts C entry point `entry`."""
    return next(k for p, k in ENTRY_WRAPPER.items() if entry.startswith(p))


def net_launches(path: str) -> dict:
    """A path's launches without its graph captures' warm-up steps: what
    its solves' LM and CG counts fix."""
    net = dict(PATH_LAUNCHES[path])
    for e, n in PATH_WARMUP.get(path, {}).items():
        net[kernel_of(e)] -= n
    return net


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
        cuda=torch.version.cuda, nvidia_smi=repr(card), **memory_state())
    open_library_handles(torch.device("cuda", 0))
    prime_profiler(torch.device("cuda", 0))
    return card


def memory_state() -> dict:
    """The card's free and total memory as this process sees it, and the
    compute processes that nvidia-smi lists on it (this one included)."""
    free, total = torch.cuda.mem_get_info(0)
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().replace("\n", "; ")
    return dict(free_mib=free >> 20, total_mib=total >> 20,
                reserved_here_mib=torch.cuda.memory_reserved(0) >> 20,
                compute_apps=repr(apps), pid=os.getpid())


def open_library_handles(dev, wait_s: float = 120.0) -> None:
    """Create this thread's cuBLAS and cuSOLVER handles (a matmul, an
    inverse, a Cholesky) before any kernel library loads. Creating a
    handle allocates on the card outside PyTorch's allocator and fails
    with CUBLAS_STATUS_ALLOC_FAILED when the card's memory is held
    elsewhere, as another process can still hold it when this run starts:
    then wait for it, up to `wait_s`, printing the memory state, and fail
    with that state."""
    A = torch.eye(30, dtype=torch.float64, device=dev).expand(4, 30, 30)
    t0 = time.perf_counter()
    while True:
        try:
            float((A @ A).sum() + torch.linalg.inv(A).sum()
                  + torch.linalg.cholesky_ex(A)[0].sum())
            break
        except RuntimeError as e:
            state = memory_state()
            say("device", library_handles="failed", error=repr(str(e)[:200]),
                **state)
            if time.perf_counter() - t0 > wait_s:
                raise RuntimeError(f"cuBLAS / cuSOLVER handles could not be "
                                   f"created within {wait_s} s: {e}; card "
                                   f"memory {state}") from e
            torch.cuda.empty_cache()
            time.sleep(5.0)
    say("device", library_handles="open",
        wait_s=round(time.perf_counter() - t0, 3), **memory_state())


def phase_build() -> None:
    """The kernels' and the loops' nvcc builds, started together."""
    kernels = (("band_matvec", band_matvec._ENTRIES),
               ("gj_inv", smallinv._ENTRIES),
               ("bcr_apply", bcr_apply._ENTRIES),
               ("graph_loops", graph_loops._ENTRIES))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        paths = list(pool.map(_kernels.build, [k for k, _ in kernels]))
    for (name, entries), path in zip(kernels, paths):
        _kernels.load(name, entries)
        say("build", kernel=name, library=path)
    say("build", parallel_seconds=f"{time.perf_counter() - t0:.2f}",
        graph_loops_cuda=json.dumps(graph_loops.versions()))


# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, and FLOP/s outside
# the tensor cores by element size
HBM_BPS = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}
K1_MAIN = (8192, 5)        # (N, F) of the main path's K1 calls
K2_MAIN = (1024, 30)       # (n, d) of the main path's first K2 call
# the same at the capacity ceiling (n_cap 32768, phase 15): K1 at N =
# n_cap, and K2's first call on Mp/2 odd super-nodes, Mp = next_pow2(
# ceil(32768 / 5)) = 8192 (ops/band.py)
K1_CAP = (32768, 5)
K2_CAP = (4096, 30)


def bound(nbytes: float, flops: float, elsize: int) -> tuple[float, str]:
    """(least time in ms the card could take, the resource that sets it):
    each input read once and each output written once at HBM_BPS, or the
    operations at the peak rate of their type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[elsize]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cold_event_ms(fn, reps: int = 30) -> float:
    """Median CUDA-event time per call with the 50 MB L2 cache flushed
    (a 256 MB write) before each call, outside the timed interval."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_k1(dev) -> dict:
    """K1 against its plain version at the main path's shape, at the
    capacity ceiling's and at N not a multiple of the tile (5000) or of 4
    (4099, the one-element-copy path), F = 1, 5 and 8, fp32 and fp64. The
    main path's numbers come back, with the capacity shape's under
    "capacity"."""
    rng = np.random.default_rng(1)
    out, cap = {}, {"N": K1_CAP[0], "F": K1_CAP[1]}
    for N in (K1_CAP[0], 8192, 5120, 5000, 4099):
        for F in (1, 5, 8):
            for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
                D, B, x = (torch.tensor(rng.normal(size=s), dtype=dt,
                                        device=dev)
                           for s in ((36, N), (F, 36, N), (6, N)))
                y = band_matvec.band_matvec(D, B, x)
                ref = band_matvec.band_matvec_plain(D, B, x)
                torch.cuda.synchronize()
                abs_err, rel = rel_err(y, ref)
                if not rel <= tol:
                    raise AssertionError(f"K1 disagrees at N={N} F={F} {dt}: "
                                         f"rel err {rel} > {tol}")
                wide = band_matvec.takes_16_byte_copies(D, B, x)
                if wide != (N * x.element_size() % 16 == 0):
                    raise AssertionError(f"K1 at N={N} {dt} took the "
                                         f"16-byte-copy path: {wide}")
                es = x.element_size()
                b_ms, b_by = bound((36 + 36 * F + 12) * N * es,
                                   2 * 6 * (6 + 12 * F) * N, es)
                ms = event_ms(lambda: band_matvec.band_matvec(D, B, x))
                row = dict(N=N, F=F, dtype=str(dt).split(".")[1],
                           max_rel_err=rel, max_abs_err=abs_err, tol=tol,
                           copies="16B" if wide else "element",
                           kernel_ms=ms, bound_ms=b_ms, bound_by=b_by,
                           bound_share=b_ms / ms)
                if F == 5:
                    row["plain_ms"] = event_ms(
                        lambda: band_matvec.band_matvec_plain(D, B, x))
                if (N, F) in (K1_MAIN, K1_CAP):
                    row["kernel_ms_cold_l2"] = cold_event_ms(
                        lambda: band_matvec.band_matvec(D, B, x))
                say("k1", **row)
                if (N, F) == K1_MAIN and dt == torch.float32:
                    out = dict(max_abs_err=abs_err, ms=ms,
                               plain_ms=row["plain_ms"], bound_ms=b_ms,
                               bound_by=b_by, bound_share=b_ms / ms,
                               ms_cold_l2=row["kernel_ms_cold_l2"],
                               library_ms=None,
                               library_note="no single PyTorch call computes "
                               "a block-banded matvec from these arrays")
                if (N, F) == K1_CAP:
                    cap[row["dtype"]] = {k: row[k] for k in (
                        "kernel_ms", "kernel_ms_cold_l2", "plain_ms",
                        "bound_ms", "bound_by", "bound_share",
                        "max_abs_err")}
    return dict(out, capacity=cap)


def spd_batch(rng, n: int, d: int, dev) -> torch.Tensor:
    G = rng.normal(size=(n, d, d))
    return torch.tensor(G @ np.swapaxes(G, -1, -2) / d + 0.5 * np.eye(d),
                        device=dev)


def phase_k2(dev) -> dict:
    """K2 against its plain version and an fp64 torch.linalg.inv at d = 12,
    30, 36 and 64 and n = 4096 (the capacity ceiling's), 1024, 512 and 1,
    fp32 and fp64; the strided odd blocks A[1::2] read in
    place (no copy) at the main path's and the capacity's n;
    torch.linalg.inv timed beside the kernel as the library yardstick (the
    port never calls it). The main path's numbers come back, with the
    capacity shape's under "capacity"."""
    rng = np.random.default_rng(2)
    out, cap = {}, {"n": K2_CAP[0], "d": K2_CAP[1]}
    tols = ((torch.float32, 1e-4), (torch.float64, 1e-10))
    for d in (12, 30, 36, 64):
        for n in (K2_CAP[0], 1024, 512, 1):
            A64 = spd_batch(rng, n, d, dev)
            exact = torch.linalg.inv(A64)
            for dt, tol in tols:
                A = A64.to(dt)
                X = smallinv.gj_inv(A)
                P = smallinv.gj_inv_plain(A)
                torch.cuda.synchronize()
                _, rel = rel_err(X, exact)
                abs_plain, rel_plain = rel_err(X, P)
                if not (rel <= tol and rel_plain <= tol):
                    raise AssertionError(
                        f"K2 disagrees at n={n} d={d} {dt}: rel err {rel} vs "
                        f"fp64 inverse, {rel_plain} vs plain, tol {tol}")
                es = A.element_size()
                b_ms, b_by = bound(2 * n * d * d * es, 2 * d ** 3 * n, es)
                row = dict(n=n, d=d, dtype=str(dt).split(".")[1],
                           max_rel_err_vs_fp64_inv=rel,
                           max_rel_err_vs_plain=rel_plain, tol=tol,
                           max_abs_err=abs_plain,
                           kernel_ms=event_ms(lambda: smallinv.gj_inv(A)),
                           bound_ms=b_ms, bound_by=b_by)
                row["bound_share"] = b_ms / row["kernel_ms"]
                if d == 30 and n > 1:
                    row["plain_ms"] = event_ms(
                        lambda: smallinv.gj_inv_plain(A))
                    row["library_ms"] = event_ms(lambda: torch.linalg.inv(A))
                say("k2", **row)
                if (n, d) == K2_MAIN and dt == torch.float32:
                    if row["kernel_ms"] > row["library_ms"]:
                        raise AssertionError(
                            f"K2 {row['kernel_ms']} ms is slower than "
                            f"torch.linalg.inv {row['library_ms']} ms")
                    out = dict(max_abs_err=abs_plain, ms=row["kernel_ms"],
                               plain_ms=row["plain_ms"], bound_ms=b_ms,
                               bound_by=b_by, bound_share=row["bound_share"],
                               library_ms=row["library_ms"],
                               library_note="torch.linalg.inv, same dtype")
                if (n, d) == K2_CAP:
                    cap[row["dtype"]] = {k: row[k] for k in (
                        "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "bound_share", "max_abs_err")}
    for n, d in (K2_MAIN, K2_CAP):
        ms = k2_strided(rng, n, d, dev, tols)
        if (n, d) == K2_CAP:
            cap["strided_kernel_ms"] = ms
    return dict(out, capacity=cap)


def k2_strided(rng, n: int, d: int, dev, tols) -> dict:
    """The cyclic reduction's odd blocks: A[1::2] of a 2n batch, a strided
    view that K2 reads in place. Returns the kernel's time by dtype."""
    whole = spd_batch(rng, 2 * n, d, dev)
    exact = torch.linalg.inv(whole[1::2])
    times = {}
    for dt, tol in tols:
        A = whole.to(dt)[1::2]
        if A.is_contiguous() or smallinv.batch_stride(A) != 2 * d * d:
            raise AssertionError(f"A[1::2] strides {A.stride()}")
        X = smallinv.gj_inv(A)
        C = smallinv.gj_inv(A.contiguous())
        torch.cuda.synchronize()
        _, rel = rel_err(X, exact)
        if not (torch.equal(X, C) and X.is_contiguous() and rel <= tol):
            raise AssertionError(f"K2 on A[1::2] n={n} {dt}: equal to the "
                                 f"contiguous call {torch.equal(X, C)}, "
                                 f"rel err {rel} vs fp64 inverse")
        # best_inv hands the view itself to the kernel: one launch, the
        # view's own data pointer, and no memory beyond the output
        lib = _kernels.load("gj_inv", smallinv._ENTRIES)
        entry = ("kpg_gj_inv_f32" if dt == torch.float32
                 else "kpg_gj_inv_f64")
        real = getattr(lib, entry)
        seen = []

        def spy(*args, real=real, seen=seen):
            seen.append(args[0])
            return real(*args)

        setattr(lib, entry, spy)
        try:
            launches = smallinv.gj_inv.launches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            Y = smallinv.best_inv(A)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - before
        finally:
            setattr(lib, entry, real)
        # a copy of the view would need as many bytes again as the output
        out_bytes = Y.numel() * Y.element_size()
        if not (seen == [A.data_ptr()] and out_bytes <= extra < 2 * out_bytes
                and smallinv.gj_inv.launches == launches + 1
                and torch.equal(Y, X)):
            raise AssertionError(
                f"best_inv(A[1::2]) n={n} {dt}: kernel pointers {seen} vs "
                f"view {A.data_ptr()}, {extra} B allocated for a "
                f"{out_bytes} B output, launches "
                f"{smallinv.gj_inv.launches - launches}")
        tag = str(dt).split(".")[1]
        times[tag] = event_ms(lambda: smallinv.gj_inv(A))
        say("k2-strided", n=n, d=d, dtype=tag,
            batch_stride=smallinv.batch_stride(A), max_rel_err_vs_fp64_inv=rel,
            equal_to_contiguous_call=True, best_inv_launches=1,
            best_inv_extra_bytes=extra, kernel_ptr_is_view_ptr=True,
            kernel_ms=times[tag])
    return times


# (n_cap, e_cap, nodes, loop edges) of the 5k and 30k cells' buckets
PRECOND_CASES = ((8192, 16384, 5000, 10000), (32768, 32768, 30000, 30000))


def precond_operands(prob, dtype, levels):
    """The main path's preconditioner operands on `prob` at its start, in
    `dtype`: (factor, coarse level, r = the reduced right-hand side)."""
    prob = problem_astype(prob, dtype)
    group = coarse_ops.auto_coarse_group(prob.n_cap)
    ops = lm_ops.DeviceOps(prob, preconditioner="band+coarse",
                           residual_mode="6dof", use_switch=True,
                           bcr_levels=levels, coarse_group=group)
    red = ops.reduce(ops.assemble(*ops.initial()),
                     torch.tensor(1e4, dtype=dtype, device=prob.device))[0]
    fac = lm_ops.band_factor(red.Dh, red.Bh, levels)
    Hc_inv, info = coarse_ops.build_coarse_inverse_arrays(
        red.Dh, red.Bh, red.Aba_h, prob.loop_b, prob.loop_a,
        prob.loop_rows_by_node, prob.fanout, group)
    coarse_ops.check_cholesky(info)
    return (fac, bcr_apply.Coarse(Hc_inv, prob.free_mask, group),
            red.rhs_n.contiguous())


def graphed_ms(fn, evict=None, reps: int = 30, calls: int = 10) -> float:
    """Median device time in ms of one fn() replayed from a CUDA graph, as
    a solve replays it: a graph of `calls` calls, timed by CUDA events, so
    that no host enqueue is timed (the apply is several launches, each a
    ctypes call). With `evict` (an L2-evicting read) before each call,
    the time of a graph of the evictions alone is taken off."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ms = []
    for body in ((lambda: (evict(), fn())) if evict else fn,
                 evict):
        if body is None:
            ms.append(0.0)
            continue
        graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                body()
        torch.cuda.current_stream().wait_stream(side)
        graph.replay()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms.append(float(np.median(times)) / calls)
    return ms[0] - ms[1]


def factor_bytes(fac, elsize: int) -> int:
    """The bytes of the factor an apply must read: each level's Aoinv, Co
    and Ce twice (forward and backward), the root blocks once."""
    d = fac.root_inv.shape[-1]
    blocks = (sum(6 * Ainv.shape[0] for Ainv, _, _ in fac.levels)
              + fac.root_inv.shape[0])
    return blocks * d * d * elsize


def phase_precond(dev, card: str) -> dict:
    """Phase 4b (see the module note). Returns the main path's row (5k,
    fp32) with the 30k bucket's under "capacity"."""
    out = {}
    big = torch.ones(48 << 20, device=dev)      # 192 MB, read to evict L2
    sink = torch.empty((), device=dev)

    def evict():
        torch.sum(big, dim=0, out=sink)

    for (n_cap, e_cap, n, loops), fanout in itertools.product(
            PRECOND_CASES, (5, 1)):
        prob = circle_problem(n, loops, n_cap, e_cap, np.float64, dev,
                              fanout=fanout)
        for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            for levels in (2, 0, 1, None):
                fac, coarse, r = precond_operands(prob, dt, levels)
                for c, node_major in itertools.product((coarse, None),
                                                       (False, True)):
                    before = bcr_apply.precond_apply.launches
                    got = bcr_apply.precond_apply(fac, r, c, node_major)
                    want = bcr_apply.precond_apply_plain(fac, r, c,
                                                         node_major)
                    torch.cuda.synchronize()
                    launched = bcr_apply.precond_apply.launches - before
                    abs_err, rel = rel_err(got, want)
                    if not (rel <= tol and got.stride() == want.stride()
                            and launched == bcr_apply.launches_per_apply(
                                fac, c is not None)):
                        raise AssertionError(
                            f"precond_apply at n_cap {n_cap}, fanout "
                            f"{fanout}, {dt}, bcr_levels {levels}, coarse "
                            f"{c is not None}, node-major {node_major}: "
                            f"rel err {rel} > {tol}, strides {got.stride()} "
                            f"or {launched} launches")
                    if levels != 2 or fanout != 5 or node_major:
                        say("precond", n_cap=n_cap, fanout=fanout,
                            dtype=str(dt)[6:], bcr_levels=levels,
                            coarse=c is not None, node_major=node_major,
                            max_rel_err=rel, tol=tol, launches=launched)
                        continue
                    es = r.element_size()
                    b_ms, b_by = bound(factor_bytes(fac, es), 0, es)
                    row = dict(
                        n_cap=n_cap, dtype=str(dt)[6:], bcr_levels=levels,
                        coarse=c is not None, d=fac.root_inv.shape[-1],
                        level_blocks=[A.shape[0] for A, _, _ in fac.levels],
                        root_blocks=fac.root_inv.shape[0], max_rel_err=rel,
                        max_abs_err=abs_err, tol=tol, launches=launched,
                        kernel_ms=event_ms(
                            lambda: bcr_apply.precond_apply(fac, r, c)),
                        kernel_ms_graphed=graphed_ms(
                            lambda: bcr_apply.precond_apply(fac, r, c)),
                        kernel_ms_graphed_l2_evicted=graphed_ms(
                            lambda: bcr_apply.precond_apply(fac, r, c),
                            evict),
                        plain_ms=event_ms(
                            lambda: bcr_apply.precond_apply_plain(fac, r, c)),
                        plain_ms_graphed=graphed_ms(
                            lambda: bcr_apply.precond_apply_plain(fac, r, c)),
                        factor_mb=factor_bytes(fac, es) / 1e6,
                        bound_ms=b_ms, bound_by=b_by)
                    row["bound_share"] = b_ms / row["kernel_ms"]
                    row["bound_share_l2_evicted"] = (
                        b_ms / row["kernel_ms_graphed_l2_evicted"])
                    say("precond", **row)
                    if c is not None:
                        key = "main" if n_cap == 8192 else "capacity"
                        out.setdefault(key, {})[row["dtype"]] = {
                            k: row[k] for k in (
                                "kernel_ms", "kernel_ms_graphed",
                                "kernel_ms_graphed_l2_evicted", "plain_ms",
                                "plain_ms_graphed", "factor_mb", "bound_ms",
                                "bound_share", "max_abs_err")}
        del prob
    # the graphed main path: every CG iteration's and every LM iteration's
    # apply through the kernels, fp32 entry points in the product and mixed
    # solves
    prob = circle_problem(5000, 10000, 8192, 16384, np.float32, dev)
    for precision in ("native", "mixed"):
        lm_solve(prob, precision=precision, **PRODUCT)   # captures
        before = dict(_kernels.ENTRY_LAUNCHES)
        res = lm_solve(prob, precision=precision, **PRODUCT)
        torch.cuda.synchronize()
        taken = {e: n - before.get(e, 0)
                 for e, n in _kernels.ENTRY_LAUNCHES.items()
                 if e.startswith("kpg_bcr_apply_") and n - before.get(e, 0)}
        per_apply = 2 * PRODUCT["bcr_levels"] + 1
        applies = int(res.total_cg_iterations) + int(res.iterations)
        want = {"kpg_bcr_apply_coarse_sum_f32": applies,
                "kpg_bcr_apply_forward_f32": 2 * applies,
                "kpg_bcr_apply_backward_f32": 2 * applies}
        if taken != want:
            raise AssertionError(f"a graphed {precision} solve of "
                                 f"{int(res.iterations)} LM and "
                                 f"{int(res.total_cg_iterations)} CG "
                                 f"iterations launched {taken}, not {want}")
        say("precond-graphed", precision=precision,
            lm_iterations=int(res.iterations),
            cg_iterations=int(res.total_cg_iterations),
            launches_per_apply=per_apply, launches=json.dumps(taken),
            card=repr(card))
    return out


def circle_problem(n, n_loops, n_cap, e_cap, dtype, device, outliers=0.2,
                   prior_w=1.1, seed=0, fanout=5):
    g = synthetic.circle_graph(n_nodes=n, n_loops=n_loops, seed=seed,
                               outlier_fraction=outliers)
    return build_problem_np(
        q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
        node_valid=np.ones(n, bool), loop_pairs=g.loop_pairs,
        loop_q=g.loop_q, loop_t=g.loop_t, loop_w=g.loop_w,
        loop_valid=np.ones(n_loops, bool), switch=np.full(n_loops, 0.99),
        prior_idx=np.array([0]), prior_q=g.vio_q[:1], prior_t=g.vio_t[:1],
        prior_w=np.array([prior_w]), n_cap=n_cap, e_cap=e_cap, p_cap=8,
        dtype=dtype, device=device, fanout=fanout)


def timed_solves(fn, reps: int = 3) -> list:
    """CUDA-event times in ms of `reps` calls of fn (a whole solve, which
    ends in a host read, so the host's enqueue is part of what it costs)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def phase_solve(dev, card: str) -> dict:
    t0 = time.perf_counter()
    prob = circle_problem(5000, 10000, 8192, 16384, np.float32, dev)
    torch.cuda.synchronize()
    say("solve", build_s=f"{time.perf_counter() - t0:.2f}",
        n_cap=prob.n_cap, e_cap=prob.e_cap, p_cap=prob.p_cap,
        dtype="float32", **PRODUCT)

    # the counted run: every launch between these two reads is the main path's
    execs, reads = dict(graphs.LAUNCHES), dict(graphs.HOST_READS)
    with counted("lm_solve"):
        res = lm_solve(prob, **PRODUCT)
    launches = PATH_LAUNCHES["lm_solve"]
    if not all(launches.values()):
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    # the solve went through one launch of the composed solve executable
    # (its LM and CG loops in WHILE nodes) and one host read
    execs = {n: graphs.LAUNCHES[n] - execs[n] for n in execs
             if graphs.LAUNCHES[n] - execs[n]}
    reads = sum(graphs.HOST_READS.values()) - sum(reads.values())
    if execs != {"solve": 1} or reads != 1:
        raise AssertionError(f"the main path launched {execs} with {reads} "
                             f"host reads")
    check_launches("lm_solve", solve_launches(res, PRODUCT[
        "max_cg_iterations"]))
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
    times = timed_solves(lambda: lm_solve(prob, **PRODUCT), reps=5)
    say("solve", chi2=chi2, chi2_fp64_eval=chi2_64, chi2_ref=CHI2_REF,
        initial_cost=float(res.initial_cost),
        lm_iterations=int(res.iterations),
        accepted=int(res.successful_steps),
        cg_iterations=int(res.total_cg_iterations),
        distress_rejects=int(res.distress_rejects),
        launches=json.dumps(launches, separators=(",", ":")),
        executables=json.dumps(execs), host_reads=reads,
        median_ms_per_solve=float(np.median(times)),
        all_ms=json.dumps([round(t, 3) for t in times]), card=repr(card))
    fp32_chi2 = chi2

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
    return fp32_chi2


def phase_engine(dev) -> None:
    """Four triggers of a 2,000-node stream, each escalated (forced) to the
    host fp64 rung in the background and drained before the next; warmup()
    first, which loads that rung on a thread of its own. The first
    escalation's wall beside its rung's own total_s shows what the
    escalation paid beyond the rung."""
    g = synthetic.circle_graph(n_nodes=2000, n_loops=1000, seed=1)
    store = native.make_store()
    cfg = Config()
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, escalate_rejects=0))
    eng = SolverEngine(store, cfg, device=dev)
    w0 = time.perf_counter()
    eng.warmup(2000, 1000)
    warm_s = time.perf_counter() - w0
    if not eng.warmup_join(timeout=300) or native_ldl._lib is None:
        raise AssertionError("warmup did not load the host fp64 rung")
    say("engine-warmup", warmup_s=round(warm_s, 4),
        join_s=round(time.perf_counter() - w0, 4), host_rung_loaded=True)
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
        st = [r for r in eng.solve_stats if "trigger_wall_ms" in r][-1]
        eng.drain()                    # the escalation lands before the next
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
    esc = [r for r in eng.solve_stats if r.get("background_escalation")]
    if len(esc) != 4 or any(r.get("escalated_rung") != "fp64-cpu"
                            for r in esc):
        raise AssertionError(f"escalations: {esc}")
    first = esc[0]
    rung_ms = 1000.0 * first["rung_stats"]["total_s"]
    say("engine-escalation", first_escalation_wall_ms=round(
        first["escalation_wall_ms"], 3), first_rung_total_ms=round(rung_ms, 3),
        outside_rung_ms=round(first["escalation_wall_ms"] - rung_ms, 3),
        later_walls_ms=json.dumps([round(r["escalation_wall_ms"], 3)
                                   for r in esc[1:]]),
        later_rung_total_ms=json.dumps([round(1000 * r["rung_stats"]
                                              ["total_s"], 3)
                                        for r in esc[1:]]))


@contextlib.contextmanager
def entry_points_taken():
    """Count the launches by kernel entry point (kpg_band_matvec_f32,
    ..._f64, kpg_gj_inv_f32, ...) in the context, from the counters
    (_kernels.ENTRY_LAUNCHES, to which a graph's replay adds what it
    launches), without the eager warm-up steps of graph captures."""
    taken: dict = {}
    before = dict(_kernels.ENTRY_LAUNCHES)
    warm = dict(graphs.WARMUP_LAUNCHES)
    try:
        yield taken
    finally:
        torch.cuda.synchronize()
        for e, n in _kernels.ENTRY_LAUNCHES.items():
            n -= before.get(e, 0) + graphs.WARMUP_LAUNCHES.get(e, 0) \
                - warm.get(e, 0)
            if n:
                taken[e] = n


def ladder_launches(res, rung: str, stats: dict) -> dict:
    """K1, K2 and preconditioner-apply launches of a graphed device-ladder
    escalation: the mixed rung (its LM and CG counts from the rung
    statistics), then, if it climbed, the fp64 rung (the result's counts);
    3 K2 per LM iteration, one K1 per CG iteration that ran and PER_APPLY
    per CG and per LM iteration."""
    mixed = stats["mixed_lm_iterations"]
    fp64 = int(res.iterations) if rung == "fp64" else 0
    k1 = stats["mixed_cg_iterations"] + (
        int(res.total_cg_iterations) if fp64 else 0)
    return {"band_matvec": k1, "gj_inv": 3 * (mixed + fp64),
            "precond_apply": PER_APPLY * (k1 + mixed + fp64)}


def by_precision(taken: dict) -> dict:
    """{kernel: {"f32": n, "f64": n}} of entry_points_taken's counts."""
    out = {k: {"f32": 0, "f64": 0} for k in WRAPPERS}
    for e, n in taken.items():
        out[kernel_of(e)][e.rsplit("_", 1)[1]] += n
    return out


def phase_escalation(dev, card: str, fp32_chi2=None) -> None:
    """The mixed rung on the phase-5 bench problem (fp32 K1 and K2 under an
    fp64 assembly), then the escalation ladder on it with escalation
    forced: the host fp64 rung ("auto"), and the device ladder ("tpu"),
    which runs the mixed rung and climbs to the fp64 rung (K1 and K2 in
    fp64)."""
    threads = min(8, os.cpu_count() or 1)
    torch.set_num_threads(threads)        # the host rung's CPU thread pool
    prob = circle_problem(5000, 10000, 8192, 16384, np.float32, dev)
    if fp32_chi2 is None:                 # phase 5 did not run
        fp32_chi2 = float(lm_solve(prob, **PRODUCT).final_cost)

    with counted("mixed"), entry_points_taken() as taken:
        res = lm_solve(prob, precision="mixed", **PRODUCT)
        chi2 = float(res.final_cost)
    check_launches("mixed", solve_launches(res, PRODUCT["max_cg_iterations"]))
    precision = by_precision(taken)
    if any(v["f64"] or v["f32"] != net_launches("mixed")[k]
           for k, v in precision.items()):
        raise AssertionError(f"the mixed rung's kernels ran {precision}, "
                             f"not all in fp32")
    if not (within_quality(chi2, CHI2_REF)
            and abs(chi2 - fp32_chi2) <= 5e-3 * fp32_chi2):
        raise AssertionError(f"mixed chi^2 {chi2} vs {CHI2_REF} and the fp32 "
                             f"solve's {fp32_chi2}")
    if not (res.q.dtype == res.final_cost.dtype == torch.float64
            and all(bool(torch.isfinite(v).all())
                    for v in (res.q, res.t, res.switch))):
        raise AssertionError(f"mixed result {res.q.dtype}, "
                             f"{res.final_cost.dtype}, or not finite")
    lm_solve(prob, precision="mixed", **PRODUCT)        # warm-up
    times = timed_solves(lambda: float(lm_solve(
        prob, precision="mixed", **PRODUCT).final_cost), reps=5)
    say("mixed", chi2=chi2, chi2_ref=CHI2_REF, gap=f"{chi2 / CHI2_REF - 1:+.4%}",
        fp32_chi2=fp32_chi2, rel_diff_vs_fp32=abs(chi2 - fp32_chi2)
        / fp32_chi2, initial_cost=float(res.initial_cost),
        lm_iterations=int(res.iterations), accepted=int(res.successful_steps),
        cg_iterations=int(res.total_cg_iterations),
        distress_rejects=int(res.distress_rejects),
        launches=json.dumps(PATH_LAUNCHES["mixed"], separators=(",", ":")),
        by_precision=json.dumps(precision, separators=(",", ":")),
        median_ms_per_solve=float(np.median(times)),
        all_ms=json.dumps([round(t, 3) for t in times]), card=repr(card))

    for backend, want in (("auto", "fp64-cpu"), ("tpu", "fp64")):
        path = f"escalation-{want}"
        with counted(path), entry_points_taken() as taken:
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
        precision = by_precision(taken)
        if rung == "fp64":
            want_n = ladder_launches(res, rung, stats)
            check_launches(path, want_n)
            # the mixed part in fp32, the fp64 part in fp64
            mixed_part = ladder_launches(res, "mixed", stats)
            split = {k: {"f32": mixed_part[k],
                         "f64": want_n[k] - mixed_part[k]} for k in want_n}
            if precision != split:
                raise AssertionError(f"device ladder ran {precision}, its "
                                     f"rungs imply {split}")
        elif any(n.values()):
            raise AssertionError(f"the host rung launched kernels: {n}")
        say("escalation", backend=backend, rung=rung, chi2=chi2,
            chi2_ref=CHI2_REF, gap=f"{chi2 / CHI2_REF - 1:+.4%}",
            wall_s=round(wall, 4),
            rung_stats=json.dumps({k: (round(v, 4) if isinstance(v, float)
                                       else v) for k, v in stats.items()}),
            lm_iterations=int(res.iterations),
            accepted=int(res.successful_steps),
            cg_iterations=int(res.total_cg_iterations),
            launches=json.dumps(n, separators=(",", ":")),
            by_precision=json.dumps(precision, separators=(",", ":")),
            torch_threads=threads, card=repr(card))


def expected_launches(rows: list, per_factor: int = 3) -> dict:
    """K1, K2 and preconditioner-apply launches of the graphed solves that
    wrote `rows`: `per_factor` K2 (bcr_levels + 1) per LM iteration, one K1
    per CG iteration that ran and PER_APPLY per CG and per LM iteration
    (an application at each CG start and one per CG iteration), for the
    fp32 trigger solves and the background escalations' device rungs (a
    "mixed" row's mixed rung, a "fp64" row's mixed rung from its rung_stats
    and then its fp64 rung); the host rung launches nothing."""
    k1 = lm = 0
    for r in rows:
        if "trigger_wall_ms" in r:
            k1 += r["cg_iterations"]
            lm += r["lm_iterations"]
        elif r.get("escalated_rung") in ("mixed", "fp64"):
            st = r["rung_stats"]
            fp64 = r["escalated_rung"] == "fp64"
            k1 += st["mixed_cg_iterations"] + (r["cg_iterations"]
                                               if fp64 else 0)
            lm += st["mixed_lm_iterations"] + (r["lm_iterations"]
                                               if fp64 else 0)
    return {"band_matvec": k1, "gj_inv": per_factor * lm,
            "precond_apply": PER_APPLY * (k1 + lm)}


def solve_launches(res, cg_cap: int, precond_matvecs: int = 0,
                   per_factor: int = 3, graphed: bool = True,
                   per_apply: int = PER_APPLY) -> dict:
    """K1, K2 and preconditioner-apply launches of one lm_solve with LM
    count res.iterations and CG count res.total_cg_iterations:
    `per_factor` K2 (bcr_levels + 1) per LM iteration; one K1 per CG
    iteration plus `precond_matvecs` in each preconditioner application
    (2 for band*coarse's two-grid), and `per_apply` apply launches in each
    (PER_APPLY_TWO_GRID for the two-grid), an application being one at
    each CG start and one per CG iteration. Graphed, the CG loop ends on
    the device, so a CG iteration is one that ran; eager (the CPU's loop
    on the card, a mesh), every one of the fixed cap."""
    it = int(res.iterations)
    cg = int(res.total_cg_iterations) if graphed else it * cg_cap
    return {"band_matvec": cg + precond_matvecs * (cg + it),
            "gj_inv": it * per_factor, "precond_apply": per_apply * (cg + it)}


def on_shards(want: dict, shards: int) -> dict:
    """The launches `want` of one device's solve on a mesh of `shards` on
    one card: K1 once per shard, K2 and the preconditioner apply once (the
    factorization and the apply are gathered)."""
    return dict(want, band_matvec=shards * want["band_matvec"])


def check_launches(path: str, want: dict) -> None:
    """The path's launches, its graph captures' warm-up steps aside, are
    what its LM and CG counts imply (`want`), and none is 0."""
    got = net_launches(path)
    if got != want or not all(want.values()):
        raise AssertionError(f"{path}: launched {PATH_LAUNCHES[path]}, of "
                             f"them {PATH_WARMUP.get(path)} in graph "
                             f"warm-ups; its LM and CG counts imply {want}")


def phase_two_grid(dev, card: str) -> None:
    """The multiplicative two-grid (band*coarse) on the bench problem."""
    prob = circle_problem(5000, 10000, 8192, 16384, np.float32, dev)
    kw = dict(PRODUCT, preconditioner="band*coarse")
    with counted("two-grid"):
        res = lm_solve(prob, **kw)
        chi2 = float(res.final_cost)
    check_launches("two-grid", solve_launches(
        res, kw["max_cg_iterations"], precond_matvecs=2,
        per_apply=PER_APPLY_TWO_GRID))
    if not within_quality(chi2, CHI2_REF):
        raise AssertionError(f"band*coarse chi^2 {chi2} not within "
                             f"{QUALITY:.0%} of {CHI2_REF}")
    if not all(bool(torch.isfinite(v).all()) for v in (res.q, res.t,
                                                        res.switch)):
        raise AssertionError("band*coarse: non-finite solution")
    times = timed_solves(lambda: float(lm_solve(prob, **kw).final_cost))
    say("two-grid", chi2=chi2, chi2_ref=CHI2_REF,
        gap=f"{chi2 / CHI2_REF - 1:+.4%}",
        initial_cost=float(res.initial_cost),
        lm_iterations=int(res.iterations),
        accepted=int(res.successful_steps),
        cg_iterations=int(res.total_cg_iterations),
        launches=json.dumps(PATH_LAUNCHES["two-grid"],
                            separators=(",", ":")),
        median_ms_per_solve=float(np.median(times)),
        all_ms=json.dumps([round(t, 3) for t in times]), card=repr(card))


def phase_four_dof(dev, card: str) -> None:
    """The 4-DOF residual family: the bench problem at the product
    defaults, a small fp64 graph on the card against the CPU, and the
    family's escalation, which only the device rung serves."""
    prob = circle_problem(5000, 10000, 8192, 16384, np.float32, dev)
    kw = dict(PRODUCT, residual_mode="4dof")
    with counted("four-dof"):
        res = lm_solve(prob, **kw)
        chi2 = float(res.final_cost)
    check_launches("four-dof", solve_launches(res, kw["max_cg_iterations"]))
    chi2_0 = float(res.initial_cost)
    if not (math.isfinite(chi2) and chi2 <= 1e-9 * chi2_0):
        raise AssertionError(f"4-DOF chi^2 {chi2} is not <= 1e-9 x the "
                             f"initial {chi2_0}")
    live = prob.loop_mask > 0.5
    off = float((res.switch[live] < 0.5).double().mean())
    if not all(bool(torch.isfinite(v).all()) for v in (res.q, res.t,
                                                        res.switch)):
        raise AssertionError("4-DOF: non-finite solution")
    times = timed_solves(lambda: float(lm_solve(prob, **kw).final_cost))
    say("four-dof", initial_chi2=chi2_0, chi2=chi2,
        final_over_initial=chi2 / chi2_0, switches_below_half=off,
        lm_iterations=int(res.iterations),
        accepted=int(res.successful_steps),
        cg_iterations=int(res.total_cg_iterations),
        launches=json.dumps(PATH_LAUNCHES["four-dof"],
                            separators=(",", ":")),
        median_ms_per_solve=float(np.median(times)),
        all_ms=json.dumps([round(t, 3) for t in times]), card=repr(card))

    # fp64 on the card (both kernels in fp64) and on the CPU: must agree
    g, c = (lm_solve(circle_problem(300, 40, 512, 64, np.float64, d,
                                    outliers=0.3, prior_w=2.0), **kw)
            for d in (dev, "cpu"))
    rel = abs(float(g.final_cost) - float(c.final_cost)) / float(c.final_cost)
    counts_equal = all(int(getattr(g, k)) == int(getattr(c, k))
                       for k in ("iterations", "successful_steps",
                                 "total_cg_iterations"))
    if not (counts_equal and rel <= 1e-9):
        raise AssertionError(f"4-DOF fp64: cuda vs cpu chi^2 rel diff {rel}, "
                             f"counts equal {counts_equal}")
    say("four-dof-small", cuda_chi2=float(g.final_cost),
        cpu_chi2=float(c.final_cost), rel_diff=rel,
        initial_chi2=float(c.initial_cost),
        cg_iterations=int(g.total_cg_iterations))

    # escalation: the host rung serves the 6-DOF family only
    with counted("escalation-4dof"):
        t0 = time.perf_counter()
        esc, rung, stats = lm_ops.escalate_resolve(prob, kw, 0,
                                                   fp64_backend="auto")
        chi2_esc = float(esc.final_cost)
        wall = time.perf_counter() - t0
    if rung != "fp64" or esc.q.dtype != torch.float64:
        raise AssertionError(f"4-DOF escalation took rung {rung!r} "
                             f"({esc.q.dtype}), expected the device ladder")
    check_launches("escalation-4dof", ladder_launches(esc, rung, stats))
    if not (math.isfinite(chi2_esc) and chi2_esc <= 1e-9 * chi2_0):
        raise AssertionError(f"4-DOF device rung chi^2 {chi2_esc} vs the "
                             f"initial {chi2_0}")
    say("four-dof-escalation", rung=rung, chi2=chi2_esc,
        wall_s=round(wall, 4), mixed_s=round(stats["mixed_s"], 4),
        mixed_lm_iterations=stats["mixed_lm_iterations"],
        mixed_cg_iterations=stats["mixed_cg_iterations"],
        lm_iterations=int(esc.iterations),
        cg_iterations=int(esc.total_cg_iterations),
        launches=json.dumps(PATH_LAUNCHES["escalation-4dof"],
                            separators=(",", ":")), card=repr(card))


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
        check_launches(path, expected_launches(rows))
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


def distress_stream(eng, store, g, every: int, inject_at: int,
                    pace_s: float = 0.0) -> dict:
    """Feed the synthetic graph `g` to `eng` node by node, each loop edge
    right after its later endpoint, and poll eng.trigger() at every
    `every`-th node (0, every, 2 every, ...) after a sleep of pace_s, as
    benchmarks/run_baseline.py's streaming_30k row does. The first poll at
    or after node `inject_at` that fires has the escalation ladder forced
    (escalate_rejects=0 for that one trigger). Works with either package's
    engine and store. Returns {"polls": one dict per poll (node, fired,
    waiting: new edges were waiting, landed: the forced escalation's row
    had been written before the poll), "injected": that trigger's id or
    None}; the caller drains and settles."""
    t0, dt = 1_000_000_000, 100_000_000
    by_later: dict = {}
    for k in range(g.n_loops):
        by_later.setdefault(int(g.loop_pairs[k].max()), []).append(k)
    polls, injected = [], None
    for i in range(g.n_nodes):
        store.add_node(t0 + i * dt, g.vio_q[i], g.vio_t[i])
        for k in by_later.get(i, ()):
            a, b = map(int, g.loop_pairs[k])
            store.add_loop_edge(t0 + a * dt, t0 + b * dt, g.loop_q[k],
                                g.loop_t[k], float(g.loop_w[k]))
        if i % every:
            continue
        if pace_s:
            time.sleep(pace_s)
        landed = injected is not None and any(
            r.get("background_escalation") and r["trigger"] == injected
            for r in eng.solve_stats)
        saved = eng.config
        inject = injected is None and i >= inject_at
        if inject:
            eng.config = dataclasses.replace(saved, solver=dataclasses.replace(
                saved.solver, escalate_rejects=0))
        waiting = store.edge_len > eng.prev_edge_len
        try:
            fired = eng.trigger()
        finally:
            eng.config = saved
        if inject and fired:
            injected = eng.trigger_id
        polls.append(dict(node=i, fired=fired, waiting=waiting,
                          landed=landed))
    return {"polls": polls, "injected": injected}


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
    out = os.path.join(tmp, "replay.json")
    ckpt = os.path.join(tmp, "ckpt")
    with counted("replay"):
        t0 = time.perf_counter()
        run_cli(["replay", "--input", stream, "--output", out,
                 "--trigger-every", every, "--save-dir", ckpt,
                 "--device", "cuda"])
        wall = time.perf_counter() - t0
    sol = json.load(open(out))
    stats = sol["solve_stats"]
    rows = [r for r in stats if "trigger_wall_ms" in r]
    bad = [r for r in rows if not r["final_cost"] <= r["initial_cost"]]
    bad += [r for r in stats if r.get("background_escalation")
            and not r.get("final_cost", math.inf)
            <= r.get("initial_cost", -math.inf)]
    if len(rows) < 5 or bad:
        raise AssertionError(f"replay: {len(rows)} triggers; "
                             f"cost not lowered in {bad}")
    saved = json.load(open(os.path.join(ckpt, "solved_posegraph.json")))
    sets = {nd["setID_of_worldID"] for nd in saved["SolvedPoseGraph"]
            if nd["worldID"] >= 0}
    worlds = {nd["worldID"] for nd in saved["SolvedPoseGraph"]}
    if len(sets) != 1 or not {0, 1, 2} <= worlds:
        raise AssertionError(f"replay: worlds {worlds} end in sets {sets}, "
                             f"expected one set")
    final = np.array([[float(v) for v in n["w_T_c"].split(";")[r].split(",")]
                      for n in sol["nodes"] for r in range(3)])
    scale = float(np.abs(final).max())
    ms = [r["trigger_wall_ms"] for r in rows]
    say("replay", triggers=len(rows),
        escalations=sum(1 for r in stats if r.get("background_escalation")),
        final_chi2=rows[-1]["final_cost"],
        median_trigger_wall_ms=round(float(np.median(ms)), 3),
        p90_trigger_wall_ms=round(float(np.percentile(ms, 90)), 3),
        replay_wall_s=round(wall, 3),
        launches=json.dumps(PATH_LAUNCHES["replay"], separators=(",", ":")),
        card=repr(card))

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
                    "--load-dir", ckpt,
                    "--device", "cuda"])
    if "load_state_from_disk" not in text or "-> True" not in text:
        raise AssertionError(f"checkpoint did not re-load:\n{text}")
    # the restored map, composed, is the saved run's composed trajectory
    # (outside the kidnap dead zones, whose poses are not solved)
    live = np.array([nd["worldID"] >= 0 for nd in saved["SolvedPoseGraph"]])
    n0 = len(live)
    nodes = json.load(open(out))["nodes"]
    got = np.array([[float(r.split(",")[3]) for r in
                     nd["w_T_c"].split(";")[:3]] for nd in nodes[:n0]])
    want = final.reshape(-1, 3, 4)[:n0, :, 3]
    err = float(np.abs(got - want)[live].max())
    if not (err <= 1e-9 * scale and len(nodes) == n0 + 200):
        raise AssertionError(f"restored map: max |dt| {err}, "
                             f"{len(nodes)} nodes")
    say("replay", pose_scale=scale, restored_nodes=n0,
        restored_max_abs_dt=err, card=repr(card))


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


def phase_incremental(tmp: str, card: str) -> None:
    """Phase 9's stream replayed with the incremental problem build on and
    off, in fp32 without the escalation ladder (phases 7-9 drive it): a
    background rung's timing decides which polls of the replay find the
    engine free, and an inline rung's row holds the rung's LM counts, not
    the fp32 solve's, so neither gives two runs that can be compared bit
    for bit with launch counts fixed by their rows."""
    stream = os.path.join(tmp, "stream.json")
    info = make_stream(stream)
    every = str(info["events"] // 10)
    runs = {}
    for on in (True, False):
        mode = "on" if on else "off"
        cfg = Config()
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(cfg.solver, adaptive_fp64=False),
            stream=dataclasses.replace(cfg.stream, incremental_build=on))
        cfg_path = os.path.join(tmp, f"incremental_{mode}.json")
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())
        out = os.path.join(tmp, f"incremental_{mode}.json.out")
        ckpt = os.path.join(tmp, f"incremental_{mode}")
        path = f"incremental-{mode}"
        with counted(path):
            run_cli(["replay", "--input", stream, "--output", out,
                     "--config", cfg_path, "--trigger-every", every,
                     "--save-dir", ckpt, "--device", "cuda"])
        sol = json.load(open(out))
        rows = [r for r in sol["solve_stats"] if "trigger_wall_ms" in r]
        check_launches(path, expected_launches(sol["solve_stats"]))
        saved = json.load(open(os.path.join(ckpt, "solved_posegraph.json")))
        runs[mode] = dict(rows=rows, switches=sol["switches"],
                          poses=[nd["w_T_c"]["data"]
                                 for nd in saved["SolvedPoseGraph"]])
        build_ms = [r["problem_build_ms"] for r in rows]
        say("incremental", mode=mode, triggers=len(rows),
            full_builds=rows[-1]["full_builds"],
            delta_builds=rows[-1]["delta_builds"],
            median_problem_build_ms=float(np.median(build_ms)),
            all_problem_build_ms=json.dumps([round(v, 3) for v in build_ms]),
            median_trigger_wall_ms=float(np.median(
                [r["trigger_wall_ms"] for r in rows])),
            final_chi2=rows[-1]["final_cost"],
            launches=json.dumps(PATH_LAUNCHES[path], separators=(",", ":")),
            card=repr(card))
    on, off = runs["on"], runs["off"]
    if not (on["rows"][-1]["delta_builds"] > 0
            and off["rows"][-1]["delta_builds"] == 0):
        raise AssertionError(
            f"delta builds: on {on['rows'][-1]['delta_builds']}, off "
            f"{off['rows'][-1]['delta_builds']}")
    same = (on["poses"] == off["poses"] and on["switches"] == off["switches"]
            and [r["final_cost"] for r in on["rows"]]
            == [r["final_cost"] for r in off["rows"]])
    if not same:
        raise AssertionError("the incremental replay differs from the "
                             "full-build replay")
    say("incremental", bitwise_equal_poses_and_switches=True,
        nodes=len(on["poses"]), switches=len(on["switches"]))


def route_of(problem) -> str:
    """The route lm_solve takes for `problem`: the composed executables
    (ops/graphs.py) or the eager loop."""
    return "graphs" if graphs.serves(problem) else "eager"


def mesh_eager(prob, sp, path: str, card: str, fields: dict):
    """Phase 14(a) on a mesh over distinct cards (the eager route): the
    product solve, counted, then timed beside the single device."""
    with counted(path):
        res = lm_solve(sp, **PRODUCT)
        float(res.final_cost)
    want = on_shards(solve_launches(res, PRODUCT["max_cg_iterations"],
                                    graphed=False), 4)
    want["gj_inv"] *= len(sp.mesh.distinct)      # a factorization per card
    want["precond_apply"] *= len(sp.mesh.distinct)   # and an apply
    check_launches(path, want)
    lm_solve(sp, **PRODUCT)                      # warm-up
    times = in_turns({
        "eager": lambda: float(lm_solve(sp, **PRODUCT).final_cost),
        "single_device": lambda: float(lm_solve(prob, **PRODUCT)
                                       .final_cost)}, reps=3)
    say(path, **fields,
        launches=json.dumps(PATH_LAUNCHES[path], separators=(",", ":")),
        **{f"median_ms_{k}": float(np.median(v)) for k, v in times.items()},
        **{f"{k}_ms": json.dumps([round(t, 3) for t in v])
           for k, v in times.items()}, card=repr(card))
    return res


def phase_mesh(dev, card: str) -> None:
    """Phase 14 (see the module note)."""
    prob = circle_problem(5000, 10000, 8192, 16384, np.float32, dev)
    # (a) the single-device reference of this run, uncounted
    one = lm_solve(prob, **PRODUCT)
    chi2_1 = float(one.final_cost)
    runs = [("mesh", [str(dev)] * 4)]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        runs.append(("mesh-distinct-cards",
                     [f"cuda:{i % n_cards}" for i in range(4)]))
    for path, devices in runs:
        t0 = time.perf_counter()
        sp = shard_problem(prob, make_mesh(devices=devices))
        distinct = len(sp.mesh.distinct)
        fields = dict(route=route_of(sp), shards=4, distinct_cards=distinct,
                      ghost_rows_per_shard=sp.layout.ghosts[0].shape[0],
                      shard_problem_s=round(time.perf_counter() - t0, 4))
        if fields["route"] != ("graphs" if distinct == 1 else "eager"):
            raise AssertionError(f"{path}: route {fields['route']} for a "
                                 f"mesh on {distinct} cards")
        if distinct == 1:
            res = graphed_against_eager(
                sp, PRODUCT, path, card, reps=3, fields=fields,
                also={"single_device": lambda: float(lm_solve(
                    prob, **PRODUCT).final_cost)})["result"]
        else:
            res = mesh_eager(prob, sp, path, card, fields)
        chi2 = float(res.final_cost)
        if not (within_quality(chi2, CHI2_REF)
                and abs(chi2 - chi2_1) <= 1e-3 * chi2_1):
            raise AssertionError(f"{path}: chi^2 {chi2} vs the reference "
                                 f"{CHI2_REF} and the single-device {chi2_1}")
        if not all(bool(torch.isfinite(v).all()) for v in (res.q, res.t,
                                                            res.switch)):
            raise AssertionError(f"{path}: non-finite solution")
        if tuple(res.q.shape) != (prob.n_cap, 4) or res.q.device != dev:
            raise AssertionError(f"{path}: result {tuple(res.q.shape)} on "
                                 f"{res.q.device}")
        say("mesh-vs-single-device", path=path, route=fields["route"],
            chi2=chi2, single_device_chi2=chi2_1,
            rel_diff=abs(chi2 - chi2_1) / chi2_1,
            gap=f"{chi2 / CHI2_REF - 1:+.4%}",
            lm_iterations=int(res.iterations),
            single_device_lm_iterations=int(one.iterations),
            cg_iterations=int(res.total_cg_iterations),
            single_device_cg_iterations=int(one.total_cg_iterations),
            card=repr(card))
    if n_cards < 2:
        print("[mesh] distinct-card copies not exercised (1 card)",
              flush=True)

    # (b) __graft_entry__.dryrun_multichip's certificate, on the card,
    # graphed, and bit for bit the eager 8-shard solve
    prob64 = circle_problem(5000, 10000, 8192, 16384, np.float64, dev)
    kw = dict(max_iterations=2, max_cg_iterations=8,
              preconditioner="band+coarse", coarse_group=64, bcr_levels=2)
    sp64 = shard_problem(prob64, make_mesh(devices=[str(dev)] * 8))
    route = route_of(sp64)
    eager_sh = lm_ops._lm_solve_eager(sp64, **kw)
    with counted("mesh-certificate"):
        t0 = time.perf_counter()
        res_sh = lm_solve(sp64, **kw)
        c_sh = float(res_sh.final_cost)
        wall_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_1 = lm_solve(prob64, **kw)
    c_1 = float(res_1.final_cost)
    wall_1 = time.perf_counter() - t0
    diffs = {name: float((getattr(res_sh, name) - getattr(res_1, name))
                         .abs().max()) for name in ("q", "t", "switch")}
    ok = (route == "graphs" and same_result(res_sh, eager_sh)
          and c_sh <= float(res_sh.initial_cost) * 1.000001
          and abs(c_sh - c_1) <= 1e-9 * max(1.0, abs(c_1))
          and int(res_sh.iterations) == int(res_1.iterations)
          and int(res_sh.total_cg_iterations)
          == int(res_1.total_cg_iterations)
          and diffs["q"] <= 1e-9 and diffs["t"] <= 1e-8
          and diffs["switch"] <= 1e-9)
    if not ok:
        raise AssertionError(f"fp64 8-shard certificate ({route}): chi^2 "
                             f"{c_sh} vs {c_1}, max diffs {diffs}, bit for "
                             f"bit the eager mesh: "
                             f"{same_result(res_sh, eager_sh)}")
    check_launches("mesh-certificate", on_shards(
        solve_launches(res_sh, kw["max_cg_iterations"]), 8))
    say("mesh-certificate", route=route, shards=8, dtype="float64",
        chi2=c_sh, unsharded_chi2=c_1, abs_diff=abs(c_sh - c_1),
        max_abs_dq=diffs["q"], max_abs_dt=diffs["t"],
        max_abs_dswitch=diffs["switch"], lm_iterations=int(res_sh.iterations),
        cg_iterations=int(res_sh.total_cg_iterations),
        bit_equal_to_eager=True,
        launches=json.dumps(PATH_LAUNCHES["mesh-certificate"],
                            separators=(",", ":")),
        first_solve_wall_s=round(wall_sh, 4),
        unsharded_wall_s=round(wall_1, 4), card=repr(card))

    # (c) pcg_sharded on phase 5's first reduced system, 8 shards
    blocks = gn.assemble_t(prob, prob.q, prob.t, prob.switch)
    radius = torch.tensor(1e4, dtype=prob.dtype, device=dev)
    red = gn.schur_reduce_t(blocks, prob,
                            *lm_ops.jacobi_scales(blocks.D, blocks.ds, radius))
    mesh8 = make_mesh(devices=[str(dev)] * 8)
    with counted("mesh-pcg-sharded"):
        t0 = time.perf_counter()
        x = pcg_sharded(red.Dh, red.Bh, red.Aba_h, prob.loop_b, prob.loop_a,
                        red.rhs_n, mesh=mesh8, max_iterations=400,
                        r_tolerance=1e-6, fanout=prob.fanout, coarse_group=64,
                        free_mask=prob.free_mask)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    resid = gn.reduced_matvec_t(red, prob, x) - red.rhs_n
    rel = float(resid.double().norm() / red.rhs_n.double().norm())
    k1 = PATH_LAUNCHES["mesh-pcg-sharded"]
    # each shard's band apply at the exact root (bcr_levels None): two
    # launches per level of its 2^L super-nodes, once at the CG start and
    # once per CG iteration (a K1 launch per shard)
    supernodes = -(-(prob.n_cap // 8) // prob.fanout)
    per_shard = 2 * (supernodes - 1).bit_length()
    applies = k1["band_matvec"] // 8 + 1
    if not (rel < 1e-4 and all(k1.values()) and k1["band_matvec"] % 8 == 0
            and k1["precond_apply"] == 8 * per_shard * applies):
        raise AssertionError(f"pcg_sharded: relative residual {rel}, "
                             f"launches {k1}, {per_shard} apply launches "
                             f"per shard and {applies} applications")
    # the sharded halo matvec against the single-device one, both K1
    layout = edge_layout(prob.loop_b, prob.loop_a, prob.n_cap, prob.fanout,
                         mesh8, live=prob.loop_mask)
    mv = HaloMatvec(*(split_nodes(v, mesh8) for v in (red.Dh, red.Bh,
                                                      red.Aba_h)), layout)
    v = torch.randn(6, prob.n_cap, dtype=prob.dtype, device=dev)
    y8 = unshard(mv(split_nodes(v, mesh8)))
    y1 = gn.reduced_matvec_t(red, prob, v)
    abs_err, mv_rel = rel_err(y8, y1)
    if not mv_rel <= 1e-5:
        raise AssertionError(f"sharded matvec vs single-device: rel err "
                             f"{mv_rel}")
    say("mesh-pcg-sharded", route="eager", shards=8, dtype="float32",
        coarse_group=64,
        rel_residual=rel, cg_iterations=k1["band_matvec"] // 8,
        launches=json.dumps(k1, separators=(",", ":")), wall_s=round(wall, 4),
        halo_matvec_max_abs_err=abs_err, halo_matvec_max_rel_err=mv_rel,
        card=repr(card))

    mesh_replay(dev, card)
    mesh_escalation(dev, card, prob)


def replay_engine(rec, dev, every: int, mesh=None, warm=None,
                  path=None) -> tuple:
    """Phase 14(d): `rec` replayed through a SolverEngine (on `mesh`, else
    on `dev`), without the escalation
    ladder so that its rows fix its launches, and in fp64: in fp32 the two
    orders of summation flip an LM stop now and then, which moved poses by
    2e-4 of their scale on a 600-node version of the stream (CPU), where
    fp64 agreed to 1e-13. `warm` (max_nodes, max_edges): the engine's
    warmup over every pair of buckets up to them first; `path`: the replay
    (not the warmup) counted under that name. Returns (trigger rows, final
    poses (n, 7), wall seconds, the engine)."""
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, adaptive_fp64=False,
                                        dtype="float64"),
        mesh=dataclasses.replace(cfg.mesh,
                                 n_devices=len(mesh) if mesh else 1))
    store = store_mod.GraphStore(initial_capacity=rec.node_len)
    eng = SolverEngine(store, cfg, device=dev, mesh=mesh)
    if warm is not None:
        eng.warmup(*warm, proportional=False)
    with counted(path) if path else contextlib.nullcontext():
        t0 = time.perf_counter()
        cli.replay_events(rec, store, eng, Composer(store, eng), every)
        wall = time.perf_counter() - t0
    poses = np.array([np.concatenate(eng.get_node_pose(i))
                      for i in range(eng.n_opt_variables())])
    rows = [r for r in eng.solve_stats if "trigger_wall_ms" in r]
    return rows, poses, wall, eng


# phase 14(d)'s stream (make_stream's sizes): nodes and loop edges, up to
# which both engines' warmups capture every pair of buckets
MESH_STREAM = (5000, 2500)


def mesh_replay(dev, card: str) -> None:
    """Phase 14(d) (see the module note); the unmeshed run is uncounted."""
    with tempfile.TemporaryDirectory(prefix="kpg") as tmp:
        stream = os.path.join(tmp, "stream.json")
        info = make_stream(stream, n=MESH_STREAM[0], n_loops=MESH_STREAM[1])
        rec = store_mod.GraphStore.load_from_json(stream)
    every = info["events"] // 10
    rows_1, poses_1, wall_1, _ = replay_engine(rec, dev, every,
                                               warm=MESH_STREAM)
    mesh = make_mesh(devices=[str(dev)] * 4)
    t0 = time.perf_counter()
    rows, poses, wall, eng = replay_engine(rec, dev, every, mesh,
                                           warm=MESH_STREAM,
                                           path="mesh-replay")
    total = time.perf_counter() - t0
    ws = eng.warmup_stats
    check_launches("mesh-replay", on_shards(expected_launches(rows), 4))
    lm, lm_1 = ([r["lm_iterations"] for r in x] for x in (rows, rows_1))
    captures = [r["trigger_captures"] for r in rows]
    diff = float(np.abs(poses - poses_1).max()) if poses.shape == \
        poses_1.shape else math.inf
    scale = float(np.abs(poses_1).max())
    sizes = [(r["node_len"], r["edge_len"]) for r in rows]
    ok = (len(rows) >= 5 and lm == lm_1 and not any(captures)
          and eng._graphed() and all(r["captured"] for r in ws)
          and sizes == [(r["node_len"], r["edge_len"]) for r in rows_1]
          and rows[-1]["delta_builds"] == 0 and diff <= 1e-8 * scale
          and all(r["final_cost"] <= r["initial_cost"] for r in rows))
    if not ok:
        raise AssertionError(f"mesh replay: triggers {sizes}, LM {lm} vs "
                             f"LM {lm_1}, captures {captures}, max pose diff "
                             f"{diff} (scale {scale}), delta builds "
                             f"{rows[-1]['delta_builds']}")
    say("mesh-replay", route="graphs", shards=4, dtype="float64", triggers=len(rows),
        trigger_captures=sum(captures), warmed_buckets=len(ws),
        setup_and_warmup_s=round(total - wall, 3),
        capture_s_total=round(sum(r["capture_s"] for r in ws), 3),
        pool_mb_total=round(sum(r["pool_mb"] for r in ws), 1),
        final_chi2=rows[-1]["final_cost"],
        unmeshed_final_chi2=rows_1[-1]["final_cost"],
        max_abs_pose_diff=diff, pose_scale=scale,
        lm_iterations=json.dumps(lm),
        median_trigger_wall_ms=float(np.median(
            [r["trigger_wall_ms"] for r in rows])),
        unmeshed_median_trigger_wall_ms=float(np.median(
            [r["trigger_wall_ms"] for r in rows_1])),
        replay_wall_s=round(wall, 3), unmeshed_replay_wall_s=round(wall_1, 3),
        launches=json.dumps(PATH_LAUNCHES["mesh-replay"],
                            separators=(",", ":")), card=repr(card))


def mesh_escalation(dev, card: str, prob) -> None:
    """Phase 14(e): the device ladder on a ShardedProblem (the unmeshed
    ladder uncounted), escalation forced, with a dispatch lock as the
    engine passes it: the mixed rung on the 4 shards, then the fp64 rung
    sharded again, each graphed in its step form (an init and a step per
    LM iteration). Both run fp64 CG with forcing 1e-5 to its cap of 100
    iterations, where two runs whose sums differ only in order drift
    apart, hence 1e-3."""
    want, _, _ = lm_ops.escalate_resolve(prob, PRODUCT, 0, fp64_backend="tpu")
    chi2_1 = float(want.final_cost)
    sp = shard_problem(prob, make_mesh(devices=[str(dev)] * 4))
    lock = threading.Lock()
    launches = dict(graphs.LAUNCHES)
    with counted("mesh-escalation-fp64"):
        t0 = time.perf_counter()
        got, rung, stats = lm_ops.escalate_resolve(
            sp, PRODUCT, 0, dispatch_lock=lock, fp64_backend="tpu")
        chi2 = float(got.final_cost)
        wall = time.perf_counter() - t0
    ran = {n: graphs.LAUNCHES[n] - launches[n] for n in launches
           if graphs.LAUNCHES[n] - launches[n]}
    check_launches("mesh-escalation-fp64",
                   on_shards(ladder_launches(got, rung, stats), 4))
    steps = stats["mixed_lm_iterations"] + int(got.iterations)
    if not (rung == "fp64" and got.q.dtype == torch.float64
            and ran == {"init": 2, "step": steps}
            and tuple(got.q.shape) == (prob.n_cap, 4)
            and within_quality(chi2, CHI2_REF)
            and abs(chi2 - chi2_1) <= 1e-3 * chi2_1):
        raise AssertionError(f"mesh device rung: rung {rung!r}, chi^2 {chi2} "
                             f"vs the unmeshed {chi2_1} and {CHI2_REF}, "
                             f"executables {ran} for {steps} LM iterations")
    say("mesh-escalation", route=route_of(sp), form="step", shards=4,
        rung=rung, chi2=chi2,
        unmeshed_chi2=chi2_1, rel_diff=abs(chi2 - chi2_1) / chi2_1,
        lm_iterations=int(got.iterations),
        cg_iterations=int(got.total_cg_iterations),
        unmeshed_cg_iterations=int(want.total_cg_iterations),
        mixed_lm_iterations=stats["mixed_lm_iterations"],
        mixed_cg_iterations=stats["mixed_cg_iterations"],
        executables=json.dumps(ran),
        mixed_s=round(stats["mixed_s"], 4), wall_s=round(wall, 4),
        launches=json.dumps(PATH_LAUNCHES["mesh-escalation-fp64"],
                            separators=(",", ":")), card=repr(card))
    graphs.clear()            # the mesh's Programs: no later phase runs them


# the reference's array sizes (PoseGraphSLAM.cpp:17-25) as
# benchmarks/run_baseline.py's bench_capacity solves them: nodes, loop
# edges, n_cap, e_cap
CAPACITY = (30000, 30000, 32768, 32768)
# the JAX package's chi^2 of that solve at the product config
# (BASELINE.md:347); a quality bar, as CHI2_REF is for the bench graph
CHI2_CAP = 5.9532
# phase 16's stream: benchmarks/run_baseline.py's streaming_30k row (its
# graph and its 2 s pause before each poll, polled every 1,000 nodes where
# it polls every 500), the ladder forced from node 20,000 on. A poll
# refused while the escalation runs returns at once, so the pauses alone
# must span it for a trigger to be served after it lands in the stream:
# nine polls after node 20,000, 18 s, against 9.2 s for the host rung at
# 20k nodes on the card's host (a 1 s pause left one poll to spare)
CAPACITY_STREAM = dict(nodes=30000, loops=3000, every=1000, inject_at=20000,
                       pace_s=2.0)


class Solves(list):
    """(n_cap, e_cap, ms) of each solve seen; `last`: the last one's
    (problem, result), the only one kept, so that the peak memory is the
    stream's own."""
    last = None


@contextlib.contextmanager
def solves_seen():
    """Record every lm_solve that the engine calls on this thread (it looks
    it up on ops.lm at each call): its trigger solves, not a background
    escalation's. n_cap and e_cap are the box
    the solve ran in, read as tests/test_engine.py's bucket-cover test
    reads them; ms is the wall time to the end of its device work (the
    card synchronised, where there is one). The
    wrapper keeps lm_solve's signature, which ops/graphs.py reads."""
    seen = Solves()
    real = lm_ops.lm_solve
    owner = threading.get_ident()

    @functools.wraps(real)
    def spy(problem, **kw):
        t0 = time.perf_counter()
        res = real(problem, **kw)
        if threading.get_ident() == owner:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            seen.append((problem.n_cap, problem.e_cap,
                         1e3 * (time.perf_counter() - t0)))
            seen.last = (problem, res)
        return res

    lm_ops.lm_solve = spy
    try:
        yield seen
    finally:
        lm_ops.lm_solve = real


def fp64_chi2(problem, res) -> float:
    """chi^2 of a result re-evaluated from scratch in fp64 (independent of
    the solve's assembly and its dtype)."""
    return float(gn.evaluate_cost(
        problem_astype(problem, torch.float64), res.q.double(),
        res.t.double(), res.switch.double()))


def prime_profiler(dev) -> None:
    """Open and close one torch.profiler session over a trivial operation,
    before any executable is composed: in the executables composed before
    a process's first session the profiler saw each WHILE node's body run
    once (measured on an H100: 1 of 318 K1 launches of a 5k/10k solve),
    and all of it in those composed after."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()


def device_profile(fn) -> dict:
    """torch.profiler over one call of fn (which ends in a host read):
    device time in total and by kernel name, and the idle share of the
    call's wall (the part in which the card ran nothing). Only the device
    activity is traced, and its raw events are read: recording every
    host op as well made the traced wall ~2x the untraced one, and
    turning ~65,000 device events into profiler FunctionEvents took
    10-30 s of host time after a 5k/10k solve. The process must have run
    prime_profiler before it composed the executables that fn launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            n, ms = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (n + 1, ms + e.duration_ns() / 1e6)
    device_ms = sum(ms for _, ms in by_name.values())
    if not device_ms:
        raise AssertionError("the profiler saw no device time")

    def kernel(key: str) -> dict:
        hits = [v for k, v in by_name.items() if key in k]
        return {"launches": sum(n for n, _ in hits),
                "ms": sum(ms for _, ms in hits)}

    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(profiled_wall_ms=wall, device_ms=device_ms,
                idle_share=1.0 - device_ms / wall,
                device_ops=sum(n for n, _ in by_name.values()),
                k1=kernel("band_matvec"), k2=kernel("gj_inv"),
                top=[{"name": k[:80], "launches": n, "ms": round(ms, 3)}
                     for k, (n, ms) in top])


def check_profiled(path: str, prof: dict) -> bool:
    """Whether the K1 and K2 launches that the profiler saw on the card in
    the counted run of `path` (device_profile) are those that the counters
    counted there (each piece's captured launches times the runs of it
    that the device counted, which lm_solve holds to its LM and CG
    counts). Records them in PROFILED, and a disagreement in DISAGREED,
    printed on its own line. It does not fail the run: on an H100 the
    profiler has seen a kernel inside a nested WHILE body once per LM
    iteration (10 of 321 K1) in a solve whose device counts and result
    (bit for bit the eager one) show every body run."""
    seen = {"band_matvec": prof["k1"]["launches"],
            "gj_inv": prof["k2"]["launches"]}
    want = {k: PATH_LAUNCHES[path][k] for k in seen}
    PROFILED[path] = seen
    if seen != want:
        DISAGREED[path] = {"profiler": seen, "counted": want}
        say("profiler-disagrees", path=path, profiler=json.dumps(seen),
            counted=json.dumps(want))
    return seen == want


def phase_capacity(dev, card: str) -> None:
    """Phase 15 (see the module note)."""
    n, loops, n_cap, e_cap = CAPACITY
    t0 = time.perf_counter()
    prob = circle_problem(n, loops, n_cap, e_cap, np.float32, dev)
    torch.cuda.synchronize()
    group = coarse_ops.auto_coarse_group(prob.n_cap)
    say("capacity", build_s=round(time.perf_counter() - t0, 3), nodes=n,
        loop_edges=loops, n_cap=prob.n_cap, e_cap=prob.e_cap,
        coarse_group=group, coarse_dim=6 * -(-prob.n_cap // group),
        dtype="float32", **PRODUCT)

    torch.cuda.reset_peak_memory_stats()
    with counted("capacity"), entry_points_taken() as taken:
        res = lm_solve(prob, **PRODUCT)
        chi2 = float(res.final_cost)
    peak = torch.cuda.max_memory_allocated()
    want = solve_launches(res, PRODUCT["max_cg_iterations"])
    check_launches("capacity", want)
    precision = by_precision(taken)
    if any(v["f64"] or v["f32"] != want[k] for k, v in precision.items()):
        raise AssertionError(f"capacity solve: kernels ran {precision}, not "
                             f"all {want} on the fp32 entry points")
    chi2_64 = fp64_chi2(prob, res)
    if not (within_quality(chi2, CHI2_CAP)
            and abs(chi2_64 - chi2) <= 1e-4 * chi2_64
            and int(res.iterations) == PRODUCT["max_iterations"]):
        raise AssertionError(
            f"capacity solve: chi^2 {chi2} (fp64 re-evaluation {chi2_64}) "
            f"vs {CHI2_CAP}, {int(res.iterations)} LM iterations")
    if not (all(bool(torch.isfinite(v).all()) for v in (res.q, res.t,
                                                         res.switch))
            and tuple(res.q.shape) == (n_cap, 4)):
        raise AssertionError(f"capacity solve: non-finite or "
                             f"{tuple(res.q.shape)} solution")
    lm_solve(prob, **PRODUCT)                    # second warm-up
    times = timed_solves(lambda: float(lm_solve(prob, **PRODUCT).final_cost),
                         reps=5)
    say("capacity", chi2=chi2, chi2_fp64_eval=chi2_64, jax_chi2=CHI2_CAP,
        gap=f"{chi2 / CHI2_CAP - 1:+.4%}",
        initial_cost=float(res.initial_cost),
        lm_iterations=int(res.iterations), accepted=int(res.successful_steps),
        cg_iterations=int(res.total_cg_iterations),
        distress_rejects=int(res.distress_rejects),
        launches=json.dumps(PATH_LAUNCHES["capacity"], separators=(",", ":")),
        expected_launches=json.dumps(want, separators=(",", ":")),
        by_precision=json.dumps(precision, separators=(",", ":")),
        median_ms_per_solve=float(np.median(times)),
        spread_ms=float(max(times) - min(times)),
        all_ms=json.dumps([round(t, 3) for t in times]),
        max_memory_allocated=peak, card=repr(card))
    with counted("capacity-profiled"):
        out = []
        prof = device_profile(lambda: out.append(lm_solve(prob, **PRODUCT))
                              or float(out[-1].final_cost))
    check_launches("capacity-profiled", want)
    if not same_result(out[-1], res):
        raise AssertionError("capacity: the profiled solve differs")
    agrees = check_profiled("capacity-profiled", prof)
    say("capacity-profile", **{k: (json.dumps(v, separators=(",", ":"))
                                   if isinstance(v, (dict, list)) else v)
                               for k, v in prof.items()},
        counted=json.dumps(PATH_LAUNCHES["capacity-profiled"]),
        profiler_agrees=agrees,
        median_unprofiled_ms=float(np.median(times)), card=repr(card))

    # the device ladder forced on the same problem: the mixed rung (K1 and
    # K2 in fp32), then the fp64 rung (both in fp64, repacked to n_cap
    # 30720); the mixed rung's own chi^2 from a solve outside the count
    mixed = float(lm_solve(prob, precision="mixed", **PRODUCT).final_cost)
    with counted("capacity-ladder"), entry_points_taken() as taken:
        t0 = time.perf_counter()
        res, rung, stats = lm_ops.escalate_resolve(prob, PRODUCT, 0,
                                                   fp64_backend="tpu")
        chi2 = float(res.final_cost)
        wall = time.perf_counter() - t0
    want = ladder_launches(res, rung, stats)
    check_launches("capacity-ladder", want)
    mixed_part = ladder_launches(res, "mixed", stats)
    split = {k: {"f32": mixed_part[k], "f64": want[k] - mixed_part[k]}
             for k in want}
    precision = by_precision(taken)
    if precision != split:
        raise AssertionError(f"capacity ladder ran {precision}, its rungs "
                             f"imply {split}")
    if not (rung == "fp64" and math.isfinite(chi2) and chi2 <= mixed):
        raise AssertionError(f"capacity ladder: rung {rung!r}, chi^2 {chi2} "
                             f"vs the mixed rung's {mixed}")
    say("capacity-ladder", rung=rung, chi2=chi2, mixed_chi2=mixed,
        lm_iterations=int(res.iterations), accepted=int(res.successful_steps),
        cg_iterations=int(res.total_cg_iterations),
        rung_stats=json.dumps({k: (round(v, 4) if isinstance(v, float)
                                   else v) for k, v in stats.items()}),
        wall_s=round(wall, 4),
        launches=json.dumps(PATH_LAUNCHES["capacity-ladder"],
                            separators=(",", ":")),
        ladder_launches=json.dumps(split, separators=(",", ":")),
        card=repr(card))


def phase_capacity_stream(dev, card: str) -> None:
    """Phase 16 (see the module note)."""
    cs = CAPACITY_STREAM
    g = synthetic.circle_graph(n_nodes=cs["nodes"], n_loops=cs["loops"],
                               seed=1)
    every, inject_at, pace_s = cs["every"], cs["inject_at"], cs["pace_s"]
    torch.set_num_threads(min(8, os.cpu_count() or 1))  # for the host rung
    store = native.make_store()
    eng = SolverEngine(store, Config(), device=dev)
    caps = eng.config.capacity
    w0 = time.perf_counter()
    eng.warmup(g.n_nodes, g.n_loops)
    if not eng.warmup_join(timeout=300) or native_ldl._lib is None:
        raise AssertionError("warmup did not load the host fp64 rung")
    warm_s = time.perf_counter() - w0
    torch.cuda.reset_peak_memory_stats()
    with counted("capacity-stream"), solves_seen() as seen:
        t0 = time.perf_counter()
        rec = distress_stream(eng, store, g, every, inject_at, pace_s)
        eng.drain()
        streamed = len(seen)
        settled = eng.trigger()
        eng.drain()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check_launches("capacity-stream", expected_launches(eng.solve_stats))

    rows = [r for r in eng.solve_stats if "trigger_wall_ms" in r]
    if len(seen) != len(rows):
        raise AssertionError(f"{len(seen)} solves for {len(rows)} triggers")
    # the triggers that the bucket cover moved out of their exact bucket
    covered = [[r["node_len"], r["edge_len"], list(b[:2])]
               for r, b in zip(rows, seen)
               if b[:2] != (_bucket(r["node_len"], caps.initial_nodes),
                            _bucket(max(r["edge_len"], 1),
                                    caps.initial_edges))]
    esc = [r for r in eng.solve_stats if r.get("background_escalation")]
    tid = rec["injected"]
    forced = [r for r in rows if r["trigger"] == tid]
    landed = [r for r in esc if r["trigger"] == tid]
    polls = rec["polls"]
    after = sum(p["fired"] and p["landed"] for p in polls)
    if not (tid is not None and forced and landed):
        raise AssertionError(f"the forced escalation: trigger {tid}, rows "
                             f"{forced}, {landed}")
    forced, landed = forced[0], landed[0]
    if not (forced["fp64_escalated"] == "pending"
            and _bucket(forced["node_len"], caps.initial_nodes)
            == _bucket(g.n_nodes, caps.initial_nodes)
            and landed.get("escalated_rung") == "fp64-cpu"
            and landed.get("applied") is True and after >= 1):
        raise AssertionError(f"the forced escalation at node_len "
                             f"{forced['node_len']}: {landed}; "
                             f"{after} triggers served after it landed")
    if not (settled and len(seen) == streamed + 1):
        raise AssertionError(f"settle trigger fired {settled}, "
                             f"{len(seen) - streamed} solves")
    problem, res = seen.last
    chi2, chi2_64 = float(res.final_cost), fp64_chi2(problem, res)
    if not (math.isfinite(chi2) and abs(chi2_64 - chi2) <= 1e-4 * chi2_64
            and rows[-1]["final_cost"] == chi2):
        raise AssertionError(f"settle chi^2 {chi2}, fp64 re-evaluation "
                             f"{chi2_64}, row {rows[-1]['final_cost']}")
    poses = np.array([np.concatenate(eng.get_node_pose(i))
                      for i in range(eng.n_opt_variables())])
    if len(poses) != g.n_nodes or not np.isfinite(poses).all():
        raise AssertionError(f"{len(poses)} poses, finite "
                             f"{np.isfinite(poses).all()}")

    walls = [r["trigger_wall_ms"] for r in rows[:-1]]
    full, delta, prev = [], [], 0
    for r in rows:
        if r["full_builds"] > prev:
            full.append([r["node_len"],
                         _bucket(r["node_len"], caps.initial_nodes),
                         _bucket(r["edge_len"], caps.initial_edges),
                         round(r["problem_build_ms"], 3)])
        else:
            delta.append(r["problem_build_ms"])
        prev = r["full_builds"]
    stats = landed["rung_stats"]
    say("capacity-stream", nodes=g.n_nodes, loop_edges=g.n_loops,
        poll_every=every, pace_s=pace_s, polls=len(polls),
        fired=sum(p["fired"] for p in polls),
        refused=sum(p["waiting"] and not p["fired"] for p in polls),
        median_trigger_wall_ms=float(np.median(walls)),
        p90_trigger_wall_ms=float(np.percentile(walls, 90)),
        max_trigger_wall_ms=float(max(walls)),
        settle_trigger_wall_ms=rows[-1]["trigger_wall_ms"],
        node_len_and_wall_ms=json.dumps([[r["node_len"],
                                          round(r["trigger_wall_ms"], 1)]
                                         for r in rows]),
        full_builds_node_len_ncap_ecap_ms=json.dumps(full),
        delta_builds=len(delta),
        median_delta_build_ms=float(np.median(delta)) if delta else None,
        max_delta_build_ms=float(max(delta)) if delta else None,
        warmup_s=round(warm_s, 3), stream_wall_s=round(wall, 3),
        max_memory_allocated=peak,
        trigger_captures=sum(r["trigger_captures"] for r in rows),
        covered_node_len_edge_len_box=json.dumps(covered,
                                                 separators=(",", ":")),
        launches=json.dumps(PATH_LAUNCHES["capacity-stream"],
                            separators=(",", ":")), card=repr(card))
    say("capacity-stream-escalation", injected_at_node=forced["node_len"] - 1,
        trigger=tid, rung=landed["escalated_rung"],
        applied=landed["applied"], rung_n_cap=stats["n_cap"],
        rung_e_cap=stats["e_cap"], rung_total_s=round(stats["total_s"], 4),
        rung_fetch_s=round(stats["fetch_s"], 4),
        escalation_wall_ms=round(landed["escalation_wall_ms"], 3),
        escalated_chi2=landed["final_cost"],
        fp32_chi2=forced["final_cost"],
        served_after_landing=after,
        other_escalations=json.dumps([(r["trigger"], r.get("escalated_rung"),
                                       r.get("applied")) for r in esc
                                      if r is not landed]),
        settle_chi2=chi2, settle_chi2_fp64_eval=chi2_64,
        settle_node_len=rows[-1]["node_len"], card=repr(card))


BENCH_REPS = 5              # phase 17's timed reps


def phase_bench(card: str) -> None:
    """Phase 17 (see the module note). The bench's launches go into the
    kernels line as path "bench": its per-rep counts times its reps."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--reps",
         str(BENCH_REPS)], cwd=REPO, capture_output=True, text=True,
        timeout=900)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise AssertionError(f"bench_torch.py exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    res = json.loads(lines[-1])
    per_rep = {"band_matvec": res["k1_launches"], "gj_inv": res["k2_launches"]}
    PROFILED["bench"] = {"band_matvec": res["k1_launches_traced"],
                         "gj_inv": res["k2_launches_traced"]}
    name = card.splitlines()[0].partition(",")[0].strip()
    checks = dict(
        metric=res["metric"] == "lm_solve_5k10k_ms",
        reps=res["reps"] == len(res["all_ms"]) == BENCH_REPS,
        chi2=math.isfinite(res["chi2"]) and res["chi2"] <= 1.02 * CHI2_REF,
        launches=per_rep == PROFILED["bench"] == {"band_matvec": 318,
                                                  "gj_inv": 30},
        card=res["card"] == name, backend=res["backend"] == "cuda")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bench_torch.py: failed {failed} in "
                             f"{lines[-1]}")
    PATH_LAUNCHES["bench"] = {k: n * BENCH_REPS for k, n in per_rep.items()}
    say("bench", process_wall_s=round(wall, 3), result=lines[-1])


# phase 19's rows of bench_stream_torch.py (--only keys) and the rows
# they give
STREAM_ROWS = {"streaming_warm": "streaming_2k_400_warm",
               "multiworld": "multiworld_1500", "cover": "cover_2k_4000"}


def phase_stream_rows(card: str) -> None:
    """Phase 19 (see the module note). The harness's launches go into the
    kernels line as path "stream-rows": the sum over its processes of what
    each counted in its row's stream."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_stream_torch.py"),
         "--only", ",".join(STREAM_ROWS), "--procs", "1"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise AssertionError(f"bench_stream_torch.py exited "
                             f"{out.returncode}:\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    res = json.loads(lines[-1])
    rows = res["rows"]
    name = card.splitlines()[0].partition(",")[0].strip()
    checks = dict(
        metric=res["metric"] == "engine_rows", procs=res["procs"] == 1,
        rows=set(rows) == set(STREAM_ROWS.values()),
        card=res["card"] == name, gates=res["gates"] > 0,
        launches=all(res["launches"].values()))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bench_stream_torch.py: failed {failed} in "
                             f"{lines[-1][:3000]}")
    PATH_LAUNCHES["stream-rows"] = res["launches"]
    warm, mw = rows["streaming_2k_400_warm"], rows["multiworld_1500"]
    say("stream-rows", process_wall_s=round(wall, 3), gates=res["gates"],
        warm_trigger_median_ms=warm["trigger_host_ms_median"]["median"],
        warm_trigger_p90_ms=warm["trigger_host_ms_p90"]["median"],
        warm_chi2=warm["final_chi2"]["median"],
        multiworld_trigger_median_ms=mw["trigger_host_ms_median"]["median"],
        multiworld_chi2=mw["final_chi2"]["median"],
        cover_solve_ms_4096_vs_exact=json.dumps(
            [[c["node_len"], round(c["solve_ms_cover"], 3),
              round(c["solve_ms_exact"], 3)]
             for c in rows["cover_2k_4000"]["covered"]],
            separators=(",", ":")),
        launches=json.dumps(res["launches"], separators=(",", ":")),
        card=repr(card))


def same_result(a, b) -> bool:
    """Every field of two LMResults equal, bit for bit."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


def in_turns(fns: dict, reps: int) -> dict:
    """CUDA-event ms of `reps` calls of each fn, in turns (the order
    alternates from one round to the next)."""
    times = {k: [] for k in fns}
    names = list(fns)
    for i in range(reps):
        for k in (names if i % 2 == 0 else names[::-1]):
            times[k] += timed_solves(fns[k], reps=1)
    return times


def graphed_against_eager(prob, kw: dict, tag: str, card: str,
                          precond_matvecs: int = 0, reps: int = 5,
                          also=None, fields=None) -> dict:
    """Phase 18 (a), (b), (d)-(f) and phase 14(a): lm_solve(prob, **kw)
    through a Program built for it (the cache emptied first, so that the
    build is measured), in its two forms: the solve executable (one
    launch, one host read) and the step executable per LM iteration under
    a dispatch lock; against the eager loop on the same problem: every
    result field bit for bit, the launches of each counted run as its LM
    and CG counts imply (K1 per CG iteration that ran when graphed, per
    iteration of the cap when eager; once per shard on a mesh; the
    preconditioner apply's per CG and LM iteration), the
    build's costs, the launches and host reads per solve, `reps` of each
    form and of each of `also` ({name: fn}) in turns; the solve form's
    counted run is profiled, and the profiler must see in it the launches
    that the counters counted (check_profiled). `fields` go on the printed
    line."""
    graphs.clear()
    cap, shards = kw["max_cg_iterations"], prob.n_shards
    with counted(f"{tag}-eager"):
        eager = lm_ops._lm_solve_eager(prob, **kw)
        float(eager.final_cost)
    built = len(graphs.LOG)
    with counted(f"{tag}-capture"):
        t0 = time.perf_counter()
        first = lm_solve(prob, **kw)
        float(first.final_cost)
        first_s = time.perf_counter() - t0
    if len(graphs.LOG) != built + 1:
        raise AssertionError(f"{tag}: {len(graphs.LOG) - built} builds")
    rec = graphs.LOG[built]
    lock = threading.Lock()
    runs = {}
    for form, lock_kw in (("solve", {}), ("step", {"dispatch_lock": lock})):
        launches, reads = dict(graphs.LAUNCHES), dict(graphs.HOST_READS)
        path = tag if form == "solve" else f"{tag}-step"
        with counted(path), entry_points_taken() as taken:
            res = lm_solve(prob, **kw, **lock_kw)
            float(res.final_cost)
        runs[form] = dict(
            res=res, taken=taken,
            launches={n: graphs.LAUNCHES[n] - launches[n] for n in launches
                      if graphs.LAUNCHES[n] - launches[n]},
            host_reads=sum(graphs.HOST_READS.values()) - sum(reads.values()))
    res = runs["solve"]["res"]
    it = int(res.iterations)
    per_apply = (PER_APPLY_TWO_GRID if kw["preconditioner"] == "band*coarse"
                 else PER_APPLY)
    want = on_shards(solve_launches(res, cap, precond_matvecs,
                                    per_apply=per_apply), shards)
    check_launches(f"{tag}-eager", on_shards(solve_launches(
        eager, cap, precond_matvecs, graphed=False, per_apply=per_apply),
        shards))
    for path in (f"{tag}-capture", tag, f"{tag}-step"):
        check_launches(path, want)
    if (PATH_WARMUP.get(tag) or PATH_WARMUP.get(f"{tag}-step")
            or runs["solve"]["launches"] != {"solve": 1}
            or runs["solve"]["host_reads"] != 1
            or runs["step"]["launches"] != {"init": 1, "step": it}
            or runs["step"]["host_reads"] != it + 2):
        raise AssertionError(
            f"{tag}: warm-ups {PATH_WARMUP.get(tag)}, solve form "
            f"{runs['solve']}, step form {runs['step']} for {it} LM "
            f"iterations")
    results = dict(solve=res, step=runs["step"]["res"], first=first)
    differ = [k for k, r in results.items() if not same_result(r, eager)]
    if differ:
        diff = {k: {f: float((getattr(results[k], f).double()
                              - getattr(eager, f).double()).abs().max())
                    for f in lm_ops.LMResult._fields} for k in differ}
        raise AssertionError(f"{tag}: results differ from eager: {diff}")
    for fn in (also or {}).values():
        fn()                                     # its warm-up
    times = in_turns({
        "solve": lambda: float(lm_solve(prob, **kw).final_cost),
        "step": lambda: float(lm_solve(prob, dispatch_lock=lock,
                                       **kw).final_cost),
        "eager": lambda: float(lm_ops._lm_solve_eager(
            prob, **kw).final_cost), **(also or {})}, reps=reps)
    med = {k: float(np.median(v)) for k, v in times.items()}
    # one more counted run of the solve form, profiled; last, because an
    # executable that ran under the profiler ran ~20 ms slower per 5k/10k
    # solve from then on in the process (H100)
    got = []
    with counted(f"{tag}-profiled"):
        prof = device_profile(lambda: got.append(lm_solve(prob, **kw))
                              or float(got[-1].final_cost))
    check_launches(f"{tag}-profiled", want)
    if not same_result(got[-1], eager):
        raise AssertionError(f"{tag}: the profiled solve differs")
    agrees = check_profiled(f"{tag}-profiled", prof)
    out = dict(
        **(fields or {}), chi2=float(res.final_cost),
        initial_cost=float(res.initial_cost), lm_iterations=it,
        accepted=int(res.successful_steps),
        cg_iterations=int(res.total_cg_iterations),
        distress_rejects=int(res.distress_rejects), bit_equal_to_eager=True,
        launches_per_solve=json.dumps(PATH_LAUNCHES[tag],
                                      separators=(",", ":")),
        by_precision=json.dumps(by_precision(runs["solve"]["taken"]),
                                separators=(",", ":")),
        executables_per_solve=json.dumps(runs["solve"]["launches"]),
        host_reads_per_solve=runs["solve"]["host_reads"],
        executables_per_step_solve=json.dumps(runs["step"]["launches"]),
        host_reads_per_step_solve=runs["step"]["host_reads"],
        warmup_ms=rec["warmup_s"] * 1e3, capture_ms=rec["capture_s"] * 1e3,
        compose_ms=rec["instantiate_s"] * 1e3,
        first_solve_ms=first_s * 1e3,
        pool_mb=rec["pool_bytes"] / 2 ** 20,
        init_pool_mb=rec["init_pool_bytes"] / 2 ** 20,
        step_pool_mb=rec["step_pool_bytes"] / 2 ** 20,
        **{f"median_ms_{k}": v for k, v in med.items()},
        **{f"{k}_ms": json.dumps([round(t, 3) for t in v])
           for k, v in times.items()},
        card=repr(card))
    say(tag, **out)
    say(f"{tag}-profile", **{k: (json.dumps(v, separators=(",", ":"))
                                 if isinstance(v, (dict, list)) else v)
                             for k, v in prof.items()},
        counted=json.dumps(PATH_LAUNCHES[f"{tag}-profiled"]),
        profiler_agrees=agrees, median_ms_solve=med["solve"],
        idle_share_of_median=1.0 - prof["device_ms"] / med["solve"],
        card=repr(card))
    return dict(out, result=res)


def cover_box(bucket: tuple, warmed: list) -> tuple:
    """The engine's bucket cover: `bucket` if it is warmed, else the
    smallest warmed (n_cap, e_cap) that holds it (None if none does)."""
    if bucket in warmed:
        return bucket
    return min((b for b in warmed if b[0] >= bucket[0] and b[1] >= bucket[1]),
               default=None)


def engine_replay(rec, every: int, eng) -> dict:
    """`rec` replayed through `eng` as the CLI's replay does: its trigger
    rows, final poses and switches, wall seconds, and each trigger's
    (n_cap, e_cap, solve ms) (solves_seen)."""
    store = eng.store
    with solves_seen() as seen:
        t0 = time.perf_counter()
        cli.replay_events(rec, store, eng, Composer(store, eng), every)
        wall = time.perf_counter() - t0
    rows = [r for r in eng.solve_stats if "trigger_wall_ms" in r]
    if len(seen) != len(rows):
        raise AssertionError(f"{len(seen)} solves for {len(rows)} triggers")
    return dict(
        rows=rows, boxes=list(seen), wall=wall,
        poses=np.array([np.concatenate(eng.get_node_pose(i))
                        for i in range(eng.n_opt_variables())]),
        switches=np.array([eng.get_switch(e)
                           for e in range(store.edge_len)]))


def same_replay(a: dict, b: dict) -> bool:
    """Two replays' poses, switches, chi^2 and LM / CG counts bit for
    bit."""
    def counts(run):
        return [(r["node_len"], r["edge_len"], r["lm_iterations"],
                 r["cg_iterations"], r["final_cost"]) for r in run["rows"]]
    return (counts(a) == counts(b)
            and np.array_equal(a["poses"], b["poses"])
            and np.array_equal(a["switches"], b["switches"]))


def walls(run: dict) -> dict:
    ms = [r["trigger_wall_ms"] for r in run["rows"]]
    return dict(median=round(float(np.median(ms)), 3),
                p90=round(float(np.percentile(ms, 90)), 3),
                max=round(float(max(ms)), 3))


# phase 18 (c)'s warmup of the full product of buckets (28 at the default
# capacities)
FULL_WARMUP = (5000, 10000)


def graphs_engine(dev, card: str) -> None:
    """Phase 18 (c): phase 9's stream replayed through SolverEngine, fp32
    at the product defaults without the escalation ladder, so that two
    runs can be compared bit for bit: once with every solve eager, once
    graphed after warmup(5000, 10000, proportional=False) (the full
    product of buckets, every trigger in its exact bucket); the graphed
    run takes no capture on the trigger path, and lands on the eager run's
    poses, switches and counts. Then graphs_engine_cover."""
    with tempfile.TemporaryDirectory(prefix="kpg") as tmp:
        stream = os.path.join(tmp, "stream.json")
        info = make_stream(stream)
        rec = store_mod.GraphStore.load_from_json(stream)
    every = info["events"] // 10
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, adaptive_fp64=False))

    def engine():
        return SolverEngine(
            store_mod.GraphStore(initial_capacity=rec.node_len), cfg,
            device=dev)

    with lm_ops._eager_solves():
        eager = engine_replay(rec, every, engine())
    eng = engine()
    w0 = time.perf_counter()
    n_warm = eng.warmup(*FULL_WARMUP, proportional=False)
    warm_s = time.perf_counter() - w0
    with counted("graphs-engine"):
        full = engine_replay(rec, every, eng)
    rows = full["rows"]
    check_launches("graphs-engine", expected_launches(rows))
    captures = [r["trigger_captures"] for r in rows]
    exact = [(_bucket(r["node_len"], cfg.capacity.initial_nodes),
              _bucket(max(r["edge_len"], 1), cfg.capacity.initial_edges))
             for r in rows]
    if not (len(rows) >= 5 and not any(captures)
            and same_replay(full, eager)
            and [b[:2] for b in full["boxes"]] == exact):
        raise AssertionError(
            f"graphed engine: {len(rows)} triggers, captures {captures}, "
            f"boxes {[b[:2] for b in full['boxes']]} for buckets {exact}, "
            f"equal to the eager replay {same_replay(full, eager)}")
    ws = eng.warmup_stats
    full.update(warmup_stats=ws, warm_s=warm_s, exact=exact)
    big = max(ws, key=lambda r: (r["n_cap"], r["e_cap"]))
    ms, ms_e = walls(full), walls(eager)
    say("graphs-engine", triggers=len(rows), trigger_captures=sum(captures),
        warmed_buckets=n_warm, warmup_s=round(warm_s, 3),
        capture_s_total=round(sum(r["capture_s"] for r in ws), 3),
        instantiate_s_total=round(sum(r["instantiate_s"] for r in ws), 3),
        first_replay_s_total=round(sum(r["first_replay_s"] for r in ws), 3),
        pool_mb_total=round(sum(r["pool_mb"] for r in ws), 1),
        largest_bucket=json.dumps({k: (round(v, 4) if isinstance(v, float)
                                       else v) for k, v in big.items()}),
        bit_equal_to_eager=True, final_chi2=rows[-1]["final_cost"],
        median_trigger_wall_ms=ms["median"], p90_trigger_wall_ms=ms["p90"],
        eager_median_trigger_wall_ms=ms_e["median"],
        eager_p90_trigger_wall_ms=ms_e["p90"],
        replay_wall_s=round(full["wall"], 3),
        eager_replay_wall_s=round(eager["wall"], 3),
        launches=json.dumps(PATH_LAUNCHES["graphs-engine"],
                            separators=(",", ":")), card=repr(card))
    graphs_engine_cover(rec, every, engine, full, card)


# phase 18 (c)'s proportional warmup: the stream's own sizes (make_stream)
COVER_WARMUP = (5000, 2500)


def graphs_engine_cover(rec, every: int, engine, full: dict,
                        card: str) -> None:
    """Phase 18 (c), the bucket cover: the same stream on an engine
    warmed by warmup(5000, 2500), the proportional ladder of the stream's
    own sizes (the full product's Programs dropped first, so that its
    buckets are captured afresh). Every trigger solves in its exact
    bucket or, where the ladder leaves that out, in the smallest captured
    bucket that holds it, with no capture on the trigger path; bit for
    bit an eager twin given the same warmup call (the same set, so the
    same boxes; its warmup finds the Programs cached and captures
    nothing). Printed beside `full`, the full-product run: the warmup's
    buckets, wall and pools; each covered trigger's solve ms against the
    full-product run's solve of it in its exact bucket, and the capture
    and composition that bucket cost there (the stall that the trigger
    path takes without a cover); trigger median, p90 and max."""
    graphs.clear()
    eng = engine()
    w0 = time.perf_counter()
    n_warm = eng.warmup(*COVER_WARMUP)
    warm_s = time.perf_counter() - w0
    with counted("graphs-engine-cover"):
        run = engine_replay(rec, every, eng)
    rows = run["rows"]
    check_launches("graphs-engine-cover", expected_launches(rows))
    ws = eng.warmup_stats
    warmed = [(r["n_cap"], r["e_cap"]) for r in ws]
    captures = [r["trigger_captures"] for r in rows]
    boxes = [b[:2] for b in run["boxes"]]
    want = [cover_box(b, warmed) for b in full["exact"]]
    covered = [i for i, (b, e) in enumerate(zip(boxes, full["exact"]))
               if b != e]
    twin = engine()
    with lm_ops._eager_solves():
        twin_warm = twin.warmup(*COVER_WARMUP)
        eager = engine_replay(rec, every, twin)
    sizes = [(r["node_len"], r["edge_len"]) for r in rows]
    if not (n_warm == twin_warm == len(ws) and all(r["captured"] for r in ws)
            and sizes == [(r["node_len"], r["edge_len"])
                          for r in full["rows"]]
            and not any(captures) and boxes == want and covered
            and [b[:2] for b in eager["boxes"]] == boxes
            and twin._warmed_buckets == eng._warmed_buckets
            and same_replay(run, eager)):
        raise AssertionError(
            f"bucket cover: warmed {warmed}, triggers {sizes}, captures "
            f"{captures}, boxes {boxes} where the cover gives {want}, eager "
            f"twin's boxes {[b[:2] for b in eager['boxes']]}, equal to it "
            f"{same_replay(run, eager)}")
    fws = {(r["n_cap"], r["e_cap"]): r for r in full["warmup_stats"]}
    stall = {}
    for i in covered:
        r = fws[full["exact"][i]]
        stall[str(full["exact"][i])] = round(
            1e3 * (r["capture_s"] + r["instantiate_s"]), 3)
    fw = full["warmup_stats"]
    ms, ms_f = walls(run), walls(full)
    say("graphs-engine-cover", route="graphs", triggers=len(rows),
        trigger_captures=sum(captures), covered_triggers=len(covered),
        warmed_buckets=n_warm, full_product_buckets=len(fw),
        warmup_s=round(warm_s, 3), full_product_warmup_s=round(full["warm_s"],
                                                                3),
        pool_mb_total=round(sum(r["pool_mb"] for r in ws), 1),
        full_product_pool_mb_total=round(sum(r["pool_mb"] for r in fw), 1),
        capture_s_total=round(sum(r["capture_s"] for r in ws), 3),
        instantiate_s_total=round(sum(r["instantiate_s"] for r in ws), 3),
        bit_equal_to_eager_twin=True,
        boxes=json.dumps(boxes, separators=(",", ":")),
        final_chi2=rows[-1]["final_cost"],
        full_product_final_chi2=full["rows"][-1]["final_cost"],
        median_trigger_wall_ms=ms["median"], p90_trigger_wall_ms=ms["p90"],
        max_trigger_wall_ms=ms["max"],
        full_product_median_trigger_wall_ms=ms_f["median"],
        full_product_p90_trigger_wall_ms=ms_f["p90"],
        full_product_max_trigger_wall_ms=ms_f["max"],
        replay_wall_s=round(run["wall"], 3),
        full_product_replay_wall_s=round(full["wall"], 3),
        launches=json.dumps(PATH_LAUNCHES["graphs-engine-cover"],
                            separators=(",", ":")), card=repr(card))
    for i in covered:
        say("graphs-engine-covered", trigger=rows[i]["trigger"],
            node_len=rows[i]["node_len"], edge_len=rows[i]["edge_len"],
            exact_bucket=json.dumps(full["exact"][i]),
            box=json.dumps(boxes[i]),
            solve_ms=round(run["boxes"][i][2], 3),
            exact_box_solve_ms=round(full["boxes"][i][2], 3),
            lm_iterations=rows[i]["lm_iterations"],
            cg_iterations=rows[i]["cg_iterations"],
            exact_box_lm_iterations=full["rows"][i]["lm_iterations"],
            exact_box_cg_iterations=full["rows"][i]["cg_iterations"],
            exact_bucket_capture_and_compose_ms=stall[
                str(full["exact"][i])],
            trigger_wall_ms=round(rows[i]["trigger_wall_ms"], 3),
            exact_box_trigger_wall_ms=round(
                full["rows"][i]["trigger_wall_ms"], 3), card=repr(card))
    graphs.clear()


def phase_graphs(dev, card: str) -> None:
    """Phase 18 (see the module note)."""
    spec = (5000, 10000, 8192, 16384)
    prob = circle_problem(*spec, np.float32, dev)
    a = graphed_against_eager(prob, PRODUCT, "graphs-5k", card)
    if not (a["lm_iterations"] == 10 and a["cg_iterations"] == 318):
        raise AssertionError(f"graphed 5k/10k: {a['lm_iterations']} LM / "
                             f"{a['cg_iterations']} CG")
    n, loops, n_cap, e_cap = CAPACITY
    cap = circle_problem(n, loops, n_cap, e_cap, np.float32, dev)
    b = graphed_against_eager(cap, PRODUCT, "graphs-30k", card)
    if not within_quality(b["chi2"], CHI2_CAP):
        raise AssertionError(f"graphed 30k/30k chi^2 {b['chi2']}")
    del cap
    graphs_engine(dev, card)
    d = graphed_against_eager(prob, dict(PRODUCT, precision="mixed"),
                              "graphs-mixed", card)
    if json.loads(d["by_precision"]) != {
            k: {"f32": v, "f64": 0} for k, v in
            solve_launches(d["result"], 45).items()}:
        raise AssertionError(f"graphed mixed rung: {d['by_precision']}")
    graphed_against_eager(prob,
                          dict(PRODUCT, preconditioner="band*coarse"),
                          "graphs-two-grid", card, precond_matvecs=2, reps=3)
    graphed_against_eager(prob, dict(PRODUCT, residual_mode="4dof"),
                          "graphs-four-dof", card, reps=3)


PHASES = ("build", "k1", "k2", "precond", "solve", "engine", "escalation", "cli-solve",
          "replay", "serve", "two-grid", "four-dof", "incremental", "mesh",
          "capacity", "capacity_stream", "bench", "graphs", "stream_rows")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run (of "
                    f"{','.join(PHASES)}); a partial run prints no result "
                    "line. Default: all")
    args = ap.parse_args(argv)
    only = [p for p in args.only.split(",") if p]
    if set(only) - set(PHASES):
        raise SystemExit(f"unknown phases {set(only) - set(PHASES)}")

    def run(phase: str) -> bool:
        return not only or phase in only

    card = phase_device()
    dev = torch.device("cuda", 0)
    k1 = k2 = precond = {}
    if run("build"):
        phase_build()
    if run("k1"):
        k1 = phase_k1(dev)
    if run("k2"):
        k2 = phase_k2(dev)
    if run("precond"):
        precond = phase_precond(dev, card)
    fp32_chi2 = None
    if run("solve"):
        fp32_chi2 = phase_solve(dev, card)
    if run("engine"):
        phase_engine(dev)
    if run("escalation"):
        phase_escalation(dev, card, fp32_chi2)
    with tempfile.TemporaryDirectory(prefix="kpg") as tmp:
        if run("cli-solve"):
            phase_cli_solve(tmp, card)
        if run("replay"):
            phase_replay(tmp, card)
        if run("serve"):
            phase_serve(dev, tmp, card)
        if run("two-grid"):
            phase_two_grid(dev, card)
        if run("four-dof"):
            phase_four_dof(dev, card)
        if run("incremental"):
            phase_incremental(tmp, card)
    if run("capacity"):
        phase_capacity(dev, card)
    if run("capacity_stream"):
        phase_capacity_stream(dev, card)
    if run("mesh"):       # after phase 15, whose profiled solve comes first
        phase_mesh(dev, card)
    if run("bench"):
        phase_bench(card)
    if run("graphs"):
        phase_graphs(dev, card)
    if run("stream_rows"):
        phase_stream_rows(card)
    if only:
        say("partial", phases=",".join(only), card=repr(card))
        return
    by_path = {k: {p: n[k] for p, n in PATH_LAUNCHES.items() if k in n}
               for k in WRAPPERS}
    kernels = [
        dict(name="band_matvec", route="cuda",
             source="solve_keyframe_pose_graph_tpu_torch/csrc/band_matvec.cu",
             replaces="solve_keyframe_pose_graph_tpu/ops/pallas_band.py:77",
             launches=sum(by_path["band_matvec"].values()),
             launches_by_path=by_path["band_matvec"],
             launches_measured={p: n["band_matvec"]
                                for p, n in PROFILED.items()},
             profiler_disagrees={p: d["profiler"]["band_matvec"]
                                 for p, d in DISAGREED.items()}, **k1),
        dict(name="gj_inv", route="cuda",
             source="solve_keyframe_pose_graph_tpu_torch/csrc/gj_inv.cu",
             replaces="solve_keyframe_pose_graph_tpu/ops/smallinv.py:74",
             launches=sum(by_path["gj_inv"].values()),
             launches_by_path=by_path["gj_inv"],
             launches_measured={p: n["gj_inv"] for p, n in PROFILED.items()},
             profiler_disagrees={p: d["profiler"]["gj_inv"]
                                 for p, d in DISAGREED.items()}, **k2),
        dict(name="bcr_apply", route="cuda",
             source="solve_keyframe_pose_graph_tpu_torch/csrc/bcr_apply.cu",
             replaces=None,
             launches=sum(by_path["precond_apply"].values()),
             launches_by_path=by_path["precond_apply"], **precond),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
