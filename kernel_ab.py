#!/usr/bin/env python3
"""A/B of the port's two CUDA kernels against another commit's, on one card.

    python3 kernel_ab.py --parent DIR [--out FILE]

DIR holds a checkout of the commit to compare with, at least its
`solve_keyframe_pose_graph_tpu_torch/` (and whatever that package imports),
for example

    git archive <commit> solve_keyframe_pose_graph_tpu_torch \\
        solve_keyframe_pose_graph_tpu native | tar -x -C _checkout/parent

It prints, one line each:
  1. the card's name and power limit;
  2. `nvcc -Xptxas -v` for each kernel instance of this tree's two sources
     (registers, stack, spills) and the dynamic shared memory a K1 launch
     asks for at the main path's shape;
  3. K1 at N = 8192, F = 5 and K2 at n = 1024, d = 30 (and K2 on the cyclic
     reduction's odd blocks A[1::2] at n = 512, which the parent copies
     first), fp32 and fp64: device time per call of the parent's kernel and
     this tree's, in turns parent, this, this, parent (chip_smoke.event_ms:
     launch overhead hidden; K1 also with the L2 cache flushed);
  4. the 5k-node / 10k-edge lm_solve of chip_smoke.py phase 5, run by each
     tree's own package in a subprocess, in turns parent, this, this,
     parent: one torch.profiler window over one warm solve (device time of
     every kernel and copy, K1's and K2's share, launches), and the host-clock
     wall of three unprofiled solves.
The results also go to FILE as JSON (default chiprun_out/kernel_ab.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from chip_smoke import K1_MAIN, K2_MAIN, card_line, cold_event_ms, event_ms
from solve_keyframe_pose_graph_tpu_torch.ops import _kernels, band_matvec
from solve_keyframe_pose_graph_tpu_torch.ops import smallinv

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "solve_keyframe_pose_graph_tpu_torch"
_P, _I = ctypes.c_void_p, ctypes.c_int

# the parent's C entries: K1 as now; K2 without the batch stride
PARENT_ENTRIES = {
    "band_matvec": {f"kpg_band_matvec_{t}": [_P, _P, _P, _P, _I, _I, _P]
                    for t in ("f32", "f64")},
    "gj_inv": {f"kpg_gj_inv_{t}": [_P, _P, _I, _I, _P]
               for t in ("f32", "f64")},
}

PROFILE = r"""
import json, time
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
from solve_keyframe_pose_graph_tpu_torch.ops.lm import lm_solve
from solve_keyframe_pose_graph_tpu_torch.solver.problem import build_problem_np

PRODUCT = dict(max_iterations=10, preconditioner="band+coarse", bcr_levels=2,
               max_cg_iterations=45)
# one profiler session before any graph is composed: in executables
# composed before a process's first session the profiler saw each WHILE
# node's body run once (chip_smoke.prime_profiler)
with profile(activities=[ProfilerActivity.CUDA]):
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
g = synthetic.circle_graph(n_nodes=5000, n_loops=10000, seed=0,
                           outlier_fraction=0.2)
prob = build_problem_np(
    q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
    node_valid=np.ones(5000, bool), loop_pairs=g.loop_pairs, loop_q=g.loop_q,
    loop_t=g.loop_t, loop_w=g.loop_w, loop_valid=np.ones(10000, bool),
    switch=np.full(10000, 0.99), prior_idx=np.array([0]), prior_q=g.vio_q[:1],
    prior_t=g.vio_t[:1], prior_w=np.array([1.1]), n_cap=8192, e_cap=16384,
    p_cap=8, dtype=np.float32, device="cuda")
for _ in range(2):
    float(lm_solve(prob, **PRODUCT).final_cost)
walls = []
for _ in range(3):
    t0 = time.perf_counter()
    float(lm_solve(prob, **PRODUCT).final_cost)
    walls.append((time.perf_counter() - t0) * 1e3)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    chi2 = float(lm_solve(prob, **PRODUCT).final_cost)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
dev = [e for e in prof.events()
       if e.device_type == torch.autograd.DeviceType.CUDA]

def ms(evs):
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3

k1 = [e for e in dev if "band_matvec" in e.name]
k2 = [e for e in dev if "gj_inv" in e.name]
device_ms = ms(dev)
print(json.dumps(dict(
    chi2=chi2, profiled_wall_ms=wall, device_ms=device_ms,
    device_busy_share=device_ms / wall, device_events=len(dev),
    k1_launches=len(k1), k1_ms=ms(k1), k2_launches=len(k2), k2_ms=ms(k2),
    unprofiled_wall_ms=walls)))
"""


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvcc(src: str, out: str, extra=()) -> subprocess.CompletedProcess:
    cmd = [_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, *extra, "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
    return proc


def ptxas_report(src: str, tmp: str) -> list:
    """One dict per kernel instance: registers, stack and spill bytes."""
    proc = nvcc(src, os.path.join(tmp, os.path.basename(src) + ".o"),
                ("-c", "-Xptxas", "-v"))
    rows, name = [], None
    for line in (proc.stderr + proc.stdout).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            rows.append(dict(kernel=name, stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3))))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def build_all(parent: str, tmp: str):
    """This tree's two libraries (through _kernels), the parent's two
    (nvcc into tmp) and the ptxas reports, all compiles started together."""
    srcs = {k: os.path.join(parent, PKG, "csrc", k + ".cu")
            for k in PARENT_ENTRIES}
    with ThreadPoolExecutor(6) as pool:
        ours = {k: pool.submit(_kernels.build, k) for k in PARENT_ENTRIES}
        theirs = {k: pool.submit(nvcc, s, os.path.join(tmp, f"lib{k}.so"))
                  for k, s in srcs.items()}
        ptx = {k: pool.submit(ptxas_report,
                              os.path.join(_kernels.CSRC_DIR, k + ".cu"), tmp)
               for k in PARENT_ENTRIES}
        for f in (*ours.values(), *theirs.values()):
            f.result()
        report = {k: f.result() for k, f in ptx.items()}
    libs = {}
    for k, entries in PARENT_ENTRIES.items():
        lib = ctypes.CDLL(os.path.join(tmp, f"lib{k}.so"))
        for fn, argtypes in entries.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[k] = lib
    return libs, report


def parent_k1(lib, D, B, x):
    y = torch.empty_like(x)
    fn = (lib.kpg_band_matvec_f32 if x.dtype == torch.float32
          else lib.kpg_band_matvec_f64)
    rc = fn(D.data_ptr(), B.data_ptr(), x.data_ptr(), y.data_ptr(),
            B.shape[0], x.shape[1], _kernels.stream_handle(x.device))
    if rc:
        raise RuntimeError(f"parent K1 launch failed ({rc})")
    return y


def parent_k2(lib, A):
    """The parent's best_inv on a CUDA batch: a contiguous copy (for a
    strided view), then its kernel."""
    A = A.contiguous()
    out = torch.empty_like(A)
    d = A.shape[-1]
    fn = (lib.kpg_gj_inv_f32 if A.dtype == torch.float32
          else lib.kpg_gj_inv_f64)
    rc = fn(A.data_ptr(), out.data_ptr(), A.numel() // (d * d), d,
            _kernels.stream_handle(A.device))
    if rc:
        raise RuntimeError(f"parent K2 launch failed ({rc})")
    return out


def in_turns(name: str, parent_fn, this_fn, ref, cold: bool = False) -> dict:
    """Device time per call, parent, this, this, parent; both checked
    against `ref` first."""
    for who, fn in (("parent", parent_fn), ("this", this_fn)):
        got = fn()
        torch.cuda.synchronize()
        err = float((got.double() - ref.double()).abs().max()
                    / ref.double().abs().max())
        if not err <= (1e-4 if got.dtype == torch.float32 else 1e-10):
            raise AssertionError(f"{name}: {who} disagrees, rel err {err}")
    times = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        fn = parent_fn if who == "parent" else this_fn
        times[who].append(event_ms(fn))
    row = dict(parent_ms=times["parent"], this_ms=times["this"],
               speedup=float(np.mean(times["parent"])
                             / np.mean(times["this"])))
    if cold:
        row["parent_ms_cold_l2"] = cold_event_ms(parent_fn)
        row["this_ms_cold_l2"] = cold_event_ms(this_fn)
    say("ab", kernel=name, **row)
    return row


def kernels_ab(libs) -> dict:
    rng = np.random.default_rng(3)
    dev = torch.device("cuda", 0)
    out = {}
    N, F = K1_MAIN
    n, d = K2_MAIN
    G = rng.normal(size=(2 * n, d, d))
    spd = G @ np.swapaxes(G, -1, -2) / d + 0.5 * np.eye(d)
    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[1]
        D, B, x = (torch.tensor(rng.normal(size=s), dtype=dt, device=dev)
                   for s in ((36, N), (F, 36, N), (6, N)))
        out[f"k1_{tag}"] = in_turns(
            f"K1 N={N} F={F} {tag}",
            lambda: parent_k1(libs["band_matvec"], D, B, x),
            lambda: band_matvec.band_matvec(D, B, x),
            band_matvec.band_matvec_plain(D, B, x), cold=True)
        whole = torch.tensor(spd, dtype=dt, device=dev)
        A = whole[:n].contiguous()
        out[f"k2_{tag}"] = in_turns(
            f"K2 n={n} d={d} {tag}",
            lambda: parent_k2(libs["gj_inv"], A),
            lambda: smallinv.gj_inv(A), torch.linalg.inv(A.double()))
        odd = whole[:n][1::2]
        out[f"k2_odd_{tag}"] = in_turns(
            f"K2 odd blocks A[1::2] n={n // 2} d={d} {tag}",
            lambda: parent_k2(libs["gj_inv"], odd),
            lambda: smallinv.best_inv(odd), torch.linalg.inv(odd.double()))
    return out


def solve_profile(root: str, who: str) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", PROFILE], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{who} solve profile failed:\n{proc.stderr}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    say("solve-profile", tree=who, **row)
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="checkout of the commit to compare with")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "kernel_ab.json"))
    args = ap.parse_args(argv)
    parent = os.path.abspath(args.parent)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(parent, PKG, "csrc")):
        raise SystemExit(f"kernel_ab: no {PKG}/csrc under {parent}")
    card = card_line()
    say("device", name=torch.cuda.get_device_name(0), nvidia_smi=repr(card))
    tmp = os.path.join(parent, "_ab_build")
    os.makedirs(tmp, exist_ok=True)
    t0 = time.perf_counter()
    libs, report = build_all(parent, tmp)
    say("build", seconds=round(time.perf_counter() - t0, 2))
    for k, rows in report.items():
        for r in rows:
            say("ptxas", source=k, **r)
    N, F = K1_MAIN
    for es in (4, 8):
        h = (F + 16 // es - 1) // (16 // es) * (16 // es)
        smem = es * (36 * 32 + 6 * (32 + 2 * h) + F * 36 * (32 + h))
        say("smem", kernel="band_matvec", elem_bytes=es, N=N, F=F,
            dynamic_shared_bytes_per_block=smem)
    result = dict(card=card, ptxas=report, kernels=kernels_ab(libs))
    result["solve"] = [solve_profile(root, who) for who, root in
                       (("parent", parent), ("this", REPO),
                        ("this", REPO), ("parent", parent))]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(card, flush=True)


if __name__ == "__main__":
    main()
