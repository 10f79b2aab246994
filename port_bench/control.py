#!/usr/bin/env python3
"""Readings for the limits of the comparison that decides `correct`: the
program's numbers and the control's, on the same judged answers.

    python3 port_bench/control.py --workload CELL --seconds S --seeds A,B,C

For each seed, one run of the cell (harness/stream.py, a window of S
seconds at the cell's own load), then, for each answer the run judges,
the numbers of harness/check.py twice: for the program's answer (the
lower reading), and for the control's, the plain reference put in the
program's place and computed in TF32 (the precision below the
configuration's float32 with TF32 off), from the same start (the upper
reading). One JSON line per seed. The benchmark's runs never run it.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench.harness import check, manifest, stream  # noqa: E402

KEYS = ("chi2_gap", "start_gap", "pose_gap_m", "switch_flips", "chi2", "chi2_reference",
        "start_chi2", "reference_iterations", "reference_s", "node_len",
        "first")


def readings(cfg: dict, rec: dict, root: str = ROOT) -> dict:
    out = {"seed": rec["seed"], "program": [], "tf32": []}
    ref_mod = check.reference(cfg, root)
    for a in check.judged(cfg, rec):
        for name, precision in (("program", "fp64"), ("tf32", "tf32")):
            nums = check.step(cfg, ref_mod, rec["graph"], a, precision)
            out[name].append({k: nums[k] for k in KEYS})
    return out


def main(argv=None, *, device: str = "cuda", root: str = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = manifest.load(root)
    wl = manifest.workload(bench, args.workload)
    cfg = manifest.config(bench, wl["config"], root)
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = stream.run(args.workload, seed, args.seconds, False,
                         t_start=time.monotonic(), device=device,
                         bench=bench, root=root)
        r = readings(cfg, rec, root)
        r["limits"] = cfg["limits"]
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
