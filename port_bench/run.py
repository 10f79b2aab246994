#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 port_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout that holds BENCHMARK.json. A cell is a
configuration (port_bench/configs/) under a traffic mix
(port_bench/traffic/), served by the program's PoseGraphServer on one card
(harness/stream.py). With --trace 0 the last line's metrics are the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, each from its
reader (port_bench/metrics/<name>.py). Earlier lines: [card], [setup],
[window], [solves] (each solve's ms, to read the wall level a process sat
at), [buckets], [profile], [k1-check], [check]. The run's full record goes
to $TMPDIR/port_bench/, gzipped.

The last line is one JSON object: correct, attempted (the window's loop
edges and pose queries), failed (edges not corrected by the drain's end and
queries not answered with a pose), metrics, device, with --trace 1
breakdown, and last "checks": each number compared with its limit
(harness/check.py). The same numbers are the last lines on standard error.

Exits non-zero with no result without a CUDA device or with fewer than the
cell asks for, and when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gzip  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench.harness import check, manifest, records, stream  # noqa: E402
from port_bench.harness import trace as trace_mod  # noqa: E402


def _num(v):
    """A JSON number: never NaN or infinite."""
    return v if v is not None and math.isfinite(v) else None


def _earlier_lines(rec: dict) -> None:
    say = stream.say
    before = [r["stats"] for r in rec["triggers"]
              if r["fired"] and r["stats"] and r["ret"] < rec["t0"]]
    say("setup", setup_s=rec["setup_s"], store=rec["store"],
        solves=len(before),
        captures=sum(r.get("trigger_captures", 0) for r in before),
        escalated=sum(1 for r in before if r.get("fp64_escalated")),
        **{k: round(v, 3) for k, v in rec["setup"].items()})
    late = [s - d for d, s in zip(rec["keyframes"]["due"],
                                  rec["keyframes"]["sent"])]
    solves = records.window_triggers(rec)
    say("window", seconds=rec["seconds"], loop_edges=len(rec["edges"]["due"]),
        keyframes=len(late), keyframe_late_ms_max=round(1e3 * max(late), 3)
        if late else None, pose_queries=len(records.query_latencies_ms(rec)),
        solves=len(solves), drain_s=round(rec["drain_s"], 3),
        clock=json.dumps(rec["clock"], separators=(",", ":")))
    lat = records.edge_latencies_ms(rec)
    say("latency", loop_p50_ms=records.percentile(lat, 50),
        loop_mean_ms=sum(lat) / len(lat) if lat else None,
        loop_max_ms=max(lat) if lat else None)
    q = records.query_latencies_ms(rec)
    say("serving", pose_query_p50_ms=records.percentile(q, 50),
        pose_query_p99_ms=records.percentile(q, 99),
        pose_query_max_ms=max(q) if q else None)
    say("solves", solve_ms=json.dumps(
        [round(r["device_solve_ms"] - r["stats"]["problem_build_ms"], 2)
         for r in solves if r["stats"]]))
    cap = rec["capacity"]
    rows = [r["stats"] for r in solves if r["stats"]]
    buckets = sorted({(records.bucket(r["node_len"], cap["initial_nodes"]),
                       records.bucket(r["edge_len"], cap["initial_edges"]))
                      for r in rows})
    esc = [r for r in rec["solve_stats"] if r.get("background_escalation")]
    say("escalations", count=len(esc), detail=json.dumps(
        [{k: r.get(k) for k in ("trigger", "node_len", "escalated_rung",
                                "applied", "escalation_wall_ms")}
         for r in esc]))
    say("buckets", used=json.dumps(buckets),
        trigger_captures=sum(r.get("trigger_captures", 0) for r in rows),
        escalated=sum(1 for r in rows if r.get("fp64_escalated")),
        lm_iterations=json.dumps(sorted({r["lm_iterations"] for r in rows})))
    prof = rec.get("profile")
    if prof:
        k1, _ = records.profile_kernels(rec, "band_matvec_kernel")
        cg = sum(r["cg_iterations"] for r in prof["solves"] if r)
        say("profile", solves=len(prof["solves"]),
            device_events=prof.get("device_events"),
            span_ms=(prof.get("span_ns") or 0) / 1e6,
            busy_ms=(prof.get("busy_ns") or 0) / 1e6)
        say("k1-check", profiler=k1, cg_iterations=cg,
            counted=prof.get("k1_counted"),
            agree=(k1 == cg == prof.get("k1_counted")))


def _trace_sound(rec: dict) -> None:
    """A traced run whose profile saw no device operation, or whose K1
    launches differ from the profiled solves' CG iterations or the
    program's launch counter, ends with no result: its device metrics
    would be missing or wrong."""
    prof = rec.get("profile") or {}
    k1, _ = records.profile_kernels(rec, "band_matvec_kernel")
    cg = sum(r["cg_iterations"] for r in prof.get("solves") or () if r)
    if not prof.get("device_events") or not k1 == cg == prof.get(
            "k1_counted"):
        sys.exit(f"port_bench: the traced run's profile is not sound "
                 f"(device events {prof.get('device_events')}, K1 launches "
                 f"{k1}, CG iterations {cg}, counted "
                 f"{prof.get('k1_counted')}); no result")


def _breakdown(rec: dict) -> dict | None:
    prof = rec.get("profile") or {}
    if not prof.get("by_name"):
        return None
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[n[:120], t / 1e9] for n, (_, t) in top],
            "idle_gaps": [[label, ns / 1e9] for label, ns in prof["gaps"]]}


def _save(rec: dict, result: dict) -> str:
    d = os.path.join(tempfile.gettempdir(), "port_bench")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{rec['cell']}-{rec['seed']}-"
                           f"{int(rec['trace'])}.json.gz")
    keep = {k: v for k, v in rec.items() if k not in ("graph", "answers")}
    keep["answers"] = [{k: a[k] for k in ("first", "call", "trigger",
                                          "escalated", "stats")}
                       for a in rec["answers"]]
    with gzip.open(path, "wt") as f:
        json.dump({"record": keep, "result": result}, f, default=str)
    return path


def main(argv=None, *, device: str = "cuda", root: str = ROOT,
         patch=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest.load(root)
    wl = manifest.workload(bench, args.workload)
    cfg = manifest.config(bench, wl["config"], root)
    trace = bool(args.trace)
    # the reference is loaded before the run: its imports (scipy.sparse,
    # scipy.sparse.linalg) are in place before the program's, which import
    # them too, on the fp64 host rung's first escalation; loaded after
    # the window instead, they move into that escalation and lengthen the
    # 5k cell's set-up (PERF.md, Open questions)
    ref_mod = check.reference(cfg, root)

    rec = stream.run(args.workload, args.seed, args.seconds, trace,
                     t_start=T_START, device=device, bench=bench, root=root,
                     patch=patch)
    rec["formulation"] = cfg["formulation"]
    metrics = {}
    for m in manifest.metrics(bench, args.workload, trace):
        v = _num(manifest.reader(m["name"], os.path.join(root, "port_bench"))
                 (rec))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    _earlier_lines(rec)
    if trace and device == "cuda":
        _trace_sound(rec)

    nums = check.compare(cfg, rec, ref_mod)
    for a in nums["per_answer"]:
        stream.say("check", **a)
    verdict = check.verdict(cfg, nums)
    uncorrected = sum(d is None for d in rec["edges"]["done"])
    window_q = [q for q in rec["queries"] if rec["t0"] <= q[0] < rec["t_end"]]
    unanswered = sum(not ok for _, _, ok in window_q)
    correct = (all(w for _, _, w in verdict.values()) and not uncorrected
               and not unanswered)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": rec["card"].get("name", device), "count": 1,
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    prof = rec.get("profile") or {}
    if trace and prof.get("span_ns"):
        dev["busy_s"] = prof["busy_ns"] / 1e9
        dev["window_s"] = prof["span_ns"] / 1e9
    result = {"correct": correct,
              "attempted": len(rec["edges"]["due"]) + len(window_q),
              "failed": uncorrected + unanswered,
              "metrics": metrics, "device": dev}
    if trace and _breakdown(rec):
        result["breakdown"] = _breakdown(rec)
    checks = {k: {"value": _num(v), "limit": lim}
              for k, (v, lim, _) in verdict.items()}
    checks["uncorrected_edges"] = {"value": uncorrected, "limit": 0}
    checks["unanswered_queries"] = {"value": unanswered, "limit": 0}
    result["checks"] = checks
    stream.say("record", path=_save(rec, result))
    trace_mod.check_no_jax("before the result")
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
