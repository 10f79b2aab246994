#!/usr/bin/env python3
"""Engine rows of the PyTorch/CUDA port on one NVIDIA GPU: the streaming
engine's trigger latency, multi-world recovery, start-up and the bucket
cover, each row in fresh processes.

    python3 bench_stream_torch.py [--only KEY,...] [--procs 3]
                                  [--out PATH] [--device cuda]

The counterpart of the engine rows of benchmarks/run_baseline.py
(bench_streaming, bench_multiworld, bench_warmup_cache), which run the JAX
package: the same graphs, seeds, trigger cadence, pacing, warmup calls,
distress injection and row keys. --only takes run_baseline.py's keys of
those rows (streaming, streaming_warm, streaming_10k, streaming_paced,
streaming_30k, streaming_distress, multiworld) and two of the port's: startup (the row
startup_10k, bench_warmup_cache's counterpart) and cover (cover_2k_4000).
Default: every row. --out writes every process's full record as JSON
(never into benchmarks/results.json).

The rows (ROWS), each through SolverEngine on the port's GraphStore:
  streaming_*: circle_graph(nodes, loops, seed=1) at the default Config,
    fed node by node, each loop edge right after its later endpoint, a
    trigger polled every `every` nodes after a sleep of pace_ms (feed).
    Warm rows call warmup(nodes, loops) first and wait for the host fp64
    rung's load; cold rows capture each bucket on the trigger path. A
    distress row runs its N-th fired trigger with the ladder forced
    (escalate_rejects=0); a poll that does not fire keeps it armed. Then
    drain, one settle trigger, drain (run_baseline.py:225-371).
  multiworld_1500: circle_graph(1500, 300, seed=4) with kidnaps before
    nodes 500 and 1000 and unkidnaps before 520 and 1030, stamped half a
    node period before the node; a trigger every 50 nodes and one at the
    end (run_baseline.py:498-538).
  startup_10k: the process loads the kernels (nvcc builds them where
    _build/ holds none: the first process on a fresh checkout), then
    SolverEngine(GraphStore(), Config()).warmup(10000, 2000,
    background=True): its return is ready_s, the time to a first solve.
    One trigger right after, on a small stream in the first bucket
    (circle_graph(1000, 200, seed=1)), serves while the warmup thread
    captures and waits for the device lock (lock_wait_ms); warmup_join()
    gives warmup_s, the time until every bucket is captured; warmup_stats
    per bucket. CUDA graphs are captured anew in every process, so the
    reference's cold / warm cache pair is --procs identical processes.
  cover_2k_4000: circle_graph(2000, 4000, seed=1), a trigger every 50
    nodes, the escalation ladder off (so both processes fire the same
    triggers), in two processes: A after warmup(5000, 2500), whose
    proportional ladder leaves (2048, 4096) out, so the triggers of that
    bucket solve in its cover (4096, 4096) at twice their n_cap; B after
    warmup(2000, 4000, proportional=False), every trigger in its exact
    bucket. Per trigger that A covers: the solve ms in each box, LM and CG
    counts, trigger walls. It changes no policy (ROADMAP.md Queue 3 item
    4).

Each process reports (mirroring run_baseline.py:329-370): the triggers;
median, p90 and max of the host-blocking trigger wall and the median of
its second half; the settle trigger's wall; the timer's mean ms by phase;
stall_detail, every trigger over twice the median with its phase deltas
and trigger_captures; the warmup's buckets, summed capture_s,
instantiate_s and pool MB, and its wall; the incremental builds, full and
delta; the background escalations (rung, applied, wall, rung_stats); the
final chi^2. Beside that: each trigger's box and exact bucket (read
through chip_smoke.solves_seen);
the K1 and K2 launches of the stream, counted (chip_smoke.counted) and
what its LM and CG counts imply (chip_smoke.expected_launches); the
card's name and power limit and nvidia-smi's SM clock, power and
temperature before and after the row.

The parent runs the processes in rounds, each row once a round, and
reads each child's last line; per row it prints the median of the
processes' medians with their min and max (the spread between processes).
Gates (row_gates, cross_gates; any failure exits non-zero before the
result line): the final chi^2 finite and within 2% of the JAX row's
(benchmarks/results.json; chip_smoke.QUALITY); 0 trigger captures on
every warmed row; launches as the LM and CG counts imply (not on
startup_10k, whose trigger shares the card with the warmup thread's
priming solves); in a distress row the forced escalation
applied and at least one trigger served after it landed (a poll or the
settle trigger); multiworld_1500 with 3 worlds in 1 set; cover_2k_4000's
boxes as cover_plan computes them without a solve, and the same triggers
in both processes.

Output: a line per process and per row, the gates, the card line, then
one JSON object: metric "engine_rows", card, power_limit_w, procs, and
per row the spread of its numbers. There is no CPU path: without CUDA it
exits non-zero before any row. The row functions take the device, so the
tests run them on the CPU at small sizes.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

import bench_torch
import chip_smoke
from chip_smoke import WRAPPERS
from solve_keyframe_pose_graph_tpu_torch.config import Config
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.ops import (
    _kernels, band_matvec, graph_loops, smallinv,
)
from solve_keyframe_pose_graph_tpu_torch.solver.engine import (
    SolverEngine, _bucket, _warmup_pairs,
)

REPO = os.path.dirname(os.path.abspath(__file__))
T0, DT = 1_000_000_000, 100_000_000      # the feed's stamps (ns)
CHILD_TIMEOUT_S = 1800


def row_key(nodes: int, loops: int, warm: bool = False, pace_ms: float = 0,
            inject_at: int = 0) -> str:
    """run_baseline.py's key of a sync streaming row (its :323-328)."""
    return (f"streaming_{nodes // 1000}k_{loops}" + ("_warm" if warm else "")
            + ("_paced" if pace_ms else "")
            + ("_distress" if inject_at else ""))


def _stream(only, chi2, nodes=2000, loops=400, every=50, **kw) -> tuple:
    spec = dict(kind="stream", only=only, chi2_jax=chi2, nodes=nodes,
                loops=loops, every=every, seed=1, warm=False, pace_ms=0.0,
                inject_at=0)
    spec.update(kw)
    return row_key(nodes, loops, spec["warm"], spec["pace_ms"],
                   spec["inject_at"]), spec


# the JAX rows' final chi^2 (benchmarks/results.json; BASELINE.md:279-289)
# of the 2k/400 stream: cold, warmed, paced
CHI2_2K = 0.14264783263206482
# run_baseline.py:514, nodes before which a kidnap (True) or an unkidnap
# (False) arrives
KIDNAPS = {500: True, 520: False, 1000: True, 1030: False}

# the rows in the order of a round, with the JAX rows' final chi^2
# (benchmarks/results.json). startup_10k goes first,
# so that the first process of a run on a fresh checkout builds the kernels
ROWS = dict([
    ("startup_10k", dict(kind="startup", only="startup", nodes=10000,
                         loops=2000)),
    _stream("streaming", CHI2_2K),
    _stream("streaming_warm", CHI2_2K, warm=True),
    _stream("streaming_10k", 1.1805845499038696, nodes=10000, loops=2000,
            every=100, warm=True),
    _stream("streaming_paced", CHI2_2K, warm=True, pace_ms=150.0),
    _stream("streaming_30k", 2.353930711746216, nodes=30000, loops=3000,
            every=500, warm=True, pace_ms=2000.0, inject_at=5),
    _stream("streaming_distress", 0.14265134930610657, warm=True,
            pace_ms=150.0, inject_at=10),
    ("multiworld_1500", dict(kind="multiworld", only="multiworld",
                             chi2_jax=0.030099306255578995, nodes=1500,
                             loops=300, seed=4, every=50, kidnaps=KIDNAPS)),
    ("cover_2k_4000", dict(kind="cover", only="cover", nodes=2000,
                           loops=4000, seed=1, every=50)),
])
ONLY_KEYS = tuple(dict.fromkeys(s["only"] for s in ROWS.values()))
# the cover row's two processes: warmup (max_nodes, max_edges), proportional
COVER_WARMUP = {"A": ((5000, 2500), True), "B": ((2000, 4000), False)}
# the start-up row's stream: one trigger in the first bucket
STARTUP_STREAM = dict(n_nodes=1000, n_loops=200, seed=1)


# ----------------------------------------------------------------------
# the feed and its statistics
# ----------------------------------------------------------------------

def edges_by_later(g) -> dict:
    """Loop edge indices of `g` by their later endpoint."""
    by_later: dict = {}
    for k in range(g.n_loops):
        a, b = map(int, g.loop_pairs[k])
        by_later.setdefault(max(a, b), []).append(k)
    return by_later


def ingest(store, g, i: int, by_later: dict, kidnaps=None) -> None:
    """Node i of `g` into `store`: a kidnap indicator of `kidnaps` (node
    -> kidnapped) half a node period before it, the node, then each loop
    edge whose later endpoint it is."""
    if kidnaps and i in kidnaps:
        store.kidnap_indicator(T0 + i * DT - DT // 2,
                               "kidnapped" if kidnaps[i] else "unkidnapped")
    store.add_node(T0 + i * DT, g.vio_q[i], g.vio_t[i])
    for k in by_later.get(i, ()):
        a, b = map(int, g.loop_pairs[k])
        store.add_loop_edge(T0 + a * DT, T0 + b * DT, g.loop_q[k],
                            g.loop_t[k], float(g.loop_w[k]))


def feed(eng, store, g, every: int, *, kidnaps=None, pace_s: float = 0.0,
         inject_at: int = 0) -> list:
    """Feed the synthetic graph `g` to `store` and poll eng.trigger() at
    every `every`-th node (0, every, ...), as run_baseline.py's streaming
    loop (:266-318) and multi-world loop (:516-528) do: each node through
    ingest(); before a poll a sleep of pace_s; the poll that would be the
    inject_at-th fired trigger (1-based) runs with escalate_rejects=0, and
    the next poll takes its place when it does not fire. Works with either
    package's engine and store. Returns one dict per fired poll: node,
    host-blocking wall ms, the engine's trigger id, the timer's phase
    deltas over it (ms), whether it was the forced one and whether the
    forced escalation's row had been written before it (landed)."""
    by_later = edges_by_later(g)
    fired, forced = [], None
    for i in range(g.n_nodes):
        ingest(store, g, i, by_later, kidnaps)
        if i % every:
            continue
        if pace_s:
            time.sleep(pace_s)
        inject = bool(inject_at) and len(fired) + 1 == inject_at
        landed = forced is not None and any(
            r.get("background_escalation") and r["trigger"] == forced
            for r in eng.solve_stats)
        saved = eng.config
        if inject:
            eng.config = dataclasses.replace(saved, solver=dataclasses.replace(
                saved.solver, escalate_rejects=0))
        before = dict(eng.timer.totals)
        t0 = time.perf_counter()
        try:
            ok = eng.trigger()
        finally:
            eng.config = saved
        wall = 1e3 * (time.perf_counter() - t0)
        if not ok:
            continue
        if inject:
            forced = eng.trigger_id
        fired.append(dict(
            node=i, wall_ms=wall, trigger=eng.trigger_id, injected=inject,
            landed=landed,
            phases_ms={k: round(1e3 * (v - before.get(k, 0.0)), 3)
                       for k, v in eng.timer.totals.items()
                       if v - before.get(k, 0.0) > 5e-4}))
    return fired


def wall_stats(walls: list) -> dict:
    """run_baseline.py's statistics of a row's trigger walls (ms)."""
    return dict(
        trigger_host_ms_median=float(np.median(walls)),
        trigger_host_ms_p90=float(np.percentile(walls, 90)),
        trigger_host_ms_max=float(max(walls)),
        steady_state_ms_median=float(np.median(walls[len(walls) // 2:])))


def exact_bucket(cap, node_len: int, edge_len: int) -> tuple:
    return (_bucket(node_len, cap.initial_nodes),
            _bucket(max(edge_len, 1), cap.initial_edges))


def cover_plan(g, every: int, warmed, cap) -> list:
    """Each trigger of `g` fed as feed() feeds it, to an engine whose
    warmup captured the buckets `warmed`, with no solve: [node, node_len,
    edge_len, exact bucket, box]. A poll fires when loop edges arrived
    since the last trigger (no kidnap, no escalation in flight); the box
    of each trigger (the engine's cover, chip_smoke.cover_box) joins the
    warmed set, as the engine's does."""
    later = np.sort(np.asarray(g.loop_pairs).max(axis=1))
    warmed, plan, prev = set(warmed), [], 0
    for i in range(0, g.n_nodes, every):
        edge_len = int(np.searchsorted(later, i, side="right"))
        if edge_len == prev:
            continue
        exact = exact_bucket(cap, i + 1, edge_len)
        box = chip_smoke.cover_box(exact, warmed) or exact
        warmed.add(box)
        plan.append([i, i + 1, edge_len, list(exact), list(box)])
        prev = edge_len
    return plan


def warmup_summary(eng, wall_s: float) -> dict:
    ws = eng.warmup_stats

    def total(k):
        return sum(r[k] for r in ws if r.get(k) is not None)

    return dict(buckets=len(ws), capture_s=total("capture_s"),
                instantiate_s=total("instantiate_s"),
                first_replay_s=total("first_replay_s"),
                pool_mb=total("pool_mb"), wall_s=wall_s)


def timed_warmup(eng, nodes: int, loops: int, **kw):
    """warmup() and the host fp64 rung's load; (buckets, wall s)."""
    t0 = time.perf_counter()
    n = eng.warmup(nodes, loops, **kw)
    if not eng.warmup_join(timeout=600):
        raise RuntimeError("warmup_join timed out")
    return n, time.perf_counter() - t0


@contextlib.contextmanager
def counted_boxes(key: str):
    """The launches of the body, counted under `key` (chip_smoke.counted),
    and the (n_cap, e_cap, ms) of each trigger's solve
    (chip_smoke.solves_seen)."""
    with chip_smoke.counted(key), chip_smoke.solves_seen() as seen:
        yield seen


def engine_record(key: str, eng, fired: list, seen: list) -> dict:
    """What a streaming or multi-world process reports of its engine after
    the stream (see the module note)."""
    cap = eng.config.capacity
    rows = [r for r in eng.solve_stats if "trigger_wall_ms" in r]
    if len(seen) != len(rows):
        raise AssertionError(f"{len(seen)} solves for {len(rows)} triggers")
    by_id = {r["trigger"]: r for r in rows}
    walls = [p["wall_ms"] for p in fired]
    med = float(np.median(walls))
    boxes = []
    for i, r in enumerate(rows):
        exact = exact_bucket(cap, r["node_len"], r["edge_len"])
        boxes.append([r["node_len"], r["edge_len"], list(exact),
                      list(seen[i][:2])])
    covered = sum(b[3] != b[2] for b in boxes)
    last = rows[-1] if rows else {}
    return dict(
        key=key, triggers=len(fired), **wall_stats(walls),
        walls_ms=[round(w, 3) for w in walls],
        stall_detail=[dict(p, trigger_captures=by_id.get(
            p["trigger"], {}).get("trigger_captures"))
            for p in fired if p["wall_ms"] > 2.0 * med],
        phase_ms_mean={k: 1e3 * eng.timer.totals[k]
                       / max(eng.timer.counts.get(k, 1), 1)
                       for k in sorted(eng.timer.totals)},
        incremental_builds=dict(full=last.get("full_builds"),
                                delta=last.get("delta_builds")),
        bg_escalations=[{k: r[k] for k in (
            "trigger", "escalated_rung", "applied", "final_cost",
            "escalation_wall_ms", "rung_stats", "escalation_error")
            if k in r} for r in eng.solve_stats
            if r.get("background_escalation")],
        trigger_captures=sum(r.get("trigger_captures", 0) for r in rows),
        boxes=boxes, covered=covered,
        solve_ms=[round(s[2], 3) for s in seen],
        final_chi2=(eng.solve_stats[-1]["final_cost"]
                    if eng.solve_stats else None),
        trigger_rows=[{k: r[k] for k in (
            "trigger", "node_len", "edge_len", "lm_iterations",
            "cg_iterations", "final_cost", "trigger_captures",
            "fp64_escalated") if k in r} for r in rows],
        launches=chip_smoke.net_launches(key),
        launches_want=chip_smoke.expected_launches(eng.solve_stats))


# ----------------------------------------------------------------------
# the rows (each returns one process's record)
# ----------------------------------------------------------------------

def stream(eng, store, g, s: dict) -> tuple:
    """A streaming row's calls (run_baseline.py:266-323): the feed, drain,
    one settle trigger (the edges that came in while an escalation ran),
    drain. Returns (fired polls, whether the settle trigger fired, its
    wall ms)."""
    fired = feed(eng, store, g, s["every"], pace_s=s["pace_ms"] / 1e3,
                 inject_at=s["inject_at"])
    eng.drain()
    t0 = time.perf_counter()
    settled = eng.trigger()
    settle_ms = 1e3 * (time.perf_counter() - t0)
    eng.drain()
    return fired, settled, settle_ms


def multiworld(eng, store, g, s: dict) -> list:
    """The multi-world row's calls (run_baseline.py:516-529): the feed
    with its kidnaps, then one trigger. Returns the fired polls."""
    fired = feed(eng, store, g, s["every"], kidnaps=s["kidnaps"])
    eng.trigger()
    return fired


def stream_row(key: str, device, config=None, **resize) -> dict:
    """One process of a streaming row of ROWS (run_baseline.py's
    bench_streaming); `config` replaces the default Config and `resize`
    entries of the row's spec (the tests' small sizes)."""
    s = dict(ROWS[key], **resize)
    g = synthetic.circle_graph(n_nodes=s["nodes"], n_loops=s["loops"],
                               seed=s["seed"])
    store = GraphStore()
    eng = SolverEngine(store, config or Config(), device=device)
    warm = None
    if s["warm"]:
        warm = warmup_summary(eng, timed_warmup(eng, s["nodes"],
                                                s["loops"])[1])
    with counted_boxes(key) as seen:
        fired, settled, settle_ms = stream(eng, store, g, s)
    rec = engine_record(key, eng, fired, seen)
    forced = [p for p in fired if p["injected"]]
    landed = [r for r in rec["bg_escalations"]
              if forced and r["trigger"] == forced[0]["trigger"]]
    rec.update(
        nodes=s["nodes"], loops=s["loops"], every=s["every"],
        pace_ms=s["pace_ms"], inject_at=s["inject_at"], warmup=warm, settle_wall_ms=settle_ms,
        settled=settled,
        forced_trigger=forced[0]["trigger"] if forced else None,
        forced_escalation=landed[0] if landed else None,
        served_after_landing=sum(p["landed"] for p in fired),
        settle_after_landing=bool(landed) and settled)
    return rec


def multiworld_row(key: str, device, config=None, **resize) -> dict:
    """One process of multiworld_1500 (run_baseline.py's
    bench_multiworld): its walls are the engine's trigger_wall_ms, as
    there. `config` and `resize` as in stream_row."""
    s = dict(ROWS[key], **resize)
    g = synthetic.circle_graph(n_nodes=s["nodes"], n_loops=s["loops"],
                               seed=s["seed"])
    store = GraphStore()
    eng = SolverEngine(store, config or Config(), device=device)
    with counted_boxes(key) as seen:
        fired = multiworld(eng, store, g, s)
    walls = {r["trigger"]: r["trigger_wall_ms"] for r in eng.solve_stats
             if "trigger_wall_ms" in r}
    for p in fired:
        p["host_wall_ms"], p["wall_ms"] = p["wall_ms"], walls[p["trigger"]]
    rec = engine_record(key, eng, fired, seen)
    rec.update(nodes=s["nodes"], loops=s["loops"], every=s["every"],
               worlds=store.n_worlds(), sets=store.worlds.n_sets())
    return rec


def cover_row(side: str, device, config=None, **resize) -> dict:
    """One process of cover_2k_4000: side "A" (the proportional ladder,
    covered triggers) or "B" (every bucket). `config` and `resize` as in
    stream_row."""
    s = dict(ROWS["cover_2k_4000"], **resize)
    cfg = config or Config()
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, adaptive_fp64=False))
    g = synthetic.circle_graph(n_nodes=s["nodes"], n_loops=s["loops"],
                               seed=s["seed"])
    store = GraphStore()
    eng = SolverEngine(store, cfg, device=device)
    (nodes, loops), prop = COVER_WARMUP[side]
    n_warm, warm_s = timed_warmup(eng, nodes, loops, proportional=prop)
    key = f"cover_2k_4000:{side}"
    with counted_boxes(key) as seen:
        fired = feed(eng, store, g, s["every"])
    rec = engine_record(key, eng, fired, seen)
    rec.update(side=side, warmup=warmup_summary(eng, warm_s),
               warmup_call=[nodes, loops, prop],
               plan=cover_plan(g, s["every"],
                               _warmup_pairs(cfg.capacity, nodes, loops,
                                             prop), cfg.capacity))
    return rec


class TimedLock:
    """The engine's device lock, recording how long each `with` on it
    waited, by thread (the start-up row's trigger against the warmup
    thread's captures)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.waits: dict = {}

    def __enter__(self):
        t0 = time.perf_counter()
        self._lock.acquire()
        self.waits.setdefault(threading.get_ident(), []).append(
            time.perf_counter() - t0)
        return self

    def __exit__(self, *exc):
        self._lock.release()


def startup_row(device, config=None, stream_kw=None) -> dict:
    """One process of startup_10k once its kernels are loaded (see the
    module note); `stream_kw` replaces STARTUP_STREAM. The stream is ingested
    before the warmup starts, so that its trigger follows ready_s at
    once."""
    s = ROWS["startup_10k"]
    store = GraphStore()
    eng = SolverEngine(store, config or Config(), device=device)
    lock = eng._device_lock = TimedLock()      # before any thread takes it
    g = synthetic.circle_graph(**(stream_kw or STARTUP_STREAM))
    by_later = edges_by_later(g)
    for i in range(g.n_nodes):
        ingest(store, g, i, by_later)
    t0 = time.perf_counter()
    n = eng.warmup(s["nodes"], s["loops"], background=True)
    ready = time.perf_counter() - t0
    thread = eng._warmup_thread
    warming = thread is not None and thread.is_alive()
    me = threading.get_ident()
    waited = len(lock.waits.get(me, ()))
    with chip_smoke.solves_seen() as seen:
        t1 = time.perf_counter()
        fired = eng.trigger()
        wall = 1e3 * (time.perf_counter() - t1)
    waits = lock.waits.get(me, [])[waited:]
    if not eng.warmup_join(timeout=1200):
        raise RuntimeError("warmup_join timed out")
    warmup_s = time.perf_counter() - t0
    row = eng.solve_stats[-1] if fired else {}
    return dict(
        key="startup_10k", nodes=s["nodes"], loops=s["loops"], buckets=n,
        ready_s=ready, warmup_s=warmup_s, warming_at_trigger=warming,
        trigger=dict(
            fired=fired, wall_ms=wall, lock_wait_ms=1e3 * sum(waits),
            lock_acquires=len(waits), node_len=row.get("node_len"),
            edge_len=row.get("edge_len"),
            exact=list(exact_bucket(eng.config.capacity, g.n_nodes,
                                    g.n_loops)),
            box=list(seen[0][:2]) if seen else None,
            solve_ms=seen[0][2] if seen else None,
            final_cost=row.get("final_cost"),
            lm_iterations=row.get("lm_iterations"),
            cg_iterations=row.get("cg_iterations"),
            trigger_captures=row.get("trigger_captures")),
        warmup=warmup_summary(eng, warmup_s), per_bucket=eng.warmup_stats,
        final_chi2=row.get("final_cost"))


# ----------------------------------------------------------------------
# gates and spreads
# ----------------------------------------------------------------------

def row_gates(key: str, rec: dict) -> dict:
    """One process's gates, by name (True where it holds). `key` is the
    process's row key (`cover_2k_4000:A` for a side of the cover row)."""
    if "error" in rec:
        return {"ran": False}
    spec = ROWS[key.partition(":")[0]]
    kind = spec["kind"]
    if kind == "startup":
        t = rec["trigger"]
        return dict(
            fired=bool(t["fired"]),
            trigger_captures=t["trigger_captures"] == 0,
            first_bucket=t["box"] == t["exact"],
            chi2=t["final_cost"] is not None
            and math.isfinite(t["final_cost"]),
            buckets=rec["buckets"] == len(rec["per_bucket"]))
    want = rec["launches_want"]
    gates = dict(launches=rec["launches"] == want and all(want.values()))
    if kind == "cover":
        gates.update(
            trigger_captures=rec["trigger_captures"] == 0,
            boxes=[p[1:] for p in rec["plan"]] == rec["boxes"],
            chi2=rec["final_chi2"] is not None
            and math.isfinite(rec["final_chi2"]))
        return gates
    gates["chi2"] = (rec["final_chi2"] is not None and chip_smoke.
                     within_quality(rec["final_chi2"], spec["chi2_jax"]))
    if kind == "multiworld":
        gates["worlds"] = (rec["worlds"], rec["sets"]) == (3, 1)
        return gates
    if spec["warm"]:
        gates["trigger_captures"] = rec["trigger_captures"] == 0
    if spec["inject_at"]:
        esc = rec["forced_escalation"]
        gates["forced_escalation_applied"] = bool(esc) and esc.get("applied")
        gates["served_after_landing"] = (rec["served_after_landing"] >= 1
                                         or rec["settle_after_landing"])
    return gates


def cross_gates(records: dict) -> dict:
    """Gates across rows: `records` maps each process's row key to its
    records, one per round."""
    gates = {}
    sides = [records.get(f"cover_2k_4000:{s}") for s in "AB"]
    if all(sides):
        gates["cover_same_triggers"] = all(
            "error" not in x and "error" not in y
            and [b[:2] for b in x["boxes"]] == [b[:2] for b in y["boxes"]]
            for x, y in zip(*sides))
    return gates


def spread(values: list) -> dict:
    """The processes' values: their median, quartiles, min and max
    (bench_torch.summary), and each."""
    v = [x for x in values if x is not None]
    return dict(bench_torch.summary(v), all=v) if v else None


SPREAD_KEYS = ("trigger_host_ms_median", "trigger_host_ms_p90",
               "trigger_host_ms_max", "steady_state_ms_median",
               "settle_wall_ms", "final_chi2", "triggers", "covered",
               "trigger_captures", "process_wall_s", "max_memory_allocated")


def row_spread(key: str, recs: list) -> dict:
    """A row's numbers over its processes (spread of each)."""
    ok = [r for r in recs if "error" not in r]
    out = {k: spread([r.get(k) for r in ok]) for k in SPREAD_KEYS
           if any(k in r for r in ok)}
    if ok and ok[0].get("warmup"):
        out["warmup_wall_s"] = spread([r["warmup"]["wall_s"] for r in ok])
        out["warmup_buckets"] = spread([r["warmup"]["buckets"] for r in ok])
        out["warmup_pool_mb"] = spread([r["warmup"]["pool_mb"] for r in ok])
    if key == "startup_10k":
        for k in ("ready_s", "warmup_s", "load_s", "import_s",
                  "cuda_init_s", "ready_from_spawn_s"):
            out[k] = spread([r.get(k) for r in ok])
        for k in ("wall_ms", "lock_wait_ms", "solve_ms"):
            out[f"trigger_{k}"] = spread([r["trigger"][k] for r in ok])
        out["built_with_nvcc"] = [r.get("built_with_nvcc") for r in ok]
        out["ready_s_by_build"] = {
            str(b): spread([r["ready_s"] for r in ok
                            if r.get("built_with_nvcc") == b])
            for b in (True, False)}
    esc = [e for r in ok for e in r.get("bg_escalations", ())]
    if esc:
        out["escalation_wall_ms"] = spread(
            [e.get("escalation_wall_ms") for e in esc])
        out["escalations"] = len(esc)
    return out


def cover_compare(recs_a: list, recs_b: list) -> list:
    """Per trigger that side A solved outside its exact bucket: A's and
    B's solve ms, counts and trigger walls, each over the rounds."""
    out = []
    for a, b in zip(recs_a, recs_b):
        if "error" in a or "error" in b:
            continue
        for i, box in enumerate(a["boxes"]):
            if box[3] == box[2]:
                continue
            ra, rb = a["trigger_rows"][i], b["trigger_rows"][i]
            out.append(dict(
                node_len=box[0], edge_len=box[1], exact=box[2], box=box[3],
                solve_ms_cover=a["solve_ms"][i],
                solve_ms_exact=b["solve_ms"][i],
                extra_ms=a["solve_ms"][i] - b["solve_ms"][i],
                lm_cover=ra["lm_iterations"], lm_exact=rb["lm_iterations"],
                cg_cover=ra["cg_iterations"], cg_exact=rb["cg_iterations"],
                chi2_cover=ra["final_cost"], chi2_exact=rb["final_cost"],
                wall_ms_cover=a["walls_ms"][i],
                wall_ms_exact=b["walls_ms"][i]))
    return out


# ----------------------------------------------------------------------
# processes
# ----------------------------------------------------------------------

LIBRARIES = (("band_matvec", band_matvec._ENTRIES),
             ("gj_inv", smallinv._ENTRIES),
             ("graph_loops", graph_loops._ENTRIES))


def load_kernels() -> dict:
    """Build (where _build/ holds none) and load K1, K2 and the loops'
    library, the nvcc runs started together as chip_smoke.phase_build
    starts them: the seconds, and whether this process ran nvcc."""
    built = any(not os.path.exists(_kernels.library_path(n))
                for n, _ in LIBRARIES)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(_kernels.build, [n for n, _ in LIBRARIES]))
    for name, entries in LIBRARIES:
        _kernels.load(name, entries)
    return dict(load_s=time.perf_counter() - t0, built_with_nvcc=built)


def child(key: str, dev, spawned_at: float) -> dict:
    """One process of one row on the card (the parent spawned it at
    `spawned_at`, epoch seconds)."""
    rec = dict(key=key, import_s=time.time() - spawned_at)
    t0 = time.perf_counter()
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev).add_(1)
    torch.cuda.synchronize(dev)
    rec["cuda_init_s"] = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec.update(load_kernels())
    rec["card"] = chip_smoke.card_line(dev.index)
    rec["clocks_before"] = bench_torch.gpu_sample(dev.index)
    row, _, side = key.partition(":")
    kind = ROWS[row]["kind"]
    cpu = os.times()
    t1 = time.perf_counter()
    if kind == "startup":
        rec.update(startup_row(dev))
        rec["ready_from_spawn_s"] = (rec["import_s"] + rec["cuda_init_s"]
                                     + rec["load_s"] + rec["ready_s"])
    elif kind == "stream":
        rec.update(stream_row(row, dev))
    elif kind == "multiworld":
        rec.update(multiworld_row(row, dev))
    else:
        rec.update(cover_row(side, dev))
    rec["row_s"] = time.perf_counter() - t1
    # this process's CPU seconds over the row (the host rung's threads
    # included): the host's share of it
    rec["row_cpu_s"] = sum(os.times()[:2]) - sum(cpu[:2])
    rec["key"] = key
    rec["clocks_after"] = bench_torch.gpu_sample(dev.index)
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return rec


def run_child(key: str, dev) -> dict:
    """Run one process of one row; its record (its last line), or an
    error with the ends of its output."""
    cmd = [sys.executable, os.path.join(REPO, "bench_stream_torch.py"),
           "--child", key, "--device", f"cuda:{dev.index}",
           "--spawned-at", repr(time.time())]
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        return dict(key=key, error=f"timed out after {CHILD_TIMEOUT_S} s",
                    stderr=str(e.stderr)[-3000:])
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    try:
        rec = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        rec = None
    if out.returncode != 0 or not isinstance(rec, dict):
        return dict(key=key, error=f"exit {out.returncode}",
                    stdout=out.stdout[-2000:], stderr=out.stderr[-3000:])
    rec["process_wall_s"] = wall
    return rec


def to_json(obj) -> str:
    return json.dumps(obj, default=lambda o: o.item() if hasattr(o, "item")
                      else str(o), separators=(",", ":"))


def process_line(rec: dict, rnd: int, gates: dict) -> str:
    fields = dict(key=rec["key"], round=rnd,
                  failed=[k for k, v in gates.items() if not v])
    if "error" in rec:
        fields["error"] = rec["error"]
    for k in ("process_wall_s", "load_s", "built_with_nvcc", "ready_s",
              "warmup_s", "triggers", "trigger_host_ms_median",
              "trigger_host_ms_p90", "trigger_host_ms_max",
              "steady_state_ms_median", "settle_wall_ms", "final_chi2",
              "trigger_captures", "covered", "launches", "launches_want"):
        if k in rec:
            fields[k] = rec[k]
    if rec.get("warmup"):
        fields["warmup"] = {k: rec["warmup"][k]
                            for k in ("buckets", "wall_s", "pool_mb")}
    if rec.get("trigger"):
        fields["trigger"] = {k: rec["trigger"][k]
                             for k in ("wall_ms", "lock_wait_ms", "solve_ms",
                                       "box")}
    for k in ("forced_escalation", "worlds", "sets"):
        if rec.get(k) is not None:
            fields[k] = rec[k]
    return "[proc] " + to_json(fields)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="",
                    help=f"comma-separated keys of {','.join(ONLY_KEYS)}; "
                    "default: every row")
    ap.add_argument("--procs", type=int, default=3,
                    help="fresh processes per row (default 3)")
    ap.add_argument("--out", default="",
                    help="write every process's record here as JSON")
    ap.add_argument("--device", default="cuda", help="cuda or cuda:N")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    ap.add_argument("--spawned-at", type=float, default=0.0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    dev = bench_torch.cuda_device(args.device)
    if args.child:
        print(to_json(child(args.child, dev, args.spawned_at)), flush=True)
        return 0
    only = [k for k in args.only.split(",") if k]
    if set(only) - set(ONLY_KEYS) or args.procs < 1:
        bench_torch.fail(f"unknown --only keys {set(only) - set(ONLY_KEYS)}"
                         f" (of {','.join(ONLY_KEYS)}), or --procs < 1")
    if args.out and os.path.abspath(args.out) == os.path.join(
            REPO, "benchmarks", "results.json"):
        bench_torch.fail("--out must not be benchmarks/results.json")
    card = chip_smoke.card_line(dev.index)
    name, _, limit = card.partition(",")
    keys = [k for k, s in ROWS.items() if not only or s["only"] in only]
    procs = [f"{k}:{side}" if ROWS[k]["kind"] == "cover" else k
             for k in keys for side in ("AB" if ROWS[k]["kind"] == "cover"
                                        else "_")]
    records = {p: [] for p in procs}
    gates = {}
    t0 = time.perf_counter()
    for rnd in range(args.procs):
        for p in procs:
            rec = run_child(p, dev)
            records[p].append(rec)
            g = row_gates(p, rec)
            gates.update({f"{p}[{rnd}]:{k}": v for k, v in g.items()})
            print(process_line(rec, rnd, g), flush=True)
            if "error" in rec:
                print(rec.get("stderr", "")[-1500:], file=sys.stderr)
    gates.update(cross_gates(records))
    rows = {}
    for k in keys:
        if ROWS[k]["kind"] == "cover":
            a, b = records[f"{k}:A"], records[f"{k}:B"]
            rows[k] = dict(A=row_spread(k, a), B=row_spread(k, b),
                           covered=cover_compare(a, b))
        else:
            rows[k] = row_spread(k, records[k])
        print(f"[row] {k} " + to_json(rows[k]), flush=True)
    launches = {w: sum(r.get("launches", {}).get(w, 0)
                       for recs in records.values() for r in recs)
                for w in WRAPPERS}
    failed = sorted(k for k, v in gates.items() if not v)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(to_json(dict(card=card, procs=args.procs, rows=rows,
                                  gates=gates, records=records)))
    print(f"[gates] checked={len(gates)} failed={to_json(failed)} "
          f"wall_s={time.perf_counter() - t0:.1f}", flush=True)
    if failed:
        bench_torch.fail(f"failed gates: {failed}")
    print(card, flush=True)
    print(to_json(dict(
        metric="engine_rows", card=name.strip(),
        power_limit_w=float(limit.strip().split()[0]), procs=args.procs,
        rows=rows, launches=launches, gates=len(gates))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
