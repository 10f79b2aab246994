"""Arithmetic on a run's record that the metric readers share.

Times are CLOCK_MONOTONIC seconds. The window is [t0, t_end). A loop edge
is in the window when it is due there; it is corrected at the return of the
first trigger that fired with the engine's prev_edge_len past its index:
the first written-back trajectory that includes it. Its latency is that
return less its due time. An edge that no trigger corrected before the
drain ended counts with the drain's end, and is counted as failed.
Percentiles are numpy's default (linear between order statistics).
"""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float | None:
    v = np.asarray(values, np.float64)
    return float(np.percentile(v, q)) if len(v) else None


def edge_latencies_ms(rec: dict) -> list:
    end = rec["t_end"] + rec.get("drain_s", 0.0)
    return [1000.0 * ((d if d is not None else max(end, u)) - u)
            for u, d in zip(rec["edges"]["due"], rec["edges"]["done"])]


def query_latencies_ms(rec: dict) -> list:
    return [1000.0 * (reply - due) for due, reply, _ in rec["queries"]
            if rec["t0"] <= due < rec["t_end"]]


def window_solves(rec: dict) -> list:
    """The solve_stats rows of the triggers that returned in the window
    having solved."""
    return [r["stats"] for r in rec["triggers"]
            if r["fired"] and r["stats"] is not None
            and rec["t0"] <= r["ret"] < rec["t_end"]]


def window_triggers(rec: dict) -> list:
    return [r for r in rec["triggers"]
            if r["fired"] and rec["t0"] <= r["ret"] < rec["t_end"]]


def profiler_hold(rec: dict) -> tuple:
    """The span (t_on, t_off) in which a traced run's profiler session held
    the solver thread, clipped to the window; (t0, t0) without one."""
    prof = rec.get("profile") or {}
    t0, t1 = rec["t0"], rec["t_end"]
    on, off = prof.get("t_on"), prof.get("t_off")
    if on is None or off is None:
        return t0, t0
    return min(max(on, t0), t1), min(max(off, t0), t1)


def loop_triggers(rec: dict) -> tuple:
    """The window's solves that returned outside the profiler's hold, and
    the seconds of the window outside it: the solver loop as it runs
    untraced."""
    on, off = profiler_hold(rec)
    rows = [r for r in window_triggers(rec) if not on <= r["ret"] <= off]
    return rows, rec["t_end"] - rec["t0"] - (off - on)


def mean(values) -> float | None:
    v = [x for x in values if x is not None]
    return float(np.mean(v)) if v else None


def profile_kernels(rec: dict, pattern: str) -> tuple:
    """(launches, device ns) of the profiled kernels whose name holds
    `pattern`; (0, 0) without a profile."""
    prof = rec.get("profile") or {}
    hits = [v for n, v in (prof.get("by_name") or {}).items()
            if pattern in n]
    return sum(c for c, _ in hits), sum(t for _, t in hits)


def profiled_bucket(rec: dict) -> tuple | None:
    """The (n_cap, e_cap) of the profiled solves, when they share one."""
    prof = rec.get("profile") or {}
    cap = rec["capacity"]
    buckets = {(bucket(r["node_len"], cap["initial_nodes"]),
                bucket(r["edge_len"], cap["initial_edges"]))
               for r in prof.get("solves") or () if r}
    return buckets.pop() if len(buckets) == 1 else None


def bucket(n: int, initial: int) -> int:
    cap = initial
    while cap < n:
        cap *= 2
    return cap
