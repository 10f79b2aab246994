"""The solve_stats rows that the readers of the program's own spans read
(edge_wait_ms, lock_wait_ms, launch_ms, result_wait_ms): the window's
solves whose trigger returned before a traced run's profiler session
started (profile t_on), all of the window's solves without one. Under the
session and after it the host pays the profiler in every launch and host
read, and its stop holds the whole process, ingest included (PERF.md
section 7), so those rows would read the profiler and not the program."""

from port_bench.harness import records


def before_profile(rec: dict) -> list:
    on = (rec.get("profile") or {}).get("t_on")
    return [r["stats"] for r in records.window_triggers(rec)
            if r["stats"] is not None and (on is None or r["ret"] < on)]
