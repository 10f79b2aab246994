"""edge_wait_ms (ms): how long a loop edge sat in the store before a
trigger took it in: over the window's solves that returned before the
profiler session (harness/program_rows.py), the sum of their new edges'
waits (solve_stats edge_wait_sum_ms: the trigger's start less each edge's
arrival stamp, both on the program's monotonic clock) over the edges
counted (edges_taken). None where the rows carry no waits."""

from port_bench.harness import program_rows


def read(rec):
    rows = [r for r in program_rows.before_profile(rec)
            if r.get("edges_taken")]
    n = sum(r["edges_taken"] for r in rows)
    return sum(r["edge_wait_sum_ms"] for r in rows) / n if n else None
