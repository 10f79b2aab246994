"""merge_solve_ms (ms): what a trigger that merges worlds costs: over the
window's solves that returned before the profiler session
(harness/program_rows.py) and made a first contact between two worlds
(solve_stats first_contacts > 0), the mean trigger_wall_ms. None where
no such row is there, or the rows do not count first contacts."""

from port_bench.harness import program_rows, records


def read(rec):
    return records.mean(r["trigger_wall_ms"]
                        for r in program_rows.before_profile(rec)
                        if (r.get("first_contacts") or 0) > 0)
