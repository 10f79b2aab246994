"""launch_ms (ms): the mean, over the window's solves that returned
before the profiler session (harness/program_rows.py), of the host's
enqueue of the composed solve executable (solve_stats launch_ms, the
program's span launch: the copy of the problem in and the launch). None
where the rows carry no such span."""

from port_bench.harness import program_rows, records


def read(rec):
    return records.mean(r.get("launch_ms")
                        for r in program_rows.before_profile(rec))
