"""result_wait_ms (ms): the mean, over the window's solves that returned
before the profiler session (harness/program_rows.py), of the time the
host was blocked in the solve's one host read, until the card had run the
launched solve (solve_stats result_wait_ms, the program's span
result_wait). None where the rows carry no such span."""

from port_bench.harness import program_rows, records


def read(rec):
    return records.mean(r.get("result_wait_ms")
                        for r in program_rows.before_profile(rec))
