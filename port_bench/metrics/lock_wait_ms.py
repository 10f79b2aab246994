"""lock_wait_ms (ms): the mean, over the window's solves that returned
before the profiler session (harness/program_rows.py), of the trigger's
waits to acquire the engine's state_lock and its device lock (solve_stats
lock_wait_ms, the program's spans state_lock_wait and device_lock_wait).
None where the rows carry no such spans."""

from port_bench.harness import program_rows, records


def read(rec):
    return records.mean(r.get("lock_wait_ms")
                        for r in program_rows.before_profile(rec))
