"""solve_ms (ms): the mean, over the window's solves, of the engine's
device_solve phase less its problem build: the launch of the captured
solve, its run on the card and the host's read of the result."""

from port_bench.harness import records


def read(rec):
    return records.mean(r["device_solve_ms"] - r["stats"]["problem_build_ms"]
                        for r in records.window_triggers(rec) if r["stats"])
