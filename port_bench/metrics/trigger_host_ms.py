"""trigger_host_ms (ms): the mean, over the window's solves, of the host's
part of a trigger: its wall (solve_stats trigger_wall_ms) less the solve
in its device_solve phase (that phase less the problem build): world
mapping, initial guesses, priors, the problem build and the write-back."""

from port_bench.harness import records


def read(rec):
    return records.mean(
        r["stats"]["trigger_wall_ms"]
        - (r["device_solve_ms"] - r["stats"]["problem_build_ms"])
        for r in records.window_triggers(rec) if r["stats"])
