"""problem_build_ms (ms): the mean problem build of the window's solves
(solve_stats problem_build_ms: the incremental build and its copy to the
card)."""

from port_bench.harness import records


def read(rec):
    return records.mean(r["problem_build_ms"]
                        for r in records.window_solves(rec))
