"""cg_iters_per_solve (count): the mean CG iterations of the window's
solves (solve_stats cg_iterations, over all LM iterations of a solve)."""

from port_bench.harness import records


def read(rec):
    return records.mean(r["cg_iterations"] for r in records.window_solves(rec))
