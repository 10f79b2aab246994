"""precond_gemv_ms (ms): device time per profiled solve of the cuBLAS
matrix-vector kernels, the band preconditioner's apply (the program's
ops/band.py bcr_solve, batched (d, d) by (d,) products). PATTERNS are the
kernel names that count."""

from port_bench.harness import records

PATTERNS = ("gemv",)


def read(rec):
    prof = rec.get("profile") or {}
    solves = len(prof.get("solves") or ())
    ns = sum(records.profile_kernels(rec, p)[1] for p in PATTERNS)
    if not solves or not ns:
        return None
    return ns / 1e6 / solves
