"""precond_apply_ms (ms): device time per profiled solve of the program's
preconditioner-apply kernels (csrc/bcr_apply.cu: the block cyclic
reduction's forward and backward passes and the coarse aggregate sums),
found by their name prefix PATTERN. None where the profile holds no such
kernel, as in a program that applies the preconditioner in plain PyTorch.
No roofline share: at 5k the factor is served from L2, so a share of the
HBM bound could pass 100%."""

from port_bench.harness import records

PATTERN = "bcr_apply_"


def read(rec):
    prof = rec.get("profile") or {}
    solves = len(prof.get("solves") or ())
    ns = records.profile_kernels(rec, PATTERN)[1]
    if not solves or not ns:
        return None
    return ns / 1e6 / solves
