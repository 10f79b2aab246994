"""k2_roofline (%): K2's share of its roofline: the least time, at
3.35 TB/s, for the bytes of one LM iteration's batched (30, 30) inverses
(one launch per reduction level and one at the root,
roofline.k2_iteration_s), times the LM iterations the profile holds, over
their device time."""

from port_bench.harness import records, roofline

KERNEL = "gj_inv_kernel"


def read(rec):
    launches, ns = records.profile_kernels(rec, KERNEL)
    bucket = records.profiled_bucket(rec)
    fml = rec["formulation"]
    per_iteration = len(roofline.k2_blocks(bucket[0], fml["fanout"],
                                           fml["bcr_levels"])) if bucket else 0
    if not launches or not ns or not per_iteration or launches % per_iteration:
        return None
    t_min = roofline.k2_iteration_s(bucket[0], fml["fanout"],
                                    fml["bcr_levels"],
                                    roofline.ELSIZE[fml["dtype"]])
    return 100.0 * t_min * (launches // per_iteration) / (ns / 1e9)
