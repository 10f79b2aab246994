"""k1_roofline (%): K1's share of its roofline: the least time, at
3.35 TB/s, for the bytes one band matvec needs at the profiled solves'
node capacity (roofline.k1_launch_s), over its mean device time per
launch in the profile."""

from port_bench.harness import records, roofline

KERNEL = "band_matvec_kernel"


def read(rec):
    launches, ns = records.profile_kernels(rec, KERNEL)
    bucket = records.profiled_bucket(rec)
    if not launches or not ns or bucket is None:
        return None
    fml = rec["formulation"]
    t_min = roofline.k1_launch_s(bucket[0], fml["fanout"],
                                 roofline.ELSIZE[fml["dtype"]])
    return 100.0 * t_min / (ns / 1e9 / launches)
