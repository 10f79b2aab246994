"""The precond_apply_ms reader on a synthetic traced record."""

from __future__ import annotations

import pytest

from port_bench.harness import manifest


def _record(by_name, solves=3):
    return {"profile": {"solves": [{"node_len": 5000, "edge_len": 9000}]
                        * solves,
                        "by_name": by_name}}


KERNELS = {
    "void (anonymous namespace)::bcr_apply_forward_kernel<float>(...)":
        [640, 6_000_000],
    "void (anonymous namespace)::bcr_apply_backward_kernel<float>(...)":
        [640, 5_400_000],
    "void (anonymous namespace)::bcr_apply_coarse_sum_kernel<float>(...)":
        [320, 600_000],
    # not the apply's: the coarse product and K1
    "std::enable_if<!(false), void>::type internal::gemvx::kernel<...>":
        [320, 1_100_000],
    "void (anonymous namespace)::band_matvec_kernel<float, true>(...)":
        [310, 2_500_000],
}


def test_reads_the_apply_kernels_per_profiled_solve():
    got = manifest.reader("precond_apply_ms")(_record(KERNELS))
    assert got == pytest.approx((6.0 + 5.4 + 0.6) / 3)


@pytest.mark.parametrize("rec", [
    {"profile": None},
    _record({k: v for k, v in KERNELS.items() if "bcr_apply" not in k}),
    _record(KERNELS, solves=0),
], ids=["no profile", "plain apply (the parent)", "no profiled solve"])
def test_reads_nothing_without_the_kernels(rec):
    assert manifest.reader("precond_apply_ms")(rec) is None
