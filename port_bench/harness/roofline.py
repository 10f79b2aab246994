"""Peaks of the card and the bytes that the program's kernels need, from
shapes alone.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores.

K1, the odometry-band matvec (the program's csrc/band_matvec.cu), reads
D (36, N), B (F, 36, N) and x (6, N) and writes y (6, N): each byte once.
Its arithmetic is 2 * 36 * (2F + 1) * N operations, far below the bytes'
time, so bytes bound it.

K2, the batched SPD inverse of the band preconditioner's block cyclic
reduction (csrc/gj_inv.cu), reads and writes n (d, d) blocks per launch,
d = 6 * group. Per LM iteration one launch per reduction level, on the odd
super-node blocks (m / 2, m / 4, ...), and one on the root's m / 2**levels
blocks, where m is the super-node count ceil(n_cap / group) padded to a
power of two. Gauss-Jordan's 2 d**3 operations per block are below the
bytes' time at d = 30 on this card (see bound()).
"""

from __future__ import annotations

HBM_BPS = 3.35e12
PEAK_FLOPS_FP32 = 67e12
ELSIZE = {"float32": 4, "float64": 8}


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of a kernel on this card: bytes or operations."""
    return max(nbytes / HBM_BPS, flops / PEAK_FLOPS_FP32)


def k1_launch_s(n_cap: int, fanout: int, elsize: int) -> float:
    nbytes = (36 + 36 * fanout + 6 + 6) * n_cap * elsize
    flops = 2 * 36 * (2 * fanout + 1) * n_cap
    return bound_s(nbytes, flops)


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def k2_blocks(n_cap: int, group: int, levels: int) -> list:
    """The batch of each K2 launch of one LM iteration."""
    m = _pow2(-(-n_cap // group))
    out = []
    for _ in range(levels):
        if m <= 1:
            break
        out.append(m // 2)
        m //= 2
    return out + [m]


def k2_iteration_s(n_cap: int, group: int, levels: int,
                   elsize: int) -> float:
    """The least time of one LM iteration's K2 launches together."""
    d = 6 * group
    return sum(bound_s(2 * n * d * d * elsize, 2 * n * d ** 3)
               for n in k2_blocks(n_cap, group, levels))
