"""Loop-aware coarse-grid correction for the PCG preconditioner
(counterpart of solve_keyframe_pose_graph_tpu/ops/coarse.py).

Group `c` consecutive nodes into one 6-DOF coarse variable (piecewise-
constant prolongation P). The coarse operator H_c = P^T H P is assembled from
the same entry-major blocks the fine matvec uses, so every loop-closure
block lands in it and long-range loop coupling is solved exactly at the
coarse level. Combined additively with the band smoother:

    M^-1 = B^-1 + P H_c^-1 P^T          ("band+coarse")

or multiplicatively, as a symmetrized two-grid cycle ("band*coarse",
two_grid_apply).

`auto_coarse_group` and `median_loop_offset` are copies of the reference's
numpy rules (its module imports jax).
"""

from __future__ import annotations

import numpy as np
import torch

from solve_keyframe_pose_graph_tpu_torch.ops import gn as gn_ops
from solve_keyframe_pose_graph_tpu_torch.solver.problem import Problem

# entry permutation implementing the 6x6 transpose on flat-36 blocks
_T36 = tuple(6 * (k % 6) + k // 6 for k in range(36))


def auto_coarse_group(n_cap: int,
                      median_loop_offset: float | None = None) -> int:
    """Hands-free aggregate size for the two-level preconditioner.

    1. Structure: halve the group (floor 8) until 2*group <= the median
       loop offset, so ring-revisit loops do not alias out of the coarse
       solve.
    2. Size: double it until the coarse dimension 6*n_cap/group <= 1536,
       the largest dense coarse solve that paid off."""
    group = 64
    if median_loop_offset is not None and median_loop_offset > 0:
        while group > 8 and 2 * group > median_loop_offset:
            group //= 2
    while n_cap // group > 256:
        group *= 2
    return group


def median_loop_offset(loop_b, loop_a, loop_mask=None) -> float | None:
    """Host-side median |b - a| over valid loop edges (None when there are
    none): the structure statistic feeding auto_coarse_group."""
    b = np.asarray(loop_b)
    a = np.asarray(loop_a)
    if loop_mask is not None:
        m = np.asarray(loop_mask) > 0.5
        b, a = b[m], a[m]
    if b.size == 0:
        return None
    return float(np.median(np.abs(b - a)))


def build_coarse_inverse(red: gn_ops.ReducedSystemT, problem: Problem,
                         group: int) -> torch.Tensor:
    """H_c = P^T H_reduced P over `group`-node aggregates, inverted:
    (6M, 6M). Frozen and padded nodes contribute +I to their segment's
    diagonal block, inert because the prolongation masks them out."""
    Dh, Bh = red.Dh, red.Bh
    dt, dev = Dh.dtype, Dh.device
    Nc = Dh.shape[-1]
    c = int(group)
    M = -(-Nc // c)
    u = torch.arange(Nc, device=dev)
    seg = u // c
    perm = torch.tensor(_T36, device=dev)

    def seg_sum(rows):
        """Per-segment row sums (nodes are segment-contiguous)."""
        pad = M * c - Nc
        if pad:
            rows = torch.cat([rows, rows.new_zeros((pad, 36))])
        return rows.reshape(M, c, 36).sum(dim=1)       # (M, 36)

    # node-diagonal and band contributions, segment-aligned:
    #   in-segment (u-f-1 in the same segment)  -> (s, s) diagonal block
    #   boundary   (u-f-1 in the previous one)  -> (s, s-1) + transpose
    Hdiag = seg_sum(Dh.T)
    Hsub = torch.zeros((M, 36), dtype=dt, device=dev)  # block (s, s-1)
    for f in range(problem.fanout):
        BT = Bh[f].T                                   # (Nc, 36)
        cross = ((u % c) <= f) & (u >= f + 1)
        BTc = BT * cross[:, None]
        in_sum = seg_sum(BT - BTc)
        Hdiag = Hdiag + in_sum + in_sum[:, perm]
        Hsub = Hsub + seg_sum(BTc)

    Hc = torch.zeros((M, M, 36), dtype=dt, device=dev)
    s = torch.arange(M, device=dev)
    Hc[s, s] = Hdiag
    Hc[s[1:], s[:-1]] = Hsub[1:]                       # seg 0 has no s-1
    Hc[s[:-1], s[1:]] = Hsub[1:, perm]
    Hc = Hc.reshape(M * M, 36)

    # loop blocks couple arbitrary segment pairs. Only the live edges' rows
    # are summed (masked ones are zero and all alias node 0), with a sorted
    # accumulate: the order is fixed, so the sums repeat run to run
    order, _ = problem.loop_rows_by_node
    sb = seg[problem.loop_b]
    sa = seg[problem.loop_a]
    AT = red.Aba_h.T                                   # (Ec, 36)
    Hc.index_put_((torch.cat([sb * M + sa, sa * M + sb])[order],),
                  torch.cat([AT, AT[:, perm]])[order], accumulate=True)

    H = (Hc.reshape(M, M, 6, 6)
           .permute(0, 2, 1, 3)
           .reshape(6 * M, 6 * M))
    # fp32 safety jitter relative to the (Jacobi-scaled ~ O(1)) diagonal
    eye = torch.eye(6 * M, dtype=dt, device=dev)
    H = H + (1e-5 * torch.mean(torch.diagonal(H))) * eye

    L = torch.linalg.cholesky(H)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    X = Linv.T @ Linv
    # two Newton refinement steps X <- X (2I - H X), symmetrized: kept for
    # parity with the reference, which needs them for the TPU's inexact
    # fp32 triangular solve
    for _ in range(2):
        X = X @ (2.0 * eye - H @ X)
        X = 0.5 * (X + X.T)
    return X


def coarse_apply(Hc_inv, free_mask, r_n, group: int):
    """x = F P H_c^-1 P^T r for a (6, Nc) residual; returns (6, Nc). F =
    diag(free_mask) keeps frozen/padded nodes at exactly zero."""
    Nc = r_n.shape[-1]
    c = int(group)
    M = Hc_inv.shape[0] // 6
    pad = M * c - Nc
    rT = r_n.T                                          # (Nc, 6)
    if pad:
        rT = torch.cat([rT, rT.new_zeros((pad, 6))])
    rc = rT.reshape(M, c, 6).sum(dim=1).reshape(M * 6)
    y = (Hc_inv @ rc).reshape(M, 1, 6)
    x = y.expand(M, c, 6).reshape(M * c, 6)[:Nc]
    return x.T * free_mask[None, :]


def two_grid_apply(band, coarse, matvec, r):
    """The symmetrized multiplicative two-grid ("band*coarse"): a coarse
    correction, a band smoothing step and a second coarse correction,
        x1 = C r;  x2 = x1 + B (r - A x1);  x = x2 + C (r - A x2),
    with A the reduced matvec. Symmetric whenever B and C are. Two matvecs
    per application; their arguments and the result are contiguous, since
    the band part of a matvec is kernel K1, which takes contiguous input."""
    x1 = coarse(r).contiguous()
    x2 = (x1 + band(r - matvec(x1))).contiguous()
    return (x2 + coarse(r - matvec(x2))).contiguous()
