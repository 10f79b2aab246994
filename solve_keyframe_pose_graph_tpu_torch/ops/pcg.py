"""Preconditioned conjugate gradients over the reduced node system
(counterpart of solve_keyframe_pose_graph_tpu/ops/pcg.py:pcg_nodes).

The reference ends its loop on the device (lax.while_loop). Here the loop
runs its fixed cap with a `done` flag kept on the device: once the residual
rule, the Q rule or a breakdown fires, every later iteration is computed and
discarded, so x, r, p, rz and the count k stay frozen. That gives the
reference's iteration count and final r with no host synchronisation per
iteration, at the price of the capped number of iterations of work.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class PCGNodesResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor       # int32 scalar
    rel_residual: torch.Tensor     # final ||r|| / ||b||
    r: torch.Tensor                # final residual b - A x (by recurrence)


def _dot(a, b):
    return torch.sum(a * b)


def pcg_nodes(
    matvec: Callable,              # x -> H x
    precond: Callable,             # r -> M^-1 r
    b: torch.Tensor,
    *,
    max_iterations: int,
    r_tolerance,                   # float or 0-d tensor
    q_tolerance: float = 0.0,      # 0 = Q rule off
) -> PCGNodesResult:
    """PCG with Ceres' two stopping rules: the residual rule
    ||r|| <= r_tolerance ||b||, and the Q rule (zeta = k (Q_k - Q_{k-1}) / Q_k
    below q_tolerance, with Q(x) = -0.5 x.(b + r)), off unless
    q_tolerance > 0."""
    b_norm = torch.sqrt(_dot(b, b))
    threshold = r_tolerance * b_norm
    use_q = q_tolerance > 0

    x = torch.zeros_like(b)             # cold start, as in the LM loop
    r = b
    z = precond(r)
    p = z
    rz = _dot(r, z)
    Q0 = torch.zeros_like(rz)           # Q(x) = -0.5 x.(b + r) at x = 0
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    done = torch.zeros((), dtype=torch.bool, device=b.device)

    for _ in range(max_iterations):
        Ap = matvec(p)
        pAp = _dot(p, Ap)
        breakdown = pAp <= 0
        alpha = torch.where(breakdown, 0.0,
                            rz / torch.where(breakdown, 1.0, pAp))
        x1 = x + alpha * p
        r1 = r - alpha * Ap
        z = precond(r1)
        rz1 = _dot(r1, z)
        beta = rz1 / torch.where(rz == 0, 1.0, rz)
        p1 = z + beta * p
        k1 = k + 1
        stop = breakdown | (torch.sqrt(_dot(r1, r1)) <= threshold)
        if use_q:
            Q1 = -0.5 * _dot(x1, b + r1)
            zeta = k1.to(b.dtype) * (Q1 - Q0) / torch.where(Q1 == 0, 1.0, Q1)
            stop = stop | (torch.abs(zeta) < q_tolerance)
            Q0 = torch.where(done, Q0, Q1)
        x = torch.where(done, x, x1)
        r = torch.where(done, r, r1)
        p = torch.where(done, p, p1)
        rz = torch.where(done, rz, rz1)
        k = torch.where(done, k, k1)
        done = done | stop

    rel = torch.sqrt(_dot(r, r)) / torch.where(b_norm == 0, 1.0, b_norm)
    return PCGNodesResult(x, k, rel, r)
