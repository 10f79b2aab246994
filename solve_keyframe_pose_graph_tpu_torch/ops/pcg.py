"""Preconditioned conjugate gradients over the reduced node system
(counterpart of solve_keyframe_pose_graph_tpu/ops/pcg.py:pcg_nodes).

The reference's pcg_nodes is a lax.while_loop (pcg.py:104) on cond
k < max_iterations & ~done (pcg.py:72-75). Here the loop is split into
its three parts, so that each can be captured as a CUDA graph on static
buffers: pcg_start (the cold start before the loop), pcg_iteration (one
iteration of the reference's body, on a PCGState) and pcg_finish (the
result after it). On the card, ops/graphs.py runs pcg_iteration in a
conditional WHILE node on the reference's cond (csrc/graph_loops.cu), so
the loop ends on the device after the iteration that set `done`, as the
reference's does. pcg_nodes, the eager form (the CPU, the mesh), runs the
fixed cap instead: once the residual rule, the Q rule or a breakdown
fires, every later iteration is computed and discarded (x, r, p, rz, Q0
and the count k stay frozen under the `done` mask), which gives the
reference's iteration count and final r with no host synchronisation.
The masks are no-ops while `done` is false, so an iteration that the
WHILE node skips changes nothing that a masked one would: both forms give
the same result bit for bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class PCGNodesResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor       # int32 scalar
    rel_residual: torch.Tensor     # final ||r|| / ||b||
    r: torch.Tensor                # final residual b - A x (by recurrence)


class PCGState(NamedTuple):
    """The loop state of pcg_nodes (the reference's while_loop carry, with
    ||b|| and the residual rule's threshold beside it)."""
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    Q0: torch.Tensor               # Q(x) = -0.5 x.(b + r) at the last step
    k: torch.Tensor                # int32: iterations taken
    done: torch.Tensor             # bool: a stopping rule fired
    b_norm: torch.Tensor
    threshold: torch.Tensor        # r_tolerance ||b||


def _dot(a, b):
    return torch.sum(a * b)


def pcg_start(precond: Callable, b: torch.Tensor, *,
              r_tolerance) -> PCGState:
    """The cold start of PCG on H x = b (x = 0), before the first
    iteration; r_tolerance is a float or a 0-d tensor."""
    b_norm = torch.sqrt(_dot(b, b))
    r = b
    z = precond(r)
    rz = _dot(r, z)
    return PCGState(
        x=torch.zeros_like(b), r=r, p=z, rz=rz,
        Q0=torch.zeros_like(rz),        # Q(x) at x = 0
        k=torch.zeros((), dtype=torch.int32, device=b.device),
        done=torch.zeros((), dtype=torch.bool, device=b.device),
        b_norm=b_norm, threshold=r_tolerance * b_norm)


def pcg_iteration(matvec: Callable, precond: Callable, b: torch.Tensor,
                  st: PCGState, *, q_tolerance: float = 0.0) -> PCGState:
    """One PCG iteration with Ceres' two stopping rules: the residual rule
    ||r|| <= r_tolerance ||b||, and the Q rule (zeta = k (Q_k - Q_{k-1}) /
    Q_k below q_tolerance, with Q(x) = -0.5 x.(b + r)), off unless
    q_tolerance > 0. Leaves the state as it is once `done` is set."""
    x, r, p, rz, Q0, k, done = st.x, st.r, st.p, st.rz, st.Q0, st.k, st.done
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
    stop = breakdown | (torch.sqrt(_dot(r1, r1)) <= st.threshold)
    if q_tolerance > 0:
        Q1 = -0.5 * _dot(x1, b + r1)
        zeta = k1.to(b.dtype) * (Q1 - Q0) / torch.where(Q1 == 0, 1.0, Q1)
        stop = stop | (torch.abs(zeta) < q_tolerance)
        Q0 = torch.where(done, Q0, Q1)
    return st._replace(
        x=torch.where(done, x, x1), r=torch.where(done, r, r1),
        p=torch.where(done, p, p1), rz=torch.where(done, rz, rz1), Q0=Q0,
        k=torch.where(done, k, k1), done=done | stop)


def pcg_finish(st: PCGState) -> PCGNodesResult:
    """pcg_nodes' result from the final loop state."""
    rel = torch.sqrt(_dot(st.r, st.r)) / torch.where(st.b_norm == 0, 1.0,
                                                     st.b_norm)
    return PCGNodesResult(st.x, st.k, rel, st.r)


def pcg_nodes(
    matvec: Callable,              # x -> H x
    precond: Callable,             # r -> M^-1 r
    b: torch.Tensor,
    *,
    max_iterations: int,
    r_tolerance,                   # float or 0-d tensor
    q_tolerance: float = 0.0,      # 0 = Q rule off
) -> PCGNodesResult:
    """PCG from a cold start, max_iterations masked iterations (see the
    module note)."""
    st = pcg_start(precond, b, r_tolerance=r_tolerance)
    for _ in range(max_iterations):
        st = pcg_iteration(matvec, precond, b, st, q_tolerance=q_tolerance)
    return pcg_finish(st)
