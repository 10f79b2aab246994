"""Gauss-Newton normal-equation blocks (counterpart of
solve_keyframe_pose_graph_tpu/ops/gn.py): the 6-DOF assembly of the product
path, the 4-DOF assembly, the switch elimination and the reduced matvec.

    H = [ H_nn  H_ns ]   H_nn = D (block diag, 6x6) + band B_f (odometry,
        [ H_ns' H_ss ]          offsets 1..F) + sparse loop blocks A_ba;
                         H_ns per-loop-edge 6-vectors; H_ss diagonal.

Entry-major layout throughout, as in the reference's production path:
blocks (36, N) with row-major 6x6 entries, vectors (6, N), node axis last.
The odometry band is dense and node-aligned, so its matvec is static shifts
plus 6x6 multiply-adds (kernel K1 on the card, ops/band_matvec.py). Loop
edges use gathers and a row scatter-add in a fixed order: a segment sum
over the live edge rows grouped by node (scatter_loop_rows, with the
grouping built once per Problem), not `index_add_`, whose atomics on CUDA
make sums differ run to run. So a solve on the card is reproducible, which
the async-vs-sync replay check relies on. The other scatters here hit
distinct rows, or add exact zeros, so their sums need no fixed order.

Not ported: the reference's TPU loop-matvec variants (sorted, tiled and
one-hot forms, gn.py:611-993) exist to feed the TPU's matrix unit and the
tiled ones drop edges on overflow; the port has the segment-sum form only.
"""

from __future__ import annotations

import dataclasses

import torch

from solve_keyframe_pose_graph_tpu_torch.ops import residuals as res
from solve_keyframe_pose_graph_tpu_torch.solver.problem import Problem

# flat-36 slots of the 6x6 diagonal, and the entry permutation implementing
# the 6x6 transpose on flat-36 blocks
DIAG36 = tuple(range(0, 36, 7))
_II = tuple(k // 6 for k in range(36))
_JJ = tuple(k % 6 for k in range(36))


def _idx(ix, device) -> torch.Tensor:
    return torch.tensor(ix, dtype=torch.long, device=device)


def scatter_loop_rows(problem: Problem, vb, va):
    """(Nc, C) with row u = the sum of vb[e] over the live loop edges whose
    b endpoint is u and of va[e] over those whose a endpoint is u; vb, va
    (Ec, C), zero on masked edges. Each node's rows are summed in edge
    order (b side first), so the result is the same on every run."""
    order, counts = problem.loop_rows_by_node
    return torch.segment_reduce(torch.cat([vb, va])[order], "sum",
                                lengths=counts, axis=0, unsafe=True)


def shift_down(x, f):
    """out[u] = x[u-f] along dim 0; first f slots zero."""
    return torch.cat([x.new_zeros((f,) + x.shape[1:]), x[:-f]], dim=0)


def shift_up(x, f):
    """out[u] = x[u+f] along dim 0; last f slots zero."""
    return torch.cat([x[f:], x.new_zeros((f,) + x.shape[1:])], dim=0)


def shift_lanes_down(x, f):
    """out[..., u] = x[..., u-f]; first f lanes zero."""
    return torch.cat([x.new_zeros(x.shape[:-1] + (f,)), x[..., :-f]], dim=-1)


def shift_lanes_up(x, f):
    """out[..., u] = x[..., u+f]; last f lanes zero."""
    return torch.cat([x[..., f:], x.new_zeros(x.shape[:-1] + (f,))], dim=-1)


def _eyecol(dtype, device) -> torch.Tensor:
    e = torch.zeros(36, dtype=dtype, device=device)
    e[list(DIAG36)] = 1.0
    return e


def _odo_inputs(problem: Problem, q, t):
    """Stacked (F,Nc,...) endpoint states for the odometry grid."""
    F = problem.fanout
    q1 = q.expand((F,) + q.shape)
    t1 = t.expand((F,) + t.shape)
    q2 = torch.stack([shift_down(q, f + 1) for f in range(F)])
    t2 = torch.stack([shift_down(t, f + 1) for f in range(F)])
    # padded slots hold zero quats; use identity there
    ident = torch.zeros_like(q2)
    ident[..., 3] = 1.0
    q2 = torch.where(torch.sum(q2 * q2, dim=-1, keepdim=True) < 0.5,
                     ident, q2)
    return q1, t1, q2, t2


def evaluate_cost(problem: Problem, q, t, s, use_switch: bool = True):
    """0.5 * ||r||^2 over all three residual families (no Jacobians)."""
    q1, t1, q2, t2 = _odo_inputs(problem, q, t)
    w = problem.odo_w * problem.odo_mask
    r_odo = res.six_dof_residual(q1, t1, q2, t2, problem.odo_q,
                                 problem.odo_t, w)
    qb, tb = q[problem.loop_b], t[problem.loop_b]
    qa, ta = q[problem.loop_a], t[problem.loop_a]
    if use_switch:
        r_loop = res.six_dof_switch_residual(
            qb, tb, qa, ta, s, problem.loop_q, problem.loop_t, problem.loop_w)
    else:
        r_loop = res.six_dof_residual(
            qb, tb, qa, ta, problem.loop_q, problem.loop_t, problem.loop_w)
    r_loop = r_loop * problem.loop_mask[:, None]
    qp, tp = q[problem.prior_idx], t[problem.prior_idx]
    r_pri = res.node_prior_residual(
        qp, tp, problem.prior_q, problem.prior_t,
        problem.prior_w * problem.prior_mask)
    return 0.5 * (torch.sum(r_odo * r_odo) + torch.sum(r_loop * r_loop)
                  + torch.sum(r_pri * r_pri))


@dataclasses.dataclass
class GNBlocksT:
    cost: torch.Tensor          # scalar, 0.5 * sum r^2
    D: torch.Tensor             # (36, Nc) node diagonal blocks
    B: torch.Tensor             # (F, 36, Nc) band: u rows with u-f-1 cols
    Aba: torch.Tensor           # (36, Ec) loop off-diag: b rows, a cols
    cb: torch.Tensor            # (6, Ec) node-b <-> switch coupling
    ca: torch.Tensor            # (6, Ec)
    ds: torch.Tensor            # (Ec,) switch diagonal
    g_n: torch.Tensor           # (6, Nc) gradient J^T r, nodes
    g_s: torch.Tensor           # (Ec,)  gradient, switches


def assemble_t(problem: Problem, q, t, s, use_switch: bool = True
               ) -> GNBlocksT:
    """Entry-major direct assembly from the closed-form block products.
    use_switch=False makes loop edges plain weighted SixDOFError residuals
    (the switch rows degenerate to inert values)."""
    Nc, Ec = problem.n_cap, problem.e_cap
    dt, dev = problem.dtype, problem.device

    # ---------------- odometry band ----------------
    q1, t1, q2, t2 = _odo_inputs(problem, q, t)
    w = problem.odo_w * problem.odo_mask
    rsq_o, A11, A22, B, g1, g2 = res.six_dof_block_products_t(
        q1, t1, q2, t2, problem.odo_q, problem.odo_t, w)
    # blocks (36,F,Nc), grads (6,F,Nc), rsq (F,Nc)
    cost = 0.5 * torch.sum(rsq_o)
    D = torch.sum(A11, dim=1)                       # (36, Nc)
    g_n = torch.sum(g1, dim=1)                      # (6, Nc)
    for f in range(problem.fanout):
        D = D + shift_lanes_up(A22[:, f], f + 1)
        g_n = g_n + shift_lanes_up(g2[:, f], f + 1)
    B_t = B.movedim(1, 0).contiguous()              # (F, 36, Nc)

    # ---------------- loop edges ----------------
    qb, tb = q[problem.loop_b], t[problem.loop_b]
    qa, ta = q[problem.loop_a], t[problem.loop_a]
    if use_switch:
        (rsq_l, Abb, Aaa, Aba, cb, ca, ds, gb, ga, g_s
         ) = res.six_dof_switch_block_products_t(
            qb, tb, qa, ta, s, problem.loop_q, problem.loop_t,
            problem.loop_w)
    else:
        rsq_l, Abb, Aaa, Aba, gb, ga = res.six_dof_block_products_t(
            qb, tb, qa, ta, problem.loop_q, problem.loop_t, problem.loop_w)
        cb = torch.zeros((6, Ec), dtype=dt, device=dev)
        ca = torch.zeros((6, Ec), dtype=dt, device=dev)
        ds = torch.ones((Ec,), dtype=dt, device=dev)
        g_s = torch.zeros((Ec,), dtype=dt, device=dev)
    m = problem.loop_mask
    rsq_l = rsq_l * m
    Abb = Abb * m
    Aaa = Aaa * m
    Aba = Aba * m
    cb = cb * m
    ca = ca * m
    ds = torch.where(m < 0.5, 1.0, ds)
    gb = gb * m
    ga = ga * m
    g_s = g_s * m
    cost = cost + 0.5 * torch.sum(rsq_l)

    D = D + scatter_loop_rows(problem, Abb.T, Aaa.T).T
    g_n = g_n + scatter_loop_rows(problem, gb.T, ga.T).T

    # ---------------- node priors ----------------
    qp, tp = q[problem.prior_idx], t[problem.prior_idx]
    rsq_p, Ap, gp = res.node_prior_block_products_t(
        qp, tp, problem.prior_q, problem.prior_t,
        problem.prior_w * problem.prior_mask)
    pm = problem.prior_mask
    cost = cost + 0.5 * torch.sum(rsq_p * pm)
    Dp = torch.zeros((Nc, 36), dtype=dt, device=dev)
    # live priors sit on distinct nodes and masked ones add exact zeros
    Dp.index_add_(0, problem.prior_idx, (Ap * pm).T)
    gpv = torch.zeros((Nc, 6), dtype=dt, device=dev)
    gpv.index_add_(0, problem.prior_idx, (gp * pm).T)
    D = D + Dp.T
    g_n = g_n + gpv.T

    # ---------------- inert padding ----------------
    inactive = problem.node_mask < 0.5
    D = torch.where(inactive[None, :], _eyecol(dt, dev)[:, None], D)
    g_n = g_n * problem.node_mask[None, :]

    return GNBlocksT(cost=cost, D=D, B=B_t, Aba=Aba, cb=cb, ca=ca, ds=ds,
                     g_n=g_n, g_s=g_s)


def assemble_4dof_t(problem: Problem, q, t, s) -> GNBlocksT:
    """4-DOF (yaw-weighted Euler) assembly, the reference's alternative
    residual family: loop edges always carry switches, and the Jacobians
    come from autodiff (res.four_dof_*_jac; this mode is not hot). Returns
    the same entry-major blocks as assemble_t, so everything downstream runs
    unchanged. The per-node loop sums go through scatter_loop_rows, in a
    fixed order, as in assemble_t."""
    F, Nc, Ec = problem.fanout, problem.n_cap, problem.e_cap
    dt, dev = problem.dtype, problem.device

    # ---------------- odometry band ----------------
    q1, t1, q2, t2 = _odo_inputs(problem, q, t)
    w = (problem.odo_w * problem.odo_mask).reshape(-1)
    r_o, J1, J2 = res.four_dof_residual_jac(
        q1.reshape(-1, 4), t1.reshape(-1, 3), q2.reshape(-1, 4),
        t2.reshape(-1, 3), problem.odo_q.reshape(-1, 4),
        problem.odo_t.reshape(-1, 3), w)
    r_o = r_o.reshape(F, Nc, 6)
    J1 = J1.reshape(F, Nc, 6, 6)
    J2 = J2.reshape(F, Nc, 6, 6)
    cost = 0.5 * torch.sum(r_o * r_o)
    A11 = torch.einsum("fuki,fukj->fuij", J1, J1)
    A22 = torch.einsum("fuki,fukj->fuij", J2, J2)
    B = torch.einsum("fuki,fukj->fuij", J1, J2)
    D = torch.sum(A11, dim=0)                              # (Nc, 6, 6)
    g_n = torch.sum(torch.einsum("fuki,fuk->fui", J1, r_o), dim=0)
    for f in range(F):
        D = D + shift_up(A22[f], f + 1)
        g_n = g_n + shift_up(torch.einsum("uki,uk->ui", J2[f], r_o[f]),
                             f + 1)

    # ---------------- loop edges ----------------
    qb, tb = q[problem.loop_b], t[problem.loop_b]
    qa, ta = q[problem.loop_a], t[problem.loop_a]
    r_l, L1, L2, Ls = res.four_dof_switch_residual_jac(
        qb, tb, qa, ta, s, problem.loop_q, problem.loop_t, problem.loop_w)
    m = problem.loop_mask
    r_l = r_l * m[:, None]
    L1 = L1 * m[:, None, None]
    L2 = L2 * m[:, None, None]
    Ls = Ls * m[:, None]
    cost = cost + 0.5 * torch.sum(r_l * r_l)
    D = D + scatter_loop_rows(
        problem, torch.einsum("eki,ekj->eij", L1, L1).reshape(Ec, 36),
        torch.einsum("eki,ekj->eij", L2, L2).reshape(Ec, 36),
    ).reshape(Nc, 6, 6)
    g_n = g_n + scatter_loop_rows(problem,
                                  torch.einsum("eki,ek->ei", L1, r_l),
                                  torch.einsum("eki,ek->ei", L2, r_l))
    Aba = torch.einsum("eki,ekj->eij", L1, L2)
    cb = torch.einsum("eki,ek->ei", L1, Ls)
    ca = torch.einsum("eki,ek->ei", L2, Ls)
    ds = torch.where(m < 0.5, 1.0, torch.sum(Ls * Ls, dim=-1))
    g_s = torch.einsum("ek,ek->e", Ls, r_l)

    # ---------------- node priors ----------------
    qp, tp = q[problem.prior_idx], t[problem.prior_idx]
    r_p, Jp = res.node_prior_residual_jac(
        qp, tp, problem.prior_q, problem.prior_t,
        problem.prior_w * problem.prior_mask)
    pm = problem.prior_mask
    r_p = r_p * pm[:, None]
    Jp = Jp * pm[:, None, None]
    cost = cost + 0.5 * torch.sum(r_p * r_p)
    # live priors sit on distinct nodes and masked ones add exact zeros
    D = D.index_add(0, problem.prior_idx,
                    torch.einsum("pki,pkj->pij", Jp, Jp))
    g_n = g_n.index_add(0, problem.prior_idx,
                        torch.einsum("pki,pk->pi", Jp, r_p))

    # ---------------- inert padding ----------------
    inactive = (problem.node_mask < 0.5)[:, None, None]
    D = torch.where(inactive, torch.eye(6, dtype=dt, device=dev), D)
    g_n = g_n * problem.node_mask[:, None]

    def entry_major(X):                       # (n, 6, 6) -> (36, n)
        return X.reshape(X.shape[0], 36).T.contiguous()

    return GNBlocksT(
        cost=cost, D=entry_major(D),
        B=torch.stack([entry_major(B[f]) for f in range(F)]),
        Aba=entry_major(Aba), cb=cb.T.contiguous(), ca=ca.T.contiguous(),
        ds=ds, g_n=g_n.T.contiguous(), g_s=g_s)


def evaluate_cost_4dof(problem: Problem, q, t, s):
    """0.5 * ||r||^2 of the 4-DOF family (no Jacobians)."""
    q1, t1, q2, t2 = _odo_inputs(problem, q, t)
    w = problem.odo_w * problem.odo_mask
    r_odo = res.four_dof_residual(q1, t1, q2, t2, problem.odo_q,
                                  problem.odo_t, w)
    qb, tb = q[problem.loop_b], t[problem.loop_b]
    qa, ta = q[problem.loop_a], t[problem.loop_a]
    r_loop = res.four_dof_switch_residual(
        qb, tb, qa, ta, s, problem.loop_q, problem.loop_t, problem.loop_w
    ) * problem.loop_mask[:, None]
    qp, tp = q[problem.prior_idx], t[problem.prior_idx]
    r_pri = res.node_prior_residual(
        qp, tp, problem.prior_q, problem.prior_t,
        problem.prior_w * problem.prior_mask)
    return 0.5 * (torch.sum(r_odo * r_odo) + torch.sum(r_loop * r_loop)
                  + torch.sum(r_pri * r_pri))


@dataclasses.dataclass
class ReducedSystemT:
    """Entry-major scaled + damped + switch-eliminated node system."""

    Dh: torch.Tensor            # (36, Nc)
    Bh: torch.Tensor            # (F, 36, Nc)
    Aba_h: torch.Tensor         # (36, Ec)
    rhs_n: torch.Tensor         # (6, Nc)
    chb: torch.Tensor           # (6, Ec)
    cha: torch.Tensor           # (6, Ec)
    ds_inv: torch.Tensor        # (Ec,)
    rhs_s: torch.Tensor         # (Ec,)


def schur_reduce_t(gn: GNBlocksT, problem: Problem, scale_n, scale_s,
                   lm_n, lm_s) -> ReducedSystemT:
    """Jacobi-scale, LM-damp and eliminate the switch variables (each couples
    only its own edge's two nodes, so the elimination is exact and O(E)).
    scale_n (6,Nc), scale_s (Ec,), lm_n (6,Nc), lm_s (Ec,)."""
    dt, dev = gn.D.dtype, gn.D.device
    ii, jj = _idx(_II, dev), _idx(_JJ, dev)
    si = scale_n[ii]                   # (36, Nc)
    sj = scale_n[jj]
    Dh = gn.D * si * sj
    Dh.index_add_(0, _idx(DIAG36, dev), lm_n)
    Bh = torch.stack([gn.B[f] * si * shift_lanes_down(scale_n, f + 1)[jj]
                      for f in range(problem.fanout)])

    snT = scale_n.T                    # (Nc, 6)
    sb = snT[problem.loop_b].T         # (6, Ec)
    sa = snT[problem.loop_a].T
    Aba_h = gn.Aba * sb[ii] * sa[jj]
    chb = gn.cb * sb * scale_s[None, :]
    cha = gn.ca * sa * scale_s[None, :]
    ds_inv = 1.0 / (gn.ds * scale_s * scale_s + lm_s)

    # Schur corrections
    w = ds_inv[None, :]
    corr_b = -(w * chb)[ii] * chb[jj]              # (36, Ec)
    corr_a = -(w * cha)[ii] * cha[jj]
    Dh = Dh + scatter_loop_rows(problem, corr_b.T, corr_a.T).T
    Aba_h = Aba_h - (w * chb)[ii] * cha[jj]

    rhs_s = -gn.g_s * scale_s
    rhs_n = -gn.g_n * scale_n
    corr = ds_inv * rhs_s
    rhs_n = rhs_n + scatter_loop_rows(problem, (-chb * corr).T,
                                      (-cha * corr).T).T

    # frozen-node projection: rows/cols -> 0, diag -> I, rhs -> 0
    free = problem.free_mask[None, :]              # (1, Nc)
    fb = problem.free_mask[problem.loop_b][None, :]
    fa = problem.free_mask[problem.loop_a][None, :]
    Dh = Dh * free + _eyecol(dt, dev)[:, None] * (1.0 - free)
    for f in range(problem.fanout):
        Bh[f] *= free * shift_lanes_down(free, f + 1)
    Aba_h = Aba_h * (fb * fa)
    chb = chb * fb
    cha = cha * fa
    rhs_n = rhs_n * free

    return ReducedSystemT(Dh=Dh, Bh=Bh, Aba_h=Aba_h, rhs_n=rhs_n,
                          chb=chb, cha=cha, ds_inv=ds_inv, rhs_s=rhs_s)


def _bmv(Bf, x):          # y_i = sum_j Bf[6i+j] * x[j]
    return torch.stack([
        sum(Bf[6 * i + j] * x[j] for j in range(6)) for i in range(6)])


def _bmv_T(Bf, x):        # y_j = sum_i Bf[6i+j] * x[i]
    return torch.stack([
        sum(Bf[6 * i + j] * x[i] for i in range(6)) for j in range(6)])


def band_matvec_t(Dh, Bh, p_n):
    """Band rows of the reduced matvec, plain form (the plain version of
    kernel K1): y = Dh p + sum_f Bh_f p[u-f-1] + sum_f Bh_f^T p[u+f+1]."""
    y = _bmv(Dh, p_n)
    for f in range(Bh.shape[0]):
        y = y + _bmv(Bh[f], shift_lanes_down(p_n, f + 1))
        y = y + shift_lanes_up(_bmv_T(Bh[f], p_n), f + 1)
    return y


def t_blocks_to_aos(Dt):
    """(36, N) -> (N, 6, 6)."""
    return Dt.movedim(0, -1).reshape(Dt.shape[-1], 6, 6)


def loop_matvec_t(red: ReducedSystemT, problem: Problem, p_n, Aba_aos=None):
    """Loop-edge rows of the reduced matvec: row gathers into (Ec,6), one
    batched product per direction, scatter-added back. Pass
    Aba_aos = t_blocks_to_aos(red.Aba_h) precomputed inside CG."""
    if Aba_aos is None:
        Aba_aos = t_blocks_to_aos(red.Aba_h)       # (Ec,6,6)
    pT = p_n.T                                     # (Nc, 6)
    xb = pT[problem.loop_b]                        # (Ec, 6)
    xa = pT[problem.loop_a]
    vb = torch.einsum("eij,ej->ei", Aba_aos, xa)
    va = torch.einsum("eij,ei->ej", Aba_aos, xb)
    return scatter_loop_rows(problem, vb, va).T


def reduced_matvec_t(red: ReducedSystemT, problem: Problem, p_n,
                     Aba_aos=None):
    """y = H_red p, p (6, Nc): the hot op of every CG iteration. The band
    part goes through kernel K1 for a CUDA tensor (its plain version on the
    CPU); the loop part is the scatter form."""
    # imported here: ops/band_matvec imports this module for its plain form
    from solve_keyframe_pose_graph_tpu_torch.ops.band_matvec import (
        band_matvec,
    )
    return (band_matvec(red.Dh, red.Bh, p_n)
            + loop_matvec_t(red, problem, p_n, Aba_aos))


def recover_switches_t(red: ReducedSystemT, problem: Problem, x_n):
    """Switch steps from the node step: xs = ds_inv (rhs_s - Hsn xn)."""
    xT = x_n.T
    xb = xT[problem.loop_b].T
    xa = xT[problem.loop_a].T
    coupling = torch.sum(red.chb * xb, dim=0) + torch.sum(red.cha * xa, dim=0)
    return red.ds_inv * (red.rhs_s - coupling)
