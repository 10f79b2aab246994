"""Block-tridiagonal band preconditioner via block cyclic reduction (BCR)
(counterpart of solve_keyframe_pose_graph_tpu/ops/band.py, the AoS build).

Group `g = fanout` consecutive nodes into one super-node of dimension
d = 6g: the odometry band (offsets 1..g) then couples only adjacent
super-nodes, an exactly block-tridiagonal system

    C[i] x[i-1] + A[i] x[i] + C[i+1]^T x[i+1] = b[i]

that cyclic reduction factors level by level in batched (d,d) inverses
(kernel K2 on the card, via smallinv.best_inv) and products. Factored once
per LM iteration, applied once per CG iteration. Loop-edge off-diagonal
blocks are left out: CG and the coarse correction handle them.

Not ported: the reference's entry-major build (band_em), bitwise equal to
this AoS build, and the bf16 factor storage (cast_factor).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from solve_keyframe_pose_graph_tpu_torch.ops.smallinv import best_inv


class BCRFactor(NamedTuple):
    # per level: (inverse of the odd diagonal blocks, odd sub-diagonals
    # Co = C[1::2], even sub-diagonals Ce = C[0::2])
    levels: tuple
    root_inv: torch.Tensor     # (m_coarse, d, d)
    group: int                 # nodes per super-node
    n_pad: int                 # padded node count = m_pad * group


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def build_band_system(Dh, Bh, group: int):
    """Assemble the block-tridiagonal (A, C) from pre-scaled/damped blocks.

    Dh (Nc,6,6) node diagonal blocks, Bh (F,Nc,6,6) band blocks (Bh[f-1,u]
    couples node u rows with node u-f cols), F == group. Returns A, C
    (Mp,d,d) with Mp = ceil(Nc/g) padded to a power of 2 and d = 6g, and
    n_pad = Mp*g. Padding blocks are identity."""
    F, Nc = Bh.shape[0], Dh.shape[0]
    g = group
    if F != g:
        raise ValueError(f"band fan-out {F} != group {g}")
    d = 6 * g
    Mp = _next_pow2(-(-Nc // g))
    n_pad = Mp * g
    pad = n_pad - Nc

    def pad_nodes(x):
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad else x

    Dp = pad_nodes(Dh)
    if pad:
        Dp[Nc:] = torch.eye(6, dtype=Dh.dtype, device=Dh.device)
    Dr = Dp.reshape(Mp, g, 6, 6)
    Br = [pad_nodes(Bh[f - 1]).reshape(Mp, g, 6, 6) for f in range(1, g + 1)]
    zero66 = Dh.new_zeros((Mp, 6, 6))

    a_rows = []
    c_rows = []
    for r in range(g):
        a_blocks = []
        c_blocks = []
        for c in range(g):
            # A[r, c]: coupling between node gI+r and node gI+c
            if r == c:
                a_blocks.append(Dr[:, r])
            elif r > c:                      # f = r - c in 1..g-1
                a_blocks.append(Br[r - c - 1][:, r])
            else:                            # upper triangle: transpose
                a_blocks.append(Br[c - r - 1][:, c].transpose(-1, -2))
            # C[r, c]: node gI+r (row) with node g(I-1)+c (col);
            # f = g + r - c in 1..g  <=>  c >= r
            c_blocks.append(Br[g + r - c - 1][:, r] if c >= r else zero66)
        a_rows.append(torch.cat(a_blocks, dim=-1))     # (Mp, 6, d)
        c_rows.append(torch.cat(c_blocks, dim=-1))
    A = torch.cat(a_rows, dim=-2)                      # (Mp, d, d)
    C = torch.cat(c_rows, dim=-2)
    C[0].fill_(0.0)   # super-node 0 has no predecessor
    return A, C, n_pad


def _prev_blocks(x):
    """x[j] -> x[j-1], zeros at j=0."""
    return torch.cat([x.new_zeros((1,) + x.shape[1:]), x[:-1]], dim=0)


def bcr_factorize(A, C, group: int, max_levels: int | None = None
                  ) -> BCRFactor:
    """Cyclic-reduction factorization: log2(M) levels of batched (d,d)
    inverses and products. max_levels truncates the reduction; the coarse
    block-tridiagonal remainder is then approximated by its block-diagonal
    inverse (SPD-preserving)."""
    levels = []
    m = A.shape[0]
    n_pad = m * group
    lvl = 0
    while m > 1 and (max_levels is None or lvl < max_levels):
        Ae, Ao = A[0::2], A[1::2]
        Ce, Co = C[0::2], C[1::2]
        Aoinv = best_inv(Ao)
        levels.append((Aoinv, Co, Ce))

        Aoinv_prev = _prev_blocks(Aoinv)
        Co_prev = _prev_blocks(Co)
        CoT = Co.transpose(-1, -2)
        A_new = (Ae
                 - torch.einsum("mij,mjk,mkl->mil", CoT, Aoinv, Co)
                 - torch.einsum("mij,mjk,mlk->mil", Ce, Aoinv_prev, Ce))
        C_new = -torch.einsum("mij,mjk,mkl->mil", Ce, Aoinv_prev, Co_prev)
        C_new[0].fill_(0.0)
        A, C = A_new, C_new
        m //= 2
        lvl += 1
    # exact root at m == 1, block-diagonal approximation otherwise
    root_inv = best_inv(A)
    return BCRFactor(levels=tuple(levels), root_inv=root_inv, group=group,
                     n_pad=n_pad)


def _mv(A, x):
    """Batched matrix-vector product (m,d,d) x (m,d) -> (m,d)."""
    return (A @ x[..., None])[..., 0]


def bcr_solve(fac: BCRFactor, b):
    """Apply the factored band inverse to b (n_pad//group, d) node-stacked
    rhs; returns x of the same shape. Every product is a matrix-vector
    product (the factor's blocks are never multiplied together here)."""
    # forward: reduce the rhs level by level
    bs = [b]
    for (Aoinv, Co, Ce) in fac.levels:
        be, bo = b[0::2], b[1::2]
        y = _mv(Aoinv, bo)
        b = be - _mv(Co.transpose(-1, -2), y) - _mv(Ce, _prev_blocks(y))
        bs.append(b)

    x = _mv(fac.root_inv, b)                            # coarse solve

    # backward: recover the odd blocks
    for (Aoinv, Co, Ce), b_lvl in zip(reversed(fac.levels), reversed(bs[:-1])):
        bo = b_lvl[1::2]
        x_even = x
        x_even_next = torch.cat([x_even[1:], x_even.new_zeros((1, x.shape[1]))])
        Ce_next = torch.cat([Ce[1:], Ce.new_zeros((1,) + Ce.shape[1:])])
        rhs = (bo
               - _mv(Co, x_even)
               - _mv(Ce_next.transpose(-1, -2), x_even_next))
        x = torch.stack([x_even, _mv(Aoinv, rhs)], dim=1).reshape(
            2 * bo.shape[0], -1)
    return x


def band_precond_apply(fac: BCRFactor, r_n):
    """Node-part preconditioner: reshape the (Nc,6) residual into super-node
    blocks, band-solve, reshape back."""
    Nc = r_n.shape[0]
    d = fac.root_inv.shape[-1]
    pad = fac.n_pad - Nc
    rp = torch.cat([r_n, r_n.new_zeros((pad, 6))]) if pad else r_n
    x = bcr_solve(fac, rp.reshape(-1, d))
    return x.reshape(-1, 6)[:Nc]
