"""Explicitly sharded PCG over a mesh (counterpart of
solve_keyframe_pose_graph_tpu/parallel/sharded_pcg.py, with its
semantics): the scale-out path when a reduced system outgrows one card.

  * nodes are split into contiguous blocks of Nc/P, loop edges into blocks
    of Ec/P (sharding.edge_layout);
  * the band matvec runs kernel K1 on halo-extended arrays, the loop rows
    are computed against the gathered x and summed into their owners
    (sharded_lm.HaloMatvec, the reference's _band_matvec_local plus its
    all_gather / psum_scatter);
  * CG dot products are rank-ordered sums (the reference's psum);
  * preconditioner: a BCR of each shard's LOCAL band (K2), so the band
    links across shard seams are dropped from the preconditioner only (a
    block-Jacobi of bands), plus, with coarse_group, the coarse inverse
    built once from the global blocks and replicated: each shard restricts
    its residual, the coarse residual is assembled from the shards' pieces
    in rank order, and each shard prolongates its own slice. coarse_group
    must divide the shard width, so that no segment straddles two shards.

Unlike ops/pcg.pcg_nodes (the LM's CG), this loop is the reference's: it
tests ||r|| > r_tolerance ||b|| before each iteration, on the host, and has
no Q rule.
"""

from __future__ import annotations

import torch

from solve_keyframe_pose_graph_tpu_torch.ops import bcr_apply
from solve_keyframe_pose_graph_tpu_torch.ops import coarse as coarse_ops
from solve_keyframe_pose_graph_tpu_torch.ops import lm as lm_ops
from solve_keyframe_pose_graph_tpu_torch.parallel.collectives import (
    Shards, all_gather, unshard,
)
from solve_keyframe_pose_graph_tpu_torch.parallel.sharded_lm import (
    HaloMatvec,
)
from solve_keyframe_pose_graph_tpu_torch.parallel.sharding import (
    Mesh, edge_layout,
)
from solve_keyframe_pose_graph_tpu_torch.solver.problem import LoopRows


def _dot(a, b):
    return torch.sum(a * b)


def split_nodes(x, mesh: Mesh) -> Shards:
    """A global (..., N) tensor as contiguous blocks along its last axis,
    block i on mesh.devices[i]."""
    n = x.shape[-1] // len(mesh)
    return Shards(x[..., i * n:(i + 1) * n].to(d)
                  for i, d in enumerate(mesh.devices))


def pcg_sharded(Dh, Bh, Aba_h, loop_b, loop_a, rhs, *, mesh: Mesh,
                max_iterations: int = 100, r_tolerance: float = 1e-7,
                fanout: int = 5, coarse_group: int = 0, free_mask=None):
    """Solve H_red x = rhs with CG over the mesh. Dh (36, Nc), Bh (F, 36,
    Nc), Aba_h (36, Ec), loop_b / loop_a (Ec,) and rhs (6, Nc) are global
    tensors; returns the global solution (6, Nc) on rhs's device.
    free_mask (Nc,) zeroes the coarse prolongation on frozen or padded
    nodes (default: all free)."""
    F = fanout
    Nc = rhs.shape[-1]
    layout = edge_layout(loop_b, loop_a, Nc, F, mesh)
    nl = layout.nl
    if free_mask is None:
        free_mask = rhs.new_ones((Nc,))
    Dh_s, Bh_s, rhs_s = (split_nodes(x, mesh) for x in (Dh, Bh, rhs))
    free_s = split_nodes(free_mask, mesh)
    Aba_s = split_nodes(Aba_h, mesh)          # edge blocks of Ec / P
    mv = HaloMatvec(Dh_s, Bh_s, Aba_s, layout)

    # the local band preconditioner (BCR of each shard's own band)
    fac = [lm_ops.band_factor(D, B, None)
           for D, B in zip(Dh_s.parts, Bh_s.parts)]

    def band(r: Shards) -> Shards:
        return Shards(bcr_apply.precond_apply(f, x.contiguous())
                      for f, x in zip(fac, r.parts))

    precond = band
    if coarse_group:
        c = int(coarse_group)
        if nl % c:
            raise ValueError("coarse_group must divide the per-shard node "
                             f"width ({nl} % {c})")
        rows = torch.arange(2 * loop_b.shape[0], device=Dh.device)
        Hc, info = coarse_ops.build_coarse_inverse_arrays(
            Dh, Bh, Aba_h, loop_b.long(), loop_a.long(),
            LoopRows(rows, torch.full((1,), rows.shape[0], device=Dh.device),
                     1), F, c)
        coarse_ops.check_cholesky(info)
        Hc_inv = {d: Hc.to(d) for d in mesh.distinct}
        Ml = nl // c

        def coarse(r: Shards) -> Shards:
            # restrict locally; the global coarse residual is the shards'
            # pieces in rank order (the reference's psum of disjoint slices)
            rc = Shards(x.T.reshape(Ml, c, 6).sum(dim=1) for x in r.parts)
            y = {d: (Hc_inv[d] @ g.reshape(-1)).reshape(-1, 6)
                 for d, g in all_gather(rc, 0).items()}
            # prolongate the own slice only, masked on frozen/padded nodes
            return Shards(
                y[x.device][i * Ml:(i + 1) * Ml, None, :]
                .expand(Ml, c, 6).reshape(nl, 6).T * f[None, :]
                for i, (x, f) in enumerate(zip(r.parts, free_s.parts)))

        def precond(r: Shards) -> Shards:
            return band(r) + coarse(r)

    b_norm = torch.sqrt(_dot(rhs_s, rhs_s))
    threshold = float(r_tolerance * b_norm)
    x = torch.zeros_like(rhs_s)
    r = rhs_s
    z = precond(r)
    p = z
    rz = _dot(r, z)
    k = 0
    while k < max_iterations and float(torch.sqrt(_dot(r, r))) > threshold:
        Ap = mv(p)
        pAp = _dot(p, Ap)
        alpha = torch.where(pAp <= 0, 0.0,
                            rz / torch.where(pAp <= 0, 1.0, pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz2 = _dot(r, z)
        beta = rz2 / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz2
        k += 1
    return unshard(x, -1, rhs.device)
