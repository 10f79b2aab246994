"""The LM solve over a mesh (counterpart of the JAX package's lm_solve on
a GSPMD-sharded Problem, solver/engine.py's mesh.n_devices > 1 path).

lm.lm_solve runs its LM loop, and ops/pcg.py its CG, unchanged on a
ShardedProblem: the loop's vectors are collectives.Shards (one block per
shard), and ShardedOps below supplies the operations that reach across
shards. It is the same mathematics as the single-device solve; only the
order of some sums differs, each of them fixed (collectives.py):

  * assembly: each shard runs gn.assemble_t / assemble_4dof_t on its
    sub-Problem (sharding.py) at its local poses, [left halo | own |
    ghosts] gathered from their owners. The band terms that land on its
    halo go to the left neighbour, the loop terms that land on its ghosts
    to their owners, and then the owner applies the real node mask (the
    sub-Problem's mask is all ones); the cost is a rank_sum;
  * Schur reduction: each shard scales its blocks (lm.jacobi_scales), runs
    gn.schur_eliminate_t on them padded to its local layout (zero on halo
    and ghosts, whose scales come from their owners), sums the corrections
    that landed on ghosts into their owners, then projects the frozen
    nodes (gn.project_frozen_t) and keeps its own block;
  * reduced matvec (HaloMatvec): kernel K1 unchanged on halo-extended
    arrays, D_ext = [0 | D | 0], B_ext = [0 | B | the right neighbour's
    first F columns of B], x_ext = [left halo | x | right halo], keeping
    the centre; the B halo is exchanged once per LM iteration, the x halo
    once per CG iteration, into buffers allocated once per LM iteration
    (K1 takes contiguous input). The loop part gathers x, runs
    gn.loop_matvec_t on the shard's edges and sums ghost rows into their
    owners;
  * preconditioner: the single-device factorization itself. Dh and Bh are
    gathered once per LM iteration and the band factored (K2) and the
    coarse inverse built once per distinct device; each application
    gathers r, applies them once per device and hands each shard its
    block. (The truncated BCR works on super-nodes of F nodes padded to a
    power of two, so its blocks do not line up with node shards.)
  * CG dots and LM scalars: rank_sum, on shard 0's device; the LM loop
    keeps its one host sync per iteration;
  * switch recovery: on each edge shard against the gathered step.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from solve_keyframe_pose_graph_tpu_torch.ops import band as band_ops
from solve_keyframe_pose_graph_tpu_torch.ops import coarse as coarse_ops
from solve_keyframe_pose_graph_tpu_torch.ops import gn as gn_ops
from solve_keyframe_pose_graph_tpu_torch.ops import lm as lm_ops
from solve_keyframe_pose_graph_tpu_torch.ops import smallinv
from solve_keyframe_pose_graph_tpu_torch.ops.band_matvec import band_matvec
from solve_keyframe_pose_graph_tpu_torch.parallel.collectives import (
    Shards, all_gather, left_halo, rank_sum, right_halo, unshard,
)

if TYPE_CHECKING:      # sharding.py imports this module
    from solve_keyframe_pose_graph_tpu_torch.parallel.sharding import (
        Layout, ShardedProblem,
    )


class HaloMatvec:
    """y = H_red x over a mesh, for the reduced blocks Dh (36, nl), Bh
    (F, 36, nl) and Aba_h (36, el) of each shard (see the module note)."""

    def __init__(self, Dh: Shards, Bh: Shards, Aba_h: Shards,
                 layout: Layout):
        F, nl = layout.fanout, layout.nl
        self.layout = layout
        right = right_halo(Bh, F)
        self.D_ext, self.B_ext, self.x_ext, self.Aba_aos = [], [], [], []
        for i, (D, B, A) in enumerate(zip(Dh.parts, Bh.parts, Aba_h.parts)):
            z = D.new_zeros((36, F))
            self.D_ext.append(torch.cat([z, D, z], dim=1))
            self.B_ext.append(torch.cat([B.new_zeros((F, 36, F)), B,
                                         right[i]], dim=2))
            self.x_ext.append(D.new_zeros((6, nl + 2 * F)))
            self.Aba_aos.append(gn_ops.t_blocks_to_aos(A))

    def __call__(self, x: Shards) -> Shards:
        L = self.layout
        F, nl, P = L.fanout, L.nl, len(x.parts)
        lh, rh = left_halo(x, F), right_halo(x, F)
        full = all_gather(x)
        band, loop = [], []
        for i, xi in enumerate(x.parts):
            xe = self.x_ext[i]          # shard 0's left halo and the last
            if i:                       # shard's right halo stay zero
                xe[:, :F] = lh[i]
            xe[:, F:F + nl] = xi
            if i + 1 < P:
                xe[:, F + nl:] = rh[i]
            band.append(band_matvec(self.D_ext[i], self.B_ext[i],
                                    xe)[:, F:F + nl])
            x_loc = torch.cat([xe[:, :F + nl],
                               full[xi.device][:, L.ghosts[i]]], dim=1)
            loop.append(gn_ops.loop_matvec_t(None, L.loops[i], x_loc,
                                             self.Aba_aos[i]))
        incoming = L.owner_sum([y[:, F + nl:].T for y in loop])
        return Shards(band[i] + loop[i][:, F:F + nl] + incoming[i].T
                      for i in range(P))


def _shard(red: gn_ops.ReducedSystemT, i: int) -> gn_ops.ReducedSystemT:
    return gn_ops.ReducedSystemT(**{
        f.name: getattr(red, f.name).parts[i]
        for f in dataclasses.fields(gn_ops.ReducedSystemT)})


class ShardedOps(lm_ops.DeviceOps):
    """lm.DeviceOps over a ShardedProblem's mesh: node vectors are Shards of
    (..., nl) blocks (poses (nl, 4) and (nl, 3)), edge vectors Shards of
    the shards' edge blocks. With precision="mixed", `hi` is the split
    with fp64 sub-Problems: the assembly runs on them and its halo and
    ghost partials are summed in fp64."""

    def __init__(self, problem: ShardedProblem, **kw):
        super().__init__(problem, **kw)
        self.sp = problem
        self.free = self._owned(self.hi, "free_mask", -1)

    @staticmethod
    def _owned(sp: ShardedProblem, name: str, dim: int) -> Shards:
        return Shards(sp.owned(i, getattr(s, name), dim)
                      for i, s in enumerate(sp.subs))

    def _local(self, x: Shards, dim: int, first=None) -> list:
        """Each shard's local-layout copy of a node vector: [left halo (shard
        0: `first`, or zeros) | own block | ghosts from their owners]."""
        L = self.sp.layout
        halo = left_halo(x, L.fanout, dim, first)
        full = all_gather(x, dim)
        return [torch.cat([halo[i], p,
                           full[p.device].index_select(dim, L.ghosts[i])],
                          dim=dim)
                for i, p in enumerate(x.parts)]

    def _pad(self, i: int, x):
        """An owned block (..., nl) padded to shard i's local layout with
        zeros on the halo and the ghosts."""
        F, G = self.sp.fanout, self.sp.layout.ghosts[i].shape[0]
        return torch.cat([x.new_zeros(x.shape[:-1] + (F,)), x,
                          x.new_zeros(x.shape[:-1] + (G,))], dim=-1)

    def _owner_sums(self, X: list) -> Shards:
        """Each shard's own columns of the local-layout (C, n_local) X, plus
        what the right neighbour's halo columns and every shard's ghost
        columns hold for its nodes."""
        L = self.sp.layout
        F, nl = L.fanout, L.nl
        incoming = L.owner_sum([x[:, F + nl:].T for x in X])
        out = []
        for i, x in enumerate(X):
            own = x[:, F:F + nl].clone()
            if i + 1 < len(X):
                own[:, nl - F:] += X[i + 1][:, :F].to(own.device)
            out.append(own + incoming[i].T)
        return Shards(out)

    def initial(self):
        hi = self.hi
        return (self._owned(hi, "q", 0), self._owned(hi, "t", 0),
                Shards(s.switch for s in hi.subs))

    def assemble(self, q: Shards, t: Shards, s: Shards) -> gn_ops.GNBlocksT:
        sp, F = self.hi, self.hi.fanout
        ql = self._local(q, 0, first=sp.subs[0].q[:F])   # identity poses
        tl = self._local(t, 0, first=sp.subs[0].t[:F])
        blk = []
        for i, sub in enumerate(sp.subs):
            if self.residual_mode == "4dof":
                blk.append(gn_ops.assemble_4dof_t(sub, ql[i], tl[i],
                                                  s.parts[i]))
            else:
                blk.append(gn_ops.assemble_t(sub, ql[i], tl[i], s.parts[i],
                                             use_switch=self.use_switch))
        D = self._owner_sums([b.D for b in blk])
        g = self._owner_sums([b.g_n for b in blk])
        # the real node mask, after the exchange (gn's inert padding)
        D = Shards(torch.where(m[None, :] < 0.5,
                               gn_ops._eyecol(d.dtype, d.device)[:, None], d)
                   for m, d in zip(sp.node_mask, D.parts))
        g = Shards(x * m[None, :] for m, x in zip(sp.node_mask, g.parts))

        def edges(name):
            return Shards(getattr(b, name) for b in blk)

        return gn_ops.GNBlocksT(
            cost=rank_sum([b.cost for b in blk]), D=D,
            B=Shards(sp.owned(i, b.B) for i, b in enumerate(blk)),
            Aba=edges("Aba"), cb=edges("cb"), ca=edges("ca"),
            ds=edges("ds"), g_n=g, g_s=edges("g_s"))

    def reduce(self, blocks: gn_ops.GNBlocksT, radius):
        sp, L = self.sp, self.sp.layout
        F, nl = L.fanout, L.nl
        sc = [lm_ops.jacobi_scales(D, ds, radius.to(D.device))
              for D, ds in zip(blocks.D.parts, blocks.ds.parts)]
        scale_n, scale_s, lm_n, lm_s = (Shards(c[k] for c in sc)
                                        for k in range(4))
        # shard 0's halo scale is zero, as the single-device shift fills
        sn_loc = self._local(scale_n, -1)
        reds = []
        for i, sub in enumerate(sp.subs):
            loc = gn_ops.GNBlocksT(
                cost=None, D=self._pad(i, blocks.D.parts[i]),
                B=self._pad(i, blocks.B.parts[i]), Aba=blocks.Aba.parts[i],
                cb=blocks.cb.parts[i], ca=blocks.ca.parts[i],
                ds=blocks.ds.parts[i], g_n=self._pad(i, blocks.g_n.parts[i]),
                g_s=blocks.g_s.parts[i])
            reds.append(gn_ops.schur_eliminate_t(
                loc, sub, sn_loc[i], scale_s.parts[i],
                self._pad(i, lm_n.parts[i]), lm_s.parts[i]))
        # Schur corrections that landed on ghosts go to their owners
        inc_D = L.owner_sum([r.Dh[:, F + nl:].T for r in reds])
        inc_r = L.owner_sum([r.rhs_n[:, F + nl:].T for r in reds])
        parts = []
        for i, (r, sub) in enumerate(zip(reds, sp.subs)):
            r.Dh[:, F:F + nl] += inc_D[i].T
            r.rhs_n[:, F:F + nl] += inc_r[i].T
            r = gn_ops.project_frozen_t(r, sub)
            parts.append(dataclasses.replace(
                r, Dh=sp.owned(i, r.Dh), Bh=sp.owned(i, r.Bh),
                rhs_n=sp.owned(i, r.rhs_n)))
        red = gn_ops.ReducedSystemT(**{
            f.name: Shards(getattr(p, f.name) for p in parts)
            for f in dataclasses.fields(gn_ops.ReducedSystemT)})
        return red, scale_n, scale_s, lm_n, lm_s

    def matvec(self, red: gn_ops.ReducedSystemT) -> HaloMatvec:
        return HaloMatvec(red.Dh, red.Bh, red.Aba_h, self.sp.layout)

    def _gathered(self, fn):
        """r -> fn(device, gathered r) once per distinct device, each shard
        keeping its own block."""
        nl = self.sp.layout.nl

        def apply(r: Shards) -> Shards:
            y = {dev: fn(dev, x) for dev, x in all_gather(r).items()}
            return Shards(y[p.device][:, i * nl:(i + 1) * nl]
                          for i, p in enumerate(r.parts))
        return apply

    def precond(self, red: gn_ops.ReducedSystemT, mv):
        """(apply, None): the mesh runs eagerly, so a failed coarse
        factorization raises here."""
        return self._precond(red, mv), None

    def _precond(self, red: gn_ops.ReducedSystemT, mv):
        kind = self.preconditioner
        if kind == "identity":
            return lambda r: r
        if kind == "jacobi":
            Minv = [smallinv.best_inv(gn_ops.t_blocks_to_aos(D))
                    for D in red.Dh.parts]
            return lambda r: Shards(
                torch.einsum("uij,uj->ui", M, x.T).T.contiguous()
                for M, x in zip(Minv, r.parts))
        Dh, Bh = all_gather(red.Dh), all_gather(red.Bh)
        fac = {dev: lm_ops.band_factor(Dh[dev], Bh[dev], self.bcr_levels)
               for dev in Dh}

        def band(dev, r):
            return band_ops.band_precond_apply(fac[dev], r.T).T

        if kind == "band":
            return self._gathered(band)
        group, sp = self.coarse_group, self.sp
        Aba = all_gather(red.Aba_h)
        Hc_inv = {}
        for dev in Dh:
            Hc_inv[dev], info = coarse_ops.build_coarse_inverse_arrays(
                Dh[dev], Bh[dev], Aba[dev], sp.topology(dev).loop_b,
                sp.topology(dev).loop_a, sp.topology(dev).loop_rows_by_node,
                sp.fanout, group)
            coarse_ops.check_cholesky(info)

        def coarse(dev, r):
            return coarse_ops.coarse_apply(
                Hc_inv[dev], sp.topology(dev).free_mask, r, group)

        if kind == "band+coarse":
            return self._gathered(lambda dev, r: band(dev, r)
                                  + coarse(dev, r))
        return lambda r: coarse_ops.two_grid_apply(
            self._gathered(band), self._gathered(coarse), mv, r)

    def recover(self, red: gn_ops.ReducedSystemT, x: Shards) -> Shards:
        xl = self._local(x, -1)
        return Shards(gn_ops.recover_switches_t(_shard(red, i), sub, xl[i])
                      for i, sub in enumerate(self.sp.subs))

    def apply_step(self, q, t, s, dx_n, dx_s, renormalize: bool):
        out = [lm_ops._apply_step(q.parts[i], t.parts[i], s.parts[i],
                                  dx_n.parts[i], dx_s.parts[i],
                                  self.free.parts[i], renormalize)
               for i in range(len(q.parts))]
        return tuple(Shards(o[k] for o in out) for k in range(3))

    def result(self, q, t, s):
        """q, t and switch gathered on shard 0's device."""
        return tuple(unshard(x, 0) for x in (q, t, s))
