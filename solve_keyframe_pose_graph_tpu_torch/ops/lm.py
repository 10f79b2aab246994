"""Levenberg-Marquardt trust region and the escalation ladder
(counterpart of solve_keyframe_pose_graph_tpu/ops/lm.py: _lm_setup,
lm_solve, lm_solve_adaptive, needs_escalation, escalate_resolve,
mixed_resolve, fp64_resolve, solve_problem, solve_problem_adaptive,
cfg_lm_kwargs).

Ceres' LevenbergMarquardtStrategy + TrustRegionMinimizer semantics, as in the
reference: jacobi column scaling, the LM diagonal clamped to [1e-6, 1e32],
step quality rho against the model cost change, Ceres' radius updates,
max_iterations counting accepted and rejected steps, the function and
parameter tolerances, a 10x tighter CG forcing on the retry after a
rejection, and speculative assembly at the candidate point. The inner solve
is PCG (ops/pcg.py) on the switch-eliminated node system (ops/gn.py) with
the band BCR (ops/band.py), the additive band+coarse or the multiplicative
band*coarse two-grid (ops/coarse.py), block-jacobi or identity
preconditioner. The residual family is 6-DOF (gn.assemble_t, the product
path) or 4-DOF (gn.assemble_4dof_t, autodiff Jacobians, loop edges always
switched).

precision="mixed" on an fp32 problem (the reference's lm.py:168-199) runs
the assembly, the cost, the parameter state q, t, s and the accept/reject
and convergence arithmetic in fp64 on an fp64 copy of the problem, and
everything between (Schur reduction, factorizations, preconditioner, CG)
in fp32 on the problem itself: the blocks are demoted before the reduction
and the step promoted before it is applied. The radius and the decrease
factor stay in the problem's dtype, as in the reference. On an fp64
problem "mixed" is "native".

On a CUDA problem every reduced matvec's band part runs kernel K1 and every
BCR inverse kernel K2: the wrappers dispatch on the tensors' device, which
replaces the reference's backend switch (lm.py:172-177). The loop is
written as _lm_pieces: init, and each LM iteration as pre (up to the CG
start), cg_iter (one CG iteration, ops/pcg.py) and post. None reads a
value on the host or copies one from it, so each can be captured:
lm_solve solves a CUDA Problem through ops/graphs.py, which captures the
pieces per capacity bucket and solver configuration and runs the LM and
CG loops on the device in conditional WHILE nodes on the reference's
conds (the counterpart of the reference's compiled, cached solve program,
lm.py:493-842): one launch and one host read per solve, or, with a
dispatch_lock, one launch and one host read per LM iteration under the
lock (lm_solve_chunked). A mesh whose shards all sit on one card
(parallel.ShardedProblem) takes the same route, through the Programs of
its own keys, as the reference dispatches its one executable on a
GSPMD-sharded Problem. A CPU Problem and a mesh over distinct cards run
the eager form (_lm_setup's body: pre, cg_iter at the fixed cap under
pcg_nodes' done mask, post; the same arithmetic), reading `done` on the
host once per LM iteration, so at most max_iterations + 1 host syncs.
The loop body reaches the Problem only through an ops object, which also
holds the precision's two copies: DeviceOps for a Problem, and the one a
problem of another layout brings (parallel.ShardedProblem.lm_ops, whose
vectors are per-shard blocks). The rungs reach a problem's layout only
through its n_shards, gathered(), reshard() and astype(), and
ops/graphs.py through its devices, leaves(), static_copy() and
refresh(), so this module imports nothing of parallel/.

Escalation ladder (the reference's lm.py:900-952). A distressed fp32 solve
(needs_escalation) is re-solved from the same initial guesses on the rungs
that SolverConfig.fp64_backend selects, as in the reference:
  * "fp64-cpu", the exact-step host rung (solver/cpu_rung.py): "auto"
    (the default) and "cpu" take it whenever it is available for the
    residual family (6-DOF switched only);
  * otherwise the device ladder: first "mixed" (mixed_resolve, the solve
    again with precision="mixed" at the caller's capacities and forcing;
    K1 and K2 in fp32), kept when it no longer shows distress; then "fp64"
    (fp64_resolve: lm_solve in float64 on the problem's own device,
    repacked to the smallest 1024-multiple capacities covering the live
    lengths, with near-exact CG forcing (cg_tolerance <= 1e-5,
    max_cg_iterations >= 100), padded back to the caller's capacities; on
    the card K1 and K2 run in fp64). fp64_backend="tpu" (the reference's
    name) always takes the device ladder; "auto" falls back to it when the
    host rung is unavailable or fails, and logs the failure at WARNING.
The device rungs take the caller's dispatch_lock around each LM iteration,
so a streaming engine's trigger solves wait at most one iteration.

The reference's AOT executable cache, lm_solve_aot (the whole solve in one
dispatch) and lm_solve_chunked (one LM iteration per dispatch under the
lock) are ops/graphs.py's solve and step executables; outer_unroll (the LM
loop as masked straight-line code, a TPU compile workaround) has no
counterpart. Not ported: freeze_preconditioner (a measured rejection) and
the TPU-only loop_impl / band_impl / tile_k / matvec_impl variants.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import threading
import time
from typing import Callable, NamedTuple

import torch

from solve_keyframe_pose_graph_tpu_torch.ops import band as band_ops
from solve_keyframe_pose_graph_tpu_torch.ops import bcr_apply
from solve_keyframe_pose_graph_tpu_torch.ops import coarse as coarse_ops
from solve_keyframe_pose_graph_tpu_torch.ops import gn as gn_ops
from solve_keyframe_pose_graph_tpu_torch.ops import pcg as pcg_ops
from solve_keyframe_pose_graph_tpu_torch.ops import se3
from solve_keyframe_pose_graph_tpu_torch.ops import smallinv
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    Problem, live_lengths, repack_problem,
)

MIN_LM_DIAGONAL = 1e-6
MAX_LM_DIAGONAL = 1e32
MIN_RELATIVE_DECREASE = 1e-3
MAX_RADIUS = 1e16
MIN_RADIUS = 1e-32
PRECONDITIONERS = ("band", "band+coarse", "band*coarse", "jacobi",
                   "identity")
RESIDUAL_MODES = ("6dof", "4dof")
FP64_BACKENDS = ("auto", "cpu", "tpu")
PRECISIONS = ("native", "mixed")

log = logging.getLogger(__name__)


class LMResult(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    switch: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor          # total LM steps attempted
    successful_steps: torch.Tensor
    distress_rejects: torch.Tensor    # rejected steps whose candidate cost
                                      # overshot by > 0.1% (the fp32-
                                      # conditioning failure signature)
    total_cg_iterations: torch.Tensor
    converged: torch.Tensor           # bool: hit a tolerance before the cap
    cg_truncation: torch.Tensor       # max over LM iterations of the CG exit
                                      # residual over its forcing target


class _LoopState(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    blocks: gn_ops.GNBlocksT      # at the current accepted point
    cost: torch.Tensor
    radius: torch.Tensor
    decrease_factor: torch.Tensor
    k: torch.Tensor
    accepted: torch.Tensor
    distress: torch.Tensor
    cg_total: torch.Tensor
    cg_trunc: torch.Tensor
    done: torch.Tensor
    tighten: torch.Tensor         # previous step rejected: tighten CG
    cost0: torch.Tensor           # the cost at the initial guesses
    fault: torch.Tensor           # bool: a coarse Cholesky factorization
                                  # failed (raised after the loop)


def _dot(a, b):
    return torch.sum(a * b)


def _select_blocks(cond, a: gn_ops.GNBlocksT, b: gn_ops.GNBlocksT):
    return gn_ops.GNBlocksT(**{
        f.name: torch.where(cond, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(gn_ops.GNBlocksT)})


def _apply_step(q, t, s, dx_n, dx_s, node_mask, renormalize: bool):
    q_new = se3.quat_box_plus(q, dx_n[:, 0:3])
    if renormalize:
        q_new = se3.quat_normalize(q_new)
    m = node_mask[:, None]
    return q * (1 - m) + q_new * m, t + dx_n[:, 3:6] * m, s + dx_s


def band_factor(Dh, Bh, bcr_levels) -> band_ops.BCRFactor:
    """The band BCR factorization of reduced blocks Dh (36,N), Bh (F,36,N),
    on AoS super-node blocks (kernel K2 for CUDA tensors). Every block is
    row-major, as the preconditioner apply's kernels read it: on the card
    bcr_factorize's einsum leaves C column-major from level 1 on, and at
    d = 6 the plain inverse returns strided blocks; such a batch is copied
    row-major here, once per factorization."""
    F = Bh.shape[0]
    Bh_aos = torch.stack([gn_ops.t_blocks_to_aos(Bh[f]) for f in range(F)])
    A_band, C_band, _ = band_ops.build_band_system(
        gn_ops.t_blocks_to_aos(Dh), Bh_aos, group=F)
    fac = band_ops.bcr_factorize(A_band, C_band, group=F,
                                 max_levels=bcr_levels)

    def rows(t):
        return t if smallinv.batch_stride(t) is not None else t.contiguous()

    return fac._replace(levels=tuple(tuple(map(rows, lvl))
                                     for lvl in fac.levels),
                        root_inv=rows(fac.root_inv))


def jacobi_scales(D, ds, radius):
    """(scale_n, scale_s, lm_n, lm_s): the Jacobi column scaling of the
    node blocks D (36,N) and switch diagonal ds (E,), and the LM diagonal
    of the SCALED system, clamped as in Ceres."""
    diag_n = D[gn_ops.DIAG]                                    # (6, N)
    scale_n = 1.0 / (1.0 + torch.sqrt(torch.clamp(diag_n, min=0)))
    scale_s = 1.0 / (1.0 + torch.sqrt(torch.clamp(ds, min=0)))
    lm_n = torch.clamp(diag_n * scale_n * scale_n, MIN_LM_DIAGONAL,
                       MAX_LM_DIAGONAL) / radius
    lm_s = torch.clamp(ds * scale_s * scale_s, MIN_LM_DIAGONAL,
                       MAX_LM_DIAGONAL) / radius
    return scale_n, scale_s, lm_n, lm_s


class DeviceOps:
    """The LM loop's operations on a Problem on one device: the residual
    family's assembly, the scaled and damped Schur reduction, the reduced
    matvec, the preconditioner, the switch recovery and the step.
    parallel/sharded_lm.ShardedOps has the same methods over a mesh, so
    _lm_setup's loop body serves both.

    With precision="mixed" on a problem of a lower dtype, `hi` is its fp64
    copy: the assembly, the parameter state and the step run on it, and
    lo() demotes the assembled blocks to the problem's dtype for the
    linear algebra. Otherwise `hi` is the problem and lo() returns its
    argument."""

    def __init__(self, problem: Problem, *, preconditioner: str,
                 residual_mode: str, use_switch: bool, bcr_levels,
                 coarse_group: int, precision: str = "native"):
        self.problem = problem
        self.dtype, self.device = problem.dtype, problem.device
        self.mixed = precision == "mixed" and self.dtype != torch.float64
        self.hi = problem.astype(torch.float64) if self.mixed else problem
        self.preconditioner = preconditioner
        self.residual_mode = residual_mode
        self.use_switch = use_switch
        self.bcr_levels = bcr_levels
        self.coarse_group = coarse_group

    def initial(self):
        p = self.hi
        return p.q, p.t, p.switch

    def assemble(self, q, t, s) -> gn_ops.GNBlocksT:
        if self.residual_mode == "4dof":      # use_switch does not apply
            return gn_ops.assemble_4dof_t(self.hi, q, t, s)
        return gn_ops.assemble_t(self.hi, q, t, s,
                                 use_switch=self.use_switch)

    def lo(self, blocks: gn_ops.GNBlocksT) -> gn_ops.GNBlocksT:
        if not self.mixed:
            return blocks
        return gn_ops.GNBlocksT(**{
            f.name: getattr(blocks, f.name).to(self.dtype)
            for f in dataclasses.fields(gn_ops.GNBlocksT)})

    def reduce(self, blocks: gn_ops.GNBlocksT, radius):
        scale_n, scale_s, lm_n, lm_s = jacobi_scales(blocks.D, blocks.ds,
                                                     radius)
        red = gn_ops.schur_reduce_t(blocks, self.problem, scale_n, scale_s,
                                    lm_n, lm_s)
        return red, scale_n, scale_s, lm_n, lm_s

    def matvec(self, red: gn_ops.ReducedSystemT):
        Aba_aos = gn_ops.t_blocks_to_aos(red.Aba_h)            # hoisted
        return lambda p: gn_ops.reduced_matvec_t(red, self.problem, p,
                                                 Aba_aos)

    def precond(self, red: gn_ops.ReducedSystemT, mv):
        """(apply, info): the preconditioner on (6,Nc) vectors, returning
        contiguous tensors (the CG direction feeds kernel K1, which takes
        contiguous input), and the coarse Cholesky factorization's info
        (None without a coarse level), which the LM loop checks after it
        ends. mv, the reduced matvec, is used by the band*coarse
        two-grid."""
        kind = self.preconditioner
        if kind == "identity":
            return (lambda r: r), None
        if kind == "jacobi":
            Minv = smallinv.best_inv(gn_ops.t_blocks_to_aos(red.Dh))
            return (lambda r: torch.einsum(
                "uij,uj->ui", Minv, r.T).T.contiguous()), None
        fac = band_factor(red.Dh, red.Bh, self.bcr_levels)

        def band(r):
            return bcr_apply.precond_apply(fac, r.contiguous())

        if kind == "band":
            return band, None
        group, p = self.coarse_group, self.problem
        Hc_inv, info = coarse_ops.build_coarse_inverse_arrays(
            red.Dh, red.Bh, red.Aba_h, p.loop_b, p.loop_a,
            p.loop_rows_by_node, p.fanout, group)

        if kind == "band+coarse":
            both = bcr_apply.Coarse(Hc_inv, p.free_mask, group)
            return (lambda r: bcr_apply.precond_apply(
                fac, r.contiguous(), both)), info

        def coarse(r):
            return coarse_ops.coarse_apply(Hc_inv, p.free_mask, r, group)

        return (lambda r: coarse_ops.two_grid_apply(band, coarse, mv, r)), info

    def recover(self, red: gn_ops.ReducedSystemT, x_n):
        return gn_ops.recover_switches_t(red, self.problem, x_n)

    def apply_step(self, q, t, s, dx_n, dx_s, renormalize: bool):
        return _apply_step(q, t, s, dx_n, dx_s, self.hi.free_mask,
                           renormalize)

    def result(self, q, t, s):
        return q, t, s


def _make_ops(problem, **kw):
    """DeviceOps for a Problem; a problem of another layout
    (parallel.ShardedProblem) brings its own through lm_ops(**kw)."""
    own = getattr(problem, "lm_ops", None)
    return own(**kw) if own is not None else DeviceOps(problem, **kw)


class _StepCtx(NamedTuple):
    """What an LM iteration's pre hands to its CG iterations and its post:
    the reduced system, the scaling, the CG forcing, the fault flag and
    the reduced matvec and preconditioner (closures over the system and
    the factorizations)."""
    red: gn_ops.ReducedSystemT
    scale_n: torch.Tensor
    scale_s: torch.Tensor
    lm_n: torch.Tensor
    lm_s: torch.Tensor
    g_n_hat: torch.Tensor
    tol_k: torch.Tensor
    fault: torch.Tensor
    mv: Callable
    precond: Callable


class LMPieces(NamedTuple):
    """The LM loop in the pieces that ops/graphs.py captures: init() the
    loop's first state; pre(state) -> (ctx, cg) an iteration up to the CG
    start; cg_iter(ctx, cg) -> cg one CG iteration; post(state, ctx, cg)
    -> state the rest of the iteration. One LM iteration is pre, CG
    iterations until cg.done or max_cg_iterations, then post."""
    ops: object
    init: Callable
    pre: Callable
    cg_iter: Callable
    post: Callable
    max_cg_iterations: int


def _lm_pieces(
    problem,
    *,
    max_cg_iterations: int,
    cg_tolerance: float,
    cg_q_tolerance: float,
    initial_radius: float,
    function_tolerance: float,
    parameter_tolerance: float,
    renormalize: bool,
    preconditioner: str,
    residual_mode: str,
    use_switch: bool,
    bcr_levels,
    coarse_group,
    cg_warm_iters: int,
    cg_warm_mult: float,
    precision: str,
) -> LMPieces:
    """The LM loop's pieces (LMPieces). None reads a value on the host or
    copies one from it, and every tensor they make from Python numbers is
    a fill: so each can be captured (ops/graphs.py)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}; use one of "
                         f"{PRECISIONS}")
    if preconditioner not in PRECONDITIONERS:
        raise ValueError(f"preconditioner={preconditioner!r}; use one of "
                         f"{PRECONDITIONERS}")
    if residual_mode not in RESIDUAL_MODES:
        raise ValueError(f"residual_mode={residual_mode!r}; use one of "
                         f"{RESIDUAL_MODES}")
    if coarse_group is None:
        coarse_group = coarse_ops.auto_coarse_group(problem.n_cap)
    ops = _make_ops(problem, precision=precision,
                    preconditioner=preconditioner,
                    residual_mode=residual_mode, use_switch=use_switch,
                    bcr_levels=bcr_levels, coarse_group=coarse_group)
    dt, dev = ops.dtype, ops.device

    def scalar(v, dtype=dt):
        return torch.full((), v, dtype=dtype, device=dev)

    tol_base = scalar(cg_tolerance)
    tol_warm = scalar(cg_tolerance * cg_warm_mult)
    tol_tight = scalar(cg_tolerance * 0.1)

    def init() -> _LoopState:
        q0, t0, s0 = ops.initial()
        blocks0 = ops.assemble(q0, t0, s0)
        zero_i = scalar(0, torch.int32)
        no = scalar(False, torch.bool)
        return _LoopState(
            q=q0, t=t0, s=s0, blocks=blocks0,
            cost=blocks0.cost, radius=scalar(initial_radius),
            decrease_factor=scalar(2.0), k=zero_i, accepted=zero_i,
            distress=zero_i, cg_total=zero_i, cg_trunc=scalar(0.0),
            done=no, tighten=no, cost0=blocks0.cost, fault=no)

    def pre(state: _LoopState) -> tuple[_StepCtx, pcg_ops.PCGState]:
        blocks = ops.lo(state.blocks)       # the linear algebra's dtype
        red, scale_n, scale_s, lm_n, lm_s = ops.reduce(blocks, state.radius)
        g_n_hat = blocks.g_n * scale_n                         # (6, Nc)
        mv = ops.matvec(red)

        # after a rejected step the retry solves CG 10x tighter
        tol_k = torch.where(state.k < cg_warm_iters, tol_warm, tol_base)
        tol_k = torch.where(state.tighten, tol_tight, tol_k)
        precond, info = ops.precond(red, mv)
        fault = state.fault if info is None else state.fault | (info != 0)
        cg = pcg_ops.pcg_start(precond, red.rhs_n, r_tolerance=tol_k)
        return _StepCtx(red, scale_n, scale_s, lm_n, lm_s, g_n_hat, tol_k,
                        fault, mv, precond), cg

    def cg_iter(ctx: _StepCtx, cg: pcg_ops.PCGState) -> pcg_ops.PCGState:
        return pcg_ops.pcg_iteration(ctx.mv, ctx.precond, ctx.red.rhs_n, cg,
                                     q_tolerance=cg_q_tolerance)

    def post(state: _LoopState, ctx: _StepCtx,
             cg: pcg_ops.PCGState) -> _LoopState:
        red, scale_n, scale_s = ctx.red, ctx.scale_n, ctx.scale_s
        sol = pcg_ops.pcg_finish(cg)
        dxh_n = sol.x                                          # (6, Nc)
        dxh_s = ops.recover(red, dxh_n)
        # model cost change -g'.dx' - 0.5 dx'.H'.dx' (H' without the LM
        # diagonal) from reduced quantities: H_red xn = rhs_n - r_cg by the
        # CG recurrence, and the switch terms telescope
        bs = red.rhs_s
        quad_S = _dot(dxh_n, red.rhs_n - sol.r) + _dot(red.ds_inv * bs, bs)
        quad_lm = _dot(ctx.lm_n * dxh_n, dxh_n) + _dot(ctx.lm_s * dxh_s,
                                                        dxh_s)
        gTdx = _dot(ctx.g_n_hat, dxh_n) - _dot(bs, dxh_s)
        model_cost_change = -gTdx - 0.5 * (quad_S - quad_lm)

        # the step is promoted to the parameter state's dtype
        dx_n = (dxh_n * scale_n).T.to(state.q.dtype)
        dx_s = (dxh_s * scale_s).to(state.s.dtype)
        q_new, t_new, s_new = ops.apply_step(
            state.q, state.t, state.s, dx_n, dx_s, renormalize)
        # speculative assembly at the candidate: its cost is the candidate
        # cost, and its blocks are the next linearization if accepted
        blocks_new = ops.assemble(q_new, t_new, s_new)
        new_cost = blocks_new.cost

        # accept / reject in the cost's dtype, the model cost change
        # promoted; the radius stays in the problem's dtype
        cost_change = state.cost - new_cost
        rho = cost_change / torch.where(model_cost_change <= 0, 1.0,
                                        model_cost_change)
        accept = (model_cost_change > 0) & (rho > MIN_RELATIVE_DECREASE)

        shrink = (1.0 - (2.0 * rho - 1.0) ** 3).to(state.radius.dtype)
        radius_acc = torch.clamp(
            state.radius / torch.clamp(shrink, min=1.0 / 3.0), max=MAX_RADIUS)
        radius = torch.where(accept, radius_acc,
                             state.radius / state.decrease_factor)
        decrease_factor = torch.where(accept, 2.0,
                                      state.decrease_factor * 2.0)

        step_norm = torch.sqrt(_dot(dx_n, dx_n) + _dot(dx_s, dx_s))
        x_norm = torch.sqrt(_dot(state.t, state.t) + _dot(state.q, state.q)
                            + _dot(state.s, state.s))
        f_conv = torch.abs(cost_change) <= function_tolerance * state.cost
        p_conv = step_norm <= parameter_tolerance * (x_norm
                                                     + parameter_tolerance)
        done = torch.where(accept, f_conv | p_conv, radius < MIN_RADIUS)

        # distress: a rejected step whose candidate cost rose materially
        overshoot = ~accept & (new_cost > state.cost * (1.0 + 1e-3)
                               + state.cost0 * 1e-9)

        return _LoopState(
            q=torch.where(accept, q_new, state.q),
            t=torch.where(accept, t_new, state.t),
            s=torch.where(accept, s_new, state.s),
            blocks=_select_blocks(accept, blocks_new, state.blocks),
            cost=torch.where(accept, new_cost, state.cost),
            radius=radius, decrease_factor=decrease_factor, k=state.k + 1,
            accepted=state.accepted + accept.to(torch.int32),
            distress=state.distress + overshoot.to(torch.int32),
            cg_total=state.cg_total + sol.iterations,
            cg_trunc=torch.maximum(state.cg_trunc,
                                   sol.rel_residual / ctx.tol_k),
            done=done | ctx.fault,
            tighten=~accept,
            cost0=state.cost0,
            fault=ctx.fault,
        )

    return LMPieces(ops, init, pre, cg_iter, post, max_cg_iterations)


def _lm_setup(problem, **setup):
    """(ops, init, body) of the LM loop's eager form: init() assembles at
    the initial guesses and returns the loop's first state, body(state) is
    one LM iteration, its CG run to the fixed cap under pcg_nodes' done
    mask (the reference's body, lm.py:324-475)."""
    pieces = _lm_pieces(problem, **setup)

    def body(state: _LoopState) -> _LoopState:
        ctx, cg = pieces.pre(state)
        for _ in range(pieces.max_cg_iterations):
            cg = pieces.cg_iter(ctx, cg)
        return pieces.post(state, ctx, cg)

    return pieces.ops, pieces.init, body


def lm_solve(
    problem: Problem,
    *,
    max_iterations: int = 10,
    max_cg_iterations: int = 60,
    cg_tolerance: float = 1e-2,
    cg_q_tolerance: float = 0.0,    # 0 = off (Ceres' eta Q rule otherwise)
    initial_radius: float = 1e4,
    function_tolerance: float = 1e-6,
    parameter_tolerance: float = 1e-8,
    renormalize: bool = True,
    preconditioner: str = "band",   # "band" | "band+coarse" |
                                    # "band*coarse" | "jacobi" | "identity"
    residual_mode: str = "6dof",    # "6dof" | "4dof"
    use_switch: bool = True,        # False: plain loop edges, no switches
                                    # (6dof only; 4dof loops are switched)
    bcr_levels=3,                   # truncate the band cyclic reduction
    coarse_group: int | None = None,  # None = coarse.auto_coarse_group
    cg_warm_iters: int = 0,         # first K LM iterations use a
    cg_warm_mult: float = 3.0,      # cg_warm_mult-times looser forcing
    precision: str = "native",      # "native": the problem's dtype
                                    # throughout; "mixed": fp64 assembly,
                                    # cost and state around fp32 CG
    dispatch_lock=None,             # held around the setup and each LM
                                    # iteration (to its host sync); on
                                    # the card also the form: one launch
                                    # per LM iteration rather than one
) -> LMResult:
    """One full LM solve of `problem` on its own device: in its own dtype
    (precision="native"), or with the assembly, cost and parameter state
    in fp64 around a linear algebra in its dtype (precision="mixed", see
    the module note; the result's q, t, switch and costs are then fp64). A
    Problem on a CUDA device is solved through the composed executables of
    its capacity bucket and configuration (ops/graphs.py: captured at first
    use, launched after; the LM and CG loops end on the device), a CPU
    Problem by the same pieces run eagerly, CG at its fixed cap. A
    parallel.ShardedProblem is solved over its mesh (parallel/
    sharded_lm.py), with the same mathematics: through the composed
    executables of its key when its shards all sit on one card
    (graphs.serves), else eagerly; its result's q, t and switch are
    gathered on the mesh's first device."""
    from solve_keyframe_pose_graph_tpu_torch.ops import graphs

    setup = dict(
        max_cg_iterations=max_cg_iterations, cg_tolerance=cg_tolerance,
        cg_q_tolerance=cg_q_tolerance, initial_radius=initial_radius,
        function_tolerance=function_tolerance,
        parameter_tolerance=parameter_tolerance, renormalize=renormalize,
        preconditioner=preconditioner, residual_mode=residual_mode,
        use_switch=use_switch, bcr_levels=bcr_levels,
        coarse_group=coarse_group, cg_warm_iters=cg_warm_iters,
        cg_warm_mult=cg_warm_mult, precision=precision)
    set_backends(problem.device)
    if not getattr(_eager, "on", False) and graphs.serves(problem):
        return graphs.solve(problem, setup, max_iterations=max_iterations,
                            dispatch_lock=dispatch_lock)
    lock = dispatch_lock if dispatch_lock is not None else \
        contextlib.nullcontext()
    with lock:
        ops, init, body = _lm_setup(problem, **setup)
        state = init()
        done = bool(state.done)
    for _ in range(max_iterations):
        if done:
            break
        with lock:
            state = body(state)
            done = bool(state.done)       # one host sync per LM iteration
    check_fault(state.fault)
    q, t, s = ops.result(state.q, state.t, state.s)
    return result(state, q, t, s)


def check_fault(fault: torch.Tensor) -> None:
    """Raise torch.linalg.LinAlgError if a coarse Cholesky factorization of
    the solve failed: `fault`, the final loop state's flag (a host read,
    after the loop)."""
    if bool(fault):
        raise torch.linalg.LinAlgError(
            "the coarse operator's Cholesky factorization failed in an LM "
            "iteration: the coarse operator is not positive-definite")


def result(state: _LoopState, q, t, s) -> LMResult:
    """The LMResult of a final loop state, with its q, t and switch."""
    return LMResult(
        q=q, t=t, switch=s,
        initial_cost=state.cost0, final_cost=state.cost,
        iterations=state.k, successful_steps=state.accepted,
        distress_rejects=state.distress,
        total_cg_iterations=state.cg_total, converged=state.done,
        cg_truncation=state.cg_trunc,
    )


def set_backends(device: torch.device) -> None:
    """The numerics every solve relies on: full-fp32 batched products (BCR
    and the coarse solve), and on the card cuSOLVER's Cholesky, which
    reports its info on the device where MAGMA's would synchronise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.backends.cuda.preferred_linalg_library("cusolver")


_eager = threading.local()


@contextlib.contextmanager
def _eager_solves():
    """Within the context, this thread's lm_solve calls run the loop
    eagerly on any device, never through ops/graphs.py: the reference
    that the graphed solves are held to (chip_smoke.py, the tests)."""
    before = getattr(_eager, "on", False)
    _eager.on = True
    try:
        yield
    finally:
        _eager.on = before


def _lm_solve_eager(problem, **kw) -> LMResult:
    """lm_solve run eagerly (see _eager_solves)."""
    with _eager_solves():
        return lm_solve(problem, **kw)


def needs_escalation(res: LMResult, escalate_rejects: int) -> bool:
    """The fp32-conditioning distress signature: overshoot rejections on a
    solve that did NOT converge within its budget (healthy solves show 0-2,
    distressed ones 4-7 on the card). escalate_rejects <= 0 always says yes."""
    if escalate_rejects <= 0:
        return True
    if bool(res.converged):
        return False
    return int(res.distress_rejects) >= escalate_rejects


def lm_solve_adaptive(problem: Problem, *, escalate_rejects: int = 3,
                      fp64_backend: str = "auto", dispatch_lock=None,
                      **lm_kw) -> tuple[LMResult, object]:
    """lm_solve, then the escalation ladder (escalate_resolve) when the
    solve shows the fp32 distress signature (needs_escalation). Returns
    (result, escalated): False, or the rung that produced the result
    ("mixed", "fp64-cpu" or "fp64")."""
    res = lm_solve(problem, dispatch_lock=dispatch_lock, **lm_kw)
    if problem.dtype == torch.float64:
        return res, False
    if not needs_escalation(res, escalate_rejects):
        return res, False
    res, rung, _ = escalate_resolve(problem, lm_kw, escalate_rejects,
                                    dispatch_lock=dispatch_lock,
                                    fp64_backend=fp64_backend)
    return res, rung


def escalate_resolve(problem: Problem, lm_kw: dict, escalate_rejects: int,
                     *, dispatch_lock=None, fp64_backend: str = "auto"
                     ) -> tuple[LMResult, str, dict]:
    """Re-solve a distressed problem from its initial guesses on the
    escalation ladder (see the module note).

    fp64_backend "auto" and "cpu" take the exact-step host rung when it is
    available for this residual family ("cpu" raises when it is not, or
    when it fails). "auto" otherwise, and "tpu" always, take the device
    ladder: the mixed rung, kept unless it still needs escalation
    (needs_escalation with escalate_rejects), then the device fp64 rung.
    Returns (result at the caller's capacities, rung, rung statistics):
    rung "fp64-cpu", "mixed" or "fp64"; the statistics hold at least
    `total_s`, the ladder's wall time, and on the device ladder `mixed_s`,
    `mixed_lm_iterations` and `mixed_cg_iterations` of the mixed rung. A
    parallel.ShardedProblem takes the host rung gathered, and the device
    rungs sharded over its mesh."""
    if fp64_backend not in FP64_BACKENDS:
        raise ValueError(f"fp64_backend={fp64_backend!r}; use one of "
                         f"{FP64_BACKENDS}")
    if fp64_backend != "tpu":
        from solve_keyframe_pose_graph_tpu_torch.solver import cpu_rung
        if cpu_rung.available(lm_kw):
            try:
                res, stats = cpu_rung.cpu_fp64_resolve(
                    problem.gathered(), lm_kw, dispatch_lock=dispatch_lock)
                return res, "fp64-cpu", stats
            except Exception:
                if fp64_backend == "cpu":
                    raise
                log.warning("host fp64 rung failed; re-solving on the "
                            "device ladder", exc_info=True)
        elif fp64_backend == "cpu":
            raise RuntimeError(
                "fp64_backend='cpu' requested but the host fp64 rung is "
                "unavailable (needs libkpg_ldl.so, scipy and the 6dof+switch "
                "residual family)")
    t0 = time.perf_counter()
    res = mixed_resolve(problem, lm_kw, dispatch_lock=dispatch_lock)
    stats = {"mixed_lm_iterations": int(res.iterations),
             "mixed_cg_iterations": int(res.total_cg_iterations)}
    stats["mixed_s"] = time.perf_counter() - t0
    rung = "mixed"
    if needs_escalation(res, escalate_rejects):
        res, rung = fp64_resolve(problem, lm_kw,
                                 dispatch_lock=dispatch_lock), "fp64"
    stats["total_s"] = time.perf_counter() - t0
    return res, rung, stats


def mixed_resolve(problem: Problem, lm_kw: dict, *,
                  dispatch_lock=None) -> LMResult:
    """The mixed rung: the solve again with precision="mixed" (fp64
    assembly, cost and parameter state; fp32 reduction, factorizations and
    CG, so K1 and K2 in fp32 on the card), at the caller's capacities and
    CG forcing, as the reference's lm.py:955-988. It takes dispatch_lock
    around each LM iteration, as lm_solve does."""
    return lm_solve(problem, dispatch_lock=dispatch_lock,
                    **dict(lm_kw, precision="mixed"))


def fp64_resolve(problem: Problem, lm_kw: dict, *,
                 dispatch_lock=None) -> LMResult:
    """The device fp64 rung: the whole solve again in float64 on the
    problem's own device, repacked as the reference repacks it (the
    smallest 1024-multiple capacities covering the live node and edge
    lengths), with the near-exact CG forcing of the reference's insurance
    rung (lm.py:1056-1073) so that its trajectory tracks the exact-step one.
    The capacity is part of the result: the BCR and coarse partitions
    follow n_cap, and the inexact-CG trajectory with them. On the 5k/10k
    bench problem both packages land at chi^2 0.4061 from n_cap 5120 and at
    71.18 from n_cap 5000 (the exact live length), so the port keeps the
    reference's granularity. The result is padded back to the caller's
    capacities; the truncated trailing entries keep their input values. A
    parallel.ShardedProblem is gathered, repacked and sharded again over
    its mesh, as the reference's rung runs a sharded Problem on its mesh;
    its capacities are multiples of lcm(1024, shards), so that the mesh
    divides them (1024 for a power-of-two mesh)."""
    kw64 = dict(lm_kw)
    kw64["cg_tolerance"] = min(1e-5, float(lm_kw.get("cg_tolerance", 1e-2)))
    kw64["max_cg_iterations"] = max(100,
                                    int(lm_kw.get("max_cg_iterations", 60)))
    kw64["cg_warm_iters"] = 0
    kw64["cg_q_tolerance"] = 0.0
    whole = problem.gathered()
    n_len, e_len = live_lengths(whole)
    small = repack_problem(whole, n_len, e_len,
                           granularity=math.lcm(1024, problem.n_shards))
    small64 = problem.reshard(small.astype(torch.float64))
    res = lm_solve(small64, dispatch_lock=dispatch_lock, **kw64)
    if small.n_cap != whole.n_cap or small.e_cap != whole.e_cap:
        def pad(full, part):
            out = full.to(part.dtype).clone()
            out[: part.shape[0]] = part
            return out
        res = res._replace(q=pad(whole.q, res.q), t=pad(whole.t, res.t),
                           switch=pad(whole.switch, res.switch))
    return res


def solve_problem(problem: Problem, solver_cfg, residual_mode: str = "6dof",
                  use_switch: bool = True) -> LMResult:
    """One solve driven by config.SolverConfig, escalation included."""
    res, _ = solve_problem_adaptive(problem, solver_cfg,
                                    residual_mode=residual_mode,
                                    use_switch=use_switch)
    return res


def solve_problem_adaptive(problem: Problem, solver_cfg,
                           residual_mode: str = "6dof",
                           use_switch: bool = True
                           ) -> tuple[LMResult, object]:
    """solve_problem with the adaptive fp64 escalation gated by
    solver_cfg.adaptive_fp64. Returns (result, escalated) as
    lm_solve_adaptive does."""
    kw = cfg_lm_kwargs(solver_cfg, residual_mode=residual_mode,
                       use_switch=use_switch)
    if solver_cfg.adaptive_fp64:
        return lm_solve_adaptive(
            problem, escalate_rejects=solver_cfg.escalate_rejects,
            fp64_backend=solver_cfg.fp64_backend, **kw)
    return lm_solve(problem, **kw), False


def cfg_lm_kwargs(solver_cfg, residual_mode: str = "6dof",
                  use_switch: bool = True) -> dict:
    """config.SolverConfig -> lm_solve keyword dict. The reference's TPU-only
    knobs (loop_impl, band_impl, tile_k, matvec_impl) select layouts for the
    TPU's matrix unit and have no counterpart here, so they are dropped."""
    return dict(
        max_iterations=solver_cfg.max_lm_iterations,
        max_cg_iterations=solver_cfg.max_cg_iterations,
        cg_tolerance=solver_cfg.cg_tolerance,
        cg_q_tolerance=solver_cfg.cg_q_tolerance,
        initial_radius=solver_cfg.initial_trust_region_radius,
        function_tolerance=solver_cfg.function_tolerance,
        parameter_tolerance=solver_cfg.parameter_tolerance,
        renormalize=solver_cfg.renormalize,
        preconditioner=solver_cfg.preconditioner,
        residual_mode=residual_mode,
        use_switch=use_switch,
        bcr_levels=solver_cfg.bcr_levels,
        coarse_group=solver_cfg.coarse_group,
        cg_warm_iters=solver_cfg.cg_warm_iters,
        cg_warm_mult=solver_cfg.cg_warm_mult,
    )
