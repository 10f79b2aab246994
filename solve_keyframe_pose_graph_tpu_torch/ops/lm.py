"""Levenberg-Marquardt trust region and the fp64 escalation ladder
(counterpart of solve_keyframe_pose_graph_tpu/ops/lm.py: _lm_setup,
lm_solve, lm_solve_adaptive, needs_escalation, escalate_resolve,
fp64_resolve, solve_problem, solve_problem_adaptive, cfg_lm_kwargs).

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

On a CUDA problem every reduced matvec's band part runs kernel K1 and every
BCR inverse kernel K2: the wrappers dispatch on the tensors' device, which
replaces the reference's backend switch (lm.py:172-177). The LM loop reads
its `done` flag on the host once per iteration, so a solve synchronises at
most max_iterations + 1 times; CG never synchronises.

Escalation ladder. A distressed fp32 solve (needs_escalation) is re-solved
in fp64 from the same initial guesses on one of two rungs, chosen by
SolverConfig.fp64_backend as in the reference:
  * "fp64-cpu", the exact-step host rung (solver/cpu_rung.py): "auto"
    (the default) and "cpu" take it whenever it is available;
  * "fp64", the device rung (fp64_resolve): lm_solve in float64 on the
    problem's own device, repacked to the smallest 1024-multiple capacities
    covering the live lengths (the reference's repack), with near-exact CG
    forcing (cg_tolerance <= 1e-5, max_cg_iterations >= 100), padded back
    to the caller's capacities. On the card it runs K1 and K2 in fp64 (the
    TPU's Pallas kernels were fp32-only). The config value
    fp64_backend="tpu" names this device rung in the port; "auto" falls
    back to it when the host rung is unavailable or fails, and logs the
    failure at WARNING.
The device rung takes the caller's dispatch_lock around each LM iteration,
so a streaming engine's trigger solves wait at most one iteration.

Not ported: the AOT executable cache, outer_unroll, freeze_preconditioner,
the mixed-precision rung and lm_solve_chunked (they exist for the TPU's
emulated fp64 and its ~100 s dispatch limit), and the TPU-only loop_impl /
band_impl / tile_k / matvec_impl variants. The host rung serves the 6-DOF
switched family only, so a 4-DOF escalation under "auto" takes the device
rung.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import NamedTuple

import torch

from solve_keyframe_pose_graph_tpu_torch.ops import band as band_ops
from solve_keyframe_pose_graph_tpu_torch.ops import coarse as coarse_ops
from solve_keyframe_pose_graph_tpu_torch.ops import gn as gn_ops
from solve_keyframe_pose_graph_tpu_torch.ops import pcg as pcg_ops
from solve_keyframe_pose_graph_tpu_torch.ops import se3
from solve_keyframe_pose_graph_tpu_torch.ops import smallinv
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    Problem, live_lengths, problem_astype, repack_problem,
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


def _lm_setup(
    problem: Problem,
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
):
    """(init_state, body) of the LM loop."""
    if preconditioner not in PRECONDITIONERS:
        raise ValueError(f"preconditioner={preconditioner!r}; use one of "
                         f"{PRECONDITIONERS}")
    if residual_mode not in RESIDUAL_MODES:
        raise ValueError(f"residual_mode={residual_mode!r}; use one of "
                         f"{RESIDUAL_MODES}")
    if coarse_group is None:
        coarse_group = coarse_ops.auto_coarse_group(problem.n_cap)
    dt, dev = problem.dtype, problem.device
    F = problem.fanout

    def scalar(v):
        return torch.tensor(v, dtype=dt, device=dev)

    tol_base = scalar(cg_tolerance)
    tol_warm = scalar(cg_tolerance * cg_warm_mult)
    tol_tight = scalar(cg_tolerance * 0.1)

    def assemble(q, t, s):
        if residual_mode == "4dof":           # use_switch does not apply
            return gn_ops.assemble_4dof_t(problem, q, t, s)
        return gn_ops.assemble_t(problem, q, t, s, use_switch=use_switch)

    def make_precond(red: gn_ops.ReducedSystemT, mv):
        """Preconditioner on (6,Nc) vectors, returning contiguous tensors
        (the CG direction feeds kernel K1, which takes contiguous input).
        mv, the reduced matvec, is used by the band*coarse two-grid."""
        if preconditioner == "identity":
            return lambda r: r
        if preconditioner == "jacobi":
            Minv = smallinv.best_inv(gn_ops.t_blocks_to_aos(red.Dh))
            return lambda r: torch.einsum(
                "uij,uj->ui", Minv, r.T).T.contiguous()
        # the BCR factorization runs on AoS super-node blocks
        Bh_aos = torch.stack([gn_ops.t_blocks_to_aos(red.Bh[f])
                              for f in range(F)])
        A_band, C_band, _ = band_ops.build_band_system(
            gn_ops.t_blocks_to_aos(red.Dh), Bh_aos, group=F)
        fac = band_ops.bcr_factorize(A_band, C_band, group=F,
                                     max_levels=bcr_levels)

        def band(r):
            return band_ops.band_precond_apply(fac, r.T).T

        if preconditioner == "band":
            return lambda r: band(r).contiguous()
        Hc_inv = coarse_ops.build_coarse_inverse(red, problem, coarse_group)

        def coarse(r):
            return coarse_ops.coarse_apply(Hc_inv, problem.free_mask, r,
                                           coarse_group)

        if preconditioner == "band+coarse":
            return lambda r: (band(r) + coarse(r)).contiguous()
        return lambda r: coarse_ops.two_grid_apply(band, coarse, mv, r)

    def reduce(blocks: gn_ops.GNBlocksT, radius):
        diag_n = blocks.D[list(gn_ops.DIAG36)]                 # (6, Nc)
        diag_s = blocks.ds                                     # (Ec,)
        scale_n = 1.0 / (1.0 + torch.sqrt(torch.clamp(diag_n, min=0)))
        scale_s = 1.0 / (1.0 + torch.sqrt(torch.clamp(diag_s, min=0)))
        # LM diagonal of the SCALED system, clamped as in Ceres
        lm_n = torch.clamp(diag_n * scale_n * scale_n, MIN_LM_DIAGONAL,
                           MAX_LM_DIAGONAL) / radius
        lm_s = torch.clamp(diag_s * scale_s * scale_s, MIN_LM_DIAGONAL,
                           MAX_LM_DIAGONAL) / radius
        red = gn_ops.schur_reduce_t(blocks, problem, scale_n, scale_s,
                                    lm_n, lm_s)
        return red, scale_n, scale_s, lm_n, lm_s

    blocks0 = assemble(problem.q, problem.t, problem.switch)
    cost0 = blocks0.cost

    def body(state: _LoopState) -> _LoopState:
        blocks = state.blocks
        red, scale_n, scale_s, lm_n, lm_s = reduce(blocks, state.radius)
        g_n_hat = blocks.g_n * scale_n                         # (6, Nc)
        Aba_aos = gn_ops.t_blocks_to_aos(red.Aba_h)            # hoisted

        def mv(p):
            return gn_ops.reduced_matvec_t(red, problem, p, Aba_aos)

        # after a rejected step the retry solves CG 10x tighter
        tol_k = torch.where(state.k < cg_warm_iters, tol_warm, tol_base)
        tol_k = torch.where(state.tighten, tol_tight, tol_k)
        sol = pcg_ops.pcg_nodes(
            mv, make_precond(red, mv), red.rhs_n,
            max_iterations=max_cg_iterations, r_tolerance=tol_k,
            q_tolerance=cg_q_tolerance)
        dxh_n = sol.x                                          # (6, Nc)
        dxh_s = gn_ops.recover_switches_t(red, problem, dxh_n)

        # model cost change -g'.dx' - 0.5 dx'.H'.dx' (H' without the LM
        # diagonal) from reduced quantities: H_red xn = rhs_n - r_cg by the
        # CG recurrence, and the switch terms telescope
        bs = red.rhs_s
        quad_S = _dot(dxh_n, red.rhs_n - sol.r) + _dot(red.ds_inv * bs, bs)
        quad_lm = _dot(lm_n * dxh_n, dxh_n) + _dot(lm_s * dxh_s, dxh_s)
        gTdx = _dot(g_n_hat, dxh_n) - _dot(bs, dxh_s)
        model_cost_change = -gTdx - 0.5 * (quad_S - quad_lm)

        dx_n = (dxh_n * scale_n).T
        dx_s = dxh_s * scale_s
        q_new, t_new, s_new = _apply_step(
            state.q, state.t, state.s, dx_n, dx_s, problem.free_mask,
            renormalize)
        # speculative assembly at the candidate: its cost is the candidate
        # cost, and its blocks are the next linearization if accepted
        blocks_new = assemble(q_new, t_new, s_new)
        new_cost = blocks_new.cost

        cost_change = state.cost - new_cost
        rho = cost_change / torch.where(model_cost_change <= 0, 1.0,
                                        model_cost_change)
        accept = (model_cost_change > 0) & (rho > MIN_RELATIVE_DECREASE)

        shrink = 1.0 - (2.0 * rho - 1.0) ** 3
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
                               + cost0 * 1e-9)

        return _LoopState(
            q=torch.where(accept, q_new, state.q),
            t=torch.where(accept, t_new, state.t),
            s=torch.where(accept, s_new, state.s),
            blocks=_select_blocks(accept, blocks_new, blocks),
            cost=torch.where(accept, new_cost, state.cost),
            radius=radius, decrease_factor=decrease_factor, k=state.k + 1,
            accepted=state.accepted + accept.to(torch.int32),
            distress=state.distress + overshoot.to(torch.int32),
            cg_total=state.cg_total + sol.iterations,
            cg_trunc=torch.maximum(state.cg_trunc,
                                   sol.rel_residual / tol_k),
            done=done,
            tighten=~accept,
        )

    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    init = _LoopState(
        q=problem.q, t=problem.t, s=problem.switch, blocks=blocks0,
        cost=cost0, radius=scalar(initial_radius),
        decrease_factor=scalar(2.0), k=zero_i, accepted=zero_i,
        distress=zero_i, cg_total=zero_i, cg_trunc=scalar(0.0),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        tighten=torch.zeros((), dtype=torch.bool, device=dev),
    )
    return init, body


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
    precision: str = "native",      # only the problem's own dtype
    dispatch_lock=None,             # held around the setup and each LM
                                    # iteration (to its host sync)
) -> LMResult:
    """One full LM solve of `problem` on its own device and dtype."""
    if precision != "native":
        raise ValueError(f"precision={precision!r} is not ported")
    # BCR and the coarse solve rely on full-fp32 batched products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lock = dispatch_lock if dispatch_lock is not None else \
        contextlib.nullcontext()
    with lock:
        state, body = _lm_setup(
            problem, max_cg_iterations=max_cg_iterations,
            cg_tolerance=cg_tolerance, cg_q_tolerance=cg_q_tolerance,
            initial_radius=initial_radius,
            function_tolerance=function_tolerance,
            parameter_tolerance=parameter_tolerance,
            renormalize=renormalize, preconditioner=preconditioner,
            residual_mode=residual_mode, use_switch=use_switch,
            bcr_levels=bcr_levels, coarse_group=coarse_group,
            cg_warm_iters=cg_warm_iters,
            cg_warm_mult=cg_warm_mult)
        done = bool(state.done)
    cost0 = state.cost
    for _ in range(max_iterations):
        if done:
            break
        with lock:
            state = body(state)
            done = bool(state.done)       # one host sync per LM iteration
    return LMResult(
        q=state.q, t=state.t, switch=state.s,
        initial_cost=cost0, final_cost=state.cost,
        iterations=state.k, successful_steps=state.accepted,
        distress_rejects=state.distress,
        total_cg_iterations=state.cg_total, converged=state.done,
        cg_truncation=state.cg_trunc,
    )


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
    """lm_solve, then the escalation ladder when the solve shows the fp32
    distress signature (needs_escalation). Returns (result, escalated):
    False, or the rung that produced the result ("fp64-cpu" or "fp64")."""
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
    """Re-solve a distressed problem in fp64 from its initial guesses.

    fp64_backend "auto" and "cpu" take the exact-step host rung when it is
    available for this residual family ("cpu" raises when it is not, or
    when it fails); "auto" otherwise, and "tpu" always, take the device
    rung. Returns (result padded to the caller's capacities, rung, rung
    statistics): rung "fp64-cpu" or "fp64", statistics a dict with at
    least `total_s`, the rung's wall time. escalate_rejects is unused by
    the two-rung ladder (the reference's mixed rung consulted it) and kept
    for its signature."""
    del escalate_rejects
    if fp64_backend not in FP64_BACKENDS:
        raise ValueError(f"fp64_backend={fp64_backend!r}; use one of "
                         f"{FP64_BACKENDS}")
    if fp64_backend != "tpu":
        from solve_keyframe_pose_graph_tpu_torch.solver import cpu_rung
        if cpu_rung.available(lm_kw):
            try:
                res, stats = cpu_rung.cpu_fp64_resolve(
                    problem, lm_kw, dispatch_lock=dispatch_lock)
                return res, "fp64-cpu", stats
            except Exception:
                if fp64_backend == "cpu":
                    raise
                log.warning("host fp64 rung failed; re-solving on the "
                            "device rung", exc_info=True)
        elif fp64_backend == "cpu":
            raise RuntimeError(
                "fp64_backend='cpu' requested but the host fp64 rung is "
                "unavailable (needs libkpg_ldl.so, scipy and the 6dof+switch "
                "residual family)")
    t0 = time.perf_counter()
    res = fp64_resolve(problem, lm_kw, dispatch_lock=dispatch_lock)
    return res, "fp64", {"total_s": time.perf_counter() - t0}


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
    capacities; the truncated trailing entries keep their input values."""
    kw64 = dict(lm_kw)
    kw64["cg_tolerance"] = min(1e-5, float(lm_kw.get("cg_tolerance", 1e-2)))
    kw64["max_cg_iterations"] = max(100,
                                    int(lm_kw.get("max_cg_iterations", 60)))
    kw64["cg_warm_iters"] = 0
    kw64["cg_q_tolerance"] = 0.0
    n_len, e_len = live_lengths(problem)
    small = repack_problem(problem, n_len, e_len)
    res = lm_solve(problem_astype(small, torch.float64),
                   dispatch_lock=dispatch_lock, **kw64)
    if small.n_cap != problem.n_cap or small.e_cap != problem.e_cap:
        def pad(full, part):
            out = full.to(part.dtype).clone()
            out[: part.shape[0]] = part
            return out
        res = res._replace(q=pad(problem.q, res.q), t=pad(problem.t, res.t),
                           switch=pad(problem.switch, res.switch))
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
