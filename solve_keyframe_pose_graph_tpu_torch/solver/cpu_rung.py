"""Exact-step fp64 rung of the escalation ladder, on the host (counterpart
of solve_keyframe_pose_graph_tpu/solver/cpu_rung.py).

The reference backend (Ceres) solves in fp64 on the CPU with exact Newton
steps (SPARSE_NORMAL_CHOLESKY). This rung does the same for a distressed
fp32 solve:
  * the device problem is repacked to its live lengths and copied to the
    host once, in fp64 (the only device work, under the caller's dispatch
    lock, so live trigger solves keep the card);
  * an LM with exact steps: assembly, Schur reduction of the switch
    variables and switch recovery are the port's own ops/gn.py functions on
    CPU torch tensors in fp64; the node system is factored by the native
    block LDL^T (solver/native_ldl.BlockSystem of the reference package,
    numpy and ctypes only), whose fill-reducing ordering and symbolic
    analysis are reused across LM iterations;
  * trust-region constants and semantics are those of the reference rung,
    line by line (jacobi scaling, clamped LM diagonal, rho and radius
    updates, function and parameter tolerances, overshoot-distress count),
    so the result plugs into the LMResult contract.

Differences from the reference rung, on purpose: the repack is to the live
lengths (no power-of-two floors, which existed to share XLA compile keys),
the rung's statistics are returned with its result instead of being left in
a module global, and there is nothing to warm (no compile).

The host work runs on torch's CPU thread pool, whose size the caller sets
(torch.set_num_threads); it is the process-wide setting.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from solve_keyframe_pose_graph_tpu_torch.ops import gn as gn_ops
from solve_keyframe_pose_graph_tpu_torch.ops.lm import (
    MAX_LM_DIAGONAL, MAX_RADIUS, MIN_LM_DIAGONAL, MIN_RADIUS,
    MIN_RELATIVE_DECREASE, LMResult, _apply_step,
)
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, Problem, live_lengths, repack_problem,
)

# serializes the host factorizations: the native library is single-threaded
# and escalations are rare, so one at a time costs nothing
_HOST_LOCK = threading.Lock()


def available(lm_kw: dict | None = None) -> bool:
    """Can the host rung run in this process, for these solver kwargs?"""
    if lm_kw is not None:
        if lm_kw.get("residual_mode", "6dof") != "6dof":
            return False
        if not lm_kw.get("use_switch", True):
            return False
    try:
        import scipy  # noqa: F401
    except ImportError:
        return False
    from solve_keyframe_pose_graph_tpu_torch.solver import native_ldl

    return native_ldl.load_library() is not None


def _band_lists(Nc: int, F: int):
    if Nc <= 1:
        z = np.zeros(0, np.int64)
        return z, z
    band_f = np.concatenate(
        [np.full(Nc - f - 1, f, np.int64) for f in range(F)])
    band_u = np.concatenate(
        [np.arange(f + 1, Nc, dtype=np.int64) for f in range(F)])
    return band_f, band_u


def host_problem64(problem: Problem) -> Problem:
    """A copy of `problem` on the CPU with fp64 float fields (int fields
    keep their type)."""
    return Problem(**{
        name: (v.cpu() if v.dtype == torch.int32
               else v.to(device="cpu", dtype=torch.float64)).contiguous()
        for name, v in ((n, getattr(problem, n)) for n in FIELDS)})


def _aos(x: torch.Tensor) -> np.ndarray:
    """(36, N) entry-major blocks -> (N, 6, 6) numpy."""
    return gn_ops.t_blocks_to_aos(x).numpy()


def lm_solve_native(problem: Problem, lm_kw: dict):
    """Exact-step fp64 LM on the host with the trust-region semantics of
    ops/lm.lm_solve and the native block LDL^T as the inner solve.

    `problem` must be a CPU fp64 Problem (host_problem64). Returns an
    ops/lm.LMResult of CPU tensors sized to this problem's capacities."""
    from solve_keyframe_pose_graph_tpu_torch.solver.native_ldl import BlockSystem

    if problem.device.type != "cpu" or problem.dtype != torch.float64:
        raise ValueError("lm_solve_native takes a CPU float64 Problem, got "
                         f"{problem.device} {problem.dtype}")
    max_iterations = int(lm_kw.get("max_iterations", 10))
    function_tolerance = float(lm_kw.get("function_tolerance", 1e-6))
    parameter_tolerance = float(lm_kw.get("parameter_tolerance", 1e-8))
    radius = float(lm_kw.get("initial_radius", 1e4))

    Nc, F = problem.n_cap, problem.fanout
    lb = problem.loop_b.numpy().astype(np.int64)
    la = problem.loop_a.numpy().astype(np.int64)
    band_f, band_u = _band_lists(Nc, F)
    free = problem.free_mask
    diag = list(gn_ops.DIAG36)

    def cost_at(q, t, s):
        return float(gn_ops.evaluate_cost(problem, q, t, s))

    with _HOST_LOCK:
        sys_ = BlockSystem(Nc, band_f, band_u, lb, la)

        q, t, s = problem.q, problem.t, problem.switch
        decrease = 2.0
        cost = cost0 = cost_at(q, t, s)
        k = accepted = distress = 0
        done = False
        while k < max_iterations and not done:
            blocks = gn_ops.assemble_t(problem, q, t, s)
            diag_n = blocks.D[diag]                               # (6, Nc)
            scale_n = 1.0 / (1.0 + torch.sqrt(torch.clamp(diag_n, min=0)))
            scale_s = 1.0 / (1.0 + torch.sqrt(torch.clamp(blocks.ds, min=0)))
            lm_n = torch.clamp(diag_n * scale_n ** 2, MIN_LM_DIAGONAL,
                               MAX_LM_DIAGONAL) / radius
            lm_s = torch.clamp(blocks.ds * scale_s ** 2, MIN_LM_DIAGONAL,
                               MAX_LM_DIAGONAL) / radius
            red = gn_ops.schur_reduce_t(blocks, problem, scale_n, scale_s,
                                        lm_n, lm_s)
            band_vals = (np.concatenate([_aos(red.Bh[f])[f + 1:]
                                         for f in range(F)])
                         if Nc > 1 else np.zeros((0, 6, 6)))
            rhs_n = red.rhs_n.T.numpy()                           # (Nc, 6)

            Ax = sys_.fill(_aos(red.Dh), band_vals, band_f, _aos(red.Aba_h))
            ok, dxh = sys_.solve(Ax, rhs_n)
            if not ok:
                # numerically singular factor: shrink the trust region and
                # retry (a rejected step, as lm_solve's invalid-step path)
                radius /= decrease
                decrease *= 2.0
                k += 1
                done = radius < MIN_RADIUS
                continue
            dxh_n = torch.from_numpy(np.ascontiguousarray(dxh.T))  # (6, Nc)
            dxh_s = gn_ops.recover_switches_t(red, problem, dxh_n)

            # model cost change from reduced quantities; the exact solve
            # means H_red dx = rhs exactly (CG residual r = 0)
            bs = red.rhs_s
            quad_S = (float(torch.sum(dxh_n * red.rhs_n))
                      + float(torch.sum(red.ds_inv * bs * bs)))
            quad_lm = (float(torch.sum(lm_n * dxh_n * dxh_n))
                       + float(torch.sum(lm_s * dxh_s * dxh_s)))
            gTdx = (float(torch.sum(blocks.g_n * scale_n * dxh_n))
                    - float(torch.sum(bs * dxh_s)))
            model_cost_change = -gTdx - 0.5 * (quad_S - quad_lm)

            dx_n = (dxh_n * scale_n).T                            # (Nc, 6)
            dx_s = dxh_s * scale_s
            q_new, t_new, s_new = _apply_step(q, t, s, dx_n, dx_s, free,
                                              renormalize=True)
            new_cost = cost_at(q_new, t_new, s_new)

            cost_change = cost - new_cost
            rho = (cost_change / model_cost_change
                   if model_cost_change > 0 else -1.0)
            accept = model_cost_change > 0 and rho > MIN_RELATIVE_DECREASE
            if accept:
                step_norm = float(torch.sqrt(torch.sum(dx_n * dx_n)
                                             + torch.sum(dx_s * dx_s)))
                x_norm = float(torch.sqrt(torch.sum(t * t) + torch.sum(q * q)
                                          + torch.sum(s * s)))
                q, t, s, cost = q_new, t_new, s_new, new_cost
                radius = min(
                    radius / max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                    MAX_RADIUS)
                decrease = 2.0
                accepted += 1
                done = (abs(cost_change) <= function_tolerance * (
                    cost + cost_change)          # vs the pre-step cost
                    or step_norm <= parameter_tolerance
                    * (x_norm + parameter_tolerance))
            else:
                if new_cost > cost * (1.0 + 1e-3) + cost0 * 1e-9:
                    distress += 1
                radius /= decrease
                decrease *= 2.0
                done = radius < MIN_RADIUS
            k += 1

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype)

    return LMResult(
        q=q, t=t, switch=s,
        initial_cost=scalar(cost0, torch.float64),
        final_cost=scalar(cost, torch.float64),
        iterations=scalar(k, torch.int32),
        successful_steps=scalar(accepted, torch.int32),
        distress_rejects=scalar(distress, torch.int32),
        total_cg_iterations=scalar(0, torch.int32),
        converged=scalar(done, torch.bool),
        cg_truncation=scalar(0.0, torch.float64),
    )


def cpu_fp64_resolve(problem: Problem, lm_kw: dict, *, dispatch_lock=None):
    """The host rung for a distressed solve of `problem` (on any device).

    The device is touched once, under dispatch_lock: the live-length repack
    and one copy to the host. Returns (LMResult of CPU fp64 tensors padded
    back to the caller's capacities, statistics {fetch_s, total_s, n_cap,
    e_cap} of this call)."""
    lock = (dispatch_lock if dispatch_lock is not None
            else contextlib.nullcontext())
    t0 = time.perf_counter()
    with lock:
        n_len, e_len = live_lengths(problem)
        small = repack_problem(problem, n_len, e_len, granularity=1)
        host = host_problem64(small)
        padded = small.n_cap != problem.n_cap or small.e_cap != problem.e_cap
        if padded:
            pad_q, pad_t, pad_s = (
                getattr(problem, f).to(device="cpu", dtype=torch.float64)
                for f in ("q", "t", "switch"))
    fetch_s = time.perf_counter() - t0

    res = lm_solve_native(host, lm_kw)
    if padded:
        # the truncated trailing entries are masked padding or dead zones:
        # they keep their input values, as in the device rung
        pad_q[: small.n_cap] = res.q
        pad_t[: small.n_cap] = res.t
        pad_s[: small.e_cap] = res.switch
        res = res._replace(q=pad_q, t=pad_t, switch=pad_s)
    stats = {"fetch_s": fetch_s, "total_s": time.perf_counter() - t0,
             "n_cap": host.n_cap, "e_cap": host.e_cap}
    return res, stats
