"""Plain NumPy reference of the switchable-constraint pose graph that the
program solves. It imports nothing of the program and nothing of JAX.

The formulation (the reference node's PoseGraphSLAM.cpp and
CeresResidues.h, as the program states it):

  * odometry: for every node u and f = 1..fanout with u >= f, the 6-row
    error between nodes u and u - f against their relative VIO pose,
    weighted by decay**f * exp(-yaw_deg**2 / yaw_sigma2), yaw that of the
    observed relative rotation;
  * loop edge (a, b), observed as the pose of a seen from b: the 6-row
    error between b and a and the row (1 - s), every row times the
    switch s (the weight is ignored, as in the reference's residual);
  * a prior on node 0, at its VIO pose, weight max(1.1, log(n) / 2);
  * 6-row error [dt; 2 vec(dq)] of dq = (q1^-1 q2)^-1 obs_q,
    dt = (q1^-1 q2)^-1 applied to (obs_t - p12);
  * cost 0.5 * sum of squares.

The solve is Levenberg-Marquardt with Ceres' semantics (Jacobi scaling,
clamped LM diagonal, its radius update), each step exact: the switches
are eliminated per edge and the node system is solved by a sparse direct
LU. Jacobians come from the complex step, which is exact to rounding.
The tangent of a node is [dtheta, dt] with q <- Exp(dtheta) q, t <- t + dt.

`precision="tf32"` runs the same algorithm with every array it keeps
(inputs, Jacobians, residuals, the step and the state) rounded to TF32's
10-bit mantissa: the lower-precision control.

It serves one world: trigger_start, trigger_problem, trigger_solve and
cost are what harness/check.py asks of a configuration's reference, and a
graph with events (a kidnap) is refused.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from port_bench.harness import generators, nse3

MIN_LM_DIAG, MAX_LM_DIAG = 1e-6, 1e32
_H = 1e-30                       # complex step


def round_tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 (8-bit exponent, 10-bit mantissa), to nearest
    even, returned as float64."""
    b = np.asarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x0FFF) + ((b >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return b.view(np.float32).astype(np.float64)


def _identity(x):
    return np.asarray(x, np.float64)


ROUNDING = {"fp64": _identity, "tf32": round_tf32}


@dataclasses.dataclass
class Problem:
    n: int
    odo_i: np.ndarray            # (M,) node u
    odo_j: np.ndarray            # (M,) node u - f
    odo_q: np.ndarray            # (M, 4) observed pose of u - f seen from u
    odo_t: np.ndarray
    odo_w: np.ndarray            # (M,)
    loop_a: np.ndarray           # (E,)
    loop_b: np.ndarray
    loop_q: np.ndarray           # (E, 4) pose of a seen from b
    loop_t: np.ndarray
    prior_q: np.ndarray          # (4,) on node 0
    prior_t: np.ndarray
    prior_w: float
    pattern: tuple | None = dataclasses.field(default=None, repr=False)


def build_problem(vio_q, vio_t, loop_a, loop_b, loop_q, loop_t, *,
                  fanout: int, decay: float, yaw_sigma2: float,
                  prior=None, rounding=_identity) -> Problem:
    """The problem over the n nodes and the E edges given; the prior on
    node 0 at `prior` (q, t), by default its VIO pose."""
    vio_q = nse3.quat_normalize(vio_q)
    n = len(vio_q)
    ii, jj, oq, ot, ow = [], [], [], [], []
    for f in range(1, fanout + 1):
        if n <= f:
            break
        rq, rt = nse3.pose_relative(vio_q[f:], vio_t[f:], vio_q[:n - f],
                                    vio_t[:n - f])
        yaw = nse3.relative_yaw_deg(rq)
        ii.append(np.arange(f, n))
        jj.append(np.arange(0, n - f))
        oq.append(rq)
        ot.append(rt)
        ow.append(decay ** f * np.exp(-yaw * yaw / yaw_sigma2))
    cat = (lambda xs, shape: np.concatenate(xs) if xs else np.zeros(shape))
    return Problem(
        n=n, odo_i=cat(ii, (0,)).astype(np.int64),
        odo_j=cat(jj, (0,)).astype(np.int64),
        odo_q=rounding(cat(oq, (0, 4))), odo_t=rounding(cat(ot, (0, 3))),
        odo_w=rounding(cat(ow, (0,))),
        loop_a=np.asarray(loop_a, np.int64),
        loop_b=np.asarray(loop_b, np.int64),
        loop_q=rounding(nse3.quat_normalize(loop_q).reshape(-1, 4)),
        loop_t=rounding(np.asarray(loop_t, np.float64).reshape(-1, 3)),
        prior_q=rounding(vio_q[0] if prior is None else prior[0]),
        prior_t=rounding(vio_t[0] if prior is None else prior[1]),
        prior_w=max(1.1, math.log(n) / 2.0))


# ---------------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------------


def start(vio_q, vio_t, n: int, e: int, prev=None,
          switch_init: float = 0.99):
    """The state a solve over the first n nodes and e edges starts from:
    the reference node's initial guesses (PoseGraphSLAM.cpp:1645-1795) for
    one world. `prev` is (q, t, s) that the previous solve wrote back, over
    its nodes and edges, or None for a session's first solve. Its nodes
    keep their poses; each newer node u is chained by odometry from the
    newest of them, `last`: w_T_last * (vio_last^-1 * vio_u). Its edges
    keep their switches; newer edges start at switch_init. With no
    previous solve every node starts at its VIO pose."""
    vio_q = np.asarray(vio_q[:n], np.float64)
    vio_t = np.asarray(vio_t[:n], np.float64)
    s = np.full(e, float(switch_init))
    if prev is None:
        return nse3.quat_normalize(vio_q), vio_t.copy(), s
    pq, pt, ps = (np.asarray(a, np.float64) for a in prev)
    m = len(pq)
    q, t = np.empty((n, 4)), np.empty((n, 3))
    q[:m], t[:m] = pq, pt
    if n > m:
        qi, ti = nse3.pose_inv(vio_q[m - 1], vio_t[m - 1])
        qd, td = nse3.pose_mul(np.broadcast_to(qi, (n - m, 4)),
                               np.broadcast_to(ti, (n - m, 3)),
                               vio_q[m:], vio_t[m:])
        qn, tn = nse3.pose_mul(np.broadcast_to(pq[m - 1], qd.shape),
                               np.broadcast_to(pt[m - 1], td.shape), qd, td)
        q[m:], t[m:] = nse3.quat_normalize(qn), tn
    s[:len(ps)] = ps
    return q, t, s


def _rotate(q, v):
    """quat_rotate written out by component (np.cross is slow)."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    ux = qy * vz - qz * vy
    uy = qz * vx - qx * vz
    uz = qx * vy - qy * vx
    return np.stack([vx + 2.0 * (qw * ux + qy * uz - qz * uy),
                     vy + 2.0 * (qw * uy + qz * ux - qx * uz),
                     vz + 2.0 * (qw * uz + qx * uy - qy * ux)], axis=-1)


def _core(q1, t1, q2, t2, oq, ot):
    q1c = nse3.quat_conj(q1)
    q12c = nse3.quat_conj(nse3.quat_mul(q1c, q2))
    p12 = _rotate(q1c, t2 - t1)
    dq = nse3.quat_mul(q12c, oq)
    dt = _rotate(q12c, ot - p12)
    return np.concatenate([dt, 2.0 * dq[..., :3]], axis=-1)


def _odo_res(p: Problem, q1, t1, q2, t2):
    return _core(q1, t1, q2, t2, p.odo_q, p.odo_t) * p.odo_w[:, None]


def _loop_res(p: Problem, qb, tb, qa, ta, s):
    core = _core(qb, tb, qa, ta, p.loop_q, p.loop_t)
    return np.concatenate([core, (1.0 - s)[:, None]], axis=-1) * s[:, None]


def _prior_res(p: Problem, q, t):
    dq, dt = nse3.pose_relative(p.prior_q, p.prior_t, q, t)
    return np.concatenate([dt, 2.0 * dq[..., :3]], axis=-1) * p.prior_w


def residuals(p: Problem, q, t, s):
    """(odometry (M, 6), loop (E, 7), prior (6,)) residuals."""
    return (_odo_res(p, q[p.odo_i], t[p.odo_i], q[p.odo_j], t[p.odo_j]),
            _loop_res(p, q[p.loop_b], t[p.loop_b], q[p.loop_a], t[p.loop_a],
                      s),
            _prior_res(p, q[0], t[0]))


def cost(p: Problem, q, t, s) -> float:
    """0.5 * sum of squares of every residual, in float64."""
    q = np.asarray(q, np.float64)
    t = np.asarray(t, np.float64)
    s = np.asarray(s, np.float64)
    return 0.5 * float(sum(np.sum(r * r) for r in residuals(p, q, t, s)))


# ---------------------------------------------------------------------------
# Jacobians by the complex step
# ---------------------------------------------------------------------------


def _perturb(q, t, k):
    """A node's state moved by i*_H along tangent component k."""
    if k < 3:
        d = np.zeros(4, complex)
        d[k] = 1j * _H
        d[3] = 1.0
        return nse3.quat_mul(d, q), t
    t = t.astype(complex)
    t[..., k - 3] += 1j * _H
    return q, t


def _jac_binary(fn, q1, t1, q2, t2, *extra):
    """r and its Jacobians (K, rows, 6) in the tangents of both nodes.

    The first node's by the complex step. The second's follow from the
    residual's invariance under a rigid motion of both nodes. A rotation
    of both by the rotation vector 2 d (q <- Exp(d) q turns q by 2 |d|)
    moves a node by dtheta = d, dt = 2 d x t, a translation v by dt = v:
    so J2_t = -J1_t and J2_theta = -J1_theta + 2 J1_t [t1 - t2]x, with
    [u]x the matrix of u x ."""
    r = fn(q1, t1, q2, t2, *extra)
    c1 = [q1.astype(complex), t1.astype(complex)]
    c2 = [q2.astype(complex), t2.astype(complex)]
    ex = [e.astype(complex) for e in extra]
    J1 = np.empty(r.shape + (6,))
    for k in range(6):
        a, b = _perturb(*c1, k)
        J1[..., k] = fn(a, b, *c2, *ex).imag / _H
    d = t1 - t2
    cross = np.zeros(d.shape[:-1] + (3, 3))
    cross[..., 0, 1], cross[..., 0, 2] = -d[..., 2], d[..., 1]
    cross[..., 1, 0], cross[..., 1, 2] = d[..., 2], -d[..., 0]
    cross[..., 2, 0], cross[..., 2, 1] = -d[..., 1], d[..., 0]
    J2 = np.empty_like(J1)
    J2[..., 3:] = -J1[..., 3:]
    J2[..., :3] = -J1[..., :3] + 2.0 * np.matmul(J1[..., 3:], cross)
    return r, J1, J2


@dataclasses.dataclass
class _Linear:
    r_odo: np.ndarray
    Jo1: np.ndarray
    Jo2: np.ndarray
    r_loop: np.ndarray
    Jl1: np.ndarray
    Jl2: np.ndarray
    Jls: np.ndarray
    r_pri: np.ndarray
    Jp: np.ndarray


def linearize(p: Problem, q, t, s, rounding=_identity) -> _Linear:
    o_fn = (lambda a, b, c, d: _odo_res(p, a, b, c, d))
    r_o, Jo1, Jo2 = _jac_binary(o_fn, q[p.odo_i], t[p.odo_i], q[p.odo_j],
                                t[p.odo_j])
    l_fn = (lambda a, b, c, d, e: _loop_res(p, a, b, c, d, e))
    qb, tb, qa, ta = q[p.loop_b], t[p.loop_b], q[p.loop_a], t[p.loop_a]
    r_l, Jl1, Jl2 = _jac_binary(l_fn, qb, tb, qa, ta, s)
    s_c = s.astype(complex) + 1j * _H
    Jls = _loop_res(p, qb.astype(complex), tb.astype(complex),
                    qa.astype(complex), ta.astype(complex), s_c).imag / _H
    r_p = _prior_res(p, q[0], t[0])
    Jp = np.empty((6, 6))
    for k in range(6):
        a, b = _perturb(q[0].astype(complex), t[0].astype(complex), k)
        Jp[:, k] = _prior_res(p, a, b).imag / _H
    R = rounding
    return _Linear(R(r_o), R(Jo1), R(Jo2), R(r_l), R(Jl1), R(Jl2), R(Jls),
                   R(r_p), R(Jp))


# ---------------------------------------------------------------------------
# Levenberg-Marquardt
# ---------------------------------------------------------------------------


def _btb(A, B):
    """Batched A^T B for (K, rows, m), (K, rows, n)."""
    return np.matmul(np.swapaxes(A, 1, 2), B)


def _btr(A, r):
    """Batched A^T r for (K, rows, m), (K, rows)."""
    return np.matmul(np.swapaxes(A, 1, 2), r[:, :, None])[:, :, 0]


def _scatter(idx, vals, n: int):
    """The sum of vals (K, ...) into (n, ...) at rows idx (K,)."""
    m = int(np.prod(vals.shape[1:]))
    flat = (idx[:, None] * m + np.arange(m)).ravel()
    return np.bincount(flat, weights=vals.reshape(-1),
                       minlength=n * m).reshape((n,) + vals.shape[1:])


def _pattern(p: Problem):
    """The node system's sparsity pattern, in CSC, and where each (6, 6)
    block entry of _step's list lands in it (found once per problem)."""
    if p.pattern is None:
        n = p.n
        rows = np.concatenate([np.arange(n), p.odo_i, p.odo_j, p.loop_b,
                               p.loop_a])
        cols = np.concatenate([np.arange(n), p.odo_j, p.odo_i, p.loop_a,
                               p.loop_b])
        idx = np.arange(6)
        r = (rows[:, None, None] * 6 + idx[None, :, None])
        c = (cols[:, None, None] * 6 + idx[None, None, :])
        key = (np.broadcast_to(c, (len(rows), 6, 6)).ravel() * (6 * n)
               + np.broadcast_to(r, (len(rows), 6, 6)).ravel())
        uniq, where = np.unique(key, return_inverse=True)
        indptr = np.concatenate([[0], np.cumsum(np.bincount(
            uniq // (6 * n), minlength=6 * n))])
        p.pattern = (where, (uniq % (6 * n)).astype(np.int32),
                     indptr.astype(np.int32), len(uniq))
    return p.pattern


def _step(p: Problem, lin: _Linear, radius: float):
    """The LM step (dx (n, 6), ds (E,)) for this radius, and the model's
    cost decrease."""
    n = p.n
    # normal equations, unscaled
    D = (_scatter(p.odo_i, _btb(lin.Jo1, lin.Jo1), n)
         + _scatter(p.odo_j, _btb(lin.Jo2, lin.Jo2), n)
         + _scatter(p.loop_b, _btb(lin.Jl1, lin.Jl1), n)
         + _scatter(p.loop_a, _btb(lin.Jl2, lin.Jl2), n))
    D[0] += lin.Jp.T @ lin.Jp
    g = (_scatter(p.odo_i, _btr(lin.Jo1, lin.r_odo), n)
         + _scatter(p.odo_j, _btr(lin.Jo2, lin.r_odo), n)
         + _scatter(p.loop_b, _btr(lin.Jl1, lin.r_loop), n)
         + _scatter(p.loop_a, _btr(lin.Jl2, lin.r_loop), n))
    g[0] += lin.Jp.T @ lin.r_pri
    O_odo = _btb(lin.Jo1, lin.Jo2)                   # rows i, cols j
    O_loop = _btb(lin.Jl1, lin.Jl2)                  # rows b, cols a
    hss = np.sum(lin.Jls * lin.Jls, axis=-1)
    h1s = _btr(lin.Jl1, lin.Jls)
    h2s = _btr(lin.Jl2, lin.Jls)
    gs = np.sum(lin.Jls * lin.r_loop, axis=-1)

    # Jacobi scaling and the LM diagonal
    dn = np.diagonal(D, axis1=-2, axis2=-1)
    sn = 1.0 / (1.0 + np.sqrt(np.maximum(dn, 0)))
    ss = 1.0 / (1.0 + np.sqrt(np.maximum(hss, 0)))
    lm_n = np.clip(dn * sn ** 2, MIN_LM_DIAG, MAX_LM_DIAG) / radius
    lm_s = np.clip(hss * ss ** 2, MIN_LM_DIAG, MAX_LM_DIAG) / radius

    Dh = D * sn[:, :, None] * sn[:, None, :]
    Dh[:, np.arange(6), np.arange(6)] += lm_n
    gh = g * sn
    Oo = O_odo * sn[p.odo_i][:, :, None] * sn[p.odo_j][:, None, :]
    Ol = O_loop * sn[p.loop_b][:, :, None] * sn[p.loop_a][:, None, :]
    # eliminate each switch from its own edge's two nodes
    hh = hss * ss ** 2 + lm_s
    v1 = h1s * sn[p.loop_b] * ss[:, None]
    v2 = h2s * sn[p.loop_a] * ss[:, None]
    ghs = gs * ss
    w = 1.0 / hh[:, None, None]
    Dh -= (_scatter(p.loop_b, v1[:, :, None] * v1[:, None, :] * w, n)
           + _scatter(p.loop_a, v2[:, :, None] * v2[:, None, :] * w, n))
    Ol = Ol - v1[:, :, None] * v2[:, None, :] * w
    gh -= (_scatter(p.loop_b, v1 * (ghs / hh)[:, None], n)
           + _scatter(p.loop_a, v2 * (ghs / hh)[:, None], n))

    where, indices, indptr, nnz = _pattern(p)
    blocks = np.concatenate([Dh, Oo, np.swapaxes(Oo, 1, 2), Ol,
                             np.swapaxes(Ol, 1, 2)])
    H = sp.csc_matrix((np.bincount(where, weights=blocks.ravel(),
                                   minlength=nnz), indices, indptr),
                      shape=(6 * n, 6 * n))
    dxh = solve_spd(H, -gh.ravel()).reshape(n, 6)
    dsh = (-ghs - np.sum(v1 * dxh[p.loop_b], -1)
           - np.sum(v2 * dxh[p.loop_a], -1)) / hh
    dx = dxh * sn
    ds = dsh * ss

    # model decrease: -(g.dx + 0.5 |J dx|^2), undamped and unscaled
    Jd_o = (np.einsum("kri,ki->kr", lin.Jo1, dx[p.odo_i])
            + np.einsum("kri,ki->kr", lin.Jo2, dx[p.odo_j]))
    Jd_l = (np.einsum("kri,ki->kr", lin.Jl1, dx[p.loop_b])
            + np.einsum("kri,ki->kr", lin.Jl2, dx[p.loop_a])
            + lin.Jls * ds[:, None])
    Jd_p = lin.Jp @ dx[0]
    gdx = np.sum(g * dx) + np.sum(gs * ds)
    quad = np.sum(Jd_o ** 2) + np.sum(Jd_l ** 2) + np.sum(Jd_p ** 2)
    return dx, ds, -(gdx + 0.5 * quad)


def solve_spd(H, b):
    """x with H x = b for the symmetric positive definite node system."""
    lu = spla.splu(H, permc_spec="MMD_AT_PLUS_A",
                   options=dict(SymmetricMode=True))
    return lu.solve(b)


def _exp_plus(q, dtheta):
    """Exp(dtheta) q, normalized (Ceres' quaternion plus)."""
    th = np.linalg.norm(dtheta, axis=-1, keepdims=True)
    k = np.where(th > 1e-12, np.sin(th) / np.where(th > 0, th, 1.0), 1.0)
    e = np.concatenate([k * dtheta, np.cos(th)], axis=-1)
    return nse3.quat_normalize(nse3.quat_mul(e, q))


@dataclasses.dataclass
class Solution:
    q: np.ndarray
    t: np.ndarray
    s: np.ndarray
    cost: float
    iterations: int
    accepted: int


def solve(p: Problem, q0, t0, s0, *, max_iterations: int,
          function_tolerance: float, parameter_tolerance: float,
          initial_radius: float, precision: str = "fp64") -> Solution:
    """Levenberg-Marquardt from (q0, t0, s0) with Ceres' rules: a step is
    accepted when the model decreases and the cost falls by more than
    1e-3 of the model's decrease; the solve ends after max_iterations, or
    after an accepted step that changed the cost by at most
    function_tolerance of it or moved the parameters by at most
    parameter_tolerance of their norm. The costs it reports are always
    evaluated in float64."""
    R = ROUNDING[precision]
    q, t, s = R(nse3.quat_normalize(q0)), R(t0), R(s0)
    c = cost(p, q, t, s)
    radius, decrease = initial_radius, 2.0
    accepted = 0
    it = 0
    for it in range(1, max_iterations + 1):
        lin = linearize(p, q, t, s, R)
        dx, ds, model = _step(p, lin, radius)
        dx, ds = R(dx), R(ds)
        q_new = R(_exp_plus(q, dx[:, :3]))
        t_new = R(t + dx[:, 3:])
        s_new = R(s + ds)
        c_new = cost(p, q_new, t_new, s_new)
        rho = (c - c_new) / model if model > 0 else -1.0
        if model > 0 and rho > 1e-3:
            x_norm = math.sqrt(np.sum(t * t) + np.sum(q * q) + np.sum(s * s))
            step = math.sqrt(np.sum(dx * dx) + np.sum(ds * ds))
            done = (abs(c - c_new) <= function_tolerance * c
                    or step <= parameter_tolerance * (x_norm
                                                      + parameter_tolerance))
            q, t, s, c = q_new, t_new, s_new, c_new
            radius = min(radius / max(1.0 / 3.0,
                                      1.0 - (2.0 * rho - 1.0) ** 3), 1e16)
            decrease = 2.0
            accepted += 1
            if done:
                break
        else:
            radius /= decrease
            decrease *= 2.0
            if radius < 1e-32:
                break
    return Solution(q=q, t=t, s=s, cost=c, iterations=it, accepted=accepted)


# ---------------------------------------------------------------------------
# what harness/check.py asks of a configuration's reference
# ---------------------------------------------------------------------------


def trigger_start(cfg: dict, g, answer: dict):
    if g.events:
        raise ValueError("posegraph.py judges one world: the graph has "
                         "events")
    return start(g.vio_q, g.vio_t, answer["node_len"], answer["edge_len"],
                 answer["prev"], cfg["formulation"]["switch_init"])


def trigger_problem(cfg: dict, g, n: int, e: int, state,
                    precision: str = "fp64") -> Problem:
    """The first n keyframes and e loop edges in stream order, the prior on
    node 0 at the start's pose."""
    fml = cfg["formulation"]
    order = generators.stream_order(g)[:e]
    return build_problem(
        g.vio_q[:n], g.vio_t[:n], g.loop_pairs[order, 0],
        g.loop_pairs[order, 1], g.loop_q[order], g.loop_t[order],
        fanout=fml["fanout"], decay=fml["decay"],
        yaw_sigma2=fml["yaw_sigma2"], prior=(state[0][0], state[1][0]),
        rounding=ROUNDING[precision])


def trigger_solve(cfg: dict, p: Problem, state,
                  precision: str = "fp64") -> Solution:
    lm = cfg["formulation"]["lm"]
    return solve(p, *state, max_iterations=lm["max_iterations"],
                 function_tolerance=lm["function_tolerance"],
                 parameter_tolerance=lm["parameter_tolerance"],
                 initial_radius=lm["initial_radius"], precision=precision)
