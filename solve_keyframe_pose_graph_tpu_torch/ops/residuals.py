"""Residuals and closed-form normal-equation block products for the 6-DOF
family (counterpart of solve_keyframe_pose_graph_tpu/ops/residuals.py:42-80
and :376-575).

The algebra, the reference quirks (the switch residual multiplies every row
by s and ignores the edge weight) and the entry-major layout are the
reference's: blocks come back as (36,)+batch stacks of row-major 6x6 entries,
gradients as (6,)+batch, so the node axis stays innermost. The 4-DOF family
is not ported yet.
"""

from __future__ import annotations

import torch

from solve_keyframe_pose_graph_tpu_torch.ops import se3

# ---------------------------------------------------------------------------
# residual functions (behind gn.evaluate_cost)
# ---------------------------------------------------------------------------


def _six_dof_core(q1, t1, q2, t2, obs_q, obs_t):
    """Common 6-row pose error [delta_t; 2*vec(delta_q)] with
    delta_q = (q1^-1 q2)^-1 obs_q, delta_t = (q1^-1 q2)^-1 (obs_t - p12)."""
    q12, p12 = se3.pose_relative(q1, t1, q2, t2)
    q12c = se3.quat_conj(q12)
    delta_q = se3.quat_mul(q12c, obs_q)
    delta_t = se3.quat_rotate(q12c, obs_t - p12)
    return torch.cat([delta_t, 2.0 * delta_q[..., :3]], dim=-1)


def six_dof_residual(q1, t1, q2, t2, obs_q, obs_t, weight):
    """SixDOFError: 6 rows scaled by weight."""
    return _six_dof_core(q1, t1, q2, t2, obs_q, obs_t) * weight[..., None]


def six_dof_switch_residual(q1, t1, q2, t2, s, obs_q, obs_t, weight):
    """SixDOFErrorWithSwitchingConstraints: rows 0..5 the six-dof error,
    row 6 = (1 - s); ALL rows multiplied by s, the weight ignored."""
    del weight
    core = _six_dof_core(q1, t1, q2, t2, obs_q, obs_t)
    r = torch.cat([core, (1.0 - s)[..., None]], dim=-1)
    return r * s[..., None]


def node_prior_residual(q, t, prior_q, prior_t, weight):
    """NodePoseRegularization: delta = prior^-1 * node,
    rows = weight * [delta_t; 2*vec(delta_q)]."""
    dq, dt = se3.pose_relative(prior_q, prior_t, q, t)
    r = torch.cat([dt, 2.0 * dq[..., :3]], dim=-1)
    return r * weight[..., None]


# ---------------------------------------------------------------------------
# entry-major block products, in scalar components
# ---------------------------------------------------------------------------


def _qmul_c(p, q):
    px, py, pz, pw = p
    qx, qy, qz, qw = q
    return (pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
            pw * qw - px * qx - py * qy - pz * qz)


def _qrot_c(q, v):
    qx, qy, qz, qw = q
    vx, vy, vz = v
    ux = qy * vz - qz * vy
    uy = qz * vx - qx * vz
    uz = qx * vy - qy * vx
    wx = qy * uz - qz * uy
    wy = qz * ux - qx * uz
    wz = qx * uy - qy * ux
    return (vx + 2 * (qw * ux + wx),
            vy + 2 * (qw * uy + wy),
            vz + 2 * (qw * uz + wz))


def _M_from(a, b):
    """9 row-major entries of M = 2 (P Q - bv av^T) with P = bw I - [bv]x,
    Q = aw I + [av]x: the rotation-row block shared by all three families."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    P = ((bw, bz, -by), (-bz, bw, bx), (by, -bx, bw))
    Q = ((aw, -az, ay), (az, aw, -ax), (-ay, ax, aw))
    bv = (bx, by, bz)
    av = (ax, ay, az)
    M = []
    for i in range(3):
        for j in range(3):
            s = P[i][0] * Q[0][j] + P[i][1] * Q[1][j] + P[i][2] * Q[2][j]
            M.append(2.0 * (s - bv[i] * av[j]))
    return M


def _MtM(M):
    out = [None] * 9
    for i in range(3):
        for j in range(i, 3):
            s = M[0 + i] * M[0 + j] + M[3 + i] * M[3 + j] + M[6 + i] * M[6 + j]
            out[3 * i + j] = s
            out[3 * j + i] = s
    return out


def _blk(tl, tr, bl, br):
    """4 row-major 9-entry 3x3 blocks -> 36-entry row-major 6x6 list."""
    out = []
    for i in range(3):
        out += [tl[3 * i], tl[3 * i + 1], tl[3 * i + 2],
                tr[3 * i], tr[3 * i + 1], tr[3 * i + 2]]
    for i in range(3):
        out += [bl[3 * i], bl[3 * i + 1], bl[3 * i + 2],
                br[3 * i], br[3 * i + 1], br[3 * i + 2]]
    return out


def _six_dof_products_core_t(q1, t1, q2, t2, obs_q, obs_t):
    """Entry-major core products. Returns (rsq, core6, A11, A22, B12, g1, g2)
    with rsq batch-shaped (sum of squared core rows), core6 a 6-tuple of
    components, blocks 36-lists, grads 6-lists, all batch-shaped."""
    x2, y2, z2, w2 = q2.unbind(-1)
    a = (-x2, -y2, -z2, w2)                         # conj(q2)
    q1c = q1.unbind(-1)
    b = _qmul_c(q1c, obs_q.unbind(-1))              # q1 (x) obs_q
    M = _M_from(a, b)
    v = _qrot_c(q1c, obs_t.unbind(-1))
    t1c = t1.unbind(-1)
    t2c = t2.unbind(-1)
    u = tuple(v[i] + t1c[i] - t2c[i] for i in range(3))
    dt_ = _qrot_c(a, u)                             # R2^T u
    dq = _qmul_c(a, b)                              # conj(q2) (x) q1 (x) obs_q
    core_e = tuple(2.0 * dq[i] for i in range(3))
    core = dt_ + core_e
    rsq = sum(c * c for c in core)

    MtM = _MtM(M)
    v2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    u2 = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
    uv = u[0] * v[0] + u[1] * v[1] + u[2] * v[2]
    one = torch.ones_like(v2)
    zero = torch.zeros_like(v2)

    def sk(w3):   # 2[w]x entries, row-major
        return (zero, -2.0 * w3[2], 2.0 * w3[1],
                2.0 * w3[2], zero, -2.0 * w3[0],
                -2.0 * w3[1], 2.0 * w3[0], zero)

    sv = sk(v)
    su = sk(u)
    eye9 = (one, zero, zero, zero, one, zero, zero, zero, one)
    neye9 = tuple(-e for e in eye9)

    tl11 = [4.0 * (v2 * eye9[k] - v[k // 3] * v[k % 3]) + MtM[k]
            for k in range(9)]
    A11 = _blk(tl11, sv, tuple(-e for e in sv), eye9)
    tl22 = [4.0 * (u2 * eye9[k] - u[k // 3] * u[k % 3]) + MtM[k]
            for k in range(9)]
    A22 = _blk(tl22, su, tuple(-e for e in su), eye9)
    tl12 = [4.0 * (u[k // 3] * v[k % 3] - uv * eye9[k]) - MtM[k]
            for k in range(9)]
    B12 = _blk(tl12, tuple(-e for e in sv), su, neye9)

    vxu = (v[1] * u[2] - v[2] * u[1],
           v[2] * u[0] - v[0] * u[2],
           v[0] * u[1] - v[1] * u[0])
    Mte = tuple(M[0 + i] * core_e[0] + M[3 + i] * core_e[1]
                + M[6 + i] * core_e[2] for i in range(3))
    g1 = [2.0 * vxu[i] + Mte[i] for i in range(3)] + [u[0], u[1], u[2]]
    g2 = [-Mte[i] for i in range(3)] + [-u[0], -u[1], -u[2]]
    return rsq, core, A11, A22, B12, g1, g2


def _scaled_stack(xs, f):
    return torch.stack([x * f for x in xs])


def six_dof_block_products_t(q1, t1, q2, t2, obs_q, obs_t, weight):
    """Entry-major weighted products: (rsq, A11, A22, B12, g1, g2) with
    rsq = w^2 |core|^2 (batch,), blocks (36,)+batch, grads (6,)+batch."""
    rsq, _, A11, A22, B12, g1, g2 = _six_dof_products_core_t(
        q1, t1, q2, t2, obs_q, obs_t)
    w2 = weight * weight
    return (rsq * w2, _scaled_stack(A11, w2), _scaled_stack(A22, w2),
            _scaled_stack(B12, w2), _scaled_stack(g1, w2),
            _scaled_stack(g2, w2))


def six_dof_switch_block_products_t(q1, t1, q2, t2, s, obs_q, obs_t, weight):
    """Entry-major switch products: (rsq, A11, A22, B12, c1, c2, ds, g1, g2,
    gs); rsq includes the 7th row (weight ignored, as in the reference)."""
    del weight
    csq, core, A11, A22, B12, g1c, g2c = _six_dof_products_core_t(
        q1, t1, q2, t2, obs_q, obs_t)
    s2 = s * s
    one2s = 1.0 - 2.0 * s
    r7 = s * (1.0 - s)
    rsq = s2 * csq + r7 * r7
    ds = csq + one2s * one2s
    gs = s * csq + r7 * one2s
    return (rsq, _scaled_stack(A11, s2), _scaled_stack(A22, s2),
            _scaled_stack(B12, s2), _scaled_stack(g1c, s),
            _scaled_stack(g2c, s), ds, _scaled_stack(g1c, s2),
            _scaled_stack(g2c, s2), gs)


def node_prior_block_products_t(q, t, prior_q, prior_t, weight):
    """Entry-major prior products: (rsq, A (36,)+batch, g (6,)+batch)."""
    xp, yp, zp, wp = prior_q.unbind(-1)
    a = (-xp, -yp, -zp, wp)
    qt = q.unbind(-1)
    tc = t.unbind(-1)
    tpc = prior_t.unbind(-1)
    diff = tuple(tc[i] - tpc[i] for i in range(3))
    dt_ = _qrot_c(a, diff)
    dq = _qmul_c(a, qt)
    r_e = tuple(2.0 * dq[i] for i in range(3))
    rsq = sum(c * c for c in dt_ + r_e)

    M = _M_from(a, qt)                    # a = conj(prior_q), b = q
    MtM = _MtM(M)
    one = torch.ones_like(rsq)
    zero = torch.zeros_like(rsq)
    eye9 = (one, zero, zero, zero, one, zero, zero, zero, one)
    A = []
    for i in range(3):
        A += [MtM[3 * i], MtM[3 * i + 1], MtM[3 * i + 2], zero, zero, zero]
    for i in range(3):
        A += [zero, zero, zero, eye9[3 * i], eye9[3 * i + 1], eye9[3 * i + 2]]
    Mte = tuple(M[0 + i] * r_e[0] + M[3 + i] * r_e[1] + M[6 + i] * r_e[2]
                for i in range(3))
    g = list(Mte) + list(diff)
    w2 = weight * weight
    return rsq * w2, _scaled_stack(A, w2), _scaled_stack(g, w2)
