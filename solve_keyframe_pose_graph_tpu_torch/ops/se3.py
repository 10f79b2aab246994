"""Batched SE(3) / quaternion primitives in PyTorch: the subset of
solve_keyframe_pose_graph_tpu/ops/se3.py that the residuals and the LM step
use, with the rotation matrix and the yaw-pitch-roll angles of the 4-DOF
residual family.

Same conventions as the reference: quaternions stored xyzw, Hamilton
product, active rotations R(q) v = q v q^-1, a pose (q, t) is w_T_c.
Shape-polymorphic over leading batch dimensions and dtype-polymorphic.
"""

from __future__ import annotations

import torch


def quat_mul(p, q):
    """Hamilton product p * q, xyzw layout."""
    px, py, pz, pw = p.unbind(-1)
    qx, qy, qz, qw = q.unbind(-1)
    return torch.stack(
        [
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
            pw * qw - px * qx - py * qy - pz * qz,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_normalize(q):
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=torch.finfo(q.dtype).tiny)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q: R(q) v (2-cross-product form)."""
    u, v = torch.broadcast_tensors(q[..., :3], v)
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (q[..., 3:4] * uv + uuv)


def quat_to_rot(q):
    """(..., 4) xyzw -> (..., 3, 3) rotation matrix. Assumes unit norm."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def rot_to_ypr_deg(R):
    """R -> [yaw, pitch, roll] in degrees, by atan2 (the formula of the
    reference's R2ypr, PoseManipUtils.cpp:143-158)."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2],
                    n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(
        a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
        -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y),
    )
    return torch.stack([y, p, r], dim=-1) / torch.pi * 180.0


def quat_box_plus(q, delta):
    """Ceres EigenQuaternionParameterization::Plus in xyzw layout:
    q_new = Exp(delta) * q with Exp(d) = [sin|d|/|d| * d, cos|d|].
    The square root's argument is guarded, not only its result: at delta = 0
    the untaken branch's tangent would otherwise be inf, and NaN under
    torch.func.jacfwd (the 4-DOF Jacobians differentiate through here)."""
    theta2 = torch.sum(delta * delta, dim=-1, keepdim=True)
    small = theta2 < 1e-12
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    k = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    w = torch.where(small, 1.0 - theta2 / 2.0, torch.cos(theta))
    return quat_mul(torch.cat([k * delta, w], dim=-1), q)


def pose_relative(q1, t1, q2, t2):
    """Relative transform 1_T_2 = (w_T_1)^-1 * (w_T_2):
    q12 = q1^-1 q2, p12 = q1^-1 (p2 - p1)."""
    q1i = quat_conj(q1)
    return quat_mul(q1i, q2), quat_rotate(q1i, t2 - t1)
