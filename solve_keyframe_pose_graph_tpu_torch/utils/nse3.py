"""Counterpart of solve_keyframe_pose_graph_tpu/utils/nse3.py, the same code.

Numpy (host, float64) SE(3) helpers — same conventions as ops/se3.py
(xyzw quaternions, Hamilton product, ypr in degrees).

Used by host-side problem assembly, world bookkeeping, and persistence so
that bookkeeping math stays float64 whatever the device's working type. Mirrors
the conversions in the reference's PoseManipUtils
(/root/reference/src/utils/PoseManipUtils.cpp)."""

from __future__ import annotations

import numpy as np


def quat_identity(n=None):
    if n is None:
        return np.array([0.0, 0.0, 0.0, 1.0])
    q = np.zeros((n, 4))
    q[:, 3] = 1.0
    return q


def quat_mul(p, q):
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    px, py, pz, pw = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack(
        [
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
            pw * qw - px * qx - py * qy - pz * qz,
        ],
        axis=-1,
    )


def quat_conj(q):
    q = np.asarray(q, np.float64)
    return np.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)


def quat_normalize(q):
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_rotate(q, v):
    q = np.asarray(q, np.float64)
    v = np.asarray(v, np.float64)
    u, w = q[..., :3], q[..., 3:4]
    uv = np.cross(u, v)
    uuv = np.cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_to_rot(q):
    q = np.asarray(q, np.float64)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = np.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def rot_to_quat(R):
    """Branch-per-element Shepperd (vectorized over leading dims)."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw_w = 1.0 + m00 + m11 + m22
    qx_x = 1.0 + m00 - m11 - m22
    qy_y = 1.0 - m00 + m11 - m22
    qz_z = 1.0 - m00 - m11 + m22
    cw = np.stack([m21 - m12, m02 - m20, m10 - m01, qw_w], axis=-1)
    cx = np.stack([qx_x, m01 + m10, m02 + m20, m21 - m12], axis=-1)
    cy = np.stack([m01 + m10, qy_y, m12 + m21, m02 - m20], axis=-1)
    cz = np.stack([m02 + m20, m12 + m21, qz_z, m10 - m01], axis=-1)
    pivots = np.stack([qw_w, qx_x, qy_y, qz_z], axis=-1)
    cands = np.stack([cw, cx, cy, cz], axis=-2)
    idx = np.argmax(pivots, axis=-1)
    best = np.take_along_axis(cands, idx[..., None, None], axis=-2)[..., 0, :]
    best = best / np.linalg.norm(best, axis=-1, keepdims=True)
    return np.where(best[..., 3:4] < 0, -best, best)


def pose_mul(qa, ta, qb, tb):
    return quat_mul(qa, qb), np.asarray(ta, np.float64) + quat_rotate(qa, tb)


def pose_inv(q, t):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def pose_relative(q1, t1, q2, t2):
    q1i = quat_conj(q1)
    return quat_mul(q1i, q2), quat_rotate(q1i, np.asarray(t2, np.float64) - np.asarray(t1, np.float64))


def pose_to_matrix(q, t):
    R = quat_to_rot(q)
    batch = R.shape[:-2]
    T = np.zeros(batch + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def matrix_to_pose(T):
    T = np.asarray(T, np.float64)
    return rot_to_quat(T[..., :3, :3]), T[..., :3, 3].copy()


def rot_to_ypr_deg(R):
    R = np.asarray(R, np.float64)
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = np.arctan2(n[..., 1], n[..., 0])
    p = np.arctan2(-n[..., 2], n[..., 0] * np.cos(y) + n[..., 1] * np.sin(y))
    r = np.arctan2(
        a[..., 0] * np.sin(y) - a[..., 1] * np.cos(y),
        -o[..., 0] * np.sin(y) + o[..., 1] * np.cos(y),
    )
    return np.stack([y, p, r], axis=-1) / np.pi * 180.0


def relative_yaw_deg(q12):
    return rot_to_ypr_deg(quat_to_rot(q12))[..., 0]
