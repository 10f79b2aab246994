"""SE(3) helpers on numpy arrays, float64: xyzw quaternions, Hamilton
product. A frozen copy of the functions that the benchmark's generator and
its plain reference need, so that neither imports the measured program."""

from __future__ import annotations

import numpy as np


def quat_mul(p, q):
    p = np.asarray(p)
    q = np.asarray(q)
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
    q = np.asarray(q)
    return np.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)


def quat_normalize(q):
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def cross(a, b):
    """np.cross of 3-vectors, term for term (the same roundings), without
    its per-call overhead."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return np.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                     a0 * b1 - a1 * b0], axis=-1)


def quat_rotate(q, v):
    q = np.asarray(q)
    v = np.asarray(v)
    u, w = q[..., :3], q[..., 3:4]
    uv = cross(u, v)
    uuv = cross(u, uv)
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


def pose_mul(qa, ta, qb, tb):
    return quat_mul(qa, qb), np.asarray(ta) + quat_rotate(qa, tb)


def pose_inv(q, t):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def pose_relative(q1, t1, q2, t2):
    q1i = quat_conj(q1)
    return quat_mul(q1i, q2), quat_rotate(q1i, np.asarray(t2) - np.asarray(t1))


def relative_yaw_deg(q12):
    """Yaw, in degrees, of the rotation q12 (the first of its yaw, pitch,
    roll angles)."""
    R = quat_to_rot(q12)
    return np.degrees(np.arctan2(R[..., 1, 0], R[..., 0, 0]))
