"""Synthetic pose-graph generators for tests and benchmarks (counterpart of
solve_keyframe_pose_graph_tpu/graph/synthetic.py).

Produces the same statistical shape as the reference's live input (VIO
keyframe poses with odometric drift + loop-closure observations with
outliers that exercise switchable constraints — BASELINE.md configs 1/2/5).
All host-side float64 numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from solve_keyframe_pose_graph_tpu_torch.utils import nse3


@dataclasses.dataclass
class SyntheticGraph:
    # ground truth
    gt_q: np.ndarray          # (N,4)
    gt_t: np.ndarray          # (N,3)
    # drifted VIO (the odometry input; also the default initial guess)
    vio_q: np.ndarray         # (N,4)
    vio_t: np.ndarray         # (N,3)
    # loop closures: pair (a, b) observed as b_T_a  (LoopEdge convention:
    # "pose of a as seen from b", msg/LoopEdge.msg pose_1T0)
    loop_pairs: np.ndarray    # (E,2) int32
    loop_q: np.ndarray        # (E,4)
    loop_t: np.ndarray        # (E,3)
    loop_w: np.ndarray        # (E,)
    loop_is_outlier: np.ndarray  # (E,) bool

    @property
    def n_nodes(self):
        return len(self.gt_t)

    @property
    def n_loops(self):
        return len(self.loop_pairs)


def _integrate(rel_q, rel_t, q0, t0):
    n = len(rel_q) + 1
    q = np.zeros((n, 4)); t = np.zeros((n, 3))
    q[0], t[0] = q0, t0
    for i in range(1, n):
        q[i], t[i] = nse3.pose_mul(q[i - 1], t[i - 1], rel_q[i - 1], rel_t[i - 1])
        q[i] /= np.linalg.norm(q[i])
    return q, t


def circle_graph(
    n_nodes: int = 500,
    n_loops: int = 50,
    *,
    radius: float = 20.0,
    odo_rot_noise: float = 0.002,
    odo_trans_noise: float = 0.01,
    loop_rot_noise: float = 0.001,
    loop_trans_noise: float = 0.005,
    outlier_fraction: float = 0.2,
    seed: int = 0,
) -> SyntheticGraph:
    """Planar circle trajectory with tangent heading, drifty odometry, and
    loop closures between revisited sectors (plus gross outliers)."""
    rng = np.random.default_rng(seed)

    # ground truth: nodes on a circle (two revolutions so loops exist)
    theta = np.linspace(0, 4 * np.pi, n_nodes, endpoint=False)
    gt_t = np.stack(
        [radius * np.cos(theta), radius * np.sin(theta), np.zeros_like(theta)],
        axis=-1,
    )
    yaw_deg = np.degrees(theta + np.pi / 2)
    # heading quats from yaw about z: q = [0,0,sin(y/2),cos(y/2)]
    half = np.radians(yaw_deg) / 2
    gt_q = np.stack(
        [np.zeros_like(half), np.zeros_like(half), np.sin(half), np.cos(half)],
        axis=-1,
    )

    # noisy odometry -> drifted VIO trajectory
    rel_q, rel_t = nse3.pose_relative(gt_q[:-1], gt_t[:-1], gt_q[1:], gt_t[1:])
    ang = rng.normal(scale=odo_rot_noise, size=(n_nodes - 1, 3))
    half_a = np.linalg.norm(ang, axis=-1, keepdims=True) / 2
    axis = np.where(half_a > 0, ang / np.maximum(2 * half_a, 1e-300), 0.0)
    nq = np.concatenate([axis * np.sin(half_a), np.cos(half_a)], axis=-1)
    rel_q_noisy = nse3.quat_mul(rel_q, nq)
    rel_t_noisy = rel_t + rng.normal(scale=odo_trans_noise, size=rel_t.shape)
    vio_q, vio_t = _integrate(rel_q_noisy, rel_t_noisy, gt_q[0], gt_t[0])

    # loop closures between the two revolutions: node i <-> i + n/2
    half_n = n_nodes // 2
    cand_a = rng.integers(half_n, n_nodes, size=n_loops)        # current
    cand_b = cand_a - half_n                                    # previous lap
    is_outlier = rng.uniform(size=n_loops) < outlier_fraction
    lq = np.zeros((n_loops, 4)); lt = np.zeros((n_loops, 3))
    for e in range(n_loops):
        a, b = int(cand_a[e]), int(cand_b[e])
        if is_outlier[e]:
            # gross wrong association
            rq = rng.normal(size=4); rq /= np.linalg.norm(rq)
            rt = rng.uniform(-10, 10, size=3)
            lq[e], lt[e] = rq, rt
        else:
            bq, bt = nse3.pose_relative(gt_q[b], gt_t[b], gt_q[a], gt_t[a])
            na = rng.normal(scale=loop_rot_noise, size=3)
            h = np.linalg.norm(na) / 2
            ax = na / max(2 * h, 1e-300)
            nq1 = np.concatenate([ax * np.sin(h), [np.cos(h)]])
            lq[e] = nse3.quat_mul(bq, nq1)
            lt[e] = bt + rng.normal(scale=loop_trans_noise, size=3)
    loop_w = rng.uniform(0.5, 1.0, size=n_loops)

    return SyntheticGraph(
        gt_q=gt_q, gt_t=gt_t, vio_q=vio_q, vio_t=vio_t,
        loop_pairs=np.stack([cand_a, cand_b], axis=-1).astype(np.int32),
        loop_q=lq, loop_t=lt, loop_w=loop_w, loop_is_outlier=is_outlier,
    )


def ate_rmse(q_est, t_est, q_gt, t_gt, align_first: bool = True):
    """Absolute trajectory error (RMSE over translations), optionally after
    aligning the first pose."""
    if align_first:
        # T_align = gt0 * est0^-1
        qi, ti = nse3.pose_inv(q_est[0], t_est[0])
        qal, tal = nse3.pose_mul(q_gt[0], t_gt[0], qi, ti)
        t_adj = tal + nse3.quat_rotate(np.tile(qal, (len(t_est), 1)), t_est)
    else:
        t_adj = t_est
    d = t_adj - t_gt
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))
