"""circle_graph: a frozen copy of the program's synthetic circle graph.

The same draws from the same seed, so the same graph. A planar circle of
two laps with tangent heading, odometry with drift integrated into the VIO
trajectory, and loop edges between node a of the second lap and node
a - n/2 of the first, a share of them gross outliers. The benchmark keeps
its own copy so that a change to the program cannot move the yardstick.
One world: no events, every loop edge counted.
"""

from __future__ import annotations

import numpy as np

from port_bench.harness import nse3
from port_bench.harness.generators import Graph


def _integrate(rel_q, rel_t, q0, t0):
    n = len(rel_q) + 1
    q = np.zeros((n, 4))
    t = np.zeros((n, 3))
    q[0], t[0] = q0, t0
    for i in range(1, n):
        q[i], t[i] = nse3.pose_mul(q[i - 1], t[i - 1], rel_q[i - 1],
                                   rel_t[i - 1])
        q[i] /= np.linalg.norm(q[i])
    return q, t


def generate(seed: int, n_nodes: int, n_loops: int, *,
             radius: float = 20.0, odo_rot_noise: float = 0.002,
             odo_trans_noise: float = 0.01, loop_rot_noise: float = 0.001,
             loop_trans_noise: float = 0.005,
             outlier_fraction: float = 0.2) -> Graph:
    rng = np.random.default_rng(seed)

    theta = np.linspace(0, 4 * np.pi, n_nodes, endpoint=False)
    gt_t = np.stack([radius * np.cos(theta), radius * np.sin(theta),
                     np.zeros_like(theta)], axis=-1)
    half = np.radians(np.degrees(theta + np.pi / 2)) / 2
    gt_q = np.stack([np.zeros_like(half), np.zeros_like(half), np.sin(half),
                     np.cos(half)], axis=-1)

    rel_q, rel_t = nse3.pose_relative(gt_q[:-1], gt_t[:-1], gt_q[1:],
                                      gt_t[1:])
    ang = rng.normal(scale=odo_rot_noise, size=(n_nodes - 1, 3))
    half_a = np.linalg.norm(ang, axis=-1, keepdims=True) / 2
    axis = np.where(half_a > 0, ang / np.maximum(2 * half_a, 1e-300), 0.0)
    nq = np.concatenate([axis * np.sin(half_a), np.cos(half_a)], axis=-1)
    rel_q_noisy = nse3.quat_mul(rel_q, nq)
    rel_t_noisy = rel_t + rng.normal(scale=odo_trans_noise, size=rel_t.shape)
    vio_q, vio_t = _integrate(rel_q_noisy, rel_t_noisy, gt_q[0], gt_t[0])

    half_n = n_nodes // 2
    cand_a = rng.integers(half_n, n_nodes, size=n_loops)
    cand_b = cand_a - half_n
    is_outlier = rng.uniform(size=n_loops) < outlier_fraction
    lq = np.zeros((n_loops, 4))
    lt = np.zeros((n_loops, 3))
    # the draws in the program's order, edge by edge; the arithmetic on
    # them, the same term for term, over all edges at once
    bq, bt = nse3.pose_relative(gt_q[cand_b], gt_t[cand_b], gt_q[cand_a],
                                gt_t[cand_a])
    nq1 = np.zeros((n_loops, 4))
    for e in range(n_loops):
        if is_outlier[e]:
            rq = rng.normal(size=4)
            rq /= np.linalg.norm(rq)
            lq[e], lt[e] = rq, rng.uniform(-10, 10, size=3)
        else:
            na = rng.normal(scale=loop_rot_noise, size=3)
            h = np.linalg.norm(na) / 2
            ax = na / max(2 * h, 1e-300)
            nq1[e] = np.concatenate([ax * np.sin(h), [np.cos(h)]])
            lt[e] = rng.normal(scale=loop_trans_noise, size=3)
    inl = ~is_outlier
    lq[inl] = nse3.quat_mul(bq[inl], nq1[inl])
    lt[inl] += bt[inl]
    loop_w = rng.uniform(0.5, 1.0, size=n_loops)

    return Graph(gt_q=gt_q, gt_t=gt_t, vio_q=vio_q, vio_t=vio_t,
                 loop_pairs=np.stack([cand_a, cand_b], -1).astype(np.int32),
                 loop_q=lq, loop_t=lt, loop_w=loop_w,
                 loop_is_outlier=is_outlier)
