"""Synthetic standard-benchmark pose graphs (sphere2500 / manhattan3500 /
torus analogs), emitted in g2o format (counterpart of
solve_keyframe_pose_graph_tpu/graph/datasets.py, the same arrays from the
same seeds).

The classic datasets are not redistributable artifacts of this repo, so we
generate graphs with the same structure and statistics deterministically:
a ground-truth trajectory on the named manifold, odometry edges corrupted
by noise (the initial estimate integrates them, accumulating drift), and
loop-closure edges between spatially-revisited node pairs. Host numpy and
scipy only.
"""

from __future__ import annotations

import numpy as np

from solve_keyframe_pose_graph_tpu_torch.graph.g2o import G2OGraph
from solve_keyframe_pose_graph_tpu_torch.utils import nse3


def _quat_from_axes(fwd, up):
    """Rotation matrix with x=fwd, z=up -> quaternion."""
    fwd = fwd / np.linalg.norm(fwd)
    rightv = np.cross(fwd, up)
    n = np.linalg.norm(rightv)
    if n < 1e-9:
        rightv = np.array([0.0, 1.0, 0.0]); n = 1.0
    rightv = rightv / n
    upv = np.cross(rightv, fwd)
    R = np.stack([fwd, -rightv, upv], axis=-1)
    return nse3.matrix_to_pose(
        np.block([[R, np.zeros((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]])
    )[0]


def _noise_quat(rng, sigma):
    v = rng.normal(scale=sigma, size=3)
    h = np.linalg.norm(v) / 2
    ax = v / max(2 * h, 1e-300)
    return np.concatenate([ax * np.sin(h), [np.cos(h)]])


def _graph_from_gt(gt_q, gt_t, loop_pairs, rng, odo_rot=0.005, odo_t=0.02,
                   loop_rot=0.005, loop_t=0.02, info_odo=100.0,
                   info_loop=100.0) -> G2OGraph:
    n = len(gt_t)
    edges, eq, et, einfo = [], [], [], []
    info6 = np.eye(6)

    for i in range(n - 1):
        mq, mt = nse3.pose_relative(gt_q[i], gt_t[i], gt_q[i + 1], gt_t[i + 1])
        mq = nse3.quat_mul(mq, _noise_quat(rng, odo_rot))
        mt = mt + rng.normal(scale=odo_t, size=3)
        edges.append((i, i + 1)); eq.append(mq); et.append(mt)
        einfo.append(info6 * info_odo)

    for a, b in loop_pairs:
        mq, mt = nse3.pose_relative(gt_q[a], gt_t[a], gt_q[b], gt_t[b])
        mq = nse3.quat_mul(mq, _noise_quat(rng, loop_rot))
        mt = mt + rng.normal(scale=loop_t, size=3)
        edges.append((int(a), int(b))); eq.append(mq); et.append(mt)
        einfo.append(info6 * info_loop)

    # integrate noisy odometry -> initial vertex estimates (standard g2o
    # dataset convention)
    q = np.zeros((n, 4)); q[:, 3] = 1.0
    t = np.zeros((n, 3))
    q[0], t[0] = gt_q[0], gt_t[0]
    for i in range(n - 1):
        q[i + 1], t[i + 1] = nse3.pose_mul(q[i], t[i], eq[i], et[i])
        q[i + 1] /= np.linalg.norm(q[i + 1])

    return G2OGraph(
        q=q, t=t,
        edges=np.asarray(edges, np.int32),
        edge_q=np.asarray(eq, np.float64),
        edge_t=np.asarray(et, np.float64),
        edge_info=np.asarray(einfo, np.float64),
        is_2d=False,
    )


def _nearby_loops(gt_t, rng, n_loops, min_sep=30, radius=2.5):
    """Sample loop pairs among spatially-near, temporally-far node pairs."""
    from scipy.spatial import cKDTree

    tree = cKDTree(gt_t)
    pairs = tree.query_pairs(r=radius, output_type="ndarray")
    far = pairs[np.abs(pairs[:, 0] - pairs[:, 1]) >= min_sep]
    if len(far) == 0:
        return np.zeros((0, 2), np.int64)
    sel = rng.choice(len(far), size=min(n_loops, len(far)), replace=False)
    return far[sel]


def sphere(n_nodes: int = 2500, n_loops: int = 2450, seed: int = 7,
           radius: float = 25.0) -> G2OGraph:
    """sphere2500 analog: spiral trajectory over a sphere surface."""
    rng = np.random.default_rng(seed)
    k = np.arange(n_nodes)
    # spherical spiral: polar angle sweeps 0->pi; ~50 nodes per revolution
    # regardless of size, so revisit gaps stay > min_sep
    revs = max(4, n_nodes // 50)
    theta = np.pi * (k + 0.5) / n_nodes
    phi = 2 * np.pi * revs * k / n_nodes
    gt_t = radius * np.stack([
        np.sin(theta) * np.cos(phi),
        np.sin(theta) * np.sin(phi),
        np.cos(theta),
    ], axis=-1)
    gt_q = np.zeros((n_nodes, 4))
    for i in range(n_nodes):
        fwd = (gt_t[min(i + 1, n_nodes - 1)] - gt_t[max(i - 1, 0)])
        up = gt_t[i] / np.linalg.norm(gt_t[i])
        gt_q[i] = _quat_from_axes(fwd, up)
    ring_sep = np.pi * radius / revs   # distance between adjacent rings
    loops = _nearby_loops(gt_t, rng, n_loops, min_sep=int(0.8 * (n_nodes // revs)),
                          radius=1.3 * ring_sep)
    return _graph_from_gt(gt_q, gt_t, loops, rng)


def manhattan(n_nodes: int = 3500, n_loops: int = 2100, seed: int = 11,
              block: float = 10.0) -> G2OGraph:
    """manhattan3500 analog: planar grid random walk with 90-degree turns."""
    rng = np.random.default_rng(seed)
    gt_t = np.zeros((n_nodes, 3))
    yaw = np.zeros(n_nodes)
    heading = 0.0
    pos = np.zeros(2)
    # city half-width in blocks scales with walk length so revisit density
    # (and hence loop-closure count) stays roughly constant
    extent = max(2, int(np.sqrt(n_nodes) / 5))
    for i in range(1, n_nodes):
        if i % 5 == 0:   # a turn decision every block of 5 steps
            turn = rng.choice([-1, 0, 0, 1])
            heading = (heading + turn * np.pi / 2) % (2 * np.pi)
        step = np.array([np.cos(heading), np.sin(heading)]) * (block / 5.0)
        cand = pos + step
        if np.any(np.abs(cand) > extent * block):   # bounce at city edge
            heading = (heading + np.pi) % (2 * np.pi)
            cand = pos + np.array([np.cos(heading), np.sin(heading)]) * (
                block / 5.0)
        pos = cand
        gt_t[i, :2] = pos
        yaw[i] = heading
    half = yaw / 2
    gt_q = np.stack([np.zeros(n_nodes), np.zeros(n_nodes),
                     np.sin(half), np.cos(half)], axis=-1)
    loops = _nearby_loops(gt_t, rng, n_loops, min_sep=30, radius=1.5)
    return _graph_from_gt(gt_q, gt_t, loops, rng,
                          odo_rot=0.008, odo_t=0.04)


def torus(n_nodes: int = 5000, n_loops: int = 4000, seed: int = 13,
          R: float = 30.0, r: float = 10.0) -> G2OGraph:
    """torus analog: winding trajectory on a torus surface."""
    rng = np.random.default_rng(seed)
    k = np.arange(n_nodes)
    winds = max(4, n_nodes // 125)          # ~125 nodes per minor winding
    u = 2 * np.pi * winds * k / n_nodes     # minor windings
    v = 2 * np.pi * k / n_nodes             # one major revolution
    gt_t = np.stack([
        (R + r * np.cos(u)) * np.cos(v),
        (R + r * np.cos(u)) * np.sin(v),
        r * np.sin(u),
    ], axis=-1)
    gt_q = np.zeros((n_nodes, 4))
    for i in range(n_nodes):
        fwd = (gt_t[min(i + 1, n_nodes - 1)] - gt_t[max(i - 1, 0)])
        # surface normal of the torus at (u, v)
        cu, su = np.cos(u[i]), np.sin(u[i])
        cv, sv = np.cos(v[i]), np.sin(v[i])
        nrm = np.array([cu * cv, cu * sv, su])
        gt_q[i] = _quat_from_axes(fwd, nrm)
    wind_sep = 2 * np.pi * R / winds   # gap between successive windings
    loops = _nearby_loops(gt_t, rng, n_loops,
                          min_sep=int(0.6 * (n_nodes // winds)),
                          radius=1.3 * wind_sep)
    return _graph_from_gt(gt_q, gt_t, loops, rng)


# "-analog" names to be honest about provenance: these are self-generated
# graphs with the canonical datasets' structure and statistics, NOT the
# standard public sphere2500/manhattan3500/torus g2o files (which are not
# redistributable artifacts of this repo and not fetchable in this
# environment). The g2o loader (graph/g2o.py) accepts the canonical files
# unchanged — drop them in and solve them with
#   kpg-solve-torch solve --input sphere2500.g2o
DATASETS = {
    "sphere2500-analog": sphere,
    "manhattan3500-analog": manhattan,
    "torus-analog": torus,
}
