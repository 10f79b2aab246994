"""g2o text-format graph I/O (SE3:QUAT and SE2), and conversion to GraphStore
(counterpart of solve_keyframe_pose_graph_tpu/graph/g2o.py).

The reference consumes live ROS topics, not g2o files; g2o is the lingua
franca for pose-graph benchmarks (sphere2500 / manhattan3500 / torus,
BASELINE.md config 4), so the batch path speaks it.

Conventions:
  VERTEX_SE3:QUAT id x y z qx qy qz qw
  EDGE_SE3:QUAT   a b  x y z qx qy qz qw  <21 upper-tri info entries>
  VERTEX_SE2      id x y theta
  EDGE_SE2        a b  dx dy dtheta  <6 upper-tri info entries>

SE2 graphs are lifted to SE3 (z = 0, yaw-only rotation). g2o's EDGE a b
measurement is a_T_b (pose of b in a's frame); our LoopEdge convention is
b_T_a ("pose of 0 as observed from 1", msg/LoopEdge.msg pose_1T0), so edges
are inverted on ingest.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from solve_keyframe_pose_graph_tpu_torch.utils import nse3


@dataclasses.dataclass
class G2OGraph:
    q: np.ndarray            # (N,4) xyzw vertex estimates
    t: np.ndarray            # (N,3)
    edges: np.ndarray        # (E,2) int (a, b)
    edge_q: np.ndarray       # (E,4) measurement a_T_b (g2o convention)
    edge_t: np.ndarray       # (E,3)
    edge_info: np.ndarray    # (E,6,6) information matrices (SE3 tangent order
                             #         [t, rot]; lifted for SE2)
    is_2d: bool

    @property
    def n_nodes(self):
        return len(self.t)

    @property
    def n_edges(self):
        return len(self.edges)

    def split_edges(self):
        """(odometry_mask, loop_mask): consecutive |a-b|==1 vs the rest."""
        d = np.abs(self.edges[:, 0] - self.edges[:, 1])
        return d == 1, d != 1


def _yaw_quat(theta):
    return np.array([0.0, 0.0, np.sin(theta / 2), np.cos(theta / 2)])


def load_g2o(path: str) -> G2OGraph:
    verts: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    edges, eq, et, einfo = [], [], [], []
    is_2d = False
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            tag = tok[0]
            if tag == "VERTEX_SE3:QUAT":
                i = int(tok[1])
                x, y, z, qx, qy, qz, qw = map(float, tok[2:9])
                verts[i] = (np.array([qx, qy, qz, qw]), np.array([x, y, z]))
            elif tag == "VERTEX_SE2":
                is_2d = True
                i = int(tok[1])
                x, y, th = map(float, tok[2:5])
                verts[i] = (_yaw_quat(th), np.array([x, y, 0.0]))
            elif tag == "EDGE_SE3:QUAT":
                a, b = int(tok[1]), int(tok[2])
                vals = list(map(float, tok[3:]))
                x, y, z, qx, qy, qz, qw = vals[:7]
                edges.append((a, b))
                eq.append([qx, qy, qz, qw])
                et.append([x, y, z])
                info = np.zeros((6, 6))
                iu = np.triu_indices(6)
                info[iu] = vals[7:28]
                info = info + np.triu(info, 1).T
                einfo.append(info)
            elif tag == "EDGE_SE2":
                is_2d = True
                a, b = int(tok[1]), int(tok[2])
                vals = list(map(float, tok[3:]))
                dx, dy, dth = vals[:3]
                edges.append((a, b))
                eq.append(list(_yaw_quat(dth)))
                et.append([dx, dy, 0.0])
                i2 = np.zeros((3, 3))
                iu = np.triu_indices(3)
                i2[iu] = vals[3:9]
                i2 = i2 + np.triu(i2, 1).T
                # lift (x, y, th) info onto SE3 tangent [t, rot]: z / roll /
                # pitch rows get a stiff prior so the problem stays planar
                info = np.zeros((6, 6))
                info[:2, :2] = i2[:2, :2]
                info[:2, 5] = i2[:2, 2]
                info[5, :2] = i2[2, :2]
                info[5, 5] = i2[2, 2]
                stiff = max(i2[0, 0], i2[1, 1], i2[2, 2])
                info[2, 2] = info[3, 3] = info[4, 4] = stiff
                einfo.append(info)

    n = max(verts) + 1 if verts else 0
    q = np.zeros((n, 4)); q[:, 3] = 1.0
    t = np.zeros((n, 3))
    for i, (qi, ti) in verts.items():
        q[i], t[i] = qi, ti
    return G2OGraph(
        q=q, t=t,
        edges=np.asarray(edges, np.int32).reshape(-1, 2),
        edge_q=np.asarray(eq, np.float64).reshape(-1, 4),
        edge_t=np.asarray(et, np.float64).reshape(-1, 3),
        edge_info=np.asarray(einfo, np.float64).reshape(-1, 6, 6),
        is_2d=is_2d,
    )


def synthetic_to_g2o(g) -> G2OGraph:
    """SyntheticGraph -> G2OGraph (for canonicalizing generated instances
    as .g2o files: every solver that is compared must read the same
    rounded values).

    Odometry edges carry the VIO relative poses, so integrating them in
    g2o_to_problem_inputs reproduces the drifted VIO trajectory exactly.
    A synthetic loop (a, b) observed as b_T_a becomes the g2o edge (b, a)
    with measurement b_T_a (g2o convention a'_T_b'), which round-trips to
    the identical LoopEdge. Identity information matrices: the reference's
    active residual ignores per-edge weight (CeresResidues.h:189-198)."""
    n = g.n_nodes
    eq = np.zeros((n - 1, 4)); et = np.zeros((n - 1, 3))
    for i in range(n - 1):
        eq[i], et[i] = nse3.pose_relative(g.vio_q[i], g.vio_t[i],
                                          g.vio_q[i + 1], g.vio_t[i + 1])
    edges = np.concatenate([
        np.stack([np.arange(n - 1), np.arange(1, n)], -1),
        np.asarray(g.loop_pairs)[:, ::-1],
    ]).astype(np.int64)
    return G2OGraph(
        q=np.asarray(g.vio_q), t=np.asarray(g.vio_t), edges=edges,
        edge_q=np.concatenate([eq, np.asarray(g.loop_q)]),
        edge_t=np.concatenate([et, np.asarray(g.loop_t)]),
        edge_info=np.tile(np.eye(6), (len(edges), 1, 1)),
        is_2d=False,
    )


def save_g2o(path: str, g: G2OGraph) -> None:
    # atomic: a crashed writer must not leave a partial file that later
    # runs silently load as a truncated graph
    import os as _os
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for i in range(g.n_nodes):
            x, y, z = g.t[i]
            qx, qy, qz, qw = g.q[i]
            f.write(f"VERTEX_SE3:QUAT {i} {x:.9g} {y:.9g} {z:.9g} "
                    f"{qx:.9g} {qy:.9g} {qz:.9g} {qw:.9g}\n")
        iu = np.triu_indices(6)
        for e in range(g.n_edges):
            a, b = g.edges[e]
            x, y, z = g.edge_t[e]
            qx, qy, qz, qw = g.edge_q[e]
            up = " ".join(f"{v:.9g}" for v in g.edge_info[e][iu])
            f.write(f"EDGE_SE3:QUAT {a} {b} {x:.9g} {y:.9g} {z:.9g} "
                    f"{qx:.9g} {qy:.9g} {qz:.9g} {qw:.9g} {up}\n")
    _os.replace(tmp, path)


def g2o_to_problem_inputs(g: G2OGraph):
    """Map a g2o batch graph onto the framework's streaming input model.

    Odometry (consecutive) edge measurements are integrated into a VIO-style
    trajectory — exactly the reference's input model (VINS odometry in,
    loop closures in). Initial guesses are the integrated odometry (matching
    the reference's warm start from VIO, PoseGraphSLAM.cpp:1755-1793), NOT
    the g2o vertex estimates, so results are self-contained.

    Non-consecutive edges become LoopEdges; g2o a_T_b is inverted to the
    LoopEdge b_T_a convention, weight 1.0 (information matrices are reported
    for diagnostics; the reference's residual ignores per-edge covariance —
    CeresResidues.h:63-66).

    Returns dict of numpy inputs for solver.problem.build_problem_np, plus
    the loop-pair array in (a, b) order.
    """
    n = g.n_nodes
    odo_mask, loop_mask = g.split_edges()

    # integrate consecutive measurements a_T_b along the chain
    vq = np.zeros((n, 4)); vq[:, 3] = 1.0
    vt = np.zeros((n, 3))
    vq[0], vt[0] = g.q[0], g.t[0]
    step = {}
    for e in np.nonzero(odo_mask)[0]:
        a, b = g.edges[e]
        lo, hi = (int(a), int(b)) if a < b else (int(b), int(a))
        mq, mt = g.edge_q[e], g.edge_t[e]
        if a > b:   # measurement is hi_T_lo; invert to lo_T_hi
            mq, mt = nse3.pose_inv(mq, mt)
        step[lo] = (mq, mt)
    for i in range(1, n):
        if i - 1 in step:
            mq, mt = step[i - 1]
            vq[i], vt[i] = nse3.pose_mul(vq[i - 1], vt[i - 1], mq, mt)
            vq[i] /= np.linalg.norm(vq[i])
        else:       # disconnected chain: fall back to the vertex estimate
            vq[i], vt[i] = g.q[i], g.t[i]

    li = np.nonzero(loop_mask)[0]
    pairs = np.zeros((len(li), 2), np.int32)
    lq = np.zeros((len(li), 4)); lt = np.zeros((len(li), 3))
    for k, e in enumerate(li):
        a, b = g.edges[e]
        # g2o measurement is a_T_b. With our pair (a', b') = (b, a) the
        # LoopEdge observation b'_T_a' = a_T_b — the measurement verbatim.
        pairs[k] = (b, a)
        lq[k], lt[k] = g.edge_q[e], g.edge_t[e]
    return {
        "vio_q": vq, "vio_t": vt,
        "loop_pairs": pairs, "loop_q": lq, "loop_t": lt,
        "loop_w": np.ones(len(li)),
    }
