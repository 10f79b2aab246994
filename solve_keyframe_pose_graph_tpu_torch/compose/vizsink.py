"""Trajectory / pose-graph visualization sink (VizPoseGraph analog;
counterpart of solve_keyframe_pose_graph_tpu/compose/vizsink.py).

The reference renders to RViz via ros markers (src/VizPoseGraph.{h,cpp});
here the same primitives are emitted as portable JSON (+ optional NPZ)
that any viewer can render:

  * per-world line strips of the corrected trajectory, colored by worldID
    or setID (publishNodesAsLineStrip, VizPoseGraph.cpp:67-165;
    color choice Composer.cpp:285)
  * loop-edge line list over corrected endpoints, false-colored by switch
    value and carrying the residual weight (publishSlamResidueVisual's
    loopedge_residues markers, VizPoseGraph.cpp:417-445)
  * odometry-residue line list false-colored by residual weight
    (publishSlamResidueVisual's odom_residues markers, VizPoseGraph.cpp:
    383-414; the (a, b, weight) tuples the reference records during
    assembly, PoseGraphSLAM.cpp:963-1002)
  * newest-N loop edges as one line list (publishLastNEdges,
    VizPoseGraph.cpp:342-376)
  * disjoint-set status (string + JSON; Worlds.cpp:278-363)
"""

from __future__ import annotations

import json
import os

import numpy as np

from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    odometry_grid_np,
)
from solve_keyframe_pose_graph_tpu_torch.utils import colors


def render_worlds_status_image(worlds, cell: int = 48) -> np.ndarray:
    """Disjoint-set status as an image (Worlds::disjoint_set_status_image
    analog, Worlds.cpp:365-407): one disc per world, filled with the SET's
    deterministic color (worlds merged into one set share a color), ringed
    with the world's own color. Pure numpy, (cell, n_worlds*cell, 3) uint8."""
    n = max(worlds.n_worlds(), 1)
    h, w = cell, cell * n
    img = np.full((h, w, 3), 255, np.uint8)
    yy, xx = np.mgrid[0:cell, 0:cell]
    cc = (cell - 1) / 2.0
    r2 = (yy - cc) ** 2 + (xx - cc) ** 2
    disc = r2 <= (0.38 * cell) ** 2
    ring = (r2 <= (0.46 * cell) ** 2) & ~disc
    for i in range(worlds.n_worlds()):
        sid = worlds.find_setID_of_world_i(i)
        fill = np.array(colors.world_color(sid if sid >= 0 else i)) * 255
        edge = np.array(colors.world_color(i)) * 255
        tile = img[:, i * cell:(i + 1) * cell]
        tile[disc] = fill.astype(np.uint8)
        tile[ring] = edge.astype(np.uint8)
    return img


def write_ppm(path: str, img: np.ndarray) -> None:
    """Minimal binary PPM writer (no image libraries in the environment)."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


class TrajectoryWriter:
    def __init__(self, out_dir: str, color_by_set: bool = False,
                 last_n_edges: int = 20):
        self.out_dir = out_dir
        self.color_by_set = color_by_set
        # newest-N loop edges emitted as one highlighted line list (the
        # reference's publishLastNEdges(n); 0 disables)
        self.last_n_edges = last_n_edges
        os.makedirs(out_dir, exist_ok=True)

    def _odom_residues(self, composer, comp) -> list:
        """(a, b, weight) line list over corrected endpoints, false-colored
        by the odometry residual weight."""
        store = composer.store
        n = store.node_len
        if comp is None or n == 0:
            return []
        rc = composer.engine.config.residual
        _, vio_q, vio_t = store.node_arrays()
        node_valid = store.node_worlds()[:n] >= 0
        _, _, ow, om = odometry_grid_np(
            vio_q[:n], vio_t[:n], node_valid, fanout=rc.odometry_fanout,
            odo_decay=rc.odometry_decay,
            odo_yaw_sigma2=rc.odometry_yaw_sigma2)
        out = []
        t_corr = np.asarray(comp.t)
        for f in range(ow.shape[0]):
            for u in np.nonzero(om[f] > 0)[0]:
                w = float(ow[f, u])
                out.append({
                    "a": int(u), "b": int(u - f - 1), "weight": w,
                    "p0": t_corr[u].tolist(),
                    "p1": t_corr[u - f - 1].tolist(),
                    "color": colors.false_color(w),
                })
        return out

    def write_tick(self, composer, tick: int, tag: str = "live") -> str:
        """Streaming-cadence dump: 90% of ticks emit only the NEWEST
        world's strip, every 10th tick emits all worlds — the reference's
        bf_traj publish economy (Composer.cpp:318-332)."""
        if tick % 10 == 0:
            return self.write(composer, tag=tag)
        comp = composer.latest or composer.assemble()
        only = ({int(comp.latest_pose_worldid)} if comp is not None
                else None)
        return self.write(composer, tag=tag, only_worlds=only)

    def write(self, composer, tag: str = "final", only_worlds=None) -> str:
        """Dump the current composed state. Returns the JSON path.
        only_worlds: optional set of world ids to restrict the strips to
        (the publish-economy path)."""
        comp = composer.assemble()
        store = composer.store
        worlds = store.worlds

        strips = []
        if comp is not None:
            for w in sorted(set(int(x) for x in comp.world_of)):
                if only_worlds is not None and w not in only_worlds:
                    continue
                pts = comp.world_polyline(w)
                if len(pts) == 0:
                    continue
                cid = worlds.find_setID_of_world_i(w) if (
                    self.color_by_set and w >= 0) else w
                strips.append({
                    "world_id": int(w),
                    "set_id": (worlds.find_setID_of_world_i(w)
                               if w >= 0 else -1),
                    "color": colors.world_color(cid),
                    "points": np.asarray(pts).tolist(),
                })

        edges = []
        p0, p1, sw = composer.corrected_loop_edges()
        _, _, _, _, ew, _ = store.edge_arrays()
        for k in range(len(sw)):
            edges.append({
                "p0": np.asarray(p0[k]).tolist(),
                "p1": np.asarray(p1[k]).tolist(),
                "switch": float(sw[k]),
                # residual weight ("goodness" from the loop detector): the
                # reference's loopedge_residues tuples carry it alongside
                # the switch value (VizPoseGraph.cpp:421-425)
                "weight": float(ew[k]) if k < len(ew) else 0.0,
                "color": colors.false_color(sw[k]),
            })

        # newest-N loop edges as one line list (publishLastNEdges,
        # VizPoseGraph.cpp:342-376; color .5,.5,.1 as in the reference)
        n_last = min(self.last_n_edges, len(sw)) if self.last_n_edges else 0
        last_n = {
            "n": n_last,
            "color": [0.5, 0.5, 0.1],
            "segments": [[np.asarray(p0[k]).tolist(),
                          np.asarray(p1[k]).tolist()]
                         for k in range(len(sw) - n_last, len(sw))],
        }

        # odometry residues false-colored by residual weight
        # (publishSlamResidueVisual's odom_residues, VizPoseGraph.cpp:
        # 383-414). Weights are pure functions of the immutable VIO input,
        # recomputed here with the problem builder's own grid helper.
        odom_residues = self._odom_residues(composer, comp)

        # raw (uncorrected) VIO odometry polyline — the reference's
        # periodic_publish_odoms thread (keyframe_pose_graph_slam_node.cpp:
        # 77-198) publishes this alongside the corrected trajectory
        _, _, vio_t = store.node_arrays()
        raw_strip = np.asarray(vio_t).tolist()

        obj = {
            "strips": strips,
            "raw_odometry": raw_strip,
            "loop_edges": edges,
            "last_n_edges": last_n,
            "odom_residues": odom_residues,
            "disjoint_set_status": worlds.disjoint_set_status(),
            "worlds_status": worlds.status_json(),
            "solved_until": composer.engine.solved_until,
        }
        path = os.path.join(self.out_dir, f"viz_{tag}.json")
        with open(path, "w") as f:
            json.dump(obj, f, indent=2)

        write_ppm(os.path.join(self.out_dir, f"worlds_status_{tag}.ppm"),
                  render_worlds_status_image(worlds))

        if comp is not None:
            np.savez(
                os.path.join(self.out_dir, f"viz_{tag}.npz"),
                q=np.asarray(comp.q), t=np.asarray(comp.t),
                world_of=np.asarray(comp.world_of),
                edge_p0=np.asarray(p0), edge_p1=np.asarray(p1),
                switch=np.asarray(sw),
            )
        return path
