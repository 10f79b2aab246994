"""Trajectory / pose-graph visualization sink for the port: the reference
package's compose/vizsink.py (host numpy, no jax at import), re-exported.

Its TrajectoryWriter builds the odometry-residue visual with the reference
package's problem module, which imports jax; the port's writer overrides
that one method to use the port's own odometry grid (the same numpy code,
solver/problem.odometry_grid_np)."""

from __future__ import annotations

import numpy as np

from solve_keyframe_pose_graph_tpu.compose import vizsink as _ref
from solve_keyframe_pose_graph_tpu.compose.vizsink import (  # noqa: F401
    render_worlds_status_image, write_ppm,
)
from solve_keyframe_pose_graph_tpu.utils import colors
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    odometry_grid_np,
)


class TrajectoryWriter(_ref.TrajectoryWriter):
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
