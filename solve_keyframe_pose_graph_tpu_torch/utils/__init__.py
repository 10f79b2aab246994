"""Host utilities for the port: the reference package's numpy SE(3) helpers
(they import no jax), re-exported so that callers of the port name one
package."""

from solve_keyframe_pose_graph_tpu.utils import nse3  # noqa: F401
