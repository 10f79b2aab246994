"""Host graph state for the port: the reference package's numpy-only graph
modules (they import no jax), re-exported so that callers of the port name
one package."""

from solve_keyframe_pose_graph_tpu.graph import (  # noqa: F401
    native, store, synthetic, worlds,
)
