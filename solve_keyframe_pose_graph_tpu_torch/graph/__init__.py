"""Host graph state for the port: the reference package's numpy-only graph
modules (they import no jax), re-exported so that callers of the port name
one package, and the port's own `native` store (a subclass of the
reference's with a `node_worlds()` that is safe under concurrent ingest)."""

from solve_keyframe_pose_graph_tpu.graph import (  # noqa: F401
    g2o, messages, store, synthetic, worlds,
)
from solve_keyframe_pose_graph_tpu_torch.graph import native  # noqa: F401
