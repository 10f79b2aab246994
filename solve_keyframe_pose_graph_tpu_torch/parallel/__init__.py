"""Solving over a mesh of devices (counterpart of
solve_keyframe_pose_graph_tpu/parallel/)."""

from solve_keyframe_pose_graph_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    ShardedProblem,
    gather_problem,
    make_mesh,
    shard_problem,
)
from solve_keyframe_pose_graph_tpu_torch.parallel.collectives import (  # noqa: F401
    unshard,
)
