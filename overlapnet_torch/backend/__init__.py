"""Pose-graph backend: turn loop-closure edges into optimized trajectories.

Port of the JAX package's ``backend``: a Gauss-Newton pose-graph optimizer
over SE(2) in PyTorch and trajectory-error evaluation (numpy).
"""

from overlapnet_torch.backend.ate import absolute_trajectory_error
from overlapnet_torch.backend.pose_graph import (
    PoseGraph,
    closures_to_edges,
    odometry_edges,
    optimize_pose_graph,
    relative_pose_edges,
)

__all__ = [
    "PoseGraph",
    "odometry_edges",
    "closures_to_edges",
    "relative_pose_edges",
    "optimize_pose_graph",
    "absolute_trajectory_error",
]
