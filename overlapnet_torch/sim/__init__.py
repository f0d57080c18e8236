"""Procedural LiDAR world simulation (KITTI-compatible synthetic sequences),
a copy of the JAX package's numpy-only ``sim/world.py``."""

from overlapnet_torch.sim.world import (
    loop_trajectory,
    make_world,
    scan_at_pose,
    write_kitti_sequence,
)

__all__ = [
    "loop_trajectory",
    "make_world",
    "scan_at_pose",
    "write_kitti_sequence",
]
