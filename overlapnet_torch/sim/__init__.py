"""Procedural LiDAR world simulation (KITTI-compatible synthetic sequences,
a copy of the JAX package's numpy-only ``sim/world.py``) and the end-to-end
accuracy harness over it (``sim/e2e.py``)."""

from overlapnet_torch.sim.e2e import build_gt, generate_sequence, make_config, run_e2e
from overlapnet_torch.sim.world import (
    loop_trajectory,
    make_world,
    scan_at_pose,
    write_kitti_sequence,
)

__all__ = [
    "build_gt",
    "generate_sequence",
    "loop_trajectory",
    "make_config",
    "make_world",
    "run_e2e",
    "scan_at_pose",
    "write_kitti_sequence",
]
