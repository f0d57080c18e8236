"""Host- and device-side geometry of the port: the KITTI loaders
(``kitti``), the spherical projection and normals (``projection``), the
ground-truth overlap and yaw (``overlap``), the offline image writers
(``gen_data``) and the rotation helpers (``rotations``)."""

from overlapnet_torch.geometry.kitti import (
    load_calib,
    load_files,
    load_poses,
    load_scan,
    load_vertex,
    poses_cam_to_velo,
)
from overlapnet_torch.geometry.projection import (
    PROJ_H,
    PROJ_W,
    normal_map,
    pad_points,
    range_projection,
    semantic_projection,
)
from overlapnet_torch.geometry.rotations import (
    euler_angles_from_rotation_matrix,
    yaw_to_bin,
)

__all__ = [
    "PROJ_H",
    "PROJ_W",
    "euler_angles_from_rotation_matrix",
    "load_calib",
    "load_files",
    "load_poses",
    "load_scan",
    "load_vertex",
    "normal_map",
    "pad_points",
    "poses_cam_to_velo",
    "range_projection",
    "semantic_projection",
    "yaw_to_bin",
]
