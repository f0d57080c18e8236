"""KITTI odometry dataset I/O: scans, poses, calibration.

Host-side (numpy) loaders. Disk contract matches the reference
(README.md:193-216): ``<seq>/velodyne/*.bin`` float32 (N,4) scans,
``poses.txt`` with 3x4 T_w_cam0 rows, ``calib.txt`` with a ``Tr:`` line
holding T_cam_velo, ``covariance.txt`` with n x 36 pose covariances.
"""

from __future__ import annotations

import os

import numpy as np


def load_scan(scan_path: str) -> np.ndarray:
    """Load a KITTI .bin scan as an (N, 4) float32 array (x, y, z, remission)."""
    return np.fromfile(scan_path, dtype=np.float32).reshape((-1, 4))


def load_vertex(scan_path: str) -> np.ndarray:
    """Load a scan as homogeneous points (N, 4) = (x, y, z, 1).

    Same contract as reference utils.load_vertex (utils.py:217-230); float64
    like the reference (np.ones default dtype) so GT poses math matches.
    """
    points = load_scan(scan_path)[:, :3]
    vertex = np.ones((points.shape[0], 4))
    vertex[:, :3] = points
    return vertex


def load_poses(pose_path: str) -> np.ndarray:
    """Load ground-truth poses (T_w_cam0) as (n, 4, 4).

    Accepts KITTI poses.txt (12 floats per line) or an .npz with 'arr_0'
    (reference utils.load_poses, utils.py:10-35).
    """
    if pose_path.endswith(".npz") or (not pose_path.endswith(".txt") and os.path.exists(pose_path)):
        try:
            return np.load(pose_path)["arr_0"]
        except Exception:
            pass
    rows = np.loadtxt(pose_path).reshape(-1, 12)
    poses = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    poses[:, :3, :4] = rows.reshape(-1, 3, 4)
    return poses


def load_calib(calib_path: str) -> np.ndarray:
    """Load T_cam_velo (4, 4) from the ``Tr:`` line of a KITTI calib.txt
    (reference utils.load_calib, utils.py:38-56)."""
    with open(calib_path) as f:
        for line in f:
            if "Tr:" in line:
                vals = np.fromstring(line.replace("Tr:", ""), dtype=float, sep=" ")
                T = np.eye(4)
                T[:3, :4] = vals.reshape(3, 4)
                return T
    raise ValueError(f"No 'Tr:' line found in {calib_path}")


def load_covariances(covariance_path: str) -> np.ndarray:
    """Load per-frame 6x6 pose covariances from an n x 36 text file
    (reference demo3_lcd.py:216-218)."""
    flat = np.loadtxt(covariance_path)
    return flat.reshape(-1, 6, 6)


def load_files(folder: str) -> list[str]:
    """All files under ``folder`` (recursive), sorted
    (reference utils.load_files, utils.py:233-239)."""
    paths = [
        os.path.join(dp, f)
        for dp, _, fn in os.walk(os.path.expanduser(folder))
        for f in fn
    ]
    paths.sort()
    return paths


def poses_cam_to_velo(poses: np.ndarray, T_cam_velo: np.ndarray) -> np.ndarray:
    """Convert KITTI camera-frame poses to LiDAR-frame poses rebased on
    frame 0: ``T_velo_cam @ inv(pose0) @ pose @ T_cam_velo``
    (reference demo4_gen_gt_files.py:71-74, demo3_lcd.py:210-213)."""
    T_velo_cam = np.linalg.inv(T_cam_velo)
    pose0_inv = np.linalg.inv(poses[0])
    return np.einsum(
        "ij,njk,kl->nil", T_velo_cam @ pose0_inv, poses, T_cam_velo
    )


# SemanticKITTI class color map, bgr (reference utils.py:242-263).
SEMANTIC_MAPPING = {
    0: [0, 0, 0],          # unlabeled and others ignored
    1: [245, 150, 100],    # car
    2: [245, 230, 100],    # bicycle
    3: [150, 60, 30],      # motorcycle
    4: [180, 30, 80],      # truck
    5: [255, 0, 0],        # other-vehicle
    6: [30, 30, 255],      # person
    7: [200, 40, 255],     # bicyclist
    8: [90, 30, 150],      # motorcyclist
    9: [255, 0, 255],      # road
    10: [255, 150, 255],   # parking
    11: [75, 0, 75],       # sidewalk
    12: [75, 0, 175],      # other-ground
    13: [0, 200, 255],     # building
    14: [50, 120, 255],    # fence
    15: [0, 175, 0],       # vegetation
    16: [0, 60, 135],      # trunk
    17: [80, 240, 150],    # terrain
    18: [150, 240, 255],   # pole
    19: [0, 0, 255],       # traffic-sign
}
