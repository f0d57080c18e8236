"""Procedural LiDAR world simulator.

No reference counterpart: the reference's demos rely on two bundled KITTI
scans plus downloadable sequence archives (reference README.md:137-141) that
cannot be fetched here. This module synthesizes KITTI-compatible sequences —
velodyne ``.bin`` scans, ``poses.txt``, ``calib.txt`` — from a procedural
world (ground plane + walls + cylinders), so the FULL pipeline (projection →
GT generation → training → loop-closure detection → pose-graph optimization)
can be exercised and its accuracy measured end-to-end without external data.

Scans are the world point cloud transformed into the sensor frame and
range-gated; the projection z-buffer (geometry.projection.range_projection)
supplies occlusion, mimicking what a spinning scanner sees. Intensities
encode a per-structure albedo so the intensity channel is informative.
"""

from __future__ import annotations

import os

import numpy as np


def make_world(
    rng: np.random.Generator,
    extent: float = 90.0,
    n_walls: int = 60,
    n_cylinders: int = 80,
    ground_step: float = 0.35,
) -> np.ndarray:
    """World point cloud (M, 4): x, y, z, intensity (world frame)."""
    clouds = []

    # ground plane with gentle undulation
    g = np.arange(-extent, extent, ground_step, dtype=np.float32)
    gx, gy = np.meshgrid(g, g)
    gz = 0.12 * np.sin(0.07 * gx) * np.cos(0.05 * gy)
    gi = np.full(gx.size, 0.1, np.float32)
    clouds.append(
        np.column_stack([gx.ravel(), gy.ravel(), gz.ravel(), gi])
    )

    # vertical walls (building facades): random position/heading/size
    for _ in range(n_walls):
        cx, cy = rng.uniform(-extent, extent, 2)
        heading = rng.uniform(0, np.pi)
        length = rng.uniform(6.0, 18.0)
        height = rng.uniform(2.5, 7.0)
        albedo = rng.uniform(0.3, 0.9)
        s = np.arange(0, length, 0.12, dtype=np.float32)
        h = np.arange(0, height, 0.12, dtype=np.float32)
        ss, hh = np.meshgrid(s, h)
        x = cx + (ss.ravel() - length / 2) * np.cos(heading)
        y = cy + (ss.ravel() - length / 2) * np.sin(heading)
        z = hh.ravel()
        i = np.full(x.size, albedo, np.float32)
        clouds.append(np.column_stack([x, y, z, i]).astype(np.float32))

    # cylinders (poles / trunks)
    for _ in range(n_cylinders):
        cx, cy = rng.uniform(-extent, extent, 2)
        radius = rng.uniform(0.15, 0.6)
        height = rng.uniform(2.0, 8.0)
        albedo = rng.uniform(0.4, 1.0)
        theta = np.arange(0, 2 * np.pi, 0.12 / max(radius, 0.25), dtype=np.float32)
        h = np.arange(0, height, 0.12, dtype=np.float32)
        tt, hh = np.meshgrid(theta, h)
        x = cx + radius * np.cos(tt.ravel())
        y = cy + radius * np.sin(tt.ravel())
        i = np.full(x.size, albedo, np.float32)
        clouds.append(np.column_stack([x, y, hh.ravel(), i]).astype(np.float32))

    return np.concatenate(clouds).astype(np.float32)


def loop_trajectory(
    n_frames: int,
    side: float = 55.0,
    laps: float = 2.0,
    z: float = 1.7,
) -> np.ndarray:
    """(n, 4, 4) sensor poses driving ``laps`` laps around a square of
    ``side`` meters, heading along the direction of travel. With laps > 1 the
    second lap revisits the first — the loop-closure ground truth."""
    # square perimeter parameterization
    t = np.linspace(0.0, laps, n_frames, endpoint=False)
    frac = (t % 1.0) * 4.0
    seg = np.floor(frac).astype(int)
    u = frac - seg
    corners = np.array(
        [[0, 0], [side, 0], [side, side], [0, side], [0, 0]], np.float64
    )
    pos = corners[seg] + (corners[seg + 1] - corners[seg]) * u[:, None]
    headings = np.array([0.0, np.pi / 2, np.pi, -np.pi / 2])[seg]

    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    c, s = np.cos(headings), np.sin(headings)
    poses[:, 0, 0] = c
    poses[:, 0, 1] = -s
    poses[:, 1, 0] = s
    poses[:, 1, 1] = c
    poses[:, 0, 3] = pos[:, 0] - side / 2
    poses[:, 1, 3] = pos[:, 1] - side / 2
    poses[:, 2, 3] = z
    return poses


def scan_at_pose(
    world: np.ndarray,
    pose: np.ndarray,
    rng: np.random.Generator,
    max_range: float = 50.0,
    min_range: float = 2.0,
    max_points: int = 130_000,
    noise_std: float = 0.02,
) -> np.ndarray:
    """Render one scan: world points in the sensor frame, range-gated,
    subsampled to ``max_points``, with gaussian range noise."""
    T_sensor_world = np.linalg.inv(pose)
    xyz = world[:, :3] @ T_sensor_world[:3, :3].T + T_sensor_world[:3, 3]
    depth = np.linalg.norm(xyz, axis=1)
    keep = (depth > min_range) & (depth < max_range)
    xyz, inten = xyz[keep], world[keep, 3]
    if xyz.shape[0] > max_points:
        idx = rng.choice(xyz.shape[0], max_points, replace=False)
        xyz, inten = xyz[idx], inten[idx]
    xyz = xyz + rng.normal(scale=noise_std, size=xyz.shape)
    return np.column_stack([xyz, inten]).astype(np.float32)


def write_kitti_sequence(
    dst_folder: str,
    world: np.ndarray,
    poses: np.ndarray,
    seed: int = 0,
    **scan_kwargs,
) -> dict:
    """Write a KITTI-layout sequence: ``velodyne/%06d.bin``, ``poses.txt``
    (identity sensor-to-camera calib in ``calib.txt``, so the camera frame IS
    the LiDAR frame), and a ``covariance.txt`` with linearly growing
    positional uncertainty for the LCD search ellipse."""
    scan_dir = os.path.join(dst_folder, "velodyne")
    os.makedirs(scan_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, pose in enumerate(poses):
        scan = scan_at_pose(world, pose, rng, **scan_kwargs)
        scan.tofile(os.path.join(scan_dir, f"{i:06d}.bin"))

    poses_file = os.path.join(dst_folder, "poses.txt")
    with open(poses_file, "w") as f:
        for pose in poses:
            f.write(" ".join(f"{v:.9f}" for v in pose[:3].ravel()) + "\n")

    calib_file = os.path.join(dst_folder, "calib.txt")
    with open(calib_file, "w") as f:
        tr = np.eye(4)[:3].ravel()
        f.write("Tr: " + " ".join(f"{v:.1f}" for v in tr) + "\n")

    cov_file = os.path.join(dst_folder, "covariance.txt")
    n = len(poses)
    with open(cov_file, "w") as f:
        for i in range(n):
            cov = np.eye(6) * (0.5 + 0.05 * i) ** 2
            f.write(" ".join(f"{v:.6f}" for v in cov.ravel()) + "\n")

    return {
        "scan_folder": scan_dir,
        "poses_file": poses_file,
        "calib_file": calib_file,
        "covariance_file": cov_file,
    }
