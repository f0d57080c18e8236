"""Plain reference of the ground-truth overlap and yaw of scan pairs.

After the reference's com_overlap_yaw.py:10-68 and utils.range_projection
(utils.py:59-134): the reference scan is moved into the query's frame by
inv(pose_q) @ pose_r and projected into a 64 x 900 range image (fov +3 to
-25 degrees, 50 m range, the nearest point wins a pixel); the overlap is
the share of the query's valid pixels where the moved scan's range lies
within 1 m of the query's own. The yaw is that of the relative rotation,
binned as int(-(yaw / pi) * W'/2 + W'/2).

``REFERENCE`` works in float64 throughout. ``CONTROL`` is one step below
the float32 the program's engine states: the move is a float32 product of
operands rounded to TF32 (what a matmul with TF32 on does), and the
projection float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

H, W = 64, 900
FOV_UP, FOV_DOWN = math.radians(3.0), math.radians(-25.0)
MAX_RANGE = 50.0
REFERENCE, CONTROL = "float64", "tf32"


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def range_images(xyz: torch.Tensor) -> torch.Tensor:
    """(K, P, 3) points (rows of zeros are padding) -> (K, H*W) nearest
    valid depth per pixel, -1 where none."""
    k, p, _ = xyz.shape
    depth = torch.linalg.vector_norm(xyz, dim=-1)
    valid = (depth > 0) & (depth < MAX_RANGE)
    safe = torch.where(depth > 0, depth, torch.ones_like(depth))
    yaw = -torch.atan2(xyz[..., 1], xyz[..., 0])
    pitch = torch.asin(torch.clamp(xyz[..., 2] / safe, -1.0, 1.0))
    u = torch.floor(0.5 * (yaw / math.pi + 1.0) * W).clamp(0, W - 1).long()
    v = torch.floor((1.0 - (pitch + abs(FOV_DOWN)) / (abs(FOV_DOWN) + abs(FOV_UP))) * H)
    v = v.clamp(0, H - 1).long()
    pix = torch.where(valid, v * W + u, H * W)
    img = torch.full((k, H * W + 1), math.inf, dtype=xyz.dtype, device=xyz.device)
    img.scatter_reduce_(1, pix, torch.where(valid, depth, math.inf), "amin")
    img = img[:, : H * W]
    return torch.where(torch.isfinite(img), img, -1.0)


def overlaps(points_q: torch.Tensor, points_r: torch.Tensor, pose_q: np.ndarray,
             pose_r: np.ndarray, prec: str = REFERENCE) -> torch.Tensor:
    """Overlap of K pairs: (K, P, 4) query and reference scans, (K, 4, 4)
    poses (float64, host). Returns (K,) float64."""
    rel = np.linalg.inv(pose_q) @ pose_r
    dtype = torch.float64 if prec == REFERENCE else torch.float32
    q = points_q[..., :3].to(dtype)
    r = points_r[..., :3].to(dtype)
    pad = (r == 0).all(dim=-1, keepdim=True)
    T = torch.as_tensor(rel, device=r.device).to(dtype)
    if prec == CONTROL:
        r, T = to_tf32(r), to_tf32(T)
    moved = torch.einsum("kij,kpj->kpi", T[:, :3, :3], r) + T[:, None, :3, 3]
    moved = torch.where(pad, torch.zeros_like(moved), moved)
    cur, ref = range_images(q), range_images(moved)
    close = ((ref > 0) & ((ref - cur).abs() < 1.0)).sum(dim=1).double()
    valid = (cur > 0).sum(dim=1).double()
    return torch.where(valid > 0, close / valid.clamp(min=1), 0.0)


def yaw_bins(pose_q: np.ndarray, pose_r: np.ndarray, width: int) -> np.ndarray:
    """(K,) yaw bins of inv(pose_q) @ pose_r."""
    rel = np.linalg.inv(pose_q) @ pose_r
    yaw = np.arctan2(rel[:, 1, 0], rel[:, 0, 0])
    half = width // 2
    return np.trunc(-(yaw / np.pi) * half + half)
