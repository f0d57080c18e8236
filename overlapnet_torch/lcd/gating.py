"""Candidate gating for online loop-closure detection.

Vectorized equivalents of the reference's search-space logic
(reference demo3_lcd.py:85-140): pose-covariance 3-sigma search ellipse plus
inactive-map constraints (candidates must be older than ``inactive_time``
frames and have a trajectory-length gap larger than ``inactive_dist``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CovarianceEllipse:
    """A covariance search ellipse (reference get_cov_ellipse,
    demo3_lcd.py:125-140): principal-axis lengths 2*nstd*sqrt(eigvals) and
    the anti-clockwise angle of the major axis."""

    width: float
    height: float
    angle_deg: float

    @classmethod
    def from_covariance(cls, cov_xy: np.ndarray, nstd: float = 3.0) -> "CovarianceEllipse":
        eigvals, eigvecs = np.linalg.eigh(cov_xy)
        order = eigvals.argsort()[::-1]
        eigvals, eigvecs = eigvals[order], eigvecs[:, order]
        vx, vy = eigvecs[0, 0], eigvecs[1, 0]
        theta = np.degrees(np.arctan2(vy, vx))
        width, height = 2.0 * nstd * np.sqrt(np.maximum(eigvals[:2], 0.0))
        return cls(float(width), float(height), float(theta))

    def contains(self, dx: np.ndarray, dy: np.ndarray) -> np.ndarray:
        """Whether offsets (dx, dy) from the ellipse center fall inside.

        Matches the reference's test (demo3_lcd.py:100-115), including its
        use of the angle 180-theta for the rotation.
        """
        cos_a = np.cos(np.radians(180.0 - self.angle_deg))
        sin_a = np.sin(np.radians(180.0 - self.angle_deg))
        xct = dx * cos_a - dy * sin_a
        yct = dx * sin_a + dy * cos_a
        half_w = max(self.width / 2.0, 1e-12)
        half_h = max(self.height / 2.0, 1e-12)
        return (xct**2 / half_w**2) + (yct**2 / half_h**2) < 1.0


def trajectory_lengths(positions: np.ndarray) -> np.ndarray:
    """Cumulative 2D trajectory length per frame (reference
    demo3_lcd.py:154-159). positions: (n, 2)."""
    steps = np.linalg.norm(np.diff(positions, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def candidate_mask(
    idx: int,
    positions: np.ndarray,
    traj_length: np.ndarray,
    ellipse: CovarianceEllipse,
    inactive_time: int = 100,
    inactive_dist: float = 50.0,
) -> np.ndarray:
    """Boolean mask over frames [0, idx) that pass all gates
    (reference demo3_lcd.py:88-115):

    - frame older than ``inactive_time`` frames,
    - trajectory-length gap > ``inactive_dist`` meters,
    - inside the query pose's search ellipse.
    """
    mask = np.zeros(idx, dtype=bool)
    if idx < inactive_time:
        return mask
    old = np.arange(idx - inactive_time)
    dist_delta = traj_length[idx] - traj_length[old]
    old = old[dist_delta > inactive_dist]
    if len(old) == 0:
        return mask
    dx = positions[idx, 0] - positions[old, 0]
    dy = positions[idx, 1] - positions[old, 1]
    mask[old[ellipse.contains(dx, dy)]] = True
    return mask
