"""Rotation helpers: euler extraction and yaw binning."""

from __future__ import annotations

import math

import numpy as np


def euler_angles_from_rotation_matrix(R) -> tuple[float, float, float]:
    """Extract (roll, pitch, yaw) = (psi, theta, phi) from a 3x3 rotation.

    Slabaugh's method, identical branch structure to reference
    utils.euler_angles_from_rotation_matrix (utils.py:189-214) so gimbal-lock
    edge cases produce the same values.
    """

    def isclose(x, y, rtol=1.0e-5, atol=1.0e-8):
        return abs(x - y) <= atol + rtol * abs(y)

    phi = 0.0
    if isclose(R[2, 0], -1.0):
        theta = math.pi / 2.0
        psi = math.atan2(R[0, 1], R[0, 2])
    elif isclose(R[2, 0], 1.0):
        theta = -math.pi / 2.0
        psi = math.atan2(-R[0, 1], -R[0, 2])
    else:
        theta = -math.asin(R[2, 0])
        cos_theta = math.cos(theta)
        psi = math.atan2(R[2, 1] / cos_theta, R[2, 2] / cos_theta)
        phi = math.atan2(R[1, 0] / cos_theta, R[0, 0] / cos_theta)
    return psi, theta, phi


def yaw_to_bin(yaw: float, resolution: int = 360) -> int:
    """Discretize a yaw angle (radians) into ``resolution`` bins with zero
    shifted to the center: ``int(-(yaw/pi) * res//2 + res//2)``
    (reference com_overlap_yaw.py:54)."""
    return int(-(yaw / np.pi) * (resolution // 2) + resolution // 2)


def relative_yaw(pose_current: np.ndarray, pose_reference: np.ndarray) -> float:
    """Yaw of ``inv(pose_current) @ pose_reference`` (reference
    com_overlap_yaw.py:49-51)."""
    relative = np.linalg.inv(pose_current) @ pose_reference
    _, _, yaw = euler_angles_from_rotation_matrix(relative[:3, :3])
    return yaw
