"""Absolute trajectory error (ATE) with rigid alignment.

Standard ATE-RMSE: align the estimate to ground truth with the best-fit 2D
rigid transform (Umeyama, rotation+translation), then RMS of positional
residuals. Used to grade the pose-graph backend (BASELINE.md target).
"""

from __future__ import annotations

import numpy as np


def align_rigid_2d(est: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Best-fit rotation+translation mapping est -> ref ((N, 2) each);
    returns the aligned copy of est."""
    mu_e = est.mean(axis=0)
    mu_r = ref.mean(axis=0)
    e = est - mu_e
    r = ref - mu_r
    h = e.T @ r
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1.0, d]) @ u.T
    return (rot @ e.T).T + mu_r


def absolute_trajectory_error(
    estimated: np.ndarray, reference: np.ndarray, align: bool = True
) -> dict:
    """ATE stats between two trajectories ((N, >=2): x, y [, ...])."""
    est = np.asarray(estimated, float)[:, :2]
    ref = np.asarray(reference, float)[:, :2]
    assert est.shape == ref.shape
    if align:
        est = align_rigid_2d(est, ref)
    d = np.linalg.norm(est - ref, axis=1)
    return {
        "ate_rmse": float(np.sqrt(np.mean(d**2))),
        "ate_mean": float(np.mean(d)),
        "ate_max": float(np.max(d)),
    }
