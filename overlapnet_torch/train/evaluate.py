"""Accuracy metrics matching the reference's evaluation harness.

Overlap: mean / max / RMS absolute error (reference testing.py:276-285).
Yaw: circular error min(|d|, W - |d|) filtered to pairs with
overlap > threshold (testing.py:304-318; default 0.7).
"""

from __future__ import annotations

import numpy as np


def overlap_metrics(pred: np.ndarray, true: np.ndarray) -> dict:
    diffs = np.abs(np.squeeze(pred) - np.squeeze(true))
    return {
        "overlap_mean_error": float(np.mean(diffs)),
        "overlap_max_error": float(np.max(diffs)),
        "overlap_rms_error": float(np.sqrt(np.mean(diffs * diffs))),
    }


def yaw_metrics(
    pred_yaw_bins: np.ndarray,
    true_yaw_bins: np.ndarray,
    true_overlap: np.ndarray,
    output_size: int,
    overlap_threshold: float = 0.7,
) -> dict:
    """Circular yaw error over pairs with true overlap > threshold."""
    diffs = np.abs(np.squeeze(pred_yaw_bins) - np.squeeze(true_yaw_bins))
    circular = np.minimum(diffs, output_size - diffs)
    mask = np.squeeze(true_overlap) > overlap_threshold
    circular = circular[mask]
    if circular.size == 0:
        return {}
    return {
        "yaw_mean_error": float(np.mean(circular)),
        "yaw_max_error": float(np.max(circular)),
        "rms_error": float(np.sqrt(np.mean(circular**2))),
        "num_pairs": int(circular.size),
    }
