"""Ground-truth distribution balancing and train/val splitting.

Reference semantics (src/utils/normalize_data.py:9-51): resample the five
overlap deciles below 0.5 down/up to the size of the [0.4, 0.5) bin (with
replacement), keep the upper deciles untouched. Split (src/utils/
split_train_val.py:10-26): random 1/10 validation holdout — reimplemented
without sklearn.
"""

from __future__ import annotations

import numpy as np


def normalize_overlap_distribution(
    gt: np.ndarray, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Rebalance an (n, 4) GT array [f1, f2, overlap, yaw] by overlap decile.

    Deciles 0.0-0.5 are resampled (with replacement) to the count of the
    [0.4, 0.5) decile; deciles >= 0.5 pass through unchanged.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    ov = gt[:, 2]
    bins = [gt[(ov >= lo) & (ov < lo + 0.1)] for lo in np.arange(0.0, 0.9, 0.1)]
    bins.append(gt[(ov >= 0.9) & (ov <= 1.0)])
    target = len(bins[4])  # the [0.4, 0.5) bin
    out = []
    for i, b in enumerate(bins):
        if i < 5 and len(b) > 0 and target > 0:
            b = b[rng.choice(len(b), target)]
        out.append(b)
    return np.concatenate([b for b in out if len(b)], axis=0)


def split_train_val(
    gt: np.ndarray,
    val_fraction: float = 0.1,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Random (train, validation) split; validation = floor(n * fraction)."""
    if rng is None:
        rng = np.random.default_rng(0)
    n = len(gt)
    n_val = int(n * val_fraction)
    perm = rng.permutation(n)
    return gt[perm[n_val:]], gt[perm[:n_val]]
