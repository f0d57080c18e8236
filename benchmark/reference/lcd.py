"""Plain reference of online loop closing's candidate gating.

Gating as the reference's demo3_lcd.py:85-140 has it with no pose
covariance: a candidate is more than ``inactive_time`` frames old and more
than ``inactive_dist`` metres back along the trajectory.
"""

from __future__ import annotations

import numpy as np


def candidates(idx: int, positions: np.ndarray, inactive_time: int = 100,
               inactive_dist: float = 50.0) -> np.ndarray:
    """Frame ids that frame ``idx`` is scored against, ascending."""
    if idx < inactive_time:
        return np.zeros(0, np.int64)
    steps = np.linalg.norm(np.diff(positions[: idx + 1], axis=0), axis=1)
    travelled = np.concatenate([[0.0], np.cumsum(steps)])
    old = np.arange(idx - inactive_time)
    return old[travelled[idx] - travelled[old] > inactive_dist]

