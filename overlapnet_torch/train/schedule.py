"""Learning-rate schedule matching the reference exactly.

Reference (training.py:47-57): epoch 0 runs at 0.1 * initial_lr (warmup),
epoch e >= 1 at initial_lr * alpha^(e-1). Keras applies it per epoch; here it
is a function of the optimizer step, parameterized by steps_per_epoch.
"""

from __future__ import annotations

import numpy as np


def reference_lr_schedule(initial_lr: float, alpha: float, steps_per_epoch: int):
    """Step-indexed schedule reproducing the reference's per-epoch values;
    ``schedule(step)`` takes the step count before the update, a host int.
    The decay is computed in float32, as the JAX package's schedule does
    (alpha rounded to float32 moves the rate by 1e-6 of itself after a
    hundred epochs)."""

    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        if epoch < 1:
            return float(np.float32(initial_lr) * np.float32(0.1))
        return float(np.float32(initial_lr) * np.power(np.float32(alpha), np.float32(epoch - 1)))

    return schedule
