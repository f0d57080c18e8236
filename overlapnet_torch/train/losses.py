"""Training losses.

Exact functional equivalents of the reference's two losses
(reference: training.py:71-92) and their 5:1 combination
(training.py:255-259):

- overlap: mean sigmoid of the absolute error,
  ``mean(1 / (1 + exp(-((|y_hat - y| + 0.25) * 24 - 12))))``
- orientation: ``tf.nn.weighted_cross_entropy_with_logits`` with
  pos_weight = network_output_size (360), against a target vector that is
  zero except target[yaw_bin] = overlap, binarized at
  min_overlap_for_angle (training.py:42-43, 86-92;
  ImagePairOverlapOrientationSequence.py:118-123).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_overlap_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid-shaped overlap regression loss (training.py:71-83).

    Args:
      pred: (B,) or (B, 1) predicted overlap in [0, 1].
      target: (B,) true overlap.
    """
    diff = torch.abs(pred.reshape(target.shape) - target)
    return torch.mean(torch.sigmoid((diff + 0.25) * 24.0 - 12.0))


def orientation_target(
    yaw_bins: torch.Tensor, overlaps: torch.Tensor, output_size: int
) -> torch.Tensor:
    """Target vector: zeros except y[yaw_bin] = overlap
    (ImagePairOverlapOrientationSequence.py:118-123). A bin outside
    [0, output_size) gives an all-zero row.

    Args:
      yaw_bins: (B,) integer yaw bin per pair.
      overlaps: (B,) overlap per pair.
    Returns: (B, output_size) float32.
    """
    cols = torch.arange(output_size, device=yaw_bins.device)
    onehot = (yaw_bins.to(torch.int64)[:, None] == cols).to(torch.float32)
    return onehot * overlaps[:, None].to(torch.float32)


def weighted_orientation_entropy(
    logits: torch.Tensor,
    target: torch.Tensor,
    pos_weight: float,
    min_overlap_for_angle: float = 0.7,
    pair_mask: torch.Tensor | None = None,
    soft_overlap_min: float = -1.0,
) -> torch.Tensor:
    """Weighted cross-entropy on yaw logits (training.py:86-92).

    The target is binarized: z = (target > min_overlap_for_angle). Loss per
    element follows tf.nn.weighted_cross_entropy_with_logits in its stable
    form, (1 - z) * x + (1 + (pos_weight - 1) * z) * (log1p(exp(-|x|)) +
    relu(-x)), reduced by the mean over batch and bins.

    ``soft_overlap_min`` in [0, min_overlap_for_angle) replaces the hard
    binarization with a linear ramp z = clip((target - soft) / (hard -
    soft), 0, 1): pairs in the (soft, hard) overlap band then carry an
    overlap-proportional positive weight at their yaw bin instead of an
    all-zero target. Default -1 = reference-parity hard binarization.

    ``pair_mask`` (B,) averages only over the pairs it marks: a
    sub-threshold pair's all-zero target means "yaw unknown", not "no yaw".
    """
    if 0.0 <= soft_overlap_min < min_overlap_for_angle:
        z = torch.clamp(
            (target - soft_overlap_min) / (min_overlap_for_angle - soft_overlap_min),
            0.0, 1.0,
        ).to(logits.dtype)
    else:
        z = (target > min_overlap_for_angle).to(logits.dtype)
    x = logits
    log_weight = 1.0 + (pos_weight - 1.0) * z
    loss = (1.0 - z) * x + log_weight * (
        torch.log1p(torch.exp(-torch.abs(x))) + F.relu(-x)
    )
    if pair_mask is not None:
        per_pair = torch.mean(loss, dim=-1)
        m = pair_mask.to(loss.dtype)
        return torch.sum(per_pair * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(loss)


def combined_loss(
    overlap_pred: torch.Tensor,
    orientation_logits: torch.Tensor,
    overlap_true: torch.Tensor,
    orientation_target_vec: torch.Tensor,
    *,
    pos_weight: float,
    min_overlap_for_angle: float = 0.7,
    overlap_weight: float = 5.0,
    orientation_weight: float = 1.0,
    mask_zero_orientation: bool = False,
    soft_overlap_min: float = -1.0,
):
    """Total loss = 5 * overlap + 1 * orientation (training.py:257).

    ``mask_zero_orientation`` restricts the orientation CE to pairs whose
    overlap exceeds the yaw-label threshold (min_overlap_for_angle, or
    soft_overlap_min when the soft ramp is active); reference parity =
    False (training.py:86-92 averages over all).

    Returns (total, {"loss", "overlap_loss", "orientation_loss"})."""
    l_overlap = sigmoid_overlap_loss(overlap_pred, overlap_true)
    soft = 0.0 <= soft_overlap_min < min_overlap_for_angle
    mask_thr = soft_overlap_min if soft else min_overlap_for_angle
    pair_mask = overlap_true > mask_thr if mask_zero_orientation else None
    l_orient = weighted_orientation_entropy(
        orientation_logits,
        orientation_target_vec,
        pos_weight,
        min_overlap_for_angle,
        pair_mask=pair_mask,
        soft_overlap_min=soft_overlap_min,
    )
    total = overlap_weight * l_overlap + orientation_weight * l_orient
    return total, {"loss": total, "overlap_loss": l_overlap, "orientation_loss": l_orient}
