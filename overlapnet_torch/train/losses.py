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

On a mesh of several ranks (``combined_loss(mesh=...)``) each rank forms its
share of the GLOBAL batch's loss, as the JAX package's loss is under GSPMD:
every mean over the batch becomes the local sum over the global batch size,
and the masked orientation mean divides by the count of unmasked pairs over
all ranks. The shares, and their gradients, sum over the ranks to the global
batch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from overlapnet_torch.parallel.mesh import Mesh, all_reduce_sum


def sigmoid_overlap_loss(
    pred: torch.Tensor, target: torch.Tensor, global_batch: int | None = None
) -> torch.Tensor:
    """Mean sigmoid-shaped overlap regression loss (training.py:71-83).

    Args:
      pred: (B,) or (B, 1) predicted overlap in [0, 1].
      target: (B,) true overlap.
      global_batch: the batch over all ranks when these B pairs are one
        rank's block: the sum is divided by it instead of B.
    """
    diff = torch.abs(pred.reshape(target.shape) - target)
    loss = torch.sigmoid((diff + 0.25) * 24.0 - 12.0)
    return torch.mean(loss) if global_batch is None else torch.sum(loss) / global_batch


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
    global_batch: int | None = None,
    mask_total: torch.Tensor | None = None,
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

    For one rank's block of a global batch: ``global_batch`` divides the
    unmasked sum, ``mask_total`` (the count of marked pairs over all ranks,
    a 0-d tensor) the masked one.
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
        count = torch.sum(m) if mask_total is None else mask_total
        return torch.sum(per_pair * m) / torch.clamp(count, min=1.0)
    if global_batch is None:
        return torch.mean(loss)
    return torch.sum(loss) / (global_batch * loss.shape[-1])


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
    mesh: Mesh | None = None,
):
    """Total loss = 5 * overlap + 1 * orientation (training.py:257).

    ``mask_zero_orientation`` restricts the orientation CE to pairs whose
    overlap exceeds the yaw-label threshold (min_overlap_for_angle, or
    soft_overlap_min when the soft ramp is active); reference parity =
    False (training.py:86-92 averages over all).

    With a ``mesh`` of more than one rank the inputs are this rank's block of
    the global batch and the values are its share of the global loss (see
    the module docstring); the count of unmasked pairs is all-reduced on the
    device, with no host read. With no mesh or a mesh of one rank the values
    are formed exactly as without.

    Returns (total, {"loss", "overlap_loss", "orientation_loss"})."""
    ranks = 1 if mesh is None else mesh.size
    global_batch = overlap_true.shape[0] * ranks if ranks > 1 else None
    l_overlap = sigmoid_overlap_loss(overlap_pred, overlap_true, global_batch)
    soft = 0.0 <= soft_overlap_min < min_overlap_for_angle
    mask_thr = soft_overlap_min if soft else min_overlap_for_angle
    pair_mask = overlap_true > mask_thr if mask_zero_orientation else None
    mask_total = None
    if pair_mask is not None and ranks > 1:
        mask_total = all_reduce_sum(mesh, torch.sum(pair_mask.to(orientation_logits.dtype)))
    l_orient = weighted_orientation_entropy(
        orientation_logits,
        orientation_target_vec,
        pos_weight,
        min_overlap_for_angle,
        pair_mask=pair_mask,
        soft_overlap_min=soft_overlap_min,
        global_batch=global_batch,
        mask_total=mask_total,
    )
    total = overlap_weight * l_overlap + orientation_weight * l_orient
    return total, {"loss": total, "overlap_loss": l_overlap, "orientation_loss": l_orient}
