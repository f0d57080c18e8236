"""Plain reference of one OverlapNet training step, float32.

The reference's training.py: the overlap loss (:71-83), the weighted
orientation cross entropy against a one-hot target that is the pair's
overlap at its yaw bin, binarized at ``min_overlap_for_angle`` (:86-92,
ImagePairOverlapOrientationSequence.py:118-123), their 5:1 sum (:255-259),
and Keras' Adagrad (:253: ``acc += g*g; p -= lr * g / sqrt(acc + 1e-7)``)
under the per-epoch schedule (:47-57: epoch 0 at a tenth of the rate, epoch
e at lr * alpha^(e-1)). The yaw target sits where the correlation peak of a
pair with that yaw lands: 1.25 bins per degree on the 900-column panorama
(``yaw_space: calibrated``), the bin itself with ``yaw_space: reference``.
Gradients come from autograd through ``reference.model``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import model as ref

ADAGRAD_EPS = 1e-7


def learning_rate(cfg: dict, step: int, steps_per_epoch: int) -> float:
    lr, alpha = float(cfg.get("learning_rate", 0.001)), float(cfg.get("lr_alpha", 0.99))
    epoch = step // steps_per_epoch
    if epoch < 1:
        return float(np.float32(lr) * np.float32(0.1))
    return float(np.float32(lr) * np.power(np.float32(alpha), np.float32(epoch - 1)))


def target_bins(bins: torch.Tensor, cfg: dict) -> torch.Tensor:
    w = ref.geometry(cfg)["out_width"]
    if cfg["model"].get("yaw_space", "calibrated") == "reference":
        return bins.long()
    yaw_deg = (w // 2 - bins.float()) * (360.0 / w)
    per_degree = ref.geometry(cfg)["width"] / (360.0 * 2)
    return torch.remainder(w // 2 - torch.round(per_degree * yaw_deg).long(), w)


def loss(cfg: dict, overlap_pred, logits, overlap, yaw_bins) -> torch.Tensor:
    w = logits.shape[-1]
    over = torch.sigmoid((torch.abs(overlap_pred - overlap) + 0.25) * 24.0 - 12.0).mean()
    target = F.one_hot(target_bins(yaw_bins, cfg), w).float() * overlap[:, None]
    z = (target > float(cfg.get("min_overlap_for_angle", 0.7))).float()
    per = (1.0 - z) * logits + (1.0 + (w - 1.0) * z) * (
        torch.log1p(torch.exp(-logits.abs())) + F.relu(-logits))
    return 5.0 * over + 1.0 * per.mean()


def step_loss(cfg, params, x1, x2, overlap, yaw_bins, prec=ref.REFERENCE):
    """The loss of one batch (its mean over the batch's pairs)."""
    n = x1.shape[0]
    vol = ref.legs(params, torch.cat([x1, x2]), prec)
    o, logits = ref.heads(params, vol[:n], vol[n:], prec)
    return loss(cfg, o, logits, overlap, yaw_bins)


def loss_and_grads(cfg, params, x1, x2, overlap, yaw_bins, prec=ref.REFERENCE, keep=None,
                   micro: int = 16):
    """The batch's loss and gradients, formed ``micro`` pairs at a time (the
    loss is a mean over pairs, so the parts weighted by their share sum to
    it) to bound the memory autograd keeps. ``keep``, when given, takes the
    mean over that many leading pairs only (a fault the check has to
    catch)."""
    n = x1.shape[0] if keep is None else keep
    total, grads = 0.0, None
    for s in range(0, n, micro):
        e = min(n, s + micro)
        part = step_loss(cfg, params, x1[s:e], x2[s:e], overlap[s:e], yaw_bins[s:e],
                         prec) * ((e - s) / n)
        g = torch.autograd.grad(part, list(params.values()))
        grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
        total += float(part.detach())
    return total, grads


def run_steps(cfg: dict, params: dict, batches, steps_per_epoch: int,
              prec=ref.REFERENCE, keep=None):
    """Adagrad steps from ``params`` (copied) over ``batches`` of (x1, x2,
    overlap, yaw_bin) device tensors. Returns (losses, the first step's
    gradients, the parameters after the last step)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    acc = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    for step, (x1, x2, overlap, bins) in enumerate(batches):
        total, grads = loss_and_grads(cfg, p, x1, x2, overlap, bins, prec, keep)
        losses.append(total)
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(p, grads)}
        lr = learning_rate(cfg, step, steps_per_epoch)
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                acc[k] += g * g
                upd = torch.where(acc[k] > 0, torch.rsqrt(acc[k] + ADAGRAD_EPS), 0.0)
                v -= lr * g * upd
    return losses, first, {k: v.detach() for k, v in p.items()}
