"""Full siamese two-head model and its leg/head factorization.

Re-design of reference generateSiameseNetworkTemplate (generateNet.py:357-396)
and the leg/head split used by serving (reference infer.py:95-111): the legs
encode each scan once into a (W', 128) feature volume; the heads score pairs
of cached feature volumes.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from overlapnet_torch.core.config import ModelConfig
from overlapnet_torch.core.device import resolve_device
from overlapnet_torch.core.profiling import count, span
from overlapnet_torch.core.registry import HEADS, LEGS, MODELS
from overlapnet_torch.models.heads import CorrelationHead, DeltaConv1OverlapHead
from overlapnet_torch.models.legs import SiameseLegs

LEGS.register("360OutputkLegs", SiameseLegs)
LEGS.register("360OutputkLegsFixed", SiameseLegs)
HEADS.register("DeltaLayerConv1NetworkHead", DeltaConv1OverlapHead)
HEADS.register("CorrelationHead", CorrelationHead)


class OverlapNet(nn.Module):
    """Siamese two-head network.

    forward(x1, x2) -> (overlap (B, 1), orientation logits (B, W')).
    ``encode`` / ``score`` are the leg/head factorization on the same
    parameters.
    """

    def __init__(self, cfg: ModelConfig, num_channels: int):
        super().__init__()
        self.cfg = cfg
        self.legs = LEGS.get(cfg.legs_type)(cfg, num_channels)
        c = self.legs.out_channels
        self.overlap_head = HEADS.get(cfg.overlap_head)(cfg, c)
        self.orientation_head = HEADS.get(cfg.orientation_head)(cfg, c)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """One leg: (B, H, W, C) range image -> (B, W', 128) feature volume."""
        with span("model.legs"):
            count("model.scans", x.shape[0])
            return self.legs(x)

    def score(self, fa: torch.Tensor, fb: torch.Tensor, stop_gradient: bool | None = None):
        """Heads on cached feature volumes -> (overlap, orientation logits).
        ``stop_gradient`` overrides ``cfg.correlation_stop_gradient`` (the
        trainer lifts it from ``correlation_release_epoch`` on)."""
        if self.cfg.correlation_stop_gradient if stop_gradient is None else stop_gradient:
            # Train the legs through the overlap loss only; yaw comes from
            # correlating overlap-learned features.
            ga, gb = fa.detach(), fb.detach()
        else:
            ga, gb = fa, fb
        with span("model.heads", device=fa.is_cuda):
            count("model.head_calls")
            count("model.pairs", fa.shape[0])
            return self.overlap_head(fa, fb), self.orientation_head(ga, gb)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, stop_gradient: bool | None = None):
        return self.score(self.encode(x1), self.encode(x2), stop_gradient)


MODELS.register("SiameseNetworkTemplate", OverlapNet)


def _fans(weight: torch.Tensor) -> tuple[int, int]:
    """(fan_in, fan_out) as the JAX package's initializers count them:
    receptive field x in / out channels."""
    cout, cin = weight.shape[:2]
    field = math.prod(weight.shape[2:])
    return cin * field, cout * field


def reset_parameters(model: OverlapNet, seed: int = 0) -> OverlapNet:
    """Seeded init with the JAX package's distributions: legs lecun-normal
    (truncated normal, variance 1/fan_in), head convs and the dense
    glorot-uniform, biases zero, ``logit_scale`` 10. The numbers differ from
    the JAX package's (another generator); the distributions match."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.endswith("logit_scale"):
                p.fill_(10.0)
            elif name.startswith("legs."):
                fan_in, _ = _fans(p)
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                p.copy_(torch.nn.init.trunc_normal_(
                    torch.empty(p.shape), std=std, a=-2 * std, b=2 * std,
                    generator=g,
                ))
            else:
                fan_in, fan_out = _fans(p)
                limit = math.sqrt(6.0 / (fan_in + fan_out))
                p.copy_(torch.empty(p.shape).uniform_(-limit, limit, generator=g))
    return model


def build_model(
    cfg: ModelConfig, num_channels: int, seed: int = 0, device="cuda"
) -> OverlapNet:
    """The model for ``cfg`` with seeded parameters, on ``device`` ("cuda" by
    default; raises if no card is visible)."""
    device = resolve_device(device)
    model = MODELS.get(cfg.model_type)(cfg, num_channels)
    return reset_parameters(model, seed).to(device)


def init_params(
    cfg: ModelConfig, num_channels: int, seed: int = 0
) -> dict[str, torch.Tensor]:
    """A seeded parameter set (CPU ``state_dict``) for the full model."""
    return build_model(cfg, num_channels, seed, device="cpu").state_dict()

