"""Pairwise heads: overlap regression and yaw-orientation correlation.

The overlap head re-designs reference generateDeltaLayerConv1NetworkHead
(generateNet.py:64-116), the orientation head generateCorrelationHead
(generateNet.py:327-354). Layer names c_conv1..3 / overlap_output are the
checkpoint schema. Feature volumes come in as (B, W', C).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from overlapnet_torch.core.config import ModelConfig
from overlapnet_torch.core.leg_specs import leg_output_width
from overlapnet_torch.kernels.delta_conv1 import delta_conv1
from overlapnet_torch.models.legs import Conv2d, Dense, torch_dtype
from overlapnet_torch.ops.correlation import circular_correlation


class DeltaConv1OverlapHead(nn.Module):
    """Overlap in [0, 1] from two (B, W', C) feature volumes.

    Fused delta + c_conv1 (linear) -> c_conv2 SxS-grid ReLU conv -> c_conv3
    3x3 ReLU conv -> NHWC flatten -> Linear(1) sigmoid ('overlap_output').

    c_conv1 always goes through ``kernels.delta_conv1``: the CUDA kernel for
    a CUDA tensor, its plain PyTorch version for a CPU tensor.
    ``ModelConfig.delta_head_impl`` is not read: its default 'xla' relied on
    a compiler fusing the abs-diff into the conv, which eager PyTorch lacks.
    """

    def __init__(self, cfg: ModelConfig, in_channels: int):
        super().__init__()
        s = cfg.conv1_network_head_conv1size
        self.stride = s
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        j = leg_output_width(cfg) // s
        self.c_conv1 = Conv2d(in_channels, 64, (1, s))  # weight (F, C, 1, S)
        self.c_conv2 = Conv2d(64, 128, (s, 1), (s, 1))
        self.c_conv3 = Conv2d(128, 256, (3, 3))
        self.overlap_output = Dense((j - 2) * (j - 2) * 256, 1)

    def forward(self, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        kernel = self.c_conv1.weight[:, :, 0, :].permute(2, 1, 0)  # (S, C, F)
        x = delta_conv1(
            fa.to(self.compute_dtype), fb.to(self.compute_dtype),
            kernel, self.c_conv1.bias, stride=self.stride,
        )  # (B, W', J, F) float32
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # NCHW
        x = F.relu(self.c_conv2(x))
        x = F.relu(self.c_conv3(x))
        # The Dense's rows follow an NHWC flatten in the JAX package.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()
        return torch.sigmoid(self.overlap_output(x))  # (B, 1)


class CorrelationHead(nn.Module):
    """Yaw-orientation logits: circular cross-correlation over all W' shifts,
    peak centered at bin W'//2. Parameter-free, except in 'cosine' mode:
    each volume is zero-centered and divided by its Frobenius norm, and the
    correlation is multiplied by a learnable ``logit_scale`` (init 10)."""

    def __init__(self, cfg: ModelConfig, in_channels: int | None = None):
        super().__init__()
        self.cfg = cfg
        if cfg.correlation_normalize == "cosine":
            self.logit_scale = nn.Parameter(torch.tensor(10.0))

    def forward(self, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        mode = self.cfg.correlation_normalize
        method = self.cfg.correlation_method
        if mode == "cosine":
            def center_norm(x):
                x = x - torch.mean(x, dim=(-2, -1), keepdim=True)
                n = torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
                return x / torch.where(n > 0, n, torch.ones_like(n))

            return self.logit_scale * circular_correlation(
                center_norm(fa), center_norm(fb), normalize="none", method=method
            )
        return circular_correlation(fa, fb, normalize=mode, method=method)
