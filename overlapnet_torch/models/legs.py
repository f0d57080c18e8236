"""Siamese legs: the per-scan descriptor encoder.

An 11-conv VALID/ReLU stack (reference generateNet.generate360OutputkLegs,
generateNet.py:119-219) that maps one (64, W, C) range image to a (W', 128)
feature volume, one 128-dim descriptor per yaw bin (W' = 360 for W = 900).
Layer names s_conv1..s_conv10 (+ s_conv3a) are the checkpoint schema.

Images come in as (B, H, W, C), as in the JAX package, and are permuted to
NCHW inside. Parameters stay float32; the convs run in ``leg_dtype``
(bfloat16 by default) and the output is float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from overlapnet_torch.core.config import ModelConfig
from overlapnet_torch.core.leg_specs import (  # noqa: F401  (re-exported)
    conv_specs,
    leg_output_height,
    leg_output_width,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"Unknown dtype {name!r}; known: {sorted(_DTYPES)}") from None


class Conv2d(nn.Module):
    """VALID conv with float32 parameters, computed in the input's dtype.

    ``weight`` is OIHW (the JAX package stores HWIO; ``weights.py``
    converts)."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int],
                 stride: tuple[int, int] = (1, 1)):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = tuple(stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        stride=self.stride)


class Dense(nn.Module):
    """Linear layer with a (out, in) ``weight`` (the JAX package stores
    (in, out); ``weights.py`` converts)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class SiameseLegs(nn.Module):
    """Shared-weight conv encoder; apply to each scan of a pair.

    Input (B, H, W, C); output (B, W', 128) float32 with the height-1 axis
    squeezed (raises if the input height does not collapse to 1).
    """

    def __init__(self, cfg: ModelConfig, num_channels: int):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.leg_dtype or cfg.compute_dtype)
        self.circular = cfg.leg_padding == "circular"
        cin = num_channels
        for name, features, kernel, strides in conv_specs(cfg):
            self.add_module(name, Conv2d(cin, features, kernel, strides))
            cin = features
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)  # NCHW
        for conv in self.children():
            kw = conv.weight.shape[-1]
            if self.circular and kw > 1:
                # Wrap-pad the width (the image is a 360-degree panorama) so
                # the feature space stays exactly periodic (W' = W/stride).
                x = torch.cat([x, x[..., : kw - 1]], dim=3)
            x = F.relu(conv(x))
        if x.shape[2] != 1:
            raise ValueError(
                f"Leg output height is {x.shape[2]}, expected 1 "
                f"(input {self.cfg.input_height} rows)"
            )
        # Feature volumes are float32 downstream (DB rows, correlation, delta
        # head): only the conv stack runs in the reduced dtype.
        return x[:, :, 0, :].permute(0, 2, 1).float()  # (B, W', C)
