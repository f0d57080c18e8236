"""Delta op: all-pairs |a_i - b_j| feature differences + first overlap conv.

The reference's DeltaLayer tiles both 1x360x128 feature volumes into a
360x360x128 tensor of absolute differences (reference generateNet.py:15-61)
and applies ``c_conv1``, a *linear* 1x15, stride (1,15) convolution
(generateNet.py:96-100). Because c_conv1 is linear with stride == kernel
width, the pair is exactly

    out[b, i, j, f] = sum_{k, c} W[k, c, f] * |a[b, i, c] - b[b, S*j + k, c]|

- ``delta_conv1``: i-blocked abs-diff + contraction in plain PyTorch. It is
  the plain version of the CUDA kernel in ``kernels/delta_conv1.py``: the
  CPU path and the reference the kernel is held to on the card.
- ``delta_volume``: the materialized semantics, for tests.
"""

from __future__ import annotations

import torch


def delta_volume(
    a: torch.Tensor, b: torch.Tensor, negate: bool = False
) -> torch.Tensor:
    """All-pairs absolute feature differences.

    Args:
      a, b: (B, W, C) feature volumes.
    Returns:
      (B, W, W, C); [b, i, j, c] = |a[b,i,c] - b[b,j,c]|.
    """
    diff = torch.abs(a[:, :, None, :] - b[:, None, :, :])
    return -diff if negate else diff


def delta_conv1(
    a: torch.Tensor,
    b: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 15,
    block: int = 24,
) -> torch.Tensor:
    """Fused DeltaLayer + c_conv1 (linear, 1xS kernel, (1,S) stride).

    Args:
      a, b: (B, W, C) left/right feature volumes.
      kernel: (1, S, C, F) HWIO conv kernel (or (S, C, F)).
      bias: (F,) or None.
      stride: S, the conv1 width/stride.
      block: left rows per step; bounds peak memory at B*block*W*C.

    Returns:
      (B, W, W//S, F) float32. Columns of ``b`` past (W//S)*S get no weight.
    """
    bsz, w, c = a.shape
    if kernel.ndim == 4:
        kernel = kernel[0]
    s, kc, f = kernel.shape
    if s != stride or kc != c:
        raise ValueError(f"kernel {tuple(kernel.shape)} vs stride {stride}, C {c}")
    j = w // s
    a = a.float()
    b_r = b.float()[:, : j * s, :].reshape(bsz, 1, j, s * c)
    wmat = kernel.float().reshape(s * c, f)
    out = torch.empty((bsz, w, j, f), dtype=torch.float32, device=a.device)
    for i0 in range(0, w, block):
        a_blk = a[:, i0 : i0 + block, :].repeat(1, 1, s)  # (B, T, S*C)
        diff = torch.abs(a_blk[:, :, None, :] - b_r)  # (B, T, J, S*C)
        out[:, i0 : i0 + block] = torch.matmul(diff, wmat)
    if bias is not None:
        out = out + bias.float()
    return out
