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
- ``delta_conv1_backward``: its gradients written out, the plain version of
  the backward CUDA kernel (K2).
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
      (B, W, W//S, F) float32 (float64 for float64 volumes). Columns of ``b``
      past (W//S)*S get no weight.
    """
    bsz, w, c = a.shape
    if kernel.ndim == 4:
        kernel = kernel[0]
    s, kc, f = kernel.shape
    if s != stride or kc != c:
        raise ValueError(f"kernel {tuple(kernel.shape)} vs stride {stride}, C {c}")
    j = w // s
    # float32, as the kernel computes; float64 inputs stay float64 (references)
    dtype = torch.float64 if a.dtype == torch.float64 else torch.float32
    a = a.to(dtype)
    b_r = b.to(dtype)[:, : j * s, :].reshape(bsz, 1, j, s * c)
    wmat = kernel.to(dtype).reshape(s * c, f)
    out = torch.empty((bsz, w, j, f), dtype=dtype, device=a.device)
    for i0 in range(0, w, block):
        a_blk = a[:, i0 : i0 + block, :].repeat(1, 1, s)  # (B, T, S*C)
        diff = torch.abs(a_blk[:, :, None, :] - b_r)  # (B, T, J, S*C)
        out[:, i0 : i0 + block] = torch.matmul(diff, wmat)
    if bias is not None:
        out = out + bias.to(dtype)
    return out


def delta_conv1_backward(
    a: torch.Tensor,
    b: torch.Tensor,
    kernel: torch.Tensor,
    g: torch.Tensor,
    *,
    stride: int = 15,
    block: int = 24,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``delta_conv1`` (without the bias) for the cotangent ``g``.

    With diff = a[b, i, c] - b[b, S*j + k, c] recomputed per block of left
    rows (the (B, W, W, C) volume is never stored):

        gw  = sum_f g[b, i, j, f] * W[k, c, f]
        da[b, i, c]       =  sum_{j, k} gw * sign(diff)
        db[b, S*j + k, c] = -sum_i      gw * sign(diff)
        dW[k, c, f]       =  sum_{b, i, j} |diff| * g[b, i, j, f]

    sign(0) is 0, as autograd through ``abs`` has it: equal features (two
    ReLU zeros) pass no gradient. Columns of ``b`` past (W//S)*S get zero.

    Args:
      a, b: (B, W, C); kernel: (S, C, F) or (1, S, C, F); g: (B, W, W//S, F).
      block: left rows per step; bounds peak memory at B*block*W*C.

    Returns: (da (B, W, C), db (B, W, C), dW (S, C, F)) in g's float type
    (float32, or float64 when everything comes in float64).
    """
    bsz, w, c = a.shape
    if kernel.ndim == 4:
        kernel = kernel[0]
    s, kc, f = kernel.shape
    j = w // s
    if s != stride or kc != c or tuple(g.shape) != (bsz, w, j, f):
        raise ValueError(
            f"kernel {tuple(kernel.shape)}, g {tuple(g.shape)} vs stride {stride}, "
            f"a {tuple(a.shape)}"
        )
    dtype = torch.float64 if g.dtype == torch.float64 else torch.float32
    a, b, g = a.to(dtype), b.to(dtype), g.to(dtype)
    wmat = kernel.to(dtype).reshape(s * c, f)
    b_r = b[:, : j * s, :].reshape(bsz, 1, j, s * c)
    da = torch.empty_like(a)
    db_r = torch.zeros((bsz, j, s * c), dtype=dtype, device=a.device)
    dw = torch.zeros((s * c, f), dtype=dtype, device=a.device)
    for i0 in range(0, w, block):
        a_blk = a[:, i0 : i0 + block, :].repeat(1, 1, s)  # (B, T, S*C)
        g_blk = g[:, i0 : i0 + block]  # (B, T, J, F)
        diff = a_blk[:, :, None, :] - b_r  # (B, T, J, S*C)
        gd = torch.matmul(g_blk, wmat.T) * torch.sign(diff)
        da[:, i0 : i0 + block] = gd.sum(dim=2).reshape(bsz, -1, s, c).sum(dim=2)
        db_r -= gd.sum(dim=1)
        dw += torch.matmul(diff.abs_().reshape(-1, s * c).T, g_blk.reshape(-1, f))
    db = torch.zeros_like(b)
    db[:, : j * s, :] = db_r.reshape(bsz, j * s, c)
    return da, db, dw.reshape(s, c, f)
