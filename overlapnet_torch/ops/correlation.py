"""Circular cross-correlation over yaw shifts (the orientation head's op).

With pad = W//2 the orientation logits are

    out[b, s] = sum_{w, c} a[b, (s + w - W//2) mod W, c] * b[b, w, c]

a circular cross-correlation with the zero-shift peak moved to the center
bin W//2, which is why inference reads ``yaw = W//2 - argmax`` (reference
infer.py:158). Feature volumes are (B, W, C), as in the JAX package.

- 'fft'  : rfft along the shift axis, channel sum in frequency space, one
           irfft of length W per sample, then a roll by W//2.
- 'conv' : one grouped 1-D convolution; each sample's right volume is its
           group's kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def wrap_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Width-wise wrap pad to width 2W-1: [x[pad:], x, x[:pad-1]]
    (pad([1 2 3 4], 2) -> [3 4 1 2 3 4 1]).

    Args:
      x: (..., W, C)
    """
    return torch.cat([x[..., pad:, :], x, x[..., : pad - 1, :]], dim=-2)


def _normalize(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Feature-volume normalization variants
    (reference NormalizedCorrelation2D.py:55-73). Production uses 'none'."""
    if mode == "none":
        return x
    if mode == "euclidean":
        norm = torch.linalg.vector_norm(x, dim=-2, keepdim=True)
        return x / torch.where(norm > 0, norm, torch.ones_like(norm))
    if mode == "scaling":
        x_min = torch.amin(x, dim=-2, keepdim=True)
        x_max = torch.amax(x, dim=-2, keepdim=True)
        return (x - x_min) / (x_max - x_min + 1e-6)
    if mode == "standardization":
        x = x - torch.mean(x, dim=-2, keepdim=True) + 1e-5
        norm = torch.linalg.vector_norm(x, dim=-2, keepdim=True)
        return x / torch.where(norm > 0, norm, torch.ones_like(norm))
    raise ValueError(f"Unknown correlation normalization: {mode!r}")


def _circular_correlation_fft(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    w = a.shape[-2]
    fa = torch.fft.rfft(a.float(), dim=-2)
    fb = torch.fft.rfft(b.float(), dim=-2)
    spec = torch.sum(fa * torch.conj(fb), dim=-1)  # channel sum in freq space
    corr = torch.fft.irfft(spec, n=w, dim=-1)
    # corr[k] = sum_w a[(w + k) mod W] * b[w]; the padded-conv indexing is
    # out[s] = corr[(s - W//2) mod W] => roll by +W//2.
    return torch.roll(corr, w // 2, dims=-1)


def _circular_correlation_conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Grouped-conv formulation: batch*channels input channels and batch
    groups, so each sample's `b` is its group's kernel."""
    bsz, w, c = a.shape
    padded = wrap_pad(a.float(), w // 2)  # (B, 2W-1, C)
    lhs = padded.permute(0, 2, 1).reshape(1, bsz * c, 2 * w - 1)
    rhs = b.float().permute(0, 2, 1)  # (B, C, W): out-channels B, C per group
    out = F.conv1d(lhs, rhs, groups=bsz)  # (1, B, W)
    return out.reshape(bsz, w)


def _take(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(logits, -1, idx.unsqueeze(-1)).squeeze(-1)


def subbin_peak(logits: torch.Tensor) -> torch.Tensor:
    """Sub-bin peak position of (..., W) correlation logits.

    Fits a parabola through the argmax bin and its two circular neighbours
    and returns argmax + vertex offset (float32, offset clipped to
    [-0.5, 0.5]).
    """
    w = logits.shape[-1]
    i = torch.argmax(logits, dim=-1)
    p = _take(logits, i)
    left = _take(logits, (i - 1) % w)
    right = _take(logits, (i + 1) % w)
    denom = left - 2.0 * p + right
    safe = torch.where(denom.abs() > 1e-12, denom, torch.ones_like(denom))
    offset = torch.where(
        denom.abs() > 1e-12, 0.5 * (left - right) / safe, torch.zeros_like(denom)
    )
    offset = torch.clamp(offset, -0.5, 0.5)
    return i.float() + offset.float()


def flip_margin(logits: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Antipodal ambiguity margin of (..., W) correlation logits, in [0, 1]:
    (peak - anti) / (peak - min), with ``anti`` the strongest bin within
    ``window`` bins of the antipode (peak + W//2)."""
    w = logits.shape[-1]
    i = torch.argmax(logits, dim=-1)
    peak = torch.amax(logits, dim=-1)
    offs = torch.arange(-window, window + 1, device=logits.device)
    anti_idx = torch.remainder(i.unsqueeze(-1) + w // 2 + offs, w)
    anti = torch.amax(torch.gather(logits, -1, anti_idx), dim=-1)
    lo = torch.amin(logits, dim=-1)
    return (peak - anti) / torch.clamp(peak - lo, min=1e-12)


def peak_margin(logits: torch.Tensor, guard: int = 8) -> torch.Tensor:
    """Secondary-peak margin of (..., W) correlation logits, in [0, 1]: the
    margin of the peak over the strongest bin at circular distance > ``guard``
    bins, normalized by the curve's dynamic range."""
    w = logits.shape[-1]
    i = torch.argmax(logits, dim=-1)
    peak = torch.amax(logits, dim=-1)
    idx = torch.arange(w, device=logits.device)
    raw = torch.abs(idx - i.unsqueeze(-1))
    dist = torch.minimum(raw, w - raw)
    masked = torch.where(
        dist > guard, logits, torch.full_like(logits, -float("inf"))
    )
    second = torch.amax(masked, dim=-1)
    lo = torch.amin(logits, dim=-1)
    return torch.clamp(
        (peak - second) / torch.clamp(peak - lo, min=1e-12), 0.0, 1.0
    )


def yaw_confidence(logits: torch.Tensor, guard: int = 8) -> torch.Tensor:
    """Ambiguity-aware yaw confidence: softmax peak mass x secondary-peak
    margin."""
    peak_mass = torch.amax(torch.softmax(logits, dim=-1), dim=-1)
    return peak_mass * peak_margin(logits, guard)


def circular_correlation(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    normalize: str = "none",
    method: str = "fft",
) -> torch.Tensor:
    """Orientation logits: correlation of two (B, W, C) feature volumes over
    all W circular shifts, peak centered at bin W//2.

    Returns (B, W) float32 logits.
    """
    a = _normalize(a, normalize)
    b = _normalize(b, normalize)
    if method == "fft":
        return _circular_correlation_fft(a, b)
    if method == "conv":
        return _circular_correlation_conv(a, b)
    raise ValueError(f"Unknown correlation method: {method!r}")
