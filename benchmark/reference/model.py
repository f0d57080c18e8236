"""Plain PyTorch reference of the OverlapNet model, float32.

Written from the architecture (reference generateNet.py: 360OutputkLegs
:119-219, DeltaLayerConv1NetworkHead :64-116, CorrelationHead :327-354),
with no kernel, no cache and no batching trick. It imports nothing of the
program and nothing of JAX.

Parameters are a dict of tensors under the program's state_dict names and
layouts (convs OIHW, the dense (out, in)), so the benchmark hands one set of
seeded weights to both sides.

``Precision`` selects the arithmetic. ``REFERENCE`` is float32 throughout,
TF32 off for matmuls and cuDNN. ``CONTROL`` is one step below what the
program runs each part in: the legs in fp8 (e4m3, a scale per tensor,
float32 sums) where they run bfloat16; the delta layer's product, the
overlap dense and the correlation with TF32 on where they run float32 (K1
and K2 are 3xTF32, which is float32 accuracy; the correlation a float32
FFT); c_conv2 and c_conv3 in bfloat16 where they run TF32 (cuDNN's default
in PyTorch, which the program keeps).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F

FEATURES = 64  # c_conv1 filters


@dataclass(frozen=True)
class Precision:
    legs_fp8: bool = False
    heads_tf32: bool = False
    head_convs_bf16: bool = False


REFERENCE = Precision()
CONTROL = Precision(legs_fp8=True, heads_tf32=True, head_convs_bf16=True)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for matmuls and cuDNN convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def channels_of(cfg: dict) -> int:
    """C = depth + 3 normals + 20 class probabilities (3 with PCA) +
    intensity, as the reference's training.py:162-176 counts them."""
    c = int(bool(cfg.get("use_depth", True))) + 3 * int(bool(cfg.get("use_normals", True)))
    if cfg.get("use_class_probabilities", False):
        c += 3 if cfg.get("use_class_probabilities_pca", False) else 20
    return c + int(bool(cfg.get("use_intensity", False)))


LEG_SPECS = [("s_conv1", 16, (5, 15), (2, 2)), ("s_conv2", 32, (3, 15), (2, 1)),
             ("s_conv3", 64, (3, 15), (2, 1)), ("s_conv3a", 64, (3, 12), (2, 1)),
             ("s_conv4", 128, (2, 9), (2, 1)), ("s_conv5", 128, (1, 9), (1, 1)),
             ("s_conv6", 128, (1, 9), (1, 1)), ("s_conv7", 128, (1, 9), (1, 1)),
             ("s_conv8", 128, (1, 7), (1, 1)), ("s_conv9", 128, (1, 5), (1, 1)),
             ("s_conv10", 128, (1, 3), (1, 1))]


def geometry(cfg: dict) -> dict:
    """Input height and width, channels, leg output width W', head stride S
    and the overlap grid J = W' // S."""
    h, w = (int(v) for v in cfg["model"]["inputShape"])
    c = channels_of(cfg)
    hh, ww = h, w
    for _, _, (kh, kw), (sh, sw) in LEG_SPECS:
        hh, ww = (hh - kh) // sh + 1, (ww - kw) // sw + 1
    if hh != 1:
        raise ValueError(f"the legs leave height {hh}, not 1, for input height {h}")
    s = int(cfg["model"].get("conv1NetworkHead_conv1size", 15))
    return {"height": h, "width": w, "channels": c, "out_width": ww, "stride": s,
            "grid": ww // s}


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every parameter, in the program's state_dict order."""
    g = geometry(cfg)
    shapes, cin = {}, g["channels"]
    for name, f, (kh, kw), _ in LEG_SPECS:
        shapes[f"legs.{name}.weight"] = (f, cin, kh, kw)
        shapes[f"legs.{name}.bias"] = (f,)
        cin = f
    s, j = g["stride"], g["grid"]
    shapes.update({
        "overlap_head.c_conv1.weight": (FEATURES, cin, 1, s),
        "overlap_head.c_conv1.bias": (FEATURES,),
        "overlap_head.c_conv2.weight": (128, FEATURES, s, 1),
        "overlap_head.c_conv2.bias": (128,),
        "overlap_head.c_conv3.weight": (256, 128, 3, 3),
        "overlap_head.c_conv3.bias": (256,),
        "overlap_head.overlap_output.weight": (1, (j - 2) * (j - 2) * 256),
        "overlap_head.overlap_output.bias": (1,),
    })
    return shapes


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per tensor (amax to 448),
    back in float32; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def legs(params: dict, x: torch.Tensor, prec: Precision = REFERENCE) -> torch.Tensor:
    """(B, H, W, C) range images -> (B, W', 128) feature volumes: eleven
    VALID convolutions, each followed by ReLU."""
    x = x.float().permute(0, 3, 1, 2)
    with tf32(False):
        for name, _, _, stride in LEG_SPECS:
            w, b = params[f"legs.{name}.weight"], params[f"legs.{name}.bias"]
            if prec.legs_fp8:
                x, w = fp8(x), fp8(w)
            x = F.relu(F.conv2d(x, w, b, stride=stride))
    return x[:, :, 0, :].permute(0, 2, 1)


def delta_conv1(fa: torch.Tensor, fb: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                block: int = 8) -> torch.Tensor:
    """The delta layer and c_conv1: out[b, i, j, f] = bias[f] + sum_{k, c}
    W[f, c, 0, k] |fa[b, i, c] - fb[b, S j + k, c]|, (B, W', J, 64)."""
    bsz, w, c = fa.shape
    s = weight.shape[-1]
    j = w // s
    wmat = weight[:, :, 0, :].permute(2, 1, 0).reshape(s * c, -1)  # row k * C + c
    right = fb[:, : j * s, :].reshape(bsz, 1, j, s * c)
    rows = []
    for i0 in range(0, w, block):
        left = fa[:, i0 : i0 + block, :].repeat(1, 1, s)[:, :, None, :]  # (B, T, 1, S*C)
        rows.append(torch.matmul(torch.abs(left - right), wmat))
    return torch.cat(rows, dim=1) + bias


def correlation(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """Orientation logits (B, W'): out[b, s] = sum_{w, c} fa[b, (s + w -
    W'//2) mod W', c] fb[b, w, c], summed directly over the W' x W' products."""
    w = fa.shape[1]
    prod = torch.matmul(fa, fb.transpose(1, 2))  # (B, W', W'): [b, i, w]
    s = torch.arange(w, device=fa.device)
    rows = (s[:, None] + s[None, :] - w // 2) % w  # [s, w] -> i
    return prod[:, rows, s[None, :].expand(w, w)].sum(dim=-1)


def overlap(params: dict, fa: torch.Tensor, fb: torch.Tensor,
            prec: Precision = REFERENCE) -> torch.Tensor:
    """The overlap head, (B,), of left volumes ``fa`` and right volumes
    ``fb``."""
    p = "overlap_head."
    with tf32(prec.heads_tf32):
        x = delta_conv1(fa, fb, params[p + "c_conv1.weight"], params[p + "c_conv1.bias"])
        s = params[p + "c_conv2.weight"].shape[2]
        x = x.permute(0, 3, 1, 2)  # (B, 64, W', J)
        dt = torch.bfloat16 if prec.head_convs_bf16 else torch.float32

        def conv(x, name, **kw):
            w, b = params[p + name + ".weight"], params[p + name + ".bias"]
            return F.relu(F.conv2d(x.to(dt), w.to(dt), b.to(dt), **kw)).float()

        x = conv(conv(x, "c_conv2", stride=(s, 1)), "c_conv3")
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        logit = F.linear(x, params[p + "overlap_output.weight"], params[p + "overlap_output.bias"])
        return torch.sigmoid(logit).reshape(-1)


def heads(params: dict, fa: torch.Tensor, fb: torch.Tensor, prec: Precision = REFERENCE):
    """(overlap (B,), orientation logits (B, W')) of left volumes ``fa`` and
    right volumes ``fb``."""
    with tf32(prec.heads_tf32):
        return overlap(params, fa, fb, prec), correlation(fa, fb)
