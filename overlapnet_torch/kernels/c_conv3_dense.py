"""K4: the overlap head's c_conv3 with its bias and ReLU and the overlap
dense, a hand-written CUDA kernel for Hopper.

``c_conv3_dense`` launches ``csrc/c_conv3_dense.cu`` (K4) for CUDA tensors
and runs the plain PyTorch version (``plain_c_conv3_dense``: ``F.conv2d``,
``F.relu``, the NHWC flatten, ``F.linear`` and ``torch.sigmoid``) for CPU
tensors: the tensor's device decides, nothing else. On a CUDA tensor it
launches the kernel or raises; nothing falls back to cuDNN.

c_conv3 is a 3 x 3 VALID convolution from 128 to 256 channels over K3's
output, (B, 128, J, J) as the NCHW view of channels-last memory; the dense
maps the NHWC flatten of its ReLU'd output, (J-2) (J-2) 256 values a pair,
to one logit. cuDNN ran c_conv3 as a TF32 implicit GEMM, then a bias-add
pass, PyTorch's ReLU pass and a gemv each went over its 496 KB a pair
(J = 24) again. K4 keeps that output in registers: the convolution on the
TF32 tensor cores with both operands rounded to nearest and fp32 sums
(3xTF32, float32 accuracy, where ``torch.backends.cudnn.allow_tf32`` is
off: K3's ``split_tf32``, the switch that set cuDNN's precision here), then
bias, ReLU and the dense's weight in its epilogue, and the sum, the dense's
bias and the sigmoid in a second small kernel. It returns the head's overlap,
(B, 1) float32.

Where autograd records the call it goes through ``CConv3DenseFunction``:
its forward is K4 (the plain version for CPU tensors); its backward
recomputes c_conv3's pre-activation with ``F.conv2d`` and takes every
gradient with plain PyTorch, as the JAX package left c_conv3's and the
dense's gradients to XLA. The counter ``k4.launches`` of ``core.profiling``
counts the calls of K4's C entry (each launching the weight's rounding, K4
and the per-pair sums): one per head call on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as nnf

from overlapnet_torch.core.profiling import count
from overlapnet_torch.kernels import build
from overlapnet_torch.kernels.c_conv2_relu import _float32, split_tf32

NAME = "c_conv3_dense"
SOURCE = "overlapnet_torch/csrc/c_conv3_dense.cu"
IN_CHANNELS = 128  # c_conv2's outputs
OUT_CHANNELS = 256
INVALID_VALUE = 1  # cudaErrorInvalidValue: sizes the kernel does not take
MAX_ELEMENTS = 2**31  # the kernel counts offsets into x in 32 bits


@functools.cache
def _entry():
    fn = build.load(NAME).c_conv3_dense_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _scratch_bytes():
    fn = build.load(NAME).c_conv3_dense_scratch_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn


def check_shapes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 dense_weight: torch.Tensor, dense_bias: torch.Tensor) -> None:
    """Raises ValueError unless K4 takes these: x (B >= 1, 128, H >= 3,
    W >= 3), weight (256, 128, 3, 3), bias (256,), dense_weight
    (1, (H-2) (W-2) 256), dense_bias (1,), all floating point, and
    B H W 128 < 2**31. The CPU version holds to the same, so both take one
    set of shapes."""
    if x.dim() != 4 or x.shape[1] != IN_CHANNELS:
        raise ValueError(f"c_conv3 takes x as (B, {IN_CHANNELS}, H, W), got {tuple(x.shape)}")
    bsz, _, h, w = x.shape
    if bsz < 1 or h < 3 or w < 3:
        raise ValueError(f"c_conv3 takes B >= 1 and H, W >= 3; got x {tuple(x.shape)}")
    shapes = {"weight": (weight, (OUT_CHANNELS, IN_CHANNELS, 3, 3)),
              "bias": (bias, (OUT_CHANNELS,)),
              "dense_weight": (dense_weight, (1, (h - 2) * (w - 2) * OUT_CHANNELS)),
              "dense_bias": (dense_bias, (1,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"c_conv3_dense's {name} must be {want}, got {tuple(t.shape)}")
    for name, t in (("x", x), *((n, t) for n, (t, _) in shapes.items())):
        if not t.is_floating_point():
            raise ValueError(f"c_conv3_dense's {name} must be floating point, not {t.dtype}")
    if bsz * h * w * IN_CHANNELS >= MAX_ELEMENTS:
        raise ValueError(f"c_conv3 takes fewer than 2**31 input elements; got x {tuple(x.shape)}")


def plain_c_conv3_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        dense_weight: torch.Tensor, dense_bias: torch.Tensor) -> torch.Tensor:
    """K4's function in plain PyTorch, the head's tail as it always ran:
    relu(conv2d(x, weight, bias)) in x's dtype, the NHWC flatten, then the
    dense and the sigmoid in float32 at least (float64 where x is)."""
    h = nnf.relu(nnf.conv2d(x, weight.to(x.dtype), bias.to(x.dtype)))
    dtype = torch.promote_types(x.dtype, torch.float32)
    flat = h.permute(0, 2, 3, 1).reshape(x.shape[0], -1).to(dtype)
    return torch.sigmoid(nnf.linear(flat, dense_weight.to(dtype), dense_bias.to(dtype)))


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            dense_weight: torch.Tensor, dense_bias: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA tensors: checks, allocates, launches; (B, 1) float32."""
    if x.device.type != "cuda":
        raise ValueError(f"c_conv3_dense runs on CUDA or CPU tensors, not {x.device}")
    check_shapes(x, weight, bias, dense_weight, dense_bias)
    if x.dtype == torch.float64:
        raise ValueError("c_conv3_dense computes in TF32 on the card: float64 x is not taken")
    bsz, _, h, w = x.shape
    # K3's output is (B, H, W, 128) in memory: this permute is then a view
    rows = _float32(x.permute(0, 2, 3, 1))
    weight, bias = _float32(weight), _float32(bias)
    dense_weight, dense_bias = _float32(dense_weight), _float32(dense_bias)
    for name, t in (("weight", weight), ("bias", bias), ("dense_weight", dense_weight),
                    ("dense_bias", dense_bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if rows.data_ptr() % 16 or dense_weight.data_ptr() % 8 or bias.data_ptr() % 8:
        raise ValueError("c_conv3_dense's x must be 16-byte aligned, its bias and dense "
                         "weight 8-byte aligned, for its loads")
    split = split_tf32()
    out = torch.empty((bsz, 1), dtype=torch.float32, device=x.device)
    # the weight rounded to TF32 (and its rest, when split) in the kernel's
    # layout, then the rows' partial sums
    scratch = torch.empty(_scratch_bytes()(bsz, h, w, split), dtype=torch.uint8,
                          device=x.device)
    # the launch goes to the current device: make it x's where it is not
    guard = (torch.cuda.device(x.device) if x.device.index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        err = _entry()(
            rows.data_ptr(), weight.data_ptr(), bias.data_ptr(), dense_weight.data_ptr(),
            dense_bias.data_ptr(), scratch.data_ptr(), out.data_ptr(), bsz, h, w,
            IN_CHANNELS, OUT_CHANNELS, split, torch.cuda.current_stream().cuda_stream,
        )
    if err == INVALID_VALUE:
        raise ValueError(f"c_conv3_dense kernel does not take a {tuple(x.shape)} input")
    if err != 0:
        raise RuntimeError(f"c_conv3_dense CUDA launch failed: cudaError {err}")
    count("k4.launches")
    return out


class CConv3DenseFunction(torch.autograd.Function):
    """``c_conv3_dense`` with its gradient written out: forward K4 (the plain
    version for CPU tensors), backward plain PyTorch, c_conv3's
    pre-activation recomputed from the saved input. Saves the input, the
    three weights and the output."""

    @staticmethod
    def forward(ctx, x, weight, bias, dense_weight, dense_bias):
        check_shapes(x, weight, bias, dense_weight, dense_bias)
        if x.device.type == "cpu":
            out = plain_c_conv3_dense(x, weight, bias, dense_weight, dense_bias)
        else:
            out = _launch(x, weight, bias, dense_weight, dense_bias)
        ctx.save_for_backward(x, weight, bias, dense_weight, out)
        ctx.dense_bias_dtype = dense_bias.dtype
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight, bias, dense_weight, out = ctx.saved_tensors
        need = ctx.needs_input_grad
        # float32 at least, float64 where the input is
        dtype = torch.promote_types(x.dtype, torch.float32)
        xf, wf = x.to(dtype), weight.to(dtype)
        pre = nnf.conv2d(xf, wf, bias.to(dtype))  # (B, 256, H-2, W-2)
        hidden = nnf.relu(pre)
        flat = hidden.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        o = out.to(dtype)
        gz = g.to(dtype) * (1 - o) * o  # through the sigmoid, as autograd takes it: (B, 1)
        dx = dweight = dbias = ddense_w = ddense_b = None
        if need[3]:
            ddense_w = (gz.t() @ flat).to(dense_weight.dtype)
        if need[4]:
            ddense_b = gz.sum(dim=0).to(ctx.dense_bias_dtype)
        if need[0] or need[1] or need[2]:
            dh = (gz @ dense_weight.to(dtype)).reshape(hidden.shape[0], hidden.shape[2],
                                                       hidden.shape[3], hidden.shape[1])
            dpre = torch.where(pre > 0, dh.permute(0, 3, 1, 2),
                               torch.zeros((), dtype=dtype, device=pre.device))
            if need[0]:
                dx = torch.nn.grad.conv2d_input(x.shape, wf, dpre).to(x.dtype)
            if need[1]:
                dweight = torch.nn.grad.conv2d_weight(xf, weight.shape, dpre).to(weight.dtype)
            if need[2]:
                dbias = dpre.sum(dim=(0, 2, 3)).to(bias.dtype)
        return dx, dweight, dbias, ddense_w, ddense_b


def c_conv3_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  dense_weight: torch.Tensor, dense_bias: torch.Tensor) -> torch.Tensor:
    """sigmoid(dense(flatten(relu(c_conv3(x))))): (B, 128, H, W) -> (B, 1).

    Args:
      x: (B, 128, H, W), K3's output (B, H, W, 128) viewed as NCHW.
      weight: (256, 128, 3, 3) OIHW; bias: (256,).
      dense_weight: (1, (H-2) (W-2) 256), its columns in the NHWC flatten
        order of c_conv3's output; dense_bias: (1,).

    K4 on a CUDA tensor (float32 result), through ``CConv3DenseFunction``
    where autograd records the call and straight to the kernel where it does
    not (inference, ``no_grad``); the plain version with ordinary autograd
    on a CPU tensor. Both raise on shapes and dtypes K4 does not take.
    """
    if x.device.type == "cpu":
        check_shapes(x, weight, bias, dense_weight, dense_bias)
        return plain_c_conv3_dense(x, weight, bias, dense_weight, dense_bias)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias, dense_weight, dense_bias)):
        return CConv3DenseFunction.apply(x, weight, bias, dense_weight, dense_bias)
    return _launch(x, weight, bias, dense_weight, dense_bias)
