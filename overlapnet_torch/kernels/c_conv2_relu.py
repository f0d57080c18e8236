"""K3: the overlap head's c_conv2 with its bias and ReLU, a hand-written CUDA
kernel for Hopper.

``c_conv2_relu`` launches ``csrc/c_conv2_relu.cu`` (K3) for CUDA tensors and
runs the plain PyTorch version (``plain_c_conv2_relu``: ``F.relu`` of
``F.conv2d``) for CPU tensors: the tensor's device decides, nothing else. On
a CUDA tensor it launches the kernel or raises; nothing falls back to cuDNN.

c_conv2 has a (S, 1) kernel at stride (S, 1) over K1's output, so it is a
GEMM over K1's blocks of S rows: M = B * (W' // S) * J, N = 128, K = S * 64.
K1 writes its output (B, W', J, 64) channels last, and the head hands it to
c_conv2 as the NCHW view (B, 64, W', J) of that memory. cuDNN converted
that view into its own layout before a legacy TF32 convolution (a pass over
the largest tensor of the head) and PyTorch's ReLU made another pass over
the result; K3 reads K1's output once as it lies, in TF32 with both
operands rounded to nearest and fp32 sums (3xTF32, float32 accuracy, where
``torch.backends.cudnn.allow_tf32`` is off: ``split_tf32``, the switch that
set cuDNN's precision here), and writes the ReLU'd result
(B, W' // S, J, 128) channels last, returned as the NCHW view with
channels-last strides, which c_conv3 reads without a copy.

Where autograd records the call on the card it goes through
``CConv2ReLUFunction``: its forward is K3; its backward masks the cotangent
by output > 0 and computes the input's and the weight's gradients with
``torch.nn.grad.conv2d_input`` and ``conv2d_weight`` on the saved input,
plain PyTorch, as the JAX package left c_conv2's gradient to XLA. The counter ``k3.launches`` of
``core.profiling`` counts the calls of K3's C entry (each launching the
weight's rounding, then K3): one per head call on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as nnf

from overlapnet_torch.core.profiling import count
from overlapnet_torch.kernels import build

NAME = "c_conv2_relu"
SOURCE = "overlapnet_torch/csrc/c_conv2_relu.cu"
IN_CHANNELS = 64  # K1's features
OUT_CHANNELS = 128
INVALID_VALUE = 1  # cudaErrorInvalidValue: sizes the kernel does not take
MAX_ELEMENTS = 2**31  # the kernel counts offsets into x in 32 bits


@functools.cache
def _entry():
    fn = build.load(NAME).c_conv2_relu_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _weight_bytes():
    fn = build.load(NAME).c_conv2_relu_weight_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn


def check_shapes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                 stride: int) -> None:
    """Raises ValueError unless K3 takes these: x (B >= 1, 64, W' >= S, J >= 1),
    weight (128, 64, S, 1), bias (128,) or None, B * W' * J * 64 < 2**31. The
    CPU version holds to the same, so both take one set of shapes."""
    if x.dim() != 4 or x.shape[1] != IN_CHANNELS:
        raise ValueError(f"c_conv2 takes x as (B, {IN_CHANNELS}, W', J), got {tuple(x.shape)}")
    bsz, _, w, j = x.shape
    if tuple(weight.shape) != (OUT_CHANNELS, IN_CHANNELS, stride, 1):
        raise ValueError(f"c_conv2 takes a ({OUT_CHANNELS}, {IN_CHANNELS}, S={stride}, 1) "
                         f"weight, got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (OUT_CHANNELS,):
        raise ValueError(f"c_conv2's bias must be ({OUT_CHANNELS},), got {tuple(bias.shape)}")
    if bsz < 1 or j < 1 or stride < 1 or w < stride:
        raise ValueError(f"c_conv2 takes B >= 1, J >= 1 and W' >= S={stride}; "
                         f"got x {tuple(x.shape)}")
    if bsz * w * j * IN_CHANNELS >= MAX_ELEMENTS:
        raise ValueError(f"c_conv2 takes fewer than 2**31 input elements; got x {tuple(x.shape)}")


def split_tf32() -> bool:
    """Whether K3 runs 3xTF32 (float32 accuracy) rather than one TF32 product:
    where ``torch.backends.cudnn.allow_tf32`` is off, the switch that set
    c_conv2's precision when cuDNN ran it (on by default, as the
    configuration states: TF32)."""
    return not torch.backends.cudnn.allow_tf32


def plain_c_conv2_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                       stride: int) -> torch.Tensor:
    """K3's function in plain PyTorch: relu(conv2d(x, weight, bias)) at stride
    (S, 1), in x's dtype."""
    return nnf.relu(nnf.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                               stride=(stride, 1)))


def _float32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous float32, itself where it already is."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
            stride: int) -> torch.Tensor:
    """K3 on CUDA tensors: checks, allocates, launches; (B, 128, W' // S, J)
    float32, the NCHW view of channels-last memory."""
    if x.device.type != "cuda":
        raise ValueError(f"c_conv2 runs on CUDA or CPU tensors, not {x.device}")
    check_shapes(x, weight, bias, stride)
    bsz, _, w, j = x.shape
    # K1's output is (B, W', J, 64) in memory: this permute is then a view
    rows = _float32(x.permute(0, 2, 3, 1))
    weight = _float32(weight)
    if bias is not None:
        bias = _float32(bias)
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if rows.data_ptr() % 16:
        raise ValueError("c_conv2's input must be 16-byte aligned for its copies")
    split = split_tf32()
    out = torch.empty((bsz, w // stride, j, OUT_CHANNELS), dtype=torch.float32, device=x.device)
    # the weight rounded to TF32 (and its rest, when split) in the kernel's layout
    w2r = torch.empty(_weight_bytes()(stride, split), dtype=torch.uint8, device=x.device)
    # the launch goes to the current device: make it x's where it is not
    guard = (torch.cuda.device(x.device) if x.device.index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        err = _entry()(
            rows.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
            w2r.data_ptr(), out.data_ptr(), bsz, w, j, stride, IN_CHANNELS, OUT_CHANNELS,
            split, torch.cuda.current_stream().cuda_stream,
        )
    if err == INVALID_VALUE:
        raise ValueError(f"c_conv2 kernel does not take a {tuple(x.shape)} input at S={stride}")
    if err != 0:
        raise RuntimeError(f"c_conv2 CUDA launch failed: cudaError {err}")
    count("k3.launches")
    return out.permute(0, 3, 1, 2)


class CConv2ReLUFunction(torch.autograd.Function):
    """``c_conv2_relu`` with its gradient written out: forward K3 (the plain
    version for CPU tensors), backward plain PyTorch through the output's
    ReLU mask. Saves the input, the weight and the output."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride):
        if x.device.type == "cpu":
            check_shapes(x, weight, bias, stride)
            out = plain_c_conv2_relu(x, weight, bias, stride)
        else:
            out = _launch(x, weight, bias, stride).to(x.dtype)
        ctx.save_for_backward(x, weight, out)
        ctx.stride = stride
        ctx.bias_dtype = None if bias is None else bias.dtype
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight, out = ctx.saved_tensors
        need_x, need_weight, need_bias = ctx.needs_input_grad[:3]
        # float32 at least, float64 where the input is
        dtype = torch.promote_types(x.dtype, torch.float32)
        g = torch.where(out > 0, g, torch.zeros((), dtype=g.dtype, device=g.device)).to(dtype)
        stride = (ctx.stride, 1)
        dx = dweight = dbias = None
        if need_x:
            dx = torch.nn.grad.conv2d_input(x.shape, weight.to(dtype), g,
                                            stride=stride).to(x.dtype)
        if need_weight:
            dweight = torch.nn.grad.conv2d_weight(x.to(dtype), weight.shape, g,
                                                  stride=stride).to(weight.dtype)
        if need_bias:
            dbias = g.sum(dim=(0, 2, 3)).to(ctx.bias_dtype)
        return dx, dweight, dbias, None


def c_conv2_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, *,
                 stride: int) -> torch.Tensor:
    """relu(c_conv2(x)): (B, 64, W', J) -> (B, 128, W' // S, J).

    Args:
      x: (B, 64, W', J), K1's output (B, W', J, 64) viewed as NCHW.
      weight: (128, 64, S, 1) OIHW; bias: (128,) or None.
      stride: S, the kernel's height and its stride along W'.

    K3 on a CUDA tensor (float32 result, NCHW view of channels-last memory,
    cast to x's dtype), through ``CConv2ReLUFunction`` where autograd
    records the call and straight to the kernel where it does not (inference,
    ``no_grad``), which spares a small batch's call the Function's host time;
    the plain version with ordinary autograd on a CPU tensor. Both raise on
    shapes K3 does not take.
    """
    if x.device.type == "cpu":
        check_shapes(x, weight, bias, stride)
        return plain_c_conv2_relu(x, weight, bias, stride)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return CConv2ReLUFunction.apply(x, weight, bias, stride)
    return _launch(x, weight, bias, stride).to(x.dtype)
