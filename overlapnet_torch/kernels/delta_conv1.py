"""K1: fused DeltaLayer + c_conv1, a hand-written CUDA kernel for Hopper.

``delta_conv1`` launches ``csrc/delta_conv1.cu`` for CUDA tensors and runs
the plain PyTorch version (``ops.delta.delta_conv1``) for CPU tensors: the
tensor's device decides, nothing else. On a CUDA tensor it launches the
kernel or raises. ``delta_conv1.launches`` counts kernel launches, so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from overlapnet_torch.kernels import build
from overlapnet_torch.ops import delta as plain

NAME = "delta_conv1"
SOURCE = "overlapnet_torch/csrc/delta_conv1.cu"
# The TPU kernel this one replaces, relative to the JAX package's root.
REPLACES = "ops/pallas_delta.py:54"
FEATURES = 64  # F the kernel takes (c_conv1's width)
CHANNEL_CHUNK = 32  # C must be a multiple of this

@functools.cache
def _entry():
    fn = build.load(NAME).delta_conv1_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_volume(name: str, x: torch.Tensor, shape: tuple[int, int]) -> None:
    if x.dim() != 3 or tuple(x.shape[1:]) != shape:
        raise ValueError(f"{name} must be (B, {shape[0]}, {shape[1]}), got {tuple(x.shape)}")
    if x.stride(2) != 1 or x.stride(1) != shape[1]:
        raise ValueError(f"{name} must have contiguous (W', C) rows, strides {x.stride()}")
    if x.shape[0] > 1 and x.stride(0) not in (0, shape[0] * shape[1]):
        raise ValueError(f"{name} batch stride {x.stride(0)} is neither 0 nor W'*C")


def _check_aligned(name: str, x: torch.Tensor) -> None:
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for vector loads")


def delta_conv1(
    a: torch.Tensor,
    b: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 15,
) -> torch.Tensor:
    """Fused DeltaLayer + linear c_conv1.

    Args:
      a, b: (B, W', C) left/right leg feature volumes. Either may carry a
        batch stride of 0 (an ``expand``ed single volume).
      kernel: (1, S, C, F) HWIO conv kernel (or (S, C, F)).
      bias: (F,) or None.

    Returns: (B, W', W'//S, F) float32, the same function as
    ``ops.delta.delta_conv1``.
    """
    if a.device.type == "cpu":
        return plain.delta_conv1(a, b, kernel, bias, stride=stride)
    if a.device.type != "cuda":
        raise ValueError(f"delta_conv1 runs on CUDA or CPU tensors, not {a.device}")
    if kernel.dim() == 4:
        kernel = kernel[0]
    # fp32 in, as the TPU kernel casts (its inputs may come in bf16)
    a, b, kernel = a.float(), b.float(), kernel.float().contiguous()
    bsz, w, c = a.shape
    s, kc, f = kernel.shape
    if s != stride or kc != c or f != FEATURES or c % CHANNEL_CHUNK or w < s:
        raise ValueError(
            f"delta_conv1 kernel takes (S={stride}, C % {CHANNEL_CHUNK} == 0, "
            f"F={FEATURES}) with W' >= S; got kernel {tuple(kernel.shape)}, "
            f"a {tuple(a.shape)}"
        )
    if b.shape[0] != bsz:
        raise ValueError(f"batch mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}")
    _check_volume("a", a, (w, c))
    _check_volume("b", b, (w, c))
    _check_aligned("kernel", kernel)
    for name, x in (("b", b), ("kernel", kernel)):
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
    if bias is not None:
        bias = bias.float().contiguous()
        if tuple(bias.shape) != (f,) or bias.device != a.device:
            raise ValueError(f"bias must be ({f},) on {a.device}")
        _check_aligned("bias", bias)
    j = w // s
    out = torch.empty((bsz, w, j, f), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _entry()(
            a.data_ptr(), b.data_ptr(), kernel.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            bsz, w, c, s, f,
            a.stride(0) if bsz > 1 else 0, b.stride(0) if bsz > 1 else 0,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"delta_conv1 CUDA launch failed: cudaError {err}")
    delta_conv1.launches += 1
    return out


delta_conv1.launches = 0
