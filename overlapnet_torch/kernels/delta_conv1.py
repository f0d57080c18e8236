"""K1 and K2: fused DeltaLayer + c_conv1 and its backward, hand-written CUDA
kernels for Hopper.

``delta_conv1`` launches ``csrc/delta_conv1.cu`` (K1) for CUDA tensors and
runs the plain PyTorch version (``ops.delta.delta_conv1``) for CPU tensors:
the tensor's device decides, nothing else. On a CUDA tensor it launches the
kernel or raises.

K1 computes ``sum W |a - b|`` as ``L_a + L_b - 2 sum W min(a, b)``, which
is the same number (``|x - y| = x + y - 2 min(x, y)``): ``L_a = a . sum_k W``
and ``L_b = sum W b`` cost 1/360 of the product each, and the product runs
on the bf16 tensor cores with exact operands. The legs hand over bf16 values
in float32, and the min of two bf16 values is one of them: one exact bf16
piece, against W as three exact bf16 pieces (truncation splits), every
partial product exact in float32 and the sums in float32. Three bf16
products at 989 TFLOP/s take the place of 3xTF32's three at 495: the floor
at B = 256, W' = 360 falls from 3.35 to 1.65 ms.

The price is cancellation. The exact path's rounding is a few float32 ulps
of L and of the min term, not of the output, so its error against the
output grows with a pair's cancellation ratio rho (``cancellation_ratio``:
the size of L_a and L_b over the spread of L_a - L_b, which is about the
output's), and features that share an offset have a large one. So each pair
takes the exact path only where rho <= ``ROUTE_RATIO`` (8), and K1's error
stays within a few times 1e-6 of the output's norm there; 3xTF32, before,
was within about 6e-7 on the same volumes. That is not float32 accuracy.
Any other pair, and every pair of a call whose volumes hold a value that is
not bf16 (float32 legs, test volumes), takes the general path in the same
kernel: |a - b| split into three bf16 pieces and the six products of order
<= 2, the tensor-core work of 3xTF32, with no cancellation. A pre-pass makes
both decisions on the device, with no host sync (``exact_operands`` and
``exact_pairs`` are the same tests in plain PyTorch). Nothing else chooses
the path: no argument, setting or configuration.

On the card the call goes through ``DeltaConv1Function``, a
``torch.autograd.Function``: its forward launches K1 and saves only the two
volumes and the weight; its backward launches ``csrc/delta_conv1_bwd.cu``
(K2, both of its products 3xTF32 ``wgmma`` on the tensor cores, sums in a
fixed order), which recomputes sign(a - b) and gives the gradients of both
volumes and of the weight. CPU tensors keep ordinary
autograd through the plain forward; the Function itself also takes CPU
tensors (plain forward, ``ops.delta.delta_conv1_backward``), which is how
the tests reach its bookkeeping.

K2's C entry takes 128-channel blocks and at most 32 right columns
j = W' // S a call; ``grouped_backward`` widens that to every shape K1 takes
(C % 32 == 0, any W' // S): it zero-pads the channels to a multiple of 128
and runs K2 over groups of at most 32 columns, adding the groups' parts of
da and dW in group order. The default legs (C = 128, W' // S = 24 or 30)
take one call.

The counters ``k1.launches`` (calls of K1's C entry, each launching the
weight split, the pre-pass, the routes, then K1) and ``k2.launches`` (calls of K2's,
each launching the split of the cotangent, the product kernels asked for and
their reductions; one a column group) of ``core.profiling`` show that a
run's main path went through the kernels; the device counter
``k1.exact_calls`` counts K1's calls whose every pair took the exact path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch
import torch.nn.functional as nnf

from overlapnet_torch.core.profiling import count, device_counter
from overlapnet_torch.kernels import build
from overlapnet_torch.ops import delta as plain

NAME = "delta_conv1"
SOURCE = "overlapnet_torch/csrc/delta_conv1.cu"
# The TPU kernel this one replaces, relative to the JAX package's root.
REPLACES = "ops/pallas_delta.py:54"
FEATURES = 64  # F the kernels take (c_conv1's width)
CHANNEL_CHUNK = 32  # K1: C must be a multiple of this
KERNEL_CHUNK = 64  # K1's C entry: C a multiple of this (the wrapper pads)
# K2
BWD_NAME = "delta_conv1_bwd"
BWD_SOURCE = "overlapnet_torch/csrc/delta_conv1_bwd.cu"
BWD_REPLACES = "ops/pallas_delta.py:114"  # _core_bwd, the custom VJP of K1
BWD_CHANNEL_CHUNK = 128  # K2's C entry: C a multiple of this (the wrapper pads)
BWD_MAX_J = 32  # K2's C entry: right columns a call (the wrapper groups)
INVALID_VALUE = 1  # cudaErrorInvalidValue: sizes the kernel does not take
ROUTE_RATIO = 8.0  # K1's exact path takes a pair whose cancellation ratio is at most this

@functools.cache
def _entry():
    fn = build.load(NAME).delta_conv1_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _scratch_bytes():
    fn = build.load(NAME).delta_conv1_scratch_bytes
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return fn


def exact_operands(a: torch.Tensor, b: torch.Tensor, stride: int) -> bool:
    """Whether K1 may take its exact path for these volumes: every element
    of ``a`` and of the rows of ``b`` that a tap reaches (the first W'//S *
    S) is a bf16 value, its float32 bits' low half zero. K1's pre-pass makes
    this test on the card; this is the same test in plain PyTorch."""
    rows = a.shape[1] // stride * stride
    return all(
        not bool((x.float().contiguous().view(torch.int32) & 0xFFFF).any())
        for x in (a, b[:, :rows])
    )


def _ratio_terms(a, b, kernel, stride):
    """(numerator, denominator) of each pair's squared cancellation ratio."""
    w, c = a.shape[1:]
    j = w // stride
    k64 = kernel.double().reshape(stride, c, -1)
    la = a.double() @ k64.sum(0)  # (B, W', F)
    lb = b[:, : j * stride].double().reshape(b.shape[0], j, stride * c) @ k64.reshape(
        stride * c, -1)
    ea, ea2 = la.mean(1), (la * la).mean(1)
    eb, eb2 = lb.mean(1), (lb * lb).mean(1)
    return ((ea2.sqrt() + eb2.sqrt()) ** 2).sum(1), (ea2 + eb2 - 2 * ea * eb).sum(1)


def cancellation_ratio(a: torch.Tensor, b: torch.Tensor, kernel: torch.Tensor,
                       stride: int) -> torch.Tensor:
    """Each pair's cancellation ratio rho, (B,) float64: with L_a[i, f] =
    sum_c a[i, c] sum_k W[k, c, f] and L_b[j, f] = sum_{k,c} W[k, c, f]
    b[S j + k, c], rho^2 = sum_f (rms_i L_a + rms_j L_b)^2 / sum_f
    mean_{i,j} (L_a[i] - L_b[j])^2. The numerator is the size of what the
    exact path's sums hold, the denominator about that of its output
    (sum W (a - b) against sum W |a - b|). K1's pre-pass computes it from
    its float32 L in float64; this is the same in float64 throughout."""
    num, den = _ratio_terms(a, b, kernel, stride)
    return (num / den).sqrt()


def exact_pairs(a: torch.Tensor, b: torch.Tensor, kernel: torch.Tensor,
                stride: int) -> torch.Tensor:
    """(B,) bool on the CPU: the pairs that take K1's exact path, the rest
    the general one: the call's volumes are bf16 values (``exact_operands``)
    and the pair's ``cancellation_ratio`` is at most ``ROUTE_RATIO``. K1's
    ``k1.exact_calls`` counts a call where all are true."""
    if not exact_operands(a, b, stride):
        return torch.zeros(a.shape[0], dtype=torch.bool)
    num, den = _ratio_terms(a, b, kernel, stride)
    return (num <= ROUTE_RATIO**2 * den).cpu()


@functools.cache
def _entry_bwd():
    fn = build.load(BWD_NAME).delta_conv1_backward
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def backward_padded_rows(width: int, stride: int, j_count: int | None = None) -> int:
    """Padded (i, j) rows per batch element in K2's split copies of the
    cotangent (``padded_rows`` in the source) for a call over ``j_count``
    right columns (default all W' // S): each left row's entries padded to a
    multiple of 8, the left rows to a multiple of both product kernels'
    steps. 0 where one call of K2 does not take the shape."""
    if j_count is None:
        j_count = width // stride if stride > 0 else 0
    if not 1 <= j_count <= BWD_MAX_J or width < stride:
        return 0
    jb = (j_count + 7) // 8
    step = 20 if jb == 3 else 16 // jb  # lcm(16 // jb rows a tile, 4 rows)
    return -(-width // step) * step * 8 * jb


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


def _pad_channels(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` with ``pad`` zero channels appended; a batch stride of 0 stays 0."""
    if x.shape[0] > 1 and x.stride(0) == 0:
        return nnf.pad(x[:1], (0, pad)).expand(x.shape[0], -1, -1)
    return nnf.pad(x, (0, pad))


def _launch_forward(
    a: torch.Tensor,
    b: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None,
    stride: int,
) -> torch.Tensor:
    """K1 on CUDA tensors: checks, allocates, launches; (B, W', J, F) fp32."""
    if a.device.type != "cuda":
        raise ValueError(f"delta_conv1 runs on CUDA or CPU tensors, not {a.device}")
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
    for name, x in (("a", a), ("b", b), ("kernel", kernel)):
        _check_aligned(name, x)
    for name, x in (("b", b), ("kernel", kernel)):
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
    if bias is not None:
        bias = bias.float().contiguous()
        if tuple(bias.shape) != (f,) or bias.device != a.device:
            raise ValueError(f"bias must be ({f},) on {a.device}")
        _check_aligned("bias", bias)
    j = w // s
    pad = -c % KERNEL_CHUNK
    if pad:  # zero channels add |0 - 0| = 0 against zero weights: exact
        a, b = _pad_channels(a, pad), _pad_channels(b, pad)
        kernel = nnf.pad(kernel, (0, 0, 0, pad))
        c += pad
    a_bstride = a.stride(0) if bsz > 1 else 0
    b_bstride = b.stride(0) if bsz > 1 else 0
    out = torch.empty((bsz, w, j, f), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        # the weight's bf16 pieces, sum_k W, L_a, L_b, the volumes' bf16
        # copies, the call's flag and the pairs' routes (the source's Scratch)
        scratch = torch.empty(
            _scratch_bytes()(bsz, w, c, s, a_bstride == 0, b_bstride == 0),
            dtype=torch.uint8, device=a.device)
        tally = device_counter("k1.exact_calls", a.device)
        err = _entry()(
            a.data_ptr(), b.data_ptr(), kernel.data_ptr(),
            None if bias is None else bias.data_ptr(), scratch.data_ptr(), tally.data_ptr(),
            out.data_ptr(), bsz, w, c, s, f, a_bstride, b_bstride,
            torch.cuda.current_stream().cuda_stream,
        )
    if err == INVALID_VALUE:
        raise ValueError(f"delta_conv1 kernel does not take a {tuple(a.shape)} volume")
    if err != 0:
        raise RuntimeError(
            f"delta_conv1 CUDA launch failed: "
            f"{f'CUresult {-err}' if err < 0 else f'cudaError {err}'}"
        )
    count("k1.launches")
    return out


def grouped_backward(
    a: torch.Tensor,
    b: torch.Tensor,
    kernel: torch.Tensor,
    g: torch.Tensor,
    group_backward: Callable[..., tuple],
    *,
    stride: int,
    need_volumes: bool = True,
    need_kernel: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """K1's backward for every shape K1 takes, from a backward that takes
    only C % 128 == 0 and at most 32 right columns a call (K2's C entry).

    ``group_backward(a, b, kernel, g, j0, jc, need_volumes, need_kernel)``
    returns (da, db, dkernel) of the right columns j0 <= j < j0 + jc alone:
    da and dkernel that group's parts, db right on the rows S*j0 ..
    S*(j0 + jc) - 1 (other rows are not read). The channels are zero-padded
    to a multiple of 128 first, which is exact: a padded channel has |0 - 0|
    = 0 and a zero weight row. The groups run in order of j0 and their parts
    of da and dkernel are added in that order, so the sums keep a fixed
    order. One group and no padding (the default legs) is one call whose
    results are returned as they are. db is 0 on the rows past J*S.

    a, b: (B, W', C) float32 contiguous; kernel: (S, C, F) float32; g:
    (B, W', W'//S, F) float32.
    """
    bsz, w, c = a.shape
    s, kc, f = kernel.shape
    j = w // s
    if s != stride or kc != c or f != FEATURES or c % CHANNEL_CHUNK or j < 1:
        raise ValueError(
            f"delta_conv1 backward takes (S={stride}, C % {CHANNEL_CHUNK} == 0, "
            f"F={FEATURES}) with W' >= S; got kernel {tuple(kernel.shape)}, a {tuple(a.shape)}"
        )
    if tuple(g.shape) != (bsz, w, j, f) or tuple(b.shape) != tuple(a.shape):
        raise ValueError(
            f"shape mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}, g {tuple(g.shape)}"
        )
    if not (need_volumes or need_kernel):
        return None, None, None
    pad = -c % BWD_CHANNEL_CHUNK
    if pad:
        a, b = nnf.pad(a, (0, pad)), nnf.pad(b, (0, pad))
        kernel = nnf.pad(kernel, (0, 0, 0, pad))
    da = db = dw = None
    for j0 in range(0, j, BWD_MAX_J):
        jc = min(BWD_MAX_J, j - j0)
        da_g, db_g, dw_g = group_backward(a, b, kernel, g, j0, jc, need_volumes, need_kernel)
        if need_volumes:
            if da is None:
                da, db = da_g, db_g
            else:
                da = da + da_g
                rows = slice(s * j0, s * (j0 + jc))
                db[:, rows] = db_g[:, rows]
        if need_kernel:
            dw = dw_g if dw is None else dw + dw_g
    if need_volumes:
        db[:, j * s :] = 0  # columns no tap reaches
        if pad:
            da, db = da[..., :c].contiguous(), db[..., :c].contiguous()
    if need_kernel and pad:
        dw = dw[:, :c].contiguous()
    return da, db, dw


def _launch_backward(a, b, kernel, g, j0: int, jc: int, need_volumes: bool,
                     need_kernel: bool):
    """One call of K2's C entry over the right columns j0 <= j < j0 + jc
    (``grouped_backward``'s per-group backward on the card)."""
    bsz, w, c = a.shape
    s, _, f = kernel.shape

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=a.device)

    m_pad = backward_padded_rows(w, s, jc)
    da = db = da_part = dw = dw_part = g_split = gt_split = w_split = None
    if need_volumes:
        da, db, da_part = empty(bsz, w, c), empty(bsz, w, c), empty(bsz, s, w, c)
        # the cotangent and the weight split into tf32 hi / lo (P1's operands)
        g_split, w_split = empty(2, bsz, m_pad, f), empty(2, s * c, f)
    if need_kernel:
        dw, dw_part = empty(s, c, f), empty(bsz, s, c, f)
        gt_split = empty(bsz, 2, f, m_pad)  # the same transposed (P2's operand)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(a.device):
        err = _entry_bwd()(
            a.data_ptr(), b.data_ptr(), kernel.data_ptr(), g.data_ptr(),
            ptr(da), ptr(db), ptr(dw), ptr(da_part), ptr(dw_part),
            ptr(g_split), ptr(gt_split), ptr(w_split),
            m_pad, bsz, w, c, s, f, j0, jc, torch.cuda.current_stream().cuda_stream,
        )
    if err == INVALID_VALUE:
        raise ValueError(f"delta_conv1 backward kernel does not take a {tuple(a.shape)} volume "
                         f"with columns {j0}..{j0 + jc - 1}")
    if err != 0:
        raise RuntimeError(
            f"delta_conv1 backward CUDA launch failed: "
            f"{f'CUresult {-err}' if err < 0 else f'cudaError {err}'}"
        )
    count("k2.launches")
    return da, db, dw


def delta_conv1_backward(
    a: torch.Tensor,
    b: torch.Tensor,
    kernel: torch.Tensor,
    g: torch.Tensor,
    *,
    stride: int = 15,
    need_volumes: bool = True,
    need_kernel: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """Gradients of ``delta_conv1`` for the cotangent ``g``: (da, db,
    dkernel) in float32, each None unless asked for. K2 for CUDA tensors
    (``grouped_backward`` over its C entry: every shape K1 takes), its plain
    version ``ops.delta.delta_conv1_backward`` for CPU tensors.

    Args:
      a, b: (B, W', C) volumes as K1 took them (a batch stride of 0 is
        written out here); kernel: (S, C, F).
      g: (B, W', W'//S, F), any float type and strides.
      need_volumes / need_kernel: which of the two products to compute
        (frozen legs need only dkernel).
    """
    if a.device.type == "cpu":
        da, db, dw = plain.delta_conv1_backward(a, b, kernel, g, stride=stride)
        return (da if need_volumes else None, db if need_volumes else None,
                dw if need_kernel else None)
    if a.device.type != "cuda":
        raise ValueError(f"delta_conv1 backward runs on CUDA or CPU tensors, not {a.device}")
    a, b, kernel = a.float().contiguous(), b.float().contiguous(), kernel.float().contiguous()
    g = g.float().contiguous()
    for name, x in (("a", a), ("b", b), ("kernel", kernel), ("g", g)):
        if x.device != a.device:
            raise ValueError(f"{name} must be on {a.device}")
        _check_aligned(name, x)
    return grouped_backward(a, b, kernel, g, _launch_backward, stride=stride,
                            need_volumes=need_volumes, need_kernel=need_kernel)


class DeltaConv1Function(torch.autograd.Function):
    """``delta_conv1`` with its gradient written out: forward K1, backward K2
    (their plain versions for CPU tensors). Saves the two volumes and the
    weight; nothing of size B*W'*W'*C is stored. ``kernel`` is (S, C, F)."""

    @staticmethod
    def forward(ctx, a, b, kernel, bias, stride):
        a32, b32, k32 = a.float(), b.float(), kernel.float()
        if a.device.type == "cpu":
            out = plain.delta_conv1(a32, b32, k32, bias, stride=stride)
        else:
            out = _launch_forward(a32, b32, k32, bias, stride)
        ctx.save_for_backward(a32, b32, k32)
        ctx.stride = stride
        ctx.dtypes = (a.dtype, b.dtype, kernel.dtype, None if bias is None else bias.dtype)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b, kernel = ctx.saved_tensors
        need_a, need_b, need_kernel, need_bias = ctx.needs_input_grad[:4]
        da = db = dkernel = dbias = None
        if need_a or need_b or need_kernel:
            da, db, dkernel = delta_conv1_backward(
                a, b, kernel, g, stride=ctx.stride,
                need_volumes=need_a or need_b, need_kernel=need_kernel)
        if need_bias:
            # the bias is added outside the JAX package's custom VJP as well
            dbias = g.float().sum(dim=(0, 1, 2)).to(ctx.dtypes[3])
        return (
            da.to(ctx.dtypes[0]) if need_a else None,
            db.to(ctx.dtypes[1]) if need_b else None,
            dkernel.to(ctx.dtypes[2]) if need_kernel else None,
            dbias,
            None,
        )


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
    ``ops.delta.delta_conv1``, differentiable in a, b, kernel and bias
    (``DeltaConv1Function`` on the card, ordinary autograd on the CPU).
    """
    if a.device.type == "cpu":
        return plain.delta_conv1(a, b, kernel, bias, stride=stride)
    if kernel.dim() == 4:
        kernel = kernel[0]
    return DeltaConv1Function.apply(a, b, kernel, bias, stride)
