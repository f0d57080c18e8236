"""K3 (kernels/c_conv2_relu.py): c_conv2 with its bias and ReLU.

On the CPU: the plain version against the implicit GEMM that the kernel
computes (rows (b, i', j), K = (tap, channel), read from K1's (B, W', J, 64)
layout), when the autograd Function is used, its gradients, the shapes the
wrapper refuses, and the head still handing c_conv2 K1's output (the benchmark's ``k1_err``
tap reads it through a forward pre-hook). On a card (marked ``card``): the
kernel against the float64 plain version, its rounding, its bits across
calls and batch splits, and its launch count. No JAX here: the card's cases
run where only the port is installed.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from overlapnet_torch.core.config import ModelConfig
from overlapnet_torch.core.profiling import totals
from overlapnet_torch.kernels import c_conv2_relu as k3
from overlapnet_torch.kernels.delta_conv1 import delta_conv1
from overlapnet_torch.models import build_model

# K3's gates on the card against the float64 plain version: TF32 to nearest
# on both operands reads about 3e-4 a pair (relative norm) and an error slope
# of about 2e-7; truncating both operands would read 7.9e-4 and -7.1e-4
# (a CPU emulation of both roundings on such inputs).
CARD_REL_LIMIT = 5e-4
CARD_SLOPE_LIMIT = 1e-4


def _inputs(bsz, w, j, s, dtype=torch.float32, seed=0):
    """K1's output as K1 lays it out, (B, W', J, 64), viewed as NCHW; a
    glorot-scale weight and a bias."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(bsz, w, j, 64))).to(dtype)
    limit = np.sqrt(6.0 / (s * 64 + s * 128))
    weight = torch.from_numpy(rng.uniform(-limit, limit, size=(128, 64, s, 1))).to(dtype)
    bias = torch.from_numpy(rng.normal(size=(128,)) * 0.1).to(dtype)
    return x.permute(0, 3, 1, 2), weight, bias


def _gemm_form(xv, weight, bias, s):
    """The kernel's arithmetic as an implicit GEMM: output row (b, i', j) is
    the dot of x[b, S i' + k, j, f] over (k, f) with W2[g, f, k]."""
    rows = xv.permute(0, 2, 3, 1)  # (B, W', J, 64): K1's layout
    bsz, w, j, f = rows.shape
    io = w // s
    blocks = rows[:, : io * s].reshape(bsz, io, s, j, f)
    out = torch.einsum("bikjf,gfk->bijg", blocks, weight[..., 0]) + bias
    return torch.relu(out).permute(0, 3, 1, 2)


def test_plain_version_is_the_kernels_gemm():
    """c_conv2_relu on CPU tensors equals the implicit GEMM over K1's layout
    that K3 computes, at an S that does not divide W' (7: the last rows of
    W' are read by no tap)."""
    xv, weight, bias = _inputs(3, 360, 24, 7, torch.float64, seed=370)
    out = k3.c_conv2_relu(xv, weight, bias, stride=7)
    assert out.shape == (3, 128, 360 // 7, 24) and out.dtype == torch.float64
    torch.testing.assert_close(out, _gemm_form(xv, weight, bias, 7), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("grad_mode,requires", [
    (torch.no_grad, None), (torch.inference_mode, None), (torch.enable_grad, None),
    (torch.enable_grad, 0), (torch.enable_grad, 1), (torch.enable_grad, 2),
], ids=["no_grad", "inference_mode", "nothing_requires_grad", "x_requires_grad",
        "weight_requires_grad", "bias_requires_grad"])
def test_off_the_cpu_the_function_is_used_only_where_autograd_records(monkeypatch, grad_mode,
                                                                       requires):
    """For a tensor off the CPU, c_conv2_relu launches K3 straight where
    autograd records nothing (``no_grad``, inference mode, no input that
    requires a gradient) and through CConv2ReLUFunction where it records the
    call. Meta tensors stand in for the card's, and the plain version for
    the launch."""
    launches, applied = [], []
    real_apply = k3.CConv2ReLUFunction.apply

    def launch(x, weight, bias, stride):
        launches.append(stride)
        return k3.plain_c_conv2_relu(x, weight, bias, stride)

    def apply(*args):
        applied.append(args[-1])
        return real_apply(*args)

    monkeypatch.setattr(k3, "_launch", launch)
    monkeypatch.setattr(k3.CConv2ReLUFunction, "apply", apply)
    inputs = [t.to("meta") for t in _inputs(2, 360, 24, 15)]
    if requires is not None:
        inputs[requires].requires_grad_()
    with grad_mode():
        out = k3.c_conv2_relu(*inputs, stride=15)
    assert launches == [15] and out.shape == (2, 128, 24, 24) and out.device.type == "meta"
    if requires is None:
        assert applied == [] and out.grad_fn is None
    else:
        assert applied == [15]
        assert type(out.grad_fn).__name__ == "CConv2ReLUFunctionBackward"


def test_function_gradients_pass_gradcheck_in_float64():
    """CConv2ReLUFunction's backward (the cotangent masked by output > 0,
    then conv2d_input / conv2d_weight and the bias sum) against finite
    differences, at a small W' that S does not divide."""
    xv, weight, bias = _inputs(2, 7, 2, 3, torch.float64, seed=3)
    xv, weight, bias = (t.clone().requires_grad_() for t in (xv, weight, bias))
    assert torch.autograd.gradcheck(
        lambda x, w, b: k3.CConv2ReLUFunction.apply(x, w, b, 3), (xv, weight, bias),
        fast_mode=True)


def test_function_gradients_equal_autograd_through_conv2d():
    """At the head's shape the Function's gradients are autograd's through
    relu(conv2d), for each of the three inputs and for any subset asked."""
    xv, weight, bias = _inputs(2, 360, 24, 15, torch.float64, seed=4)
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 128, 24, 24)))
    leaves = [t.clone().requires_grad_() for t in (xv, weight, bias)]
    ref_out = F.relu(F.conv2d(*leaves, stride=(15, 1)))
    want = torch.autograd.grad(ref_out, leaves, g)
    got_leaves = [t.clone().requires_grad_() for t in (xv, weight, bias)]
    got = torch.autograd.grad(k3.CConv2ReLUFunction.apply(*got_leaves, 15), got_leaves, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    # the weight alone (frozen input, as a frozen leg would leave it)
    w_only = weight.clone().requires_grad_()
    (dw,) = torch.autograd.grad(k3.CConv2ReLUFunction.apply(xv, w_only, bias, 15), w_only, g)
    torch.testing.assert_close(dw, want[1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["channels", "weight", "bias", "short", "dims"])
def test_wrapper_raises_on_shapes_it_does_not_take(case):
    xv, weight, bias = _inputs(2, 360, 24, 15)
    s = 15
    if case == "channels":
        xv = xv[:, :32]
    elif case == "weight":
        weight = weight[:, :, :14]
    elif case == "bias":
        bias = bias[:64]
    elif case == "short":  # W' < S
        xv, s = xv[:, :, :10], 15
    else:
        xv = xv[0]
    with pytest.raises(ValueError):
        k3.c_conv2_relu(xv, weight, bias, stride=s)
    with pytest.raises(ValueError):
        k3.CConv2ReLUFunction.apply(xv, weight, bias, s)


def test_head_hands_c_conv2_k1s_output_and_gets_it_relud():
    """A forward pre-hook on overlap_head.c_conv2 receives K1's output as
    the (B, 64, W', J) view of its (B, W', J, 64) memory, and the module's
    output is already ReLU'd: the head applies no ReLU of its own after it."""
    cfg = ModelConfig(input_width=360, leg_dtype="float32")
    model = build_model(cfg, 4, device="cpu").eval()
    head = model.overlap_head
    seen = {}
    head.c_conv2.register_forward_pre_hook(lambda m, args: seen.setdefault("in", args[0]))
    head.c_conv2.register_forward_hook(lambda m, args, out: seen.setdefault("out", out))
    rng = np.random.default_rng(6)
    fa, fb = (torch.from_numpy(np.maximum(rng.normal(size=(3, 90, 128)), 0).astype(np.float32))
              for _ in range(2))
    with torch.no_grad():
        model.score(fa, fb)
        kernel = head.c_conv1.weight[:, :, 0, :].permute(2, 1, 0)
        want = delta_conv1(fa, fb, kernel, head.c_conv1.bias, stride=15)  # (B, W', J, F)
    x = seen["in"]
    assert x.shape == (3, 64, 90, 6)
    assert x.permute(0, 2, 3, 1).is_contiguous()
    torch.testing.assert_close(x.permute(0, 2, 3, 1), want, rtol=0, atol=0)
    out = seen["out"]
    assert out.shape == (3, 128, 6, 6) and bool((out >= 0).all()) and bool((out == 0).any())
    torch.testing.assert_close(out, F.relu(F.conv2d(x, head.c_conv2.weight, head.c_conv2.bias,
                                                     stride=(15, 1))), rtol=0, atol=0)
    assert list(head.state_dict()) == [
        "c_conv1.weight", "c_conv1.bias", "c_conv2.weight", "c_conv2.bias",
        "c_conv3.weight", "c_conv3.bias", "overlap_output.weight", "overlap_output.bias"]


# -- on a card -------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 runs only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("bsz,w,j,s", [(256, 360, 24, 15), (32, 450, 30, 15), (3, 360, 24, 7)],
                         ids=["b256_w360", "b32_w450", "s7_b3_w360"])
def test_kernel_matches_float64_and_rounds_to_nearest(bsz, w, j, s):
    """K3 against the float64 plain version: each pair's relative norm of the
    error within CARD_REL_LIMIT, the error's slope on the output within
    CARD_SLOPE_LIMIT (truncation would shrink every sum alike), channels-last
    strides, and two calls with the same bits."""
    dev = _card()
    xv, weight, bias = (t.to(dev) for t in _inputs(bsz, w, j, s, seed=bsz + s))
    out = k3.c_conv2_relu(xv, weight, bias, stride=s)
    again = k3.c_conv2_relu(xv, weight, bias, stride=s)
    assert out.shape == (bsz, 128, w // s, j) and out.permute(0, 2, 3, 1).is_contiguous()
    assert torch.equal(out, again)
    ref = k3.plain_c_conv2_relu(xv.double(), weight.double(), bias.double(), s)
    d = out.double() - ref
    pair = d.flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
    assert float(pair.max()) < CARD_REL_LIMIT
    assert abs(float((d * ref).sum() / (ref * ref).sum())) < CARD_SLOPE_LIMIT


@pytest.mark.card
def test_kernel_with_cudnn_tf32_off_is_float32_accurate():
    """With ``torch.backends.cudnn.allow_tf32`` off (what set c_conv2's
    precision under cuDNN) K3 runs 3xTF32: each pair within 1e-5 of the
    float64 plain version, the same bits on two calls."""
    dev = _card()
    xv, weight, bias = (t.to(dev) for t in _inputs(64, 360, 24, 15, seed=11))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = k3.c_conv2_relu(xv, weight, bias, stride=15)
        again = k3.c_conv2_relu(xv, weight, bias, stride=15)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert torch.equal(out, again)
    ref = k3.plain_c_conv2_relu(xv.double(), weight.double(), bias.double(), 15)
    pair = (out.double() - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
    assert float(pair.max()) < 1e-5


@pytest.mark.card
def test_kernel_gives_every_chunk_batch_the_rows_of_the_whole_call():
    """Every batch from 1 to 256 that a chunked head call can give: K3 on the
    first b pairs equals those rows of the 256-pair call, bit for bit."""
    dev = _card()
    xv, weight, bias = (t.to(dev) for t in _inputs(256, 360, 24, 15, seed=9))
    whole = k3.c_conv2_relu(xv, weight, bias, stride=15)
    for b in range(1, 257):
        assert torch.equal(k3.c_conv2_relu(xv[:b], weight, bias, stride=15), whole[:b]), b


@pytest.mark.card
def test_every_head_call_on_the_card_launches_k3_once():
    """``k3.launches`` rises by one for each head call (``model.head_calls``),
    and the head's overlaps agree with the CPU's within TF32 noise."""
    dev = _card()
    cfg = ModelConfig(input_width=360, leg_dtype="float32")
    model = build_model(cfg, 4, device="cpu").eval()
    rng = np.random.default_rng(10)
    fa, fb = (torch.from_numpy(np.maximum(rng.normal(size=(5, 90, 128)), 0).astype(np.float32))
              for _ in range(2))
    with torch.no_grad():
        want, _ = model.score(fa, fb)
        model.to(dev)
        before = totals()
        for _ in range(3):
            got, _ = model.score(fa.to(dev), fb.to(dev))
        after = totals()
    assert after.get("k3.launches", 0) - before.get("k3.launches", 0) == 3
    assert after["model.head_calls"] - before["model.head_calls"] == 3
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-3)


@pytest.mark.card
def test_kernel_gives_the_same_bits_with_and_without_autograd():
    """The straight launch (no gradient recorded) and the autograd Function's
    forward are the same K3 call: equal bits, and the Function's gradient
    flows to the weight."""
    dev = _card()
    xv, weight, bias = (t.to(dev) for t in _inputs(17, 360, 24, 15, seed=12))
    with torch.inference_mode():
        plain_call = k3.c_conv2_relu(xv, weight, bias, stride=15)
    w = weight.clone().requires_grad_()
    out = k3.c_conv2_relu(xv, w, bias, stride=15)
    assert torch.equal(out.detach(), plain_call)
    out.sum().backward()
    assert w.grad is not None and bool(torch.isfinite(w.grad).all())
