"""K4 (kernels/c_conv3_dense.py): c_conv3 with its bias and ReLU and the
overlap dense.

On the CPU: the plain version against the head's tail as it ran before K4
(conv2d + bias + ReLU + NHWC flatten + linear + sigmoid) and against the
implicit GEMM that the kernel computes (rows (b, y, x), K = (channel
quarter, tap, channel), each row's ReLU'd outputs dotted with its slice of
the dense weight), the head as a whole, the autograd Function's gradients,
the shapes and dtypes the wrapper refuses, and the reader of
``k4_roofline.replay``. On a card (marked ``card``): the kernel against the
float64 plain version, its bits across calls and batch splits, its 3xTF32
form and its launch count. No JAX here: the card's cases run where only the
port is installed.
"""

import importlib.util
import math
import os
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from overlapnet_torch.core import profiling
from overlapnet_torch.core.config import ModelConfig
from overlapnet_torch.core.leg_specs import leg_output_width
from overlapnet_torch.kernels import c_conv3_dense as k4
from overlapnet_torch.models import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# K4's bounds on the card, on each pair's overlap (inputs below: logits over
# about +-3). Against the float64 plain version on x and c_conv3's weight
# rounded to TF32 to nearest, as K4 rounds them, what is left is K4's fp32
# sums: up to 1.6e-6 at B = 256 (an H100), where the same operands rounded
# to bfloat16 (the benchmark's control, one precision below) read 6.5e-4 to
# 2.8e-3 and truncated TF32 more than 1e-4 (a CPU emulation).
CARD_RNA_LIMIT = 2e-5
# Against the float64 plain version on the operands as given: TF32 rounding
# itself reads up to 3.0e-4 there.
CARD_ERR_LIMIT = 5e-4
# With cuDNN's TF32 off K4 runs 3xTF32, float32 accuracy: up to 4.7e-6
CARD_SPLIT_ERR_LIMIT = 2e-5


def _inputs(bsz, j, dtype=torch.float32, seed=0):
    """K3's output as K3 lays it out, (B, J, J, 128) ReLU'd, viewed as NCHW;
    c_conv3's glorot-scale weight and a bias; a dense weight whose logits
    spread over a few units, and its bias."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(np.maximum(rng.normal(size=(bsz, j, j, 128)), 0)).to(dtype)
    limit = math.sqrt(6.0 / (9 * 128 + 9 * 256))
    weight = torch.from_numpy(rng.uniform(-limit, limit, size=(256, 128, 3, 3))).to(dtype)
    bias = torch.from_numpy(rng.normal(size=(256,)) * 0.1).to(dtype)
    k = (j - 2) * (j - 2) * 256
    dense_w = torch.from_numpy(rng.normal(size=(1, k)) * (4.0 / math.sqrt(k))).to(dtype)
    dense_b = torch.tensor([0.1], dtype=dtype)
    return x.permute(0, 3, 1, 2), weight, bias, dense_w, dense_b


def _old_tail(x, weight, bias, dense_w, dense_b):
    """The head's tail as models/heads.py ran it before K4."""
    h = F.relu(F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype)))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1).float()
    return torch.sigmoid(F.linear(h, dense_w.to(h.dtype), dense_b.to(h.dtype)))


def _gemm_form(xv, weight, bias, dense_w, dense_b):
    """The kernel's arithmetic as an implicit GEMM: output row (b, y, x) and
    channel o is the dot of X[b, y + dy, x + dx, 32 q + k] over (q, tap, k)
    with W3[o, 32 q + k, dy, dx]; each row's ReLU'd outputs dotted with
    D[y, x, :] give the row's partial, and a pair's partials summed, plus
    the dense's bias, through the sigmoid give its overlap."""
    rows = xv.permute(0, 2, 3, 1)  # (B, H, W, 128): K3's layout
    bsz, h, w, _ = rows.shape
    ho, wo = h - 2, w - 2
    taps = [rows[:, dy:dy + ho, dx:dx + wo] for dy in range(3) for dx in range(3)]
    patches = torch.stack(taps, dim=3)  # (B, ho, wo, 9, 128)
    wt = weight.reshape(256, 128, 9).permute(0, 2, 1)  # (256, 9, 128)
    pre = torch.einsum("byxtc,otc->byxo", patches, wt) + bias
    part = (torch.relu(pre) * dense_w.reshape(ho, wo, 256)).sum(dim=(2, 3))  # (B, ho)
    return torch.sigmoid(part.sum(dim=1, keepdim=True) + dense_b)


@pytest.mark.parametrize("bsz,j", [(1, 24), (3, 24), (3, 6)], ids=["b1_j24", "b3_j24", "b3_j6"])
def test_plain_version_is_the_heads_old_tail(bsz, j):
    """In float32 with TF32 off the plain version runs the operators the head
    ran before K4, in the same order, on the same CPU: the same bits (a
    tolerance of 0). J = 24 is W' = 360; J = 6 the small test model's."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        args = _inputs(bsz, j, seed=bsz * 10 + j)
        got = k4.c_conv3_dense(*args)
        want = _old_tail(*args)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert got.shape == (bsz, 1) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bsz,j", [(2, 24), (3, 5)], ids=["b2_j24", "b3_j5"])
def test_plain_version_is_the_kernels_gemm(bsz, j):
    """In float64 the plain version equals the implicit GEMM with the
    per-row partials that K4 computes, to float64 rounding (1e-12: the two
    sum in other orders)."""
    args = _inputs(bsz, j, torch.float64, seed=j)
    out = k4.c_conv3_dense(*args)
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, _gemm_form(*args), rtol=1e-12, atol=1e-12)


def test_head_forward_is_the_old_head_on_the_small_test_model():
    """The overlap head of the small test model (W' = 90, J = 6) gives the
    bits of the head before K4: K1 and K3, then the old tail on c_conv3 and
    overlap_output's parameters; the checkpoint keys are unchanged."""
    cfg = ModelConfig(input_width=360, leg_dtype="float32")
    model = build_model(cfg, 4, device="cpu").eval()
    head = model.overlap_head
    assert leg_output_width(cfg) // head.stride == 6
    seen = {}
    head.c_conv2.register_forward_hook(lambda m, args, out: seen.setdefault("x", out))
    rng = np.random.default_rng(7)
    fa, fb = (torch.from_numpy(np.maximum(rng.normal(size=(3, 90, 128)), 0).astype(np.float32))
              for _ in range(2))
    with torch.no_grad():
        got = head(fa, fb)
        want = _old_tail(seen["x"], head.c_conv3.weight, head.c_conv3.bias,
                         head.overlap_output.weight, head.overlap_output.bias)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert list(head.state_dict()) == [
        "c_conv1.weight", "c_conv1.bias", "c_conv2.weight", "c_conv2.bias",
        "c_conv3.weight", "c_conv3.bias", "overlap_output.weight", "overlap_output.bias"]


@pytest.mark.parametrize("grad_mode,requires", [
    (torch.no_grad, None), (torch.inference_mode, None), (torch.enable_grad, None),
    (torch.enable_grad, 0), (torch.enable_grad, 1), (torch.enable_grad, 3),
], ids=["no_grad", "inference_mode", "nothing_requires_grad", "x_requires_grad",
        "weight_requires_grad", "dense_requires_grad"])
def test_off_the_cpu_the_function_is_used_only_where_autograd_records(monkeypatch, grad_mode,
                                                                       requires):
    """For a tensor off the CPU, c_conv3_dense launches K4 straight where
    autograd records nothing and through CConv3DenseFunction where it
    records the call. Meta tensors stand in for the card's, and the plain
    version for the launch."""
    launches, applied = [], []
    real_apply = k4.CConv3DenseFunction.apply

    def launch(*args):
        launches.append(args[0].shape)
        return k4.plain_c_conv3_dense(*args)

    def apply(*args):
        applied.append(args[0].shape)
        return real_apply(*args)

    monkeypatch.setattr(k4, "_launch", launch)
    monkeypatch.setattr(k4.CConv3DenseFunction, "apply", apply)
    inputs = [t.to("meta") for t in _inputs(2, 6)]
    if requires is not None:
        inputs[requires].requires_grad_()
    with grad_mode():
        out = k4.c_conv3_dense(*inputs)
    assert len(launches) == 1 and out.shape == (2, 1) and out.device.type == "meta"
    if requires is None:
        assert applied == [] and out.grad_fn is None
    else:
        assert len(applied) == 1
        assert type(out.grad_fn).__name__ == "CConv3DenseFunctionBackward"


def test_function_gradients_pass_gradcheck_in_float64():
    """CConv3DenseFunction's backward against finite differences at a small
    grid (J = 4, two output rows of two)."""
    leaves = [t.clone().requires_grad_() for t in _inputs(2, 4, torch.float64, seed=3)]
    assert torch.autograd.gradcheck(lambda *a: k4.CConv3DenseFunction.apply(*a), leaves,
                                    fast_mode=True)


@pytest.mark.parametrize("subset", [(0, 1, 2, 3, 4), (1,), (0,), (3, 4), (2,)],
                         ids=["all", "weight", "x", "dense", "bias"])
def test_function_gradients_equal_the_plain_paths(subset):
    """At the head's J = 24 the Function's gradients are autograd's through
    the plain version (float64, 1e-10: the two sum in other orders), for any
    subset of the five inputs asked for."""
    base = _inputs(2, 24, torch.float64, seed=4)
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 1)))
    ref = [t.clone().requires_grad_(i in subset) for i, t in enumerate(base)]
    want = torch.autograd.grad(k4.plain_c_conv3_dense(*ref), [ref[i] for i in subset], g)
    got_in = [t.clone().requires_grad_(i in subset) for i, t in enumerate(base)]
    got = torch.autograd.grad(k4.CConv3DenseFunction.apply(*got_in),
                              [got_in[i] for i in subset], g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", ["channels", "weight", "bias", "dense", "dense_bias", "small",
                                  "dims", "int_x", "int_weight", "bool_dense"])
def test_wrapper_raises_on_shapes_and_dtypes_it_does_not_take(case):
    x, weight, bias, dense_w, dense_b = _inputs(2, 6)
    if case == "channels":
        x = x[:, :64]
    elif case == "weight":
        weight = weight[:, :, :2]
    elif case == "bias":
        bias = bias[:128]
    elif case == "dense":  # the dense of another grid
        dense_w = dense_w[:, :-256]
    elif case == "dense_bias":
        dense_b = torch.zeros(2)
    elif case == "small":  # H < 3: no output row
        x = x[:, :, :2]
    elif case == "dims":
        x = x[0]
    elif case == "int_x":
        x = x.to(torch.int32)
    elif case == "int_weight":
        weight = weight.to(torch.int64)
    else:
        dense_w = dense_w > 0
    with pytest.raises(ValueError):
        k4.c_conv3_dense(x, weight, bias, dense_w, dense_b)
    with pytest.raises(ValueError):
        k4.CConv3DenseFunction.apply(x, weight, bias, dense_w, dense_b)


def _metric():
    path = os.path.join(ROOT, "benchmark", "metrics", "k4_roofline.replay.py")
    spec = importlib.util.spec_from_file_location("k4_roofline_replay", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(device):
    cfg = {"model": {"inputShape": [64, 900], "conv1NetworkHead_conv1size": 15},
           "use_depth": True, "use_normals": True}
    return types.SimpleNamespace(device=torch.device(device), config=cfg)


@pytest.mark.parametrize("counts,want_none", [
    ({"k4.launches": 10, "model.head_calls": 10, "model.pairs": 2560}, False),
    ({"k4.launches": 9, "model.head_calls": 10, "model.pairs": 2560}, True),
    ({"model.head_calls": 10, "model.pairs": 2560}, True),
], ids=["every_call", "a_call_missed", "no_counter"])
def test_k4_roofline_reader_on_a_hand_built_record(counts, want_none, monkeypatch):
    """``k4_roofline.replay``: the least time of the window's K4 work (at
    J = 24 the TF32 operations of its 2560 pairs bound it, 1.48 ms against
    0.23 ms of bytes) over K4's rows (names holding ``c_conv3_dense``, 1.52
    ms); None unless every head call launched K4, and None off a card."""
    from benchmark.tracing import Trace

    mod = _metric()
    monkeypatch.setattr(profiling, "record", lambda: {"counts": counts, "device_ms": {}})
    trace = Trace(device=[("void c_conv3_dense_kernel<false>(...)", 0.0, 1500.0),
                          ("c_conv3_dense_round_weight", 1500.0, 1510.0),
                          ("c_conv3_dense_finish", 1510.0, 1520.0),
                          ("delta_conv1_kernel", 2000.0, 9000.0)],
                  start_us=0.0, end_us=10000.0)
    got = mod.read(_run("cuda"), trace)
    if want_none:
        assert got is None
        return
    flops = 2560 * 2.0 * 22 * 22 * 256 * 1152
    assert mod.k4_flops_per_pair(24) * 2560 == flops
    assert got == pytest.approx(100.0 * flops / 495e12 / 1520e-6)
    assert mod.read(_run("cpu"), trace) is None


# -- on a card -------------------------------------------------------------------


def _rna_tf32(t):
    """``t`` rounded to TF32 to nearest, ties away from zero (cvt.rna), as
    float64."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32).double()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 runs only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("bsz,w", [(1, 360), (32, 360), (256, 360), (1, 450), (32, 450),
                                   (256, 450)],
                         ids=["b1_w360", "b32_w360", "b256_w360", "b1_w450", "b32_w450",
                              "b256_w450"])
def test_kernel_matches_float64_and_gives_the_same_bits_twice(bsz, w):
    """K4 against the float64 plain version: each pair's overlap within
    CARD_RNA_LIMIT of it on the operands rounded to TF32 to nearest
    (bfloat16 or truncated operands would read above it) and within
    CARD_ERR_LIMIT of it on the operands as given, (B, 1) float32, and two
    calls with the same bits. J = W' // 15."""
    dev = _card()
    args = [t.to(dev) for t in _inputs(bsz, w // 15, seed=bsz + w)]
    out = k4.c_conv3_dense(*args)
    again = k4.c_conv3_dense(*args)
    assert out.shape == (bsz, 1) and out.dtype == torch.float32
    assert torch.equal(out, again)
    exact = [t.double() for t in args]
    ref = k4.plain_c_conv3_dense(*exact)
    ref_rna = k4.plain_c_conv3_dense(_rna_tf32(args[0]), _rna_tf32(args[1]), *exact[2:])
    assert float((out.double() - ref_rna).abs().max()) < CARD_RNA_LIMIT
    assert float((out.double() - ref).abs().max()) < CARD_ERR_LIMIT


@pytest.mark.card
def test_kernel_with_cudnn_tf32_off_is_float32_accurate():
    """With ``torch.backends.cudnn.allow_tf32`` off K4 runs 3xTF32: each
    overlap within CARD_SPLIT_ERR_LIMIT of the float64 plain version, the
    same bits on two calls."""
    dev = _card()
    args = [t.to(dev) for t in _inputs(64, 24, seed=11)]
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = k4.c_conv3_dense(*args)
        again = k4.c_conv3_dense(*args)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert torch.equal(out, again)
    ref = k4.plain_c_conv3_dense(*(t.double() for t in args))
    assert float((out.double() - ref).abs().max()) < CARD_SPLIT_ERR_LIMIT


@pytest.mark.card
def test_kernel_gives_every_chunk_batch_the_rows_of_the_whole_call():
    """Every batch from 1 to 256 that a chunked head call can give: K4 on the
    first b pairs equals those rows of the 256-pair call, bit for bit."""
    dev = _card()
    x, *rest = (t.to(dev) for t in _inputs(256, 24, seed=9))
    whole = k4.c_conv3_dense(x, *rest)
    for b in range(1, 257):
        assert torch.equal(k4.c_conv3_dense(x[:b], *rest), whole[:b]), b


@pytest.mark.card
def test_every_head_call_on_the_card_launches_k4_once():
    """``k4.launches`` rises by one for each head call, as K3's and K1's do,
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
        before = profiling.totals()
        for _ in range(3):
            got, _ = model.score(fa.to(dev), fb.to(dev))
        after = profiling.totals()
    rose = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("k1.launches", "k3.launches", "k4.launches", "model.head_calls")}
    assert rose == {"k1.launches": 3, "k3.launches": 3, "k4.launches": 3, "model.head_calls": 3}
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-3)


@pytest.mark.card
def test_kernel_gives_the_same_bits_with_and_without_autograd():
    """The straight launch and the autograd Function's forward are the same
    K4 call: equal bits, with cuDNN's TF32 on and off. With it off (3xTF32
    forward, float32 convolutions in the backward, as the training gate of
    chip_smoke.py runs them) the Function's gradients for all five inputs
    match the float64 plain version's through autograd within 1e-3 of each
    gradient's largest magnitude (a ReLU whose input lies within float32
    rounding of zero may take the other side)."""
    dev = _card()
    args = [t.to(dev) for t in _inputs(17, 24, seed=12)]
    saved = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            with torch.inference_mode():
                straight = k4.c_conv3_dense(*args)
            leaves = [t.clone().requires_grad_() for t in args]
            out = k4.c_conv3_dense(*leaves)
            assert torch.equal(out.detach(), straight)
        got = torch.autograd.grad(out.sum(), leaves)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    ref = [t.double().requires_grad_() for t in args]
    want = torch.autograd.grad(k4.plain_c_conv3_dense(*ref).sum(), ref)
    for a, b in zip(got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert float((a.double() - b).abs().max()) <= 1e-3 * float(b.abs().max())
