"""PyTorch port ops vs the JAX package on the same numpy inputs (CPU).

K1's plain version is held to the JAX Pallas kernel (run in interpret mode,
as tests/test_ops.py runs it) and the correlation / yaw ops to their JAX
counterparts. Tolerances: rtol/atol 1e-4 for fp32 sums that differ only in
order; atol 1e-4 on correlation logits of scale 1 with exact argmax. The
tests marked ``card`` run K1 itself and skip without a card.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine with the card has no JAX and runs only the
    # `card` tests of this file there (`-m card --noconftest`)
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from overlapnet_tpu.core.config import ModelConfig as JaxModelConfig
    from overlapnet_tpu.ops import correlation as jcorr
    from overlapnet_tpu.ops import delta as jdelta
    from overlapnet_tpu.ops import yaw as jyaw
    from overlapnet_tpu.ops.pallas_delta import delta_conv1_pallas
except ModuleNotFoundError:
    pass
from overlapnet_torch.core import profiling
from overlapnet_torch.core.config import ModelConfig
from overlapnet_torch.kernels import delta_conv1 as k1
from overlapnet_torch.ops import correlation as tcorr
from overlapnet_torch.ops import delta as tdelta
from overlapnet_torch.ops import yaw as tyaw


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _launches() -> dict:
    """K1's and K2's launch counters (``core.profiling`` totals)."""
    t = profiling.totals()
    return {k: t.get(k, 0) for k in ("k1.launches", "k2.launches")}


@pytest.mark.parametrize("w", [90, 450])
def test_k1_plain_version_matches_pallas_kernel(w):
    """The port's K1 wrapper on CPU tensors (its plain version) == the JAX
    Pallas kernel in interpret mode; W'=450 has a ragged J*S tail."""
    rng = np.random.default_rng(7)
    bsz, c, s, f = 2, 32, 15, 16
    a = rng.normal(size=(bsz, w, c)).astype(np.float32)
    b = rng.normal(size=(bsz, w, c)).astype(np.float32)
    kernel = rng.normal(size=(1, s, c, f)).astype(np.float32) * 0.1
    bias = rng.normal(size=(f,)).astype(np.float32)

    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(delta_conv1_pallas(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(kernel),
            jnp.asarray(bias), stride=s,
        ))
    launches = _launches()
    out = k1.delta_conv1(_t(a), _t(b), _t(kernel), _t(bias), stride=s)
    assert _launches() == launches  # CPU tensors: no kernel
    assert out.shape == expected.shape == (bsz, w, w // s, f)
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-4, atol=1e-4)
    # the (S, C, F) kernel form and a batch-broadcast right volume agree too
    out_b = tdelta.delta_conv1(
        _t(a), _t(b[:1]).expand(bsz, w, c), _t(kernel[0]), _t(bias), stride=s
    )
    ref_b = np.asarray(jdelta.delta_conv1(
        jnp.asarray(a), jnp.asarray(np.broadcast_to(b[:1], a.shape)),
        jnp.asarray(kernel), jnp.asarray(bias), stride=s,
    ))
    np.testing.assert_allclose(out_b.numpy(), ref_b, rtol=1e-4, atol=1e-4)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as cvt.rna.tf32.f32 rounds (nearest, ties away from
    zero): (bits + 0x1000) & 0xFFFFE000 on the int32 view (K2's split)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _bf16_pieces(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``x`` as K1 splits it: n bf16 values (float32 with the low 16 bits
    cleared), each the truncation of what the pieces before left; for n = 3
    their sum is ``x`` exactly."""
    pieces = []
    for _ in range(n):
        pieces.append((x.view(torch.int32) & -0x10000).view(torch.float32))
        x = x - pieces[-1]
    return pieces


def _k1_scheme(a, b, kernel, bias, *, exact: bool, w_pieces: int = 3, a_pieces: int = 3):
    """K1's arithmetic on the card in plain float32 (B = 1), W split into
    ``w_pieces`` bf16 pieces. The exact path: L_a + L_b + bias - 2 sum W
    min(a, b), min(a, b) one bf16 piece, three products. The general path:
    sum W |a - b| + bias, |a - b| (rounded to float32) split into
    ``a_pieces`` pieces, the products of order <= 2. Each partial product is
    exact in float32 and summed in float32."""
    w, c = a.shape[1:]
    s, _, f = kernel.shape
    j = w // s
    wmat = _t(kernel).reshape(s * c, f)
    wp = _bf16_pieces(wmat, w_pieces)
    b_r = _t(b[0, : j * s]).reshape(j, s * c)
    la = _t(a[0]) @ _t(kernel).sum(0)
    lb = b_r @ wmat
    out = torch.empty((w, j, f))
    for i0 in range(0, w, 45):
        a_rep = _t(a[0, i0 : i0 + 45]).repeat(1, s)[:, None, :]
        if exact:
            prod = sum(torch.minimum(a_rep, b_r) @ p for p in wp)
            out[i0 : i0 + 45] = (la[i0 : i0 + 45, None] + lb[None] + _t(bias)) - 2 * prod
        else:
            ap = _bf16_pieces((a_rep - b_r).abs(), a_pieces)
            out[i0 : i0 + 45] = sum(ap[p] @ wp[q] for p in range(len(ap))
                                    for q in range(len(wp)) if p + q <= 2) + _t(bias)
    return out.numpy()


@pytest.mark.parametrize("path", ["exact", "general"])
@pytest.mark.parametrize("w", [360, 450])
def test_k1_scheme_matches_jax_fp32(w, path):
    """K1's arithmetic, emulated in plain torch at full width (C=128, S=15,
    F=64, B=1), held to the JAX package's fp32 delta_conv1 at the kernel's
    1e-4 gate on the card: on bf16-valued volumes (the bf16 legs' output) the
    exact path, min(a, b) in one bf16 piece against W in three; on float32
    volumes the general path, |a - b| in three pieces and the six products of
    order <= 2. W in one piece misses the gate, and so does one piece of
    |a - b| on float32 volumes. (The chip run holds the kernel itself.)"""
    rng = np.random.default_rng(w)
    c, s, f = 128, 15, 64
    a, b = (np.maximum(rng.normal(size=(1, w, c)), 0).astype(np.float32) for _ in range(2))
    if path == "exact":
        a, b = (_t(x).bfloat16().float().numpy() for x in (a, b))
    assert k1.exact_operands(_t(a), _t(b), s) == (path == "exact")
    limit = np.sqrt(6.0 / (s * c + s * f))
    kernel = rng.uniform(-limit, limit, size=(s, c, f)).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32) * 0.1
    expected = np.asarray(jdelta.delta_conv1(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(kernel), jnp.asarray(bias), stride=s,
    ))[0]
    exact = path == "exact"
    np.testing.assert_allclose(_k1_scheme(a, b, kernel, bias, exact=exact), expected,
                               rtol=1e-4, atol=1e-4)
    one_w_piece = _k1_scheme(a, b, kernel, bias, exact=exact, w_pieces=1)
    assert np.abs(one_w_piece - expected).max() > 1e-4
    if not exact:
        one_a_piece = _k1_scheme(a, b, kernel, bias, exact=False, a_pieces=1)
        assert np.abs(one_a_piece - expected).max() > 1e-4


def test_k1_exact_operands_flips_on_one_value_that_is_not_bf16():
    """The test K1's pre-pass makes for its exact path: every element of a
    and of the rows of b a tap reaches is a bf16 value. One element with a
    low bit set, in either volume (an expanded query included), turns it
    off; b's rows past W'//S * S, which no tap reaches, do not."""
    rng = np.random.default_rng(3)
    w, c, s = 100, 32, 15  # taps reach rows 0..89 of b
    a = _t(np.maximum(rng.normal(size=(2, w, c)), 0).astype(np.float32)).bfloat16().float()
    b = _t(np.maximum(rng.normal(size=(1, w, c)), 0).astype(np.float32)).bfloat16().float()
    assert k1.exact_operands(a, b.expand(2, w, c), s)
    for x, at in ((a, (1, 50, 7)), (b, (0, 89, 31))):
        odd = x.clone()
        odd[at] = float(np.nextafter(np.float32(odd[at].item() + 1.0), np.float32(np.inf)))
        pair = (odd, b.expand(2, w, c)) if x is a else (a, odd.expand(2, w, c))
        assert not k1.exact_operands(*pair, s)
    tail = b.clone()
    tail[0, 95, 3] = 1.0 + 2.0 ** -20  # past J * S = 90
    assert k1.exact_operands(a, tail.expand(2, w, c), s)


def test_k1_min_identity_holds_on_ties_and_zeros():
    """|x - y| = x + y - 2 min(x, y) on ReLU features with many exact ties
    and zeros (values on a grid of 1/4): L_a + L_b - 2 sum W min(a, b)
    equals sum W |a - b| in float64 to rounding, and the exact path in
    float32 stays within float32 rounding of it."""
    rng = np.random.default_rng(11)
    w, c, s, f = 90, 128, 15, 64
    a, b = (np.maximum(np.round(rng.normal(size=(1, w, c)) * 4) / 4, 0).astype(np.float32)
            for _ in range(2))
    j = w // s
    b_r = b[0, : j * s].reshape(j, s * c)
    ties = (np.tile(a[0], (1, s))[:, None, :] == b_r[None]).mean()
    assert ties > 0.3 and (a == 0).mean() > 0.4
    limit = np.sqrt(6.0 / (s * c + s * f))
    kernel = rng.uniform(-limit, limit, size=(s, c, f)).astype(np.float32)
    bias = np.zeros(f, np.float32)
    want = tdelta.delta_conv1(_t(a).double(), _t(b).double(), _t(kernel).double(),
                              stride=s)[0].numpy()
    k64 = _t(kernel).double()
    la = _t(a[0]).double() @ k64.sum(0)
    lb = _t(b_r).double() @ k64.reshape(s * c, f)
    m = torch.minimum(_t(a[0]).double().repeat(1, s)[:, None, :], _t(b_r).double())
    identity = (la[:, None] + lb[None] - 2 * m @ k64.reshape(s * c, f)).numpy()
    scale = np.abs(want).max()
    assert np.abs(identity - want).max() <= 1e-12 * scale
    got = _k1_scheme(a, b, kernel, bias, exact=True)
    assert np.abs(got - want).max() <= 1e-5 * scale


def _offset_volumes(rng, bsz, w, c, offset):
    """bf16-valued (B, W', C) volumes: ReLU'd normals, or normals of mean
    ``offset`` and spread 1 (features that share an offset)."""
    x = rng.normal(size=(bsz, w, c))
    x = x + offset if offset else np.maximum(x, 0)
    return _t(x.astype(np.float32)).bfloat16().float()


@pytest.mark.parametrize("offset,exact", [(0, True), (3, True), (10, False), (30, False)])
def test_k1_route_sends_offset_features_to_the_general_path(offset, exact):
    """A pair takes K1's exact path only where its cancellation ratio rho is
    at most ROUTE_RATIO: ReLU'd features (rho about 1.6) and an offset of 3
    over a spread of 1 (about 4) do, offsets of 10 and 30 (about 13 and 39)
    do not. rho's closed form equals its definition summed over every
    (i, j), and the exact path's error, emulated in float32, grows with rho
    where it is left to run: past 1e-6 of the output's norm at offset 10."""
    rng = np.random.default_rng(40 + offset)
    w, c, s, f = 360, 128, 15, 64
    a, b = (_offset_volumes(rng, 2, w, c, offset) for _ in range(2))
    limit = np.sqrt(6.0 / (s * c + s * f))
    kernel = _t(rng.uniform(-limit, limit, size=(s, c, f)).astype(np.float32))
    rho = k1.cancellation_ratio(a, b, kernel, s)
    assert k1.exact_pairs(a, b, kernel, s).tolist() == [exact, exact]
    assert bool((rho <= k1.ROUTE_RATIO).all()) == exact
    j = w // s
    k64 = kernel.double()
    la = a[0].double() @ k64.sum(0)
    lb = b[0, : j * s].double().reshape(j, s * c) @ k64.reshape(s * c, f)
    num = ((la.pow(2).mean(0).sqrt() + lb.pow(2).mean(0).sqrt()) ** 2).sum()
    den = (la[:, None] - lb[None]).pow(2).mean((0, 1)).sum()
    assert abs(float((num / den).sqrt()) - float(rho[0])) <= 1e-9 * float(rho[0])

    bias = np.zeros(f, np.float32)
    want = tdelta.delta_conv1(a[:1].double(), b[:1].double(), k64, stride=s)[0].numpy()
    got = _k1_scheme(a[:1].numpy(), b[:1].numpy(), kernel.numpy(), bias, exact=True)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    # float32 sums: a few ulps (6e-8) of the output's norm for each unit of rho
    assert rel <= 5e-7 * float(rho[0])
    if offset >= 10:
        assert rel > 1e-6


def test_k1_route_ratio_is_the_sources():
    """kernels/delta_conv1.py's ROUTE_RATIO is the one the CUDA source uses."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(k1.__file__), "..", "csrc", "delta_conv1.cu")).read()
    found = re.findall(r"constexpr double ROUTE_RATIO = ([0-9.]+);", src)
    assert found and float(found[0]) == k1.ROUTE_RATIO


@pytest.mark.parametrize("negate", [False, True])
def test_delta_volume_matches_jax(negate):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 30, 8)).astype(np.float32)
    b = rng.normal(size=(2, 30, 8)).astype(np.float32)
    out = tdelta.delta_volume(_t(a), _t(b), negate=negate).numpy()
    ref = np.asarray(jdelta.delta_volume(jnp.asarray(a), jnp.asarray(b), negate=negate))
    np.testing.assert_array_equal(out, ref)


def _volumes(seed, bsz, w, c):
    """Feature volumes scaled so the correlation logits are O(1)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(bsz, w, c)).astype(np.float32) / np.sqrt(w * c)
    b = np.roll(a, 5, axis=1) + 0.1 * rng.normal(size=a.shape).astype(np.float32) / np.sqrt(w * c)
    return a, b.astype(np.float32)


@pytest.mark.parametrize("method", ["fft", "conv"])
@pytest.mark.parametrize("normalize", ["none", "euclidean", "scaling", "standardization"])
@pytest.mark.parametrize("w", [90, 450])
def test_circular_correlation_matches_jax(method, normalize, w):
    a, b = _volumes(3, 3, w, 16)
    if normalize != "none":  # the normalized modes make logits O(C)
        a, b = a * np.sqrt(w * 16), b * np.sqrt(w * 16)
    out = tcorr.circular_correlation(_t(a), _t(b), normalize=normalize, method=method).numpy()
    ref = np.asarray(jcorr.circular_correlation(
        jnp.asarray(a), jnp.asarray(b), normalize=normalize, method=method
    ))
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out / scale, ref / scale, atol=1e-4)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def test_wrap_pad_matches_jax():
    x = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)
    np.testing.assert_array_equal(
        tcorr.wrap_pad(_t(x), 2).numpy(), np.asarray(jcorr.wrap_pad(jnp.asarray(x), 2))
    )


def test_peak_statistics_match_jax():
    """subbin_peak, flip_margin, peak_margin and yaw_confidence on logits
    with a sharp peak, a flat curve, a bimodal curve and random noise."""
    rng = np.random.default_rng(5)
    w = 90
    x = np.arange(w)
    logits = np.stack([
        -0.01 * (x - 40.3) ** 2,
        np.zeros(w),
        np.exp(-0.5 * (x - 10) ** 2) + 0.9 * np.exp(-0.5 * (x - 55) ** 2),
        rng.normal(size=w),
        rng.normal(size=w) * 5.0,
    ]).astype(np.float32)
    lt, lj = _t(logits), jnp.asarray(logits)
    for fn in ("subbin_peak", "flip_margin", "peak_margin", "yaw_confidence"):
        out = getattr(tcorr, fn)(lt).numpy()
        ref = np.asarray(getattr(jcorr, fn)(lj))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5, err_msg=fn)


@pytest.mark.parametrize("yaw_space", ["calibrated", "reference"])
@pytest.mark.parametrize("leg_padding", ["valid", "circular"])
def test_yaw_decode_matches_jax(yaw_space, leg_padding):
    tcfg = ModelConfig(yaw_space=yaw_space, leg_padding=leg_padding)
    jcfg = JaxModelConfig(yaw_space=yaw_space, leg_padding=leg_padding)
    peaks = np.linspace(-3.0, 452.0, 97).astype(np.float32)
    np.testing.assert_allclose(
        tyaw.peak_to_degrees(peaks, tcfg).numpy(),
        np.asarray(jyaw.peak_to_degrees(peaks, jcfg)), rtol=1e-6, atol=1e-5,
    )
    bins = np.arange(0, 360, 7)
    np.testing.assert_allclose(
        tyaw.ref_bins_to_degrees(bins, tcfg).numpy(),
        np.asarray(jyaw.ref_bins_to_degrees(bins, jcfg)), rtol=1e-6,
    )
    np.testing.assert_array_equal(
        tyaw.target_bins(bins, tcfg).numpy(), np.asarray(jyaw.target_bins(bins, jcfg))
    )


# -- K2: the backward of K1 -------------------------------------------------------


def _relu_volumes(seed, bsz, w, c, s, f):
    """ReLU'd volumes (a quarter of all (i, j, c) differences are exact ties,
    0 - 0), a weight and a cotangent."""
    rng = np.random.default_rng(seed)
    a = np.maximum(rng.normal(size=(bsz, w, c)), 0).astype(np.float32)
    b = np.maximum(rng.normal(size=(bsz, w, c)), 0).astype(np.float32)
    b[:, 3] = a[:, 5]  # a whole row equal to a left row as well
    kernel = (rng.normal(size=(s, c, f)) * 0.1).astype(np.float32)
    g = rng.normal(size=(bsz, w, w // s, f)).astype(np.float32)
    assert (a[:, :, None, :] == b[:, None, :, :]).mean() > 0.2
    return a, b, kernel, g


@pytest.mark.parametrize("w,entry", [(90, "pallas"), (450, "pallas"), (100, "xla")])
def test_k2_plain_version_matches_jax_grad(w, entry):
    """ops.delta.delta_conv1_backward == jax.grad through delta_conv1_pallas
    in interpret mode (as tests/test_ops.py runs it; rtol/atol 1e-3 as
    there), on data with exact ties. The Pallas entry takes only W' that S
    divides; w=100, which leaves columns no tap reaches, is held to jax.grad
    through the JAX package's plain delta_conv1 on volumes without ties:
    JAX differentiates abs at 0 as +1 where the Pallas entry's custom VJP
    (and torch) take sign(0) = 0. (Behind ReLU legs the two conventions
    give the same parameter gradients: a tie at 0 - 0 is a dead unit.)"""
    import jax

    a, b, kernel, g = _relu_volumes(11, 2, w, 32, 15, 16)
    if entry == "xla":
        rng = np.random.default_rng(17)
        a, b = (rng.normal(size=a.shape).astype(np.float32) for _ in range(2))
    fwd = delta_conv1_pallas if entry == "pallas" else jdelta.delta_conv1

    def loss(a_, b_, k_):
        return jnp.sum(fwd(a_, b_, k_, stride=15) * jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(b), jnp.asarray(kernel))
    got = tdelta.delta_conv1_backward(_t(a), _t(b), _t(kernel), _t(g), stride=15)
    for name, x, y in zip(("da", "db", "dkernel"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-3, atol=1e-3, err_msg=name)
    assert not got[1][:, (w // 15) * 15:].any()


@pytest.mark.parametrize("w", [90, 100])
def test_k2_plain_version_matches_fp64_autograd(w):
    """In float64 the written-out gradients equal autograd through the plain
    forward to 1e-10; sign(0) = 0 on both sides."""
    a, b, kernel, g = _relu_volumes(12, 2, w, 32, 15, 16)
    a, b, kernel = (_t(x).double().requires_grad_() for x in (a, b, kernel))
    g = _t(g).double()
    out = tdelta.delta_conv1(a, b, kernel, stride=15)
    assert out.dtype == torch.float64
    out.backward(g)
    got = tdelta.delta_conv1_backward(a.detach(), b.detach(), kernel.detach(), g, stride=15)
    for name, x, y in zip(("da", "db", "dkernel"), got, (a.grad, b.grad, kernel.grad)):
        assert x.dtype == torch.float64
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10, atol=1e-10, err_msg=name)
    # a tie passes no gradient: with b == a everywhere, da and db vanish
    same = a.detach()[:, :15].contiguous()
    da, db, _ = tdelta.delta_conv1_backward(
        same[:, :1].expand(2, 15, 32).contiguous(), same[:, :1].expand(2, 15, 32).contiguous(),
        kernel.detach(), g[:, :15, :1], stride=15)
    assert not da.any() and not db.any()


def test_delta_conv1_function_gives_all_four_gradients_on_cpu():
    """DeltaConv1Function on CPU tensors (plain forward, written-out
    backward) == ordinary autograd through the plain forward, for a, b, the
    kernel and the bias; bf16 volumes get bf16 gradients; no launch is
    counted."""
    a, b, kernel, g = _relu_volumes(13, 2, 100, 32, 15, 16)
    bias = np.linspace(-1, 1, 16).astype(np.float32)

    def grads(fn, dtype=torch.float32):
        leaves = [_t(a).to(dtype).requires_grad_(), _t(b).to(dtype).requires_grad_(),
                  _t(kernel).requires_grad_(), _t(bias).requires_grad_()]
        fn(*leaves).backward(_t(g))
        return [x.grad for x in leaves]

    counts = _launches()
    want = grads(lambda a_, b_, k_, bias_: tdelta.delta_conv1(a_, b_, k_, bias_, stride=15))
    got = grads(lambda a_, b_, k_, bias_: k1.DeltaConv1Function.apply(a_, b_, k_, bias_, 15))
    for name, x, y in zip(("da", "db", "dkernel", "dbias"), got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
    # the public wrapper on CPU tensors is ordinary autograd through the plain version
    for x, y in zip(grads(lambda a_, b_, k_, bias_: k1.delta_conv1(a_, b_, k_[None], bias_, stride=15)), want):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    low = grads(lambda a_, b_, k_, bias_: k1.DeltaConv1Function.apply(a_, b_, k_, bias_, 15),
                dtype=torch.bfloat16)
    assert low[0].dtype == low[1].dtype == torch.bfloat16 and low[2].dtype == torch.float32
    assert _launches() == counts


def test_delta_conv1_function_honours_needs_input_grad(monkeypatch):
    """Frozen legs ask only for the kernel's gradient; a frozen head only for
    the volumes'; nothing asked, nothing computed."""
    a, b, kernel, g = _relu_volumes(14, 1, 30, 32, 15, 16)
    asked = []
    real = k1.delta_conv1_backward

    def spy(*args, need_volumes=True, need_kernel=True, **kw):
        asked.append((need_volumes, need_kernel))
        return real(*args, need_volumes=need_volumes, need_kernel=need_kernel, **kw)

    monkeypatch.setattr(k1, "delta_conv1_backward", spy)
    for leg_grad, kernel_grad in ((False, True), (True, False), (True, True)):
        ta, tb = _t(a).requires_grad_(leg_grad), _t(b)
        tk = _t(kernel).requires_grad_(kernel_grad)
        k1.DeltaConv1Function.apply(ta, tb, tk, None, 15).backward(_t(g))
        assert asked[-1] == (leg_grad, kernel_grad)
        assert (ta.grad is not None) == leg_grad and (tk.grad is not None) == kernel_grad
        assert tb.grad is None
    out = real(_t(a), _t(b), _t(kernel), _t(g), stride=15, need_volumes=False)
    assert out[0] is None and out[1] is None and out[2] is not None
    # only the bias asks: K2 is not called at all
    n = len(asked)
    bias = torch.zeros(16, requires_grad=True)
    k1.DeltaConv1Function.apply(_t(a), _t(b), _t(kernel), bias, 15).backward(_t(g))
    assert len(asked) == n
    np.testing.assert_allclose(bias.grad.numpy(), g.sum((0, 1, 2)), rtol=1e-5, atol=1e-5)


def test_delta_conv1_function_sums_the_gradient_of_an_expanded_volume():
    """One query expanded over the batch (batch stride 0), with a gradient:
    the Function returns a full (B, W', C) gradient and autograd's expand
    sums it."""
    a, b, kernel, g = _relu_volumes(15, 3, 30, 32, 15, 16)
    q = _t(b[:1]).requires_grad_()
    k1.DeltaConv1Function.apply(_t(a), q.expand(3, 30, 32), _t(kernel), None, 15).backward(_t(g))
    _, db, _ = tdelta.delta_conv1_backward(
        _t(a), _t(np.broadcast_to(b[:1], a.shape).copy()), _t(kernel), _t(g), stride=15)
    np.testing.assert_allclose(q.grad.numpy(), db.sum(0, keepdim=True).numpy(), rtol=1e-5, atol=1e-5)


def _held_to_scale(got, want, gate=1e-4):
    """K2's gate on the card: |got - want| <= gate * (max|want| + |want|)."""
    want = np.asarray(want)
    return bool(np.all(np.abs(got - want) <= gate * (np.abs(want).max() + np.abs(want))))


@pytest.mark.parametrize("w", [360, 450])
def test_k2_3xtf32_scheme_matches_jax_grad(w):
    """K2's arithmetic, emulated in plain torch at full width (C=128, S=15,
    F=64, B=1) on volumes with exact ties: the cotangent, the weight and
    |diff| split into TF32 hi and lo = tf32(x - hi); P1 as g_hi W_hi +
    g_hi W_lo + g_lo W_hi masked by sign(diff) (sign(0) = 0) and summed over j
    and over i in fp32; P2 as the three partial products of |diff|^T and g over
    four left rows at a time (the kernel's flush interval), the four-row sums
    added in fp32 in order. Held to jax.grad through the Pallas entry in
    interpret mode at the card's gate, 1e-4 of each gradient's largest
    magnitude. A single TF32 pass misses that gate for every gradient. (The
    chip run holds the kernel itself.)"""
    import jax

    c, s, f = 128, 15, 64
    j = w // s
    a, b, kernel, g = _relu_volumes(w, 1, w, c, s, f)

    def loss(a_, b_, k_):
        return jnp.sum(delta_conv1_pallas(a_, b_, k_, stride=s) * jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(b), jnp.asarray(kernel))
    want = [np.asarray(x) for x in want]

    def split(x):
        hi = _tf32_rna(x)
        return hi, _tf32_rna(x - hi)

    wmat = _t(kernel).reshape(s * c, f)
    w_hi, w_lo = split(wmat)
    b_r = _t(b[0, : j * s]).reshape(j, s * c)
    da3, da1 = torch.empty((w, c)), torch.empty((w, c))
    db3, db1 = torch.zeros((j, s * c)), torch.zeros((j, s * c))
    dw3, dw1 = torch.zeros((s * c, f)), torch.zeros((s * c, f))
    rows = 4  # left rows between the kernel's fp32 flushes
    for i0 in range(0, w, rows):
        n = min(rows, w - i0)
        g_hi, g_lo = split(_t(g[0, i0 : i0 + n]))  # (n, J, F)
        diff = _t(a[0, i0 : i0 + n]).repeat(1, s)[:, None, :] - b_r  # (n, J, S*C)
        sign = torch.sign(diff)
        gw3 = (g_hi @ w_hi.T + g_hi @ w_lo.T + g_lo @ w_hi.T) * sign
        gw1 = (g_hi @ w_hi.T) * sign
        da3[i0 : i0 + n] = gw3.sum(1).reshape(n, s, c).sum(1)
        da1[i0 : i0 + n] = gw1.sum(1).reshape(n, s, c).sum(1)
        db3 -= gw3.sum(0)
        db1 -= gw1.sum(0)
        d_hi, d_lo = split(diff.abs().reshape(n * j, s * c))
        g_hi, g_lo = g_hi.reshape(n * j, f), g_lo.reshape(n * j, f)
        dw3 += d_hi.T @ g_hi + d_hi.T @ g_lo + d_lo.T @ g_hi
        dw1 += d_hi.T @ g_hi
    pad = np.zeros((w - j * s, c), np.float32)
    got3 = (da3.numpy(), np.concatenate([db3.reshape(j * s, c).numpy(), pad]), dw3.reshape(s, c, f).numpy())
    got1 = (da1.numpy(), np.concatenate([db1.reshape(j * s, c).numpy(), pad]), dw1.reshape(s, c, f).numpy())
    for name, x3, x1, y in zip(("da", "db", "dkernel"), got3, got1, want):
        y = y[0] if name != "dkernel" else y
        assert _held_to_scale(x3, y), name
        assert not _held_to_scale(x1, y), f"one TF32 pass holds the gate for {name}"


@pytest.mark.parametrize("w,s,rows", [
    (360, 15, 360 * 24),   # J = 24: already whole groups of 8, 360 = 18 * 20
    (450, 15, 452 * 32),   # J = 30 -> 32, 450 -> 452 left rows
    (100, 15, 112 * 8),    # J = 6 -> 8, tiles of 16 left rows
    (90, 5, 100 * 24),     # J = 18 -> 24, 90 -> 100 left rows (steps of 20)
    (495, 15, 0),          # J = 33: more than K2 takes
    (10, 15, 0),           # W' < S
])
def test_k2_padded_rows(w, s, rows):
    """The padded row count the wrapper sizes K2's scratch by: J to a
    multiple of 8, the left rows to lcm(16 // (Jp / 8), 4); 0 where K2 does
    not take the shape."""
    assert k1.backward_padded_rows(w, s) == rows
    if rows:
        assert rows % 32 == 0 and rows >= w * (w // s)


def test_k2_wrapper_rejects_what_it_does_not_take():
    a, b, kernel, g = _relu_volumes(16, 1, 30, 32, 15, 16)
    with pytest.raises(ValueError, match="stride"):
        tdelta.delta_conv1_backward(_t(a), _t(b), _t(kernel), _t(g), stride=5)
    with pytest.raises(ValueError, match="g "):
        tdelta.delta_conv1_backward(_t(a), _t(b), _t(kernel), _t(g[:, :, :1]), stride=15)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k1.delta_conv1_backward(_t(a).to("meta"), _t(b), _t(kernel), _t(g), stride=15)
    # one call of K2's C entry takes 128-channel blocks and at most 32 right
    # columns (the scratch size is 0 outside them); grouped_backward pads and
    # groups the rest, and still rejects what K1 does not take
    assert (k1.BWD_CHANNEL_CHUNK, k1.BWD_MAX_J, k1.FEATURES) == (128, 32, 64)
    assert k1.backward_padded_rows(32 * 15 + 14, 15) > 0
    assert k1.backward_padded_rows(33 * 15, 15) == 0 and k1.backward_padded_rows(14, 15) == 0
    assert k1.backward_padded_rows(33 * 15, 15, 32) > 0 and k1.backward_padded_rows(33 * 15, 15, 1) > 0

    def no_group(*args):
        raise AssertionError("no group may run for a shape K1 does not take")

    with pytest.raises(ValueError, match="F=64"):  # F = 16
        k1.grouped_backward(_t(a), _t(b), _t(kernel), _t(g), no_group, stride=15)
    a, b, kernel, g = _relu_volumes(16, 1, 30, 48, 15, 64)
    with pytest.raises(ValueError, match="C % 32"):
        k1.grouped_backward(_t(a), _t(b), _t(kernel), _t(g), no_group, stride=15)
    a, b, kernel, g = _relu_volumes(16, 1, 30, 64, 15, 64)
    with pytest.raises(ValueError, match="S=5"):
        k1.grouped_backward(_t(a), _t(b), _t(kernel), _t(g), no_group, stride=5)
    with pytest.raises(ValueError, match="g "):
        k1.grouped_backward(_t(a), _t(b), _t(kernel), _t(g[:, :, :1]), no_group, stride=15)


def _plain_group(calls):
    """``grouped_backward``'s per-group backward from the plain version:
    the cotangent outside the group's columns zeroed; db's rows outside the
    group NaN, so that reading them would show."""

    def run(a, b, kernel, g, j0, jc, need_volumes, need_kernel):
        s = kernel.shape[0]
        calls.append((j0, jc, a.shape[2]))
        gm = torch.zeros_like(g)
        gm[:, :, j0 : j0 + jc] = g[:, :, j0 : j0 + jc]
        da, db, dw = tdelta.delta_conv1_backward(a, b, kernel, gm, stride=s)
        rows = slice(s * j0, s * (j0 + jc))
        db_group = torch.full_like(db, float("nan"))
        db_group[:, rows] = db[:, rows]
        return (da if need_volumes else None, db_group if need_volumes else None,
                dw if need_kernel else None)

    return run


@pytest.mark.parametrize("w,s,c,groups", [
    (99, 3, 128, [(0, 32, 128), (32, 1, 128)]),                    # J = 33
    (212, 3, 128, [(0, 32, 128), (32, 32, 128), (64, 6, 128)]),    # J = 70, 2 rows past J*S
    (60, 3, 32, [(0, 20, 128)]),                                   # C = 32 padded to 128
    (100, 3, 64, [(0, 32, 128), (32, 1, 128)]),                    # C = 64 and J = 33
])
def test_k2_grouping_matches_the_ungrouped_backward(w, s, c, groups):
    """K2's reach widened to every shape K1 takes: channels zero-padded to
    a multiple of 128, right columns in groups of at most 32, da's and dW's
    group parts added in group order, db taken from each group's own rows and
    0 past J*S. Driven through the plain backward as the per-group callable
    (the card runs K2's C entry there), in float64 against the ungrouped plain
    backward: the parts are the same sums split, so 1e-10."""
    a, b, kernel, g = (_t(x).double() for x in _relu_volumes(21, 2, w, c, s, 64))
    want = tdelta.delta_conv1_backward(a, b, kernel, g, stride=s)
    calls = []
    got = k1.grouped_backward(a, b, kernel, g, _plain_group(calls), stride=s)
    assert calls == groups
    for name, x, y in zip(("da", "db", "dkernel"), got, want):
        assert x.shape == y.shape and x.is_contiguous(), name
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10, atol=1e-10, err_msg=name)
    assert not got[1][:, (w // s) * s :].any()
    # frozen legs: only dkernel, the same groups
    calls.clear()
    da, db, dw = k1.grouped_backward(a, b, kernel, g, _plain_group(calls), stride=s,
                                     need_volumes=False)
    assert da is None and db is None and calls == groups
    np.testing.assert_allclose(dw.numpy(), want[2].numpy(), rtol=1e-10, atol=1e-10)


# -- on a card -------------------------------------------------------------------

# K1's gate on each pair against the plain version in float64 (relative norm
# of the difference): the benchmark's k1_err limit, and chip_smoke.py's
K1_CARD_PAIR_LIMIT = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 runs only there")
    return torch.device("cuda")


def _card_volumes(w, path, dev):
    """256 pairs of ReLU'd normal volumes at leg-feature scale, glorot-scale
    weights and a bias, on the card; bf16 values for K1's exact path,
    float32 for its general one."""
    rng = np.random.default_rng(18 + w)
    bsz, s, c, f = 256, 15, 128, 64
    a, b = (torch.from_numpy(np.maximum(rng.normal(size=(bsz, w, c)), 0).astype(np.float32))
            for _ in range(2))
    if path == "exact":
        a, b = a.bfloat16().float(), b.bfloat16().float()
    limit = np.sqrt(6.0 / (s * c + s * f))
    kernel = torch.from_numpy(rng.uniform(-limit, limit, size=(s, c, f)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(f,)).astype(np.float32) * 0.1)
    return a.to(dev), b.to(dev), kernel.to(dev), bias.to(dev)


@pytest.mark.card
@pytest.mark.parametrize("bsz", [1, 32, 256])
@pytest.mark.parametrize("w", [360, 450])
@pytest.mark.parametrize("path", ["exact", "general"])
def test_k1_on_the_card_is_within_its_bound_and_keeps_its_bits(path, w, bsz):
    """K1 on the first ``bsz`` of 256 pairs, on the path the volumes choose:
    each pair within K1_CARD_PAIR_LIMIT of the float64 plain version, two
    calls with equal bits, and each pair's bits the same alone, in the
    batch and in the 256-pair call."""
    dev = _card()
    s = 15
    a, b, kernel, bias = _card_volumes(w, path, dev)
    assert k1.exact_pairs(a[:bsz], b[:bsz], kernel, s).tolist() == [path == "exact"] * bsz
    out = k1.delta_conv1(a[:bsz], b[:bsz], kernel, bias, stride=s)
    assert torch.equal(out, k1.delta_conv1(a[:bsz], b[:bsz], kernel, bias, stride=s))
    whole = k1.delta_conv1(a, b, kernel, bias, stride=s)
    assert torch.equal(out, whole[:bsz])
    for p in (0, bsz - 1):
        alone = k1.delta_conv1(a[p:p + 1], b[p:p + 1], kernel, bias, stride=s)
        assert torch.equal(alone, whole[p:p + 1]), p

    idx = torch.from_numpy(np.unique(np.linspace(0, bsz - 1, min(bsz, 8)).round().astype(int)))
    sel = idx.to(dev)
    want = tdelta.delta_conv1(a[sel].double(), b[sel].double(), kernel.double(),
                              bias.double(), stride=s)
    d = out[sel].double() - want
    pair = d.flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
    assert float(pair.max()) < K1_CARD_PAIR_LIMIT, pair.tolist()
