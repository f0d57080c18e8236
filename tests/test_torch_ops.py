"""PyTorch port ops vs the JAX package on the same numpy inputs (CPU).

K1's plain version is held to the JAX Pallas kernel (run in interpret mode,
as tests/test_ops.py runs it) and the correlation / yaw ops to their JAX
counterparts. Tolerances: rtol/atol 1e-4 for fp32 sums that differ only in
order; atol 1e-4 on correlation logits of scale 1 with exact argmax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from overlapnet_tpu.core.config import ModelConfig as JaxModelConfig
from overlapnet_tpu.ops import correlation as jcorr
from overlapnet_tpu.ops import delta as jdelta
from overlapnet_tpu.ops import yaw as jyaw
from overlapnet_tpu.ops.pallas_delta import delta_conv1_pallas
from overlapnet_torch.core.config import ModelConfig
from overlapnet_torch.kernels import delta_conv1 as k1
from overlapnet_torch.ops import correlation as tcorr
from overlapnet_torch.ops import delta as tdelta
from overlapnet_torch.ops import yaw as tyaw


def _t(x):
    return torch.from_numpy(np.asarray(x))


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
    launches = k1.delta_conv1.launches
    out = k1.delta_conv1(_t(a), _t(b), _t(kernel), _t(bias), stride=s)
    assert k1.delta_conv1.launches == launches  # CPU tensors: no kernel
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
