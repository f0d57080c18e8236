"""The port's legs, heads and whole OverlapNet vs the JAX package, on the
same weights (carried across by ``overlapnet_torch.weights``) and the same
numpy inputs, at the small input_width=360 geometry (W'=90 valid, 180
circular). Gates as in tests/test_golden.py: fp32 legs overlap |d| < 1e-3,
logits rtol 1e-3, exact argmax; bf16 legs overlap |d| < 5e-3."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from overlapnet_tpu.core.config import ModelConfig as JaxModelConfig
from overlapnet_tpu.models import build_model as jax_build_model
from overlapnet_tpu.models import init_params as jax_init_params
from overlapnet_tpu.models.siamese import OverlapNet as JaxOverlapNet
from overlapnet_tpu.train.checkpoint import save_params_npz
from overlapnet_torch.core.config import ModelConfig
from overlapnet_torch.models import build_model
from overlapnet_torch.weights import load_npz


def _pair(cfg_kw, tmp_path, rng=0):
    """(jax model, jax params, port model) sharing one set of weights."""
    jcfg = JaxModelConfig(input_width=360, **cfg_kw)
    jparams = jax_init_params(jcfg, 4, rng=rng)
    path = str(tmp_path / "params.npz")
    save_params_npz(path, jparams)
    model = build_model(ModelConfig(input_width=360, **cfg_kw), 4)
    model.load_state_dict(load_npz(path))
    return jax_build_model(jcfg), jparams, model.eval()


def _images(seed, n=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 64, 360, 4)).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) * 10.0  # depth-like channel
    return x


@pytest.mark.parametrize("leg_padding", ["valid", "circular"])
def test_legs_match_jax_fp32(leg_padding, tmp_path):
    jm, jp, tm = _pair(dict(leg_padding=leg_padding, leg_dtype="float32"), tmp_path)
    x = _images(1)
    ref = np.asarray(jax.jit(
        lambda p, x: jm.apply(p, x, method=JaxOverlapNet.encode))(jp, x))
    with torch.inference_mode():
        out = tm.encode(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 90 if leg_padding == "valid" else 180, 128)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("cfg_kw", [
    dict(),
    dict(leg_padding="circular"),
    dict(correlation_normalize="cosine", correlation_method="conv"),
    dict(correlation_normalize="euclidean"),
], ids=["valid", "circular", "cosine-conv", "euclidean"])
def test_heads_match_jax(cfg_kw, tmp_path):
    """Overlap head (incl. the NHWC-flattened dense) and correlation head on
    the same feature volumes."""
    jm, jp, tm = _pair(cfg_kw, tmp_path, rng=2)
    if cfg_kw.get("correlation_normalize") == "cosine":
        # a loaded logit_scale, not the init value, must reach the logits
        jp = jax.tree_util.tree_map(lambda v: v, jp)
        jp["params"]["orientation_head"]["logit_scale"] = np.float32(7.5)
        tm.orientation_head.logit_scale.data.fill_(7.5)
    w = 90 if cfg_kw.get("leg_padding", "valid") == "valid" else 180
    rng = np.random.default_rng(3)
    fa = np.maximum(rng.normal(size=(3, w, 128)), 0).astype(np.float32) * 0.1
    fb = np.maximum(np.roll(fa, 7, axis=1) + 0.02 * rng.normal(size=fa.shape), 0).astype(np.float32)
    ov_j, lg_j = jax.jit(lambda p, a, b: jm.apply(p, a, b, method=JaxOverlapNet.score))(jp, fa, fb)
    with torch.inference_mode():
        ov_t, lg_t = tm.score(torch.from_numpy(fa), torch.from_numpy(fb))
    ov_j, lg_j = np.asarray(ov_j), np.asarray(lg_j)
    assert ov_t.shape == ov_j.shape == (3, 1) and lg_t.shape == lg_j.shape == (3, w)
    np.testing.assert_allclose(ov_t.numpy(), ov_j, atol=1e-5)
    np.testing.assert_allclose(lg_t.numpy(), lg_j, rtol=1e-4, atol=1e-4 * np.abs(lg_j).max())
    np.testing.assert_array_equal(lg_t.numpy().argmax(-1), lg_j.argmax(-1))


@pytest.mark.parametrize("cfg_kw,overlap_gate", [
    (dict(leg_dtype="float32"), 1e-3),
    (dict(leg_dtype="float32", leg_padding="circular"), 1e-3),
    (dict(), 5e-3),  # default: bf16 legs
], ids=["fp32-valid", "fp32-circular", "bf16-valid"])
def test_overlapnet_matches_jax(cfg_kw, overlap_gate, tmp_path):
    jm, jp, tm = _pair(cfg_kw, tmp_path)
    x1, x2 = _images(4), _images(5)
    x2[1] = np.roll(x1[1], 40, axis=1)  # a rotated revisit: a clear peak
    ov_j, lg_j = jax.jit(lambda p, a, b: jm.apply(p, a, b))(jp, x1, x2)
    with torch.inference_mode():
        ov_t, lg_t = tm(torch.from_numpy(x1), torch.from_numpy(x2))
    ov_j, lg_j, ov_t, lg_t = map(np.asarray, (ov_j, lg_j, ov_t, lg_t))
    assert np.all(np.isfinite(ov_t)) and np.all((ov_t >= 0) & (ov_t <= 1))
    assert np.abs(ov_t - ov_j).max() < overlap_gate
    np.testing.assert_array_equal(lg_t.argmax(-1), lg_j.argmax(-1))
    if cfg_kw.get("leg_dtype") == "float32":
        np.testing.assert_allclose(lg_t.mean(-1), lg_j.mean(-1), rtol=1e-3)
        np.testing.assert_allclose(lg_t.max(-1), lg_j.max(-1), rtol=1e-3)


def test_legs_reject_output_height_not_one():
    model = build_model(ModelConfig(input_height=96, input_width=360), 4)
    with pytest.raises(ValueError, match="height"):
        model.encode(torch.zeros(1, 96, 360, 4))


def test_correlation_stop_gradient_detaches_the_yaw_head():
    cfg = dataclasses.replace(ModelConfig(input_width=360), correlation_stop_gradient=True,
                              leg_dtype="float32")
    model = build_model(cfg, 4)
    x = torch.from_numpy(_images(6, n=1))
    overlap, logits = model(x, x)
    assert not logits.requires_grad  # 'none' mode: no parameter, no path back
    overlap.sum().backward()
    assert any(p.grad is not None and p.grad.abs().sum() > 0 for p in model.legs.parameters())
