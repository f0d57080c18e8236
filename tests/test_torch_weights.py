"""Weight bridge between the JAX package's flat-key .npz and the port, and
the port's import isolation."""

import os
import subprocess
import sys

import numpy as np
import pytest

from overlapnet_tpu.core.config import ModelConfig as JaxModelConfig
from overlapnet_tpu.models import init_params as jax_init_params
from overlapnet_tpu.train.checkpoint import save_params_npz
from overlapnet_torch.core.config import ModelConfig
from overlapnet_torch.models import build_model, init_params
from overlapnet_torch.weights import load_npz, params_from_jax, params_to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("normalize", ["none", "cosine"])
def test_npz_round_trip_is_bit_exact(tmp_path, normalize):
    """flat npz (as the JAX package writes it) -> state_dict -> flat npz."""
    path = str(tmp_path / "params.npz")
    save_params_npz(path, jax_init_params(
        JaxModelConfig(input_width=360, correlation_normalize=normalize), 4, rng=1
    ))
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    sd = params_from_jax(flat)
    assert ("orientation_head.logit_scale" in sd) == (normalize == "cosine")
    # the state_dict fits the port's model exactly (strict load)
    model = build_model(ModelConfig(input_width=360, correlation_normalize=normalize), 4,
                        device="cpu")
    model.load_state_dict(sd)
    assert sd.keys() == model.state_dict().keys()
    for name, t in model.state_dict().items():
        assert t.shape == sd[name].shape, name

    back = params_to_jax(load_npz(path))
    assert back.keys() == flat.keys()
    for k in flat:
        assert back[k].dtype == flat[k].dtype and back[k].shape == flat[k].shape, k
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_layouts_follow_torch_conventions(tmp_path):
    """HWIO conv kernels become OIHW; the (in, out) dense kernel (out, in)."""
    path = str(tmp_path / "params.npz")
    save_params_npz(path, jax_init_params(JaxModelConfig(input_width=360), 4, rng=0))
    with np.load(path) as data:
        k = data["params/legs/s_conv1/kernel"]
        d = data["params/overlap_head/overlap_output/kernel"]
    sd = load_npz(path)
    np.testing.assert_array_equal(sd["legs.s_conv1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["overlap_head.overlap_output.weight"].numpy(), d.T)


def test_seeded_init_is_deterministic_with_the_reference_scales():
    cfg = ModelConfig(input_width=360)
    a, b, c = init_params(cfg, 4, seed=0), init_params(cfg, 4, seed=0), init_params(cfg, 4, seed=1)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
    assert not np.array_equal(a["legs.s_conv5.weight"].numpy(), c["legs.s_conv5.weight"].numpy())
    # legs: lecun normal, variance 1/fan_in; heads: glorot uniform
    w = a["legs.s_conv5.weight"].numpy()  # (128, 128, 1, 9)
    assert abs(w.std() * np.sqrt(128 * 9) - 1.0) < 0.05
    w = a["overlap_head.c_conv3.weight"].numpy()  # (256, 128, 3, 3)
    limit = np.sqrt(6.0 / (128 * 9 + 256 * 9))
    assert w.max() <= limit and w.min() >= -limit and w.max() > 0.99 * limit
    assert not a["legs.s_conv1.bias"].any()


def test_port_imports_nothing_of_jax():
    """Every module of the port imports, and neither jax nor the JAX package
    is loaded (a subprocess: this test process already imported jax)."""
    code = r"""
import importlib, os, pkgutil, sys
import overlapnet_torch
names = [m.name for m in pkgutil.walk_packages(overlapnet_torch.__path__, "overlapnet_torch.")]
for n in names:
    importlib.import_module(n)
assert len(names) >= 30, names
for new in ("lcd.gating", "lcd.online", "geometry.kitti", "cli.lcd",
            "train.losses", "train.schedule", "train.trainer", "train.evaluate",
            "train.checkpoint", "train.import_keras", "core.metrics", "data.gt_files",
            "data.dataset", "cli.train", "kernels.delta_conv1", "sim.world",
            "geometry.projection", "geometry.overlap", "geometry.gen_data",
            "geometry.rotations", "data.native", "data.pack", "data.balancing",
            "cli.gen_data", "cli.gen_gt", "cli.pack", "backend", "backend.ate",
            "backend.pose_graph", "core.profiling", "cli.evaluate", "cli.sim",
            "sim.e2e", "sim.trainability_ab"):
    assert "overlapnet_torch." + new in names, new
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "optax", "orbax") or m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "orbax", "overlapnet_tpu"))
assert not bad, bad
print("ok", len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")
