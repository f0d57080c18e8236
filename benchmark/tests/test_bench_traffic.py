"""The traffic generators are deterministic in the seed, and give every
seed the same sizes."""

import os

import numpy as np
import pytest
import torch

from benchmark import synth

CFG = {"use_class_probabilities": True, "use_intensity": True,
       "model": {"inputShape": [64, 900], "conv1NetworkHead_conv1size": 15}}
BIG = 2**31 + 987_654_321


def train_pairs(seed):
    from types import SimpleNamespace

    from benchmark import harness
    drv = harness.load_module(os.path.join(harness.HERE, "traffic", "train_resident.py"))
    return drv.pairs_of(SimpleNamespace(seed=seed, config=CFG, mix={"pairs": 64, "scans": 16}))


def images(seed):
    return synth.stack_channels(synth.range_images(
        2, CFG, 64, 120, synth.generator(seed, "cpu", 9), "cpu"))


@pytest.mark.parametrize("make", [
    lambda s: synth.init_weights(CFG, s, "cpu")["legs.s_conv1.weight"],
    images,
    lambda s: torch.from_numpy(np.stack(train_pairs(s))),
    lambda s: synth.street_scans(synth.loop_route(6, 6, 5.0, sway_rad=0.05), 200, 256,
                                 synth.generator(s, "cpu", 4000), "cpu"),
], ids=["weights", "images", "pairs", "street_scans"])
def test_same_seed_same_inputs(make):
    a, b, c = make(BIG), make(BIG), make(BIG + 1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_route_and_images_are_what_the_cells_say():
    poses = synth.loop_route(4541, 3000, 0.8)
    step = np.linalg.norm(np.diff(poses[:, :2, 3], axis=0), axis=1)
    assert np.median(step) == pytest.approx(0.8)
    # the second lap retraces the first half a metre aside
    assert np.linalg.norm(poses[3100, :2, 3] - poses[100, :2, 3]) == pytest.approx(0.5)
    x = synth.range_images(3, CFG, 64, 900, synth.generator(5, "cpu", 1), "cpu")
    assert set(x) == {"depth", "normal", "probability", "intensity"}
    assert torch.allclose(x["probability"].sum(-1), torch.ones(3, 64, 900), atol=1e-5)
    d = x["depth"]
    assert ((d == -1) | ((d > 1) & (d < 81))).all()
    assert synth.stack_channels(x).shape == (3, 64, 900, 25)
