"""The port's evaluation harness (``FeatureVolumePairs``, ``cli evaluate``)
and ``cli sim`` against the JAX package's, on the CPU: a 6-frame sim
sequence, its GT, one weights file of the small input_width=360 model (fp32
legs), and both CLIs on the same network.yml.

Tolerances: predicted overlaps within 2e-5 and sub-bin yaw peaks within
1e-3 bins (fp32 on both sides, summation order only); labels, pair indices
and the npz keys equal. ``cli sim``'s scans and text files are equal byte for
byte, its images as in tests/test_torch_e2e.py.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from overlapnet_tpu.cli import evaluate as jeval
from overlapnet_tpu.cli import sim as jsim
from overlapnet_tpu.core.config import ModelConfig
from overlapnet_tpu.data.dataset import FeatureVolumePairs as JaxFeatureVolumePairs
from overlapnet_tpu.models import init_params as jax_init_params
from overlapnet_tpu.sim import e2e as je2e
from overlapnet_tpu.train.checkpoint import save_params_npz
from overlapnet_torch.cli.__main__ import main as cli_main
from overlapnet_torch.data.dataset import FeatureVolumePairs

from test_torch_e2e import assert_same_sequence

N_FRAMES = 6


def test_feature_volume_pairs_batches_equal_jax():
    rng = np.random.default_rng(0)
    fv = rng.normal(size=(10, 6, 4)).astype(np.float32)
    idx1, idx2 = rng.integers(0, 10, 23), rng.integers(0, 10, 23)
    overlap, orientation = rng.uniform(size=23), rng.integers(0, 6, 23)
    want = list(JaxFeatureVolumePairs(fv, idx1, idx2, overlap, orientation).batches(5))
    for src in (fv, torch.from_numpy(fv)):
        pairs = FeatureVolumePairs(src, idx1, idx2, overlap, orientation, device="cpu")
        got = list(pairs.batches(5))
        assert len(pairs) == 23 and len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in ("fa", "fb"):
                assert isinstance(g[key], torch.Tensor)
                np.testing.assert_array_equal(g[key].numpy(), w[key])
            for key in ("overlap", "orientation"):
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])
    bare = next(FeatureVolumePairs(fv, idx1, idx2, device="cpu").batches(4))
    assert set(bare) == {"fa", "fb"}
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FeatureVolumePairs(fv, idx1, idx2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    work = str(root / "work")
    files, poses = je2e.generate_sequence(work, N_FRAMES)
    je2e.build_gt(work, files, poses, leg_output_width=90)
    weights = str(root / "params.npz")
    save_params_npz(weights, jax_init_params(
        ModelConfig(input_width=360, leg_dtype="float32"), 4, rng=2))
    return root, work, weights


def _yml(root, work, testname, **extra):
    path = os.path.join(root, f"{testname}.yml")
    with open(path, "w") as f:
        yaml.safe_dump({
            "data_root_folder": work, "experiments_path": os.path.join(root, "exp"),
            "testname": testname, "batch_size": 4,
            "model": {"inputShape": [64, 360, 4], "leg_dtype": "float32"}, **extra}, f)
    return path


@pytest.mark.parametrize("source", ["testing_seqs", "training_seqs"])
def test_cli_evaluate_matches_jax(tree, source):
    """Both CLIs on the same yml and weights: the full GT table
    (testing_seqs, cut by --max-pairs) or the validation split."""
    root, work, weights = tree
    extra = {source: ["00"]}
    argv = ["--weights", weights, "--max-pairs", "30"]
    assert jeval.main([_yml(root, work, f"jax_{source}", **extra), *argv]) == 0
    assert cli_main(["evaluate", _yml(root, work, f"port_{source}", **extra), *argv,
                     "--device", "cpu"]) == 0
    out = {}
    for who in ("jax", "port"):
        exp = os.path.join(root, "exp", f"{who}_{source}")
        with np.load(os.path.join(exp, "validation_results.npz")) as data:
            out[who] = {k: data[k] for k in data.files}
        with open(os.path.join(exp, "validation.jsonl")) as f:
            out[who]["metrics"] = [json.loads(line) for line in f][-1]
    got, want = out["port"], out["jax"]
    assert got.keys() == want.keys()
    n = len(want["pred_overlap"])
    assert n == (30 if source == "testing_seqs" else len(got["true_overlap"])) and n > 0
    for key in ("true_overlap", "true_orientation", "true_yaw_deg", "pair_idx1", "pair_idx2"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["pred_overlap"], want["pred_overlap"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["pred_orientation"], want["pred_orientation"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["pred_yaw_deg"], want["pred_yaw_deg"], rtol=0, atol=1e-2)
    gm, wm = got["metrics"], want["metrics"]
    assert gm["phase"] == wm["phase"] == "test"
    keys = sorted(k for k in wm if k not in ("time", "step", "phase"))
    assert keys == sorted(k for k in gm if k not in ("time", "step", "phase"))
    for k in keys:
        assert gm[k] == pytest.approx(wm[k], abs=2e-5 if k.startswith("overlap") else 1e-2), k


def test_cli_sim_writes_the_jax_packages_files(tmp_path):
    argv = ["--frames", "3", "--side", "40", "--seed", "5", "--images"]
    jdst, tdst = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jsim.main(["--dst-folder", jdst, *argv]) == 0
    assert cli_main(["sim", "--dst-folder", tdst, *argv, "--device", "cpu"]) == 0
    assert sorted(os.listdir(tdst)) == sorted(os.listdir(jdst))
    assert_same_sequence(jdst, tdst, images=("depth", "normal", "intensity"))
