"""The port's serving slice (DescriptorDB, Infer, CLI) vs the JAX package's
Infer on the same weights file and the same preprocessed-image tree (the
tree of tests/test_lcd.py::infer_tree), on the CPU."""

import os

import numpy as np
import pytest
import torch
import yaml

from overlapnet_tpu.core.config import (
    ChannelConfig,
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OverlapNetConfig,
    TrainConfig,
)
from overlapnet_tpu.lcd.infer import Infer as JaxInfer
from overlapnet_tpu.models import init_params as jax_init_params
from overlapnet_tpu.train.checkpoint import save_params_npz
from overlapnet_torch.core import config as tconfig
from overlapnet_torch.lcd.descriptor_db import DescriptorDB
from overlapnet_torch.lcd.infer import Infer
from overlapnet_torch.models import build_model

N_SCANS = 6


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Preprocessed-image tree (depth + normal) and a JAX weights export."""
    root = tmp_path_factory.mktemp("serving")
    rng = np.random.default_rng(4)
    h, w = 64, 360
    for kind, ch in [("depth", None), ("normal", 3)]:
        os.makedirs(root / "data" / "07" / kind)
        for i in range(N_SCANS):
            shape = (h, w) if ch is None else (h, w, ch)
            np.save(root / "data" / "07" / kind / f"{i:06d}.npy",
                    rng.normal(size=shape).astype(np.float32))
    weights = str(root / "params.npz")
    save_params_npz(weights, jax_init_params(ModelConfig(input_width=360), 4, rng=3))
    return str(root / "data"), weights


def _cfgs(tree, **model_kw):
    data_root, weights = tree
    kw = dict(
        channels=ChannelConfig(), model=ModelConfig(input_width=360, **model_kw),
        train=TrainConfig(batch_size=2),
        data=DataConfig(data_root_folder=data_root, infer_seqs="07"),
        experiment=ExperimentConfig(pretrained_weightsfilename=weights),
    )
    # the port's config is a copy: the same fields build both
    tkw = {k: getattr(tconfig, type(v).__name__)(**vars(v)) for k, v in kw.items()}
    return OverlapNetConfig(**kw), tconfig.OverlapNetConfig(**tkw)


@pytest.mark.parametrize("leg_dtype,gate", [("float32", 1e-3), ("bfloat16", 5e-3)])
def test_infer_matches_jax_infer(tree, leg_dtype, gate):
    jcfg, tcfg = _cfgs(tree, leg_dtype=leg_dtype)
    ji, ti = JaxInfer(jcfg, db_capacity=16), Infer(tcfg, db_capacity=16, device="cpu")
    yaw_tol = 0.05 if leg_dtype == "float32" else 0.5  # degrees

    def same(out_t, out_j):
        for t, j in zip(out_t, out_j):
            np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=gate)

    fv_t = ti.create_feature_volumes(["000000", "000001.bin"])
    fv_j = ji.create_feature_volumes(["000000", "000001.bin"])
    assert fv_t.shape == fv_j.shape == (2, 90, 128)
    np.testing.assert_allclose(fv_t, fv_j, atol=0.05 * np.abs(fv_j).max())

    ov_t, yaw_t = ti.infer_one("000000.bin", "000001.bin")
    ov_j, yaw_j = ji.infer_one("000000.bin", "000001.bin")
    assert abs(float(ov_t) - float(ov_j)) < gate
    np.testing.assert_allclose(yaw_t, yaw_j, atol=yaw_tol)

    assert ti.infer_multiple(0, []) is None and ji.infer_multiple(0, []) is None
    for cur, refs in [(1, [0]), (2, [0, 1])]:
        (o_t, y_t, c_t), (o_j, y_j, c_j) = ti.infer_multiple(cur, refs), ji.infer_multiple(cur, refs)
        assert o_t.shape == o_j.shape == (len(refs),)
        same((o_t, c_t), (o_j, c_j))
        np.testing.assert_allclose(y_t, y_j, atol=yaw_tol)

    best_t, best_j = ti.query_best(3, [0, 1, 2]), ji.query_best(3, [0, 1, 2])
    assert best_t[0] == best_j[0]
    same(best_t[1:2] + best_t[3:], best_j[1:2] + best_j[3:])
    assert abs(best_t[2] - best_j[2]) < yaw_tol
    assert ti.query_best(4, []) is None and ji.query_best(4, []) is None

    frame_t, frame_j = ti.dispatch_frame(5, [0, 3]), ji.dispatch_frame(5, [0, 3])
    assert frame_t.frame_id == frame_j.frame_id == 5
    assert frame_t.result[0] == frame_j.result[0]
    same(frame_t.result[1:2], frame_j.result[1:2])
    np.testing.assert_allclose(ti.feature_volumes, ji.feature_volumes, atol=0.05 * np.abs(fv_j).max())

    names = ["000000", "000001", "000002.bin"]
    (o_t, y_t), (o_j, y_j) = (
        inf.infer_multiple_vs_multiple(names, [0, 1, 2], [2, 1, 1]) for inf in (ti, ji)
    )
    same((o_t,), (o_j,))
    np.testing.assert_allclose(y_t, y_j, atol=yaw_tol)
    assert int(y_t[1]) == 0  # self-pair: zero shift


@pytest.mark.parametrize("shards", [1, 2])
def test_explicit_volume_entry_points_answer_on_every_store_layout(tree, shards):
    """infer_one and infer_multiple_vs_multiple score explicit volumes, which
    every store layout scores alike: Infer(shards=N) answers them as
    Infer() does."""
    _, tcfg = _cfgs(tree, leg_dtype="float32")
    plain = Infer(tcfg, db_capacity=16, device="cpu")
    sharded = Infer(tcfg, db_capacity=16, device="cpu", shards=shards)
    names = ["000000", "000001", "000002.bin"]
    for want, got in zip(
        (plain.infer_one("000000.bin", "000003.bin"),
         plain.infer_multiple_vs_multiple(names, [0, 1, 2], [2, 1, 1])),
        (sharded.infer_one("000000.bin", "000003.bin"),
         sharded.infer_multiple_vs_multiple(names, [0, 1, 2], [2, 1, 1]))):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


def test_cache_round_trip_and_jax_compatibility(tree, tmp_path):
    jcfg, tcfg = _cfgs(tree, leg_dtype="float32")
    ti = Infer(tcfg, db_capacity=16, device="cpu")
    for f in range(3):
        ti.infer_multiple(f, list(range(f)))
    path = str(tmp_path / "cache.npz")
    ti.save_cache(path)
    restored = Infer(tcfg, db_capacity=16, device="cpu")
    assert restored.restore_cache(path) == 3
    np.testing.assert_array_equal(restored.feature_volumes, ti.feature_volumes)
    a = ti.infer_multiple(3, [0, 2])
    b = restored.infer_multiple(3, [0, 2])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # a frame dispatched with its image in hand == the frame read from disk
    a = ti.dispatch_frame(4, [1, 3])
    b = restored.dispatch_frame(4, [1, 3], image=restored._load_image("000004"))
    assert a.result[0] == b.result[0] and a.result[1:] == pytest.approx(b.result[1:], abs=1e-6)
    ji = JaxInfer(jcfg, db_capacity=16)  # the JAX engine reads the port's cache
    assert ji.restore_cache(path) == 3
    np.testing.assert_allclose(ji.feature_volumes, ti.feature_volumes[:3])
    assert ji._frame_rows == {0: 0, 1: 1, 2: 2}


def test_descriptor_db_store(tmp_path, monkeypatch):
    """add/load/save/restore/score_pairs/query against explicit scoring."""
    calls = []

    def head(fa, fb):
        calls.append(fa.shape[0])
        logits = torch.einsum("bwc,bvc->bw", fa, fb)
        return fa.mean(dim=(1, 2))[:, None], logits

    db = DescriptorDB(head, capacity=40, width=6, channels=2, device="cpu")
    rng = np.random.default_rng(0)
    fv = rng.normal(size=(20, 6, 2)).astype(np.float32)
    assert db.add(fv[0]) == 0 and db.add(fv[1:20]) == 1 and len(db) == 20
    np.testing.assert_array_equal(db.feature_volumes, fv)
    ov, peak, conf = db.query(fv[3], [5, 7])
    ov2, peak2, conf2 = db.score_volumes(fv[[5, 7]], np.stack([fv[3], fv[3]]))
    np.testing.assert_allclose(ov, fv[[5, 7]].mean(axis=(1, 2)), rtol=1e-6)
    for x, y in ((ov, ov2), (peak, peak2), (conf, conf2)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(db.score_pairs([5, 7], [3, 3])[0], ov)
    with pytest.raises(IndexError):
        db.query(fv[0], [20])
    with pytest.raises(ValueError, match="capacity"):
        db.add(np.zeros((21, 6, 2), np.float32))
    db.save(str(tmp_path / "db.npz"))
    other = DescriptorDB(head, capacity=40, width=6, channels=2, device="cpu")
    assert other.restore(str(tmp_path / "db.npz")) == 20
    np.testing.assert_array_equal(other.feature_volumes, fv)
    with pytest.raises(ValueError, match="embedding shape"):
        other.load(np.zeros((2, 5, 2), np.float32))
    assert all(len(x) == 0 for x in db.query(fv[0], []))
    # long queries go to the heads in chunks, with the same results
    full = db.query(fv[0], np.arange(7))
    monkeypatch.setattr("overlapnet_torch.lcd.descriptor_db.MAX_PAIRS_PER_CALL", 3)
    calls.clear()
    for x, y in zip(db.query(fv[0], np.arange(7)), full):
        np.testing.assert_array_equal(x, y)
    assert calls == [3, 3, 1]


def test_infer_defaults_to_cuda_and_never_falls_back(tree):
    """With no card, Infer(cfg) raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is usable")
    _, tcfg = _cfgs(tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        Infer(tcfg)


def test_constructors_default_to_cuda_and_never_fall_back():
    """DescriptorDB() and build_model() with no device run on the card, and
    raise where none is visible (decided here, when the test runs)."""
    cfg = tconfig.ModelConfig(input_width=360)
    if torch.cuda.is_available():
        assert DescriptorDB(lambda fa, fb: None, width=6, channels=2).device.type == "cuda"
        assert next(build_model(cfg, 4).parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        DescriptorDB(lambda fa, fb: None, width=6, channels=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, 4)


def test_unported_weight_formats_raise(tree, tmp_path):
    """A directory that holds no checkpoint of the port (an orbax directory
    of the JAX package, say) is an explicit error that names the npz export;
    a Keras file goes to the HDF5 importer (tests/test_torch_train.py loads
    one), which rejects a file that is not HDF5."""
    _, tcfg = _cfgs(tree)
    tcfg.experiment.pretrained_weightsfilename = str(tmp_path)
    with pytest.raises(NotImplementedError, match="save_params_npz"):
        Infer(tcfg, device="cpu")
    pytest.importorskip("h5py")
    h5 = tmp_path / "model_geo.h5"
    h5.write_bytes(b"")
    tcfg.experiment.pretrained_weightsfilename = str(h5)
    with pytest.raises(OSError):
        Infer(tcfg, device="cpu")


def test_cli_infer(tree, tmp_path, capsys):
    from overlapnet_torch.cli.__main__ import main

    data_root, weights = tree
    yml = tmp_path / "network.yml"
    yml.write_text(yaml.safe_dump({
        "model": {"inputShape": [64, 360]},
        "pretrained_weightsfilename": weights,
    }))
    rc = main(["infer", str(yml), "000000.bin", "000000.bin",
               "--data-root", data_root, "--infer-seqs", "07", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Overlap:" in out and "Yaw [deg]: 0" in out
    assert main(["nope"]) == 2
