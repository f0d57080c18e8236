"""The port's data path against the JAX package on the CPU: sequence packs,
the native batcher, pair batches from packs, ``cli pack`` and ``cli train
--pack-dir``, and the resident store's dtype in ``cli train``.

Packs hold float32 copies of the images and the batcher copies bytes, so
everything here is held bit for bit.
"""

import json
import os

import numpy as np
import pytest
import yaml

from overlapnet_tpu.core.config import ChannelConfig as JaxChannelConfig
from overlapnet_tpu.data import dataset as jdata
from overlapnet_tpu.data.gt_files import PairList as JaxPairList
from overlapnet_tpu.data.pack import SequencePack as JaxPack
from overlapnet_tpu.data.pack import open_packs as jax_open_packs
from overlapnet_torch.cli import train as cli_train
from overlapnet_torch.cli.__main__ import main as cli_main
from overlapnet_torch.core.config import ChannelConfig
from overlapnet_torch.data import dataset as tdata
from overlapnet_torch.data import native
from overlapnet_torch.data.gt_files import PairList, save_gt_files
from overlapnet_torch.data.pack import SequencePack, open_packs
from overlapnet_torch.geometry.projection import pad_points
from overlapnet_torch.train.checkpoint import latest_step

H, W = 8, 24
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_images(root, seqs=("07", "08"), n_scans=6, h=H, w=W):
    rng = np.random.default_rng(3)
    for seq in seqs:
        for kind, ch in (("depth", None), ("normal", 3)):
            os.makedirs(os.path.join(root, seq, kind), exist_ok=True)
            for i in range(n_scans):
                shape = (h, w) if ch is None else (h, w, ch)
                np.save(os.path.join(root, seq, kind, f"{i:06d}.npy"),
                        rng.normal(size=shape).astype(np.float32))
    return str(root)


@pytest.fixture(scope="module")
def native_lib():
    return native.build()


def test_packs_cross_between_the_packages(tmp_path):
    """A pack written by the port is the JAX package's byte for byte, and
    each package opens the other's."""
    root = _write_images(tmp_path / "img")
    for seq in ("07", "08"):
        ours = SequencePack.build(root, seq, ChannelConfig(), str(tmp_path / "t"), H, W)
        theirs = JaxPack.build(root, seq, JaxChannelConfig(), str(tmp_path / "j"), H, W)
        for suffix in (".pack.npy", ".pack.json"):
            with open(tmp_path / "t" / (seq + suffix), "rb") as f, \
                    open(tmp_path / "j" / (seq + suffix), "rb") as g:
                assert f.read() == g.read(), seq + suffix
        assert ours.names == theirs.names == [f"{i:06d}" for i in range(6)]
        assert ours.data.shape == (6, H, W, 4)
        for opened in (SequencePack.open(str(tmp_path / "j"), seq),
                       JaxPack.open(str(tmp_path / "t"), seq)):
            np.testing.assert_array_equal(np.asarray(opened.data), np.asarray(ours.data))
            np.testing.assert_array_equal(
                opened.image("000004"),
                tdata.assemble_scan_image(root, seq, "000004", ChannelConfig(), H, W))
    # missing packs are skipped, as in the JAX package
    assert sorted(open_packs(str(tmp_path / "t"), ["07", "09"])) == ["07"]
    assert sorted(jax_open_packs(str(tmp_path / "t"), ["07", "09"])) == ["07"]


def test_native_build_stays_in_the_ports_build_dir(native_lib):
    """The port compiles native/batcher.cc into its git-ignored _build, not
    into native/."""
    build_dir = os.path.join(REPO, "overlapnet_torch", "_build") + os.sep
    assert native_lib.startswith(build_dir) and os.path.exists(native_lib)
    assert native.SOURCE == os.path.join(REPO, "native", "batcher.cc")
    assert native.available()
    assert native.build() == native_lib == native.library_path()  # idempotent


@pytest.mark.parametrize("shifted", [True, False], ids=["shifts", "no-shift"])
def test_gather_batch_is_np_roll(native_lib, shifted):
    rng = np.random.default_rng(0)
    src = rng.normal(size=(7, H, W, 4)).astype(np.float32)
    idx = np.array([3, 0, 6, 3, 5])
    shifts = np.array([0, 1, W - 1, W + 5, -7]) if shifted else None
    out = native.gather_batch(src, idx, shifts)
    want = np.stack([np.roll(src[i], 0 if shifts is None else int(s), axis=1)
                     for i, s in zip(idx, shifts if shifted else [0] * len(idx))])
    np.testing.assert_array_equal(out, want)
    assert out.flags.writeable and out.flags.c_contiguous
    # the numpy path (a non-contiguous source) gives the same bits
    np.testing.assert_array_equal(
        native.gather_batch(np.asfortranarray(src), idx, shifts), want)
    with pytest.raises(IndexError):
        native.gather_batch(src, np.array([7]), None)


def test_read_scans_is_pad_points(native_lib, tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    for i, n in enumerate((5, 20, 31)):
        pts = rng.normal(size=(n, 4)).astype(np.float32)
        paths.append(str(tmp_path / f"{i:06d}.bin"))
        pts.tofile(paths[-1])
    out = native.read_scans(paths, max_points=20)
    assert out.shape == (3, 20, 4) and out.dtype == np.float32
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(
            out[i], pad_points(np.fromfile(p, np.float32).reshape(-1, 4), 20))
    with pytest.raises(IOError):
        native.read_scans([str(tmp_path / "nope.bin")], max_points=8)
    bad = tmp_path / "bad.bin"
    np.arange(6, dtype=np.float32).tofile(bad)  # one and a half records
    with pytest.raises(IOError):
        native.read_scans([str(bad)], max_points=4)


def _pairs(cls, n_pairs, seed=5):
    rng = np.random.default_rng(seed)
    i1, i2 = rng.integers(0, 6, n_pairs), rng.integers(0, 6, n_pairs)
    seqs = np.array(["07", "08"])
    d1, d2 = list(seqs[rng.integers(0, 2, n_pairs)]), list(seqs[rng.integers(0, 2, n_pairs)])
    return cls([f"{i:06d}" for i in i1], [f"{i:06d}" for i in i2], d1, d2,
               rng.uniform(0, 1, n_pairs), rng.integers(0, 360, n_pairs).astype(float))


@pytest.mark.parametrize("rotate", [0, 1, 2])
def test_pack_batches_equal_the_jax_datasets(native_lib, tmp_path, rotate):
    """``PairImageDataset(packs=...)`` batches (native gather, fused roll)
    against the JAX dataset with the JAX package's packs, and against the
    port's own per-image batches; only sequence 07 is packed, so a batch
    mixes both paths. Two shuffled epochs."""
    root = _write_images(tmp_path / "img")
    SequencePack.build(root, "07", ChannelConfig(), str(tmp_path / "t"), H, W)
    JaxPack.build(root, "07", JaxChannelConfig(), str(tmp_path / "j"), H, W)
    kw = dict(height=H, width=W, rotate_data=rotate, seed=11, adjust_yaw_labels=True,
              leg_output_width=W // 4)
    packed = tdata.PairImageDataset(root, _pairs(PairList, 10), ChannelConfig(),
                                    packs=open_packs(str(tmp_path / "t"), ["07", "08"]), **kw)
    plain = tdata.PairImageDataset(root, _pairs(PairList, 10), ChannelConfig(), **kw)
    theirs = jdata.PairImageDataset(root, _pairs(JaxPairList, 10), JaxChannelConfig(),
                                    packs=jax_open_packs(str(tmp_path / "j"), ["07", "08"]), **kw)
    assert (packed._rows1 >= 0).any() and (packed._rows1 < 0).any()
    for epoch in (0, 1):
        b = dict(epoch=epoch, shuffle=True, drop_remainder=True)
        got, want, ref = (list(d.batches(4, **b)) for d in (packed, theirs, plain))
        assert len(got) == len(want) == len(ref) == 2
        for x, y, z in zip(got, want, ref):
            assert x.keys() == y.keys() == z.keys()
            for k in y:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
                np.testing.assert_array_equal(x[k], z[k], err_msg=k)


def _gt_and_yml(tmp_path, root, **extra):
    """GT files for sequence 07 and a network.yml of the small CPU model
    (64 x 360 inputs, fp32 legs) reading them."""
    rng = np.random.default_rng(4)
    n = 8
    table = np.stack([rng.integers(0, 6, n), rng.integers(0, 6, n), rng.uniform(0, 1, n),
                      rng.integers(0, 90, n)], axis=1).astype(float)
    save_gt_files(os.path.join(root, "07", "ground_truth"), "07", table, table, table[:3])
    exp = str(tmp_path / "exp")
    os.makedirs(exp, exist_ok=True)
    cfg = {
        "data_root_folder": root, "experiments_path": exp, "testname": "mini",
        "training_seqs": "07", "batch_size": 2, "no_epochs": 1, "no_batches_in_epoch": 2,
        "no_test_pairs": 2, "learning_rate": 0.001, "rotate_training_data": 1,
        "model": {"inputShape": [64, 360, 4], "leg_dtype": "float32"},
        "use_depth": True, "use_normals": True, "infer_seqs": "07", **extra,
    }
    path = os.path.join(exp, "network.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, os.path.join(exp, "mini")


def test_cli_pack_then_train_from_packs(native_lib, tmp_path):
    """``cli pack`` builds the pack of the training sequence; ``cli train
    --pack-dir`` takes two CPU steps from it, host batches (the native
    gather) and the resident store alike."""
    root = _write_images(tmp_path / "img", seqs=("07",), h=64, w=360)
    yml, _ = _gt_and_yml(tmp_path, root)
    packs = str(tmp_path / "packs")
    assert cli_main(["pack", yml, "--out-dir", packs]) == 0
    pack = SequencePack.open(packs, "07")
    assert pack.data.shape == (6, 64, 360, 4)
    np.testing.assert_array_equal(
        pack.image("000002"), tdata.assemble_scan_image(root, "07", "000002", ChannelConfig(),
                                                        64, 360))
    for name, extra in (("host", ["--no-resident"]), ("resident", [])):
        yml, exp = _gt_and_yml(tmp_path / name, root)
        assert cli_main(["train", yml, "--device", "cpu", "--pack-dir", packs, *extra]) == 0
        assert latest_step(os.path.join(exp, "checkpoints")) == 2
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        assert [x["phase"] for x in lines] == ["train", "validation"]
        assert np.isfinite(lines[0]["epoch_loss"])


def test_cli_train_builds_the_resident_store_in_float32(tmp_path, monkeypatch):
    """As the JAX CLI: ``ResidentPairs`` at float32 whatever
    ``train.input_dtype`` says (it casts host batches only)."""
    root = _write_images(tmp_path / "img", seqs=("07",), h=64, w=360)
    yml, _ = _gt_and_yml(tmp_path, root, input_dtype="bfloat16")
    given = []

    def recording(ds, *args, **kw):
        given.append((args, kw))
        store = tdata.ResidentPairs(ds, *args, **kw)
        given[-1] += (store.images.dtype,)
        return store

    monkeypatch.setattr(cli_train, "ResidentPairs", recording)
    assert cli_main(["train", yml, "--device", "cpu"]) == 0
    (args, kw, dtype), = given
    assert kw.get("input_dtype", "float32") == "float32" and not args
    assert str(dtype) == "torch.float32"
