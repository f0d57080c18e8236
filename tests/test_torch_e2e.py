"""The port's end-to-end harness (``sim/e2e.py``) against the JAX package's,
on the CPU, on an 8-frame sim sequence (130,000-point scans, 64x900 images)
and the small input_width=360 model (W'=90) with fp32 legs.

Tolerances. The scans and poses are equal; the images of the two packages
differ on at most 5e-4 of the pixels (the port's atan2/asin are rounded
from float64, the JAX package's are float32: 6 of 57,600 pixels measured),
so the GT overlaps are held to two pixels of their query. Closures: frame
and match equal, overlap within 1e-4, yaw within 1e-2 degrees. ATE before
the pose graph within 1e-4 m; after it, within the JAX package's own float32
noise (its float32 and float64 answers differ by 1.5 cm on the forged loop:
200 CG steps amplify an ulp, see tests/test_torch_backend.py).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from overlapnet_tpu.models import init_params as jax_init_params
from overlapnet_tpu.sim import e2e as je2e
from overlapnet_tpu.train.checkpoint import save_params_npz
from overlapnet_torch.core.profiling import StepTimer, trace
from overlapnet_torch.lcd.online import LoopClosure
from overlapnet_torch.sim import e2e as te2e
from overlapnet_torch.weights import load_npz

N_FRAMES = 8
SMALL = {"input_width": 360, "leg_dtype": "float32"}
W_OUT = 90
PIXEL_SHARE = 0.9995  # measured: 6 of 57,600 pixels of one scan differ


def assert_same_sequence(jdir: str, tdir: str, images=("depth", "normal")):
    """Scans and text files equal byte for byte; images equal where the
    projection picked the same point, on PIXEL_SHARE of the pixels."""
    for name in ("poses.txt", "calib.txt", "covariance.txt"):
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    scans = sorted(os.listdir(os.path.join(jdir, "velodyne")))
    assert scans == sorted(os.listdir(os.path.join(tdir, "velodyne")))
    for s in scans:
        with open(os.path.join(jdir, "velodyne", s), "rb") as a, \
                open(os.path.join(tdir, "velodyne", s), "rb") as b:
            assert a.read() == b.read(), s
    for kind in images:
        names = sorted(os.listdir(os.path.join(jdir, kind)))
        assert names == sorted(os.listdir(os.path.join(tdir, kind))) and len(names) == len(scans)
        for n in names:
            a, b = (np.load(os.path.join(d, kind, n)) for d in (jdir, tdir))
            assert a.shape == b.shape and a.dtype == b.dtype
            same = (a == b).reshape(a.shape[0], a.shape[1], -1).all(-1)
            assert same.mean() >= PIXEL_SHARE, (kind, n, same.mean())


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """The sequence and its GT from both packages, and one JAX weights file
    of the small cosine-head model ``make_config`` builds."""
    root = tmp_path_factory.mktemp("e2e")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jfiles, jposes = je2e.generate_sequence(jdir, N_FRAMES)
    tfiles, tposes = te2e.generate_sequence(tdir, N_FRAMES, device="cpu")
    jgt = je2e.build_gt(jdir, jfiles, jposes, leg_output_width=W_OUT)
    tgt = te2e.build_gt(tdir, tfiles, tposes, leg_output_width=W_OUT, device="cpu")
    jcfg = je2e.make_config(jdir, dict(SMALL), batch_size=4)
    weights = str(root / "params.npz")
    save_params_npz(weights, jax_init_params(jcfg.model, 4, rng=0))
    return {"jax": (jdir, jfiles, jposes, jgt), "port": (tdir, tfiles, tposes, tgt),
            "jcfg": jcfg, "weights": weights}


def test_generate_sequence_and_build_gt_match_jax(seq, capsys):
    jdir, jfiles, jposes, jgt = seq["jax"]
    tdir, tfiles, tposes, tgt = seq["port"]
    np.testing.assert_array_equal(tposes, jposes)
    assert sorted(tfiles) == sorted(jfiles)
    assert_same_sequence(os.path.join(jdir, "00"), os.path.join(tdir, "00"))
    with open(os.path.join(tdir, "00", "sequence_params.json")) as f, \
            open(os.path.join(jdir, "00", "sequence_params.json")) as g:
        assert f.read() == g.read()

    jt, tt = jgt["gt_table"], tgt["gt_table"]
    assert tt.shape == jt.shape == (N_FRAMES * N_FRAMES, 4)
    np.testing.assert_array_equal(tt[:, [0, 1, 3]], jt[:, [0, 1, 3]])
    valid = np.array([(np.load(os.path.join(jdir, "00", "depth", f"{i:06d}.npy")) > 0).sum()
                      for i in range(N_FRAMES)])
    assert (np.abs(tt[:, 2] - jt[:, 2]) <= 2.0 / valid[jt[:, 0].astype(int)]).all()
    for key in ("train_set", "validation_set"):
        with np.load(jgt[key]) as a, np.load(tgt[key]) as b:
            assert sorted(a.files) == sorted(b.files)
            np.testing.assert_array_equal(b["seq"], a["seq"])
            np.testing.assert_array_equal(b["overlaps"][:, [0, 1, 3]], a["overlaps"][:, [0, 1, 3]])
            np.testing.assert_allclose(b["overlaps"][:, 2], a["overlaps"][:, 2], rtol=0, atol=1e-3)

    # the stamps make a second call reuse the sequence and its GT
    capsys.readouterr()
    files, _ = te2e.generate_sequence(tdir, N_FRAMES, device="cpu")
    again = te2e.build_gt(tdir, files, tposes, leg_output_width=W_OUT, device="cpu")
    assert "reusing existing sequence" in capsys.readouterr().out
    np.testing.assert_array_equal(again["gt_table"], tt)


def test_make_config_follows_the_jax_overrides(seq):
    jcfg = seq["jcfg"]
    tcfg = te2e.make_config(seq["jax"][0], dict(SMALL), device="cpu", batch_size=4)
    for part in ("model", "train", "data", "experiment"):
        want = dataclasses.asdict(getattr(jcfg, part))
        got = dataclasses.asdict(getattr(tcfg, part))
        assert got.keys() == want.keys(), part
        assert got == want, part
    assert tcfg.train.steps_per_dispatch == 1
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            te2e.make_config(seq["jax"][0])


def test_run_lcd_matches_jax(seq):
    """One weights file through both engines on the JAX package's tree."""
    jdir, jfiles, jposes, jgt = seq["jax"]
    jcfg = seq["jcfg"]
    tcfg = te2e.make_config(jdir, dict(SMALL), device="cpu", batch_size=4)
    want = je2e.run_lcd(jcfg, jax_init_params(jcfg.model, 4, rng=0), jposes, jgt["gt_table"],
                        covariance_file=jfiles["covariance_file"])
    got = te2e.run_lcd(tcfg, load_npz(seq["weights"]), jposes, jgt["gt_table"],
                       covariance_file=jfiles["covariance_file"], device="cpu")
    assert want["n_closures"] > 0
    assert [(c.frame, c.match) for c in got["closures"]] == [
        (c.frame, c.match) for c in want["closures"]]
    for a, b in zip(got["closures"], want["closures"]):
        assert a.overlap == pytest.approx(b.overlap, abs=1e-4)
        assert a.yaw_deg == pytest.approx(b.yaw_deg, abs=1e-2)
        assert a.confidence == pytest.approx(b.confidence, abs=1e-4)
    for key in ("n_closures", "true_positives", "false_positives", "positive_frames",
                "precision", "recall", "f1"):
        assert got[key] == want[key], key
    assert got["yaw_rmse_deg"] == pytest.approx(want["yaw_rmse_deg"], abs=1e-2, nan_ok=True)


def test_run_pose_graph_matches_jax_on_forged_closures():
    """A 64-frame two-lap loop: every second second-lap frame closes on its
    twin with the true yaw."""
    import jax

    from overlapnet_torch.geometry.rotations import relative_yaw
    from overlapnet_torch.sim.world import loop_trajectory

    poses = loop_trajectory(64, laps=2.0)
    closures = [LoopClosure(f, f - 32, 0.8, float(np.degrees(relative_yaw(poses[f - 32], poses[f]))))
                for f in range(36, 64, 2)]
    want = je2e.run_pose_graph(poses, closures)
    with jax.enable_x64(True):
        want64 = je2e.run_pose_graph(poses, closures)
    got = te2e.run_pose_graph(poses, closures, device="cpu")
    assert got["ate_before_m"] == pytest.approx(want["ate_before_m"], abs=1e-4)
    noise = abs(want["ate_after_m"] - want64["ate_after_m"])
    assert abs(got["ate_after_m"] - want["ate_after_m"]) <= noise, (got, want, want64)
    assert got["ate_after_m"] < got["ate_before_m"] / 5
    assert te2e.run_pose_graph(poses, [], device="cpu")["ate_after_m"] == got["ate_before_m"]


def test_train_and_eval_resumes_where_the_budget_stopped(seq, tmp_path):
    """A budget spent after epoch 0, then a rerun, equals a straight run
    (on the first 16 train and 4 validation pairs, to keep the test short)."""
    tdir, _, _, tgt = seq["port"]
    tgt = dict(tgt)
    for key, n in (("train_set", 16), ("validation_set", 4)):
        with np.load(tgt[key]) as data:
            tgt[key] = str(tmp_path / f"{key}.npz")
            np.savez(tgt[key], **{k: data[k][:n] for k in data.files})
    cfg = te2e.make_config(tdir, dict(SMALL), device="cpu", batch_size=4, no_epochs=2)
    straight = te2e.train_and_eval(cfg, tgt, device="cpu")
    work = str(tmp_path / "chunked")
    os.makedirs(work)
    assert te2e.train_and_eval(cfg, tgt, time_budget_s=1e-9, work_dir=work, device="cpu") is None
    assert os.path.exists(os.path.join(work, "train_partial.json"))
    assert any(f.startswith("step_") for f in os.listdir(os.path.join(work, "train_ckpt")))
    resumed = te2e.train_and_eval(cfg, tgt, time_budget_s=1e9, work_dir=work, device="cpu")
    assert resumed is not None
    for key in ("n_train_pairs", "n_val_pairs", "epoch0_loss", "epoch1_loss", "untrained",
                "trained"):
        assert resumed[key] == straight[key], key
    for name, t in straight["params"].items():
        assert torch.equal(resumed["params"][name], t), name


def test_step_timer_and_trace(tmp_path):
    timer = StepTimer()
    for items in (3, 5):
        timer.start()
        assert timer.stop(items, sync=torch.ones(2)) >= 0.0
    assert (timer.steps, timer.items) == (2, 8)
    assert timer.items_per_sec == pytest.approx(8 / timer.total_s)
    assert timer.sec_per_step == pytest.approx(timer.total_s / 2)
    assert set(timer.summary("train")) == {
        "train_steps", "train_sec_per_step", "train_items_per_sec"}
    assert StepTimer().summary() == {"steps": 0, "sec_per_step": 0.0, "items_per_sec": 0.0}
    with trace(None):
        pass
    with trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert sorted(os.listdir(tmp_path / "prof")) == ["key_averages.txt", "trace.json"]


@pytest.mark.slow
def test_e2e_floors(tmp_path):
    """The floors of tests/test_accuracy_floor.py on the port, on the CPU
    (fp32 legs: PyTorch's CPU bf16 conv weight gradient has returned NaN)."""
    m = te2e.run_e2e(str(tmp_path / "e2e"), n_frames=12, epochs=8, batch_size=4,
                     model_overrides={"leg_dtype": "float32"}, device="cpu")
    assert m["trained_overlap_rms_error"] < 0.8 * m["untrained_overlap_rms_error"], m
    assert m["lcd_f1"] >= 0.9, m
    assert m["lcd_false_positives"] <= m["lcd_true_positives"], m
    assert m.get("lcd_yaw_err_p50_deg", 0.0) <= 2.0, m
    assert m["ate_after_m"] <= m["ate_before_m"] * 1.2, m


@pytest.mark.slow
def test_trainability_ab_one_epoch(tmp_path, capsys):
    import json

    from overlapnet_torch.sim import trainability_ab

    out = str(tmp_path / "ab.json")
    assert trainability_ab.main(["--work-dir", str(tmp_path / "ab"), "--frames", "12",
                                 "--epochs", "1", "--out", out, "--device", "cpu"]) == 0
    with open(out) as f:
        res = json.load(f)
    for arm in ("A_reference_parity", "B_trainability"):
        assert len(res[arm]["epoch_loss"]) == 1 and "overlap_rms_error" in res[arm]["final"]
    assert res["A_reference_parity"]["config"]["optimizer"] == "adagrad"
    assert res["B_trainability"]["config"]["optimizer"] == "adam"
