"""The port's online loop-closing slice (gating, ShardedDescriptorDB, the
fused frame step of Infer(shards=...), OnlineLoopCloser, ``cli lcd``) vs the
JAX package on the CPU: the same numpy-seeded inputs and one weights file
(``save_params_npz`` -> ``load_npz``) go through both, at the small
input_width=360 geometry (W'=90 valid, 180 circular).

Tolerances. Both engines run fp32 on the CPU here, so they differ by
summation order only: overlap and confidence atol 2e-5 (1e-5 for the DB on
explicit volumes), sub-bin yaw peak atol 1e-4 bins, yaw atol 1e-3 degrees.
Top-k results are compared on live entries only (overlap > -1): with k above
the candidate count the fillers' ids are arbitrary in both engines.
"""

import functools
import os
import time

import jax
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
from overlapnet_tpu.geometry import kitti as jax_kitti
from overlapnet_tpu.lcd import gating as jax_gating
from overlapnet_tpu.lcd.descriptor_db import ShardedDescriptorDB as JaxShardedDB
from overlapnet_tpu.lcd.infer import Infer as JaxInfer
from overlapnet_tpu.lcd.online import OnlineLoopCloser as JaxOnlineLoopCloser
from overlapnet_tpu.models import init_params as jax_init_params
from overlapnet_tpu.models import make_head_apply
from overlapnet_tpu.parallel.mesh import make_mesh
from overlapnet_tpu.train.checkpoint import save_params_npz
from overlapnet_torch.core import config as tconfig
from overlapnet_torch.core import profiling
from overlapnet_torch.geometry import kitti
from overlapnet_torch.lcd import gating, online
from overlapnet_torch.lcd.descriptor_db import ShardedDescriptorDB
from overlapnet_torch.lcd.infer import Infer, PendingFrame
from overlapnet_torch.lcd.online import LoopClosure, OnlineLoopCloser
from overlapnet_torch.models import build_model
from overlapnet_torch.weights import load_npz

LAP = 12  # frames per lap of the seeded loop
N_FRAMES = 2 * LAP
CLI_OUT, CLI_REVISITS = 101, 10  # the sequence `cli lcd` runs on: out, then back


def _mesh(d):
    return make_mesh(d, devices=jax.devices("cpu"))


@functools.cache
def _jax_params(leg_padding="valid"):
    """One seeded JAX parameter set per geometry, shared by the tests."""
    return jax_init_params(ModelConfig(input_width=360, leg_padding=leg_padding), 4, rng=3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A two-lap sequence as a preprocessed-image tree (depth + normal) with
    a JAX weights export. Second-lap scans are column-rolled first-lap scans
    plus small noise: revisits with a clear yaw peak."""
    root = tmp_path_factory.mktemp("lcd")
    rng = np.random.default_rng(4)
    h, w = 64, 360
    for kind in ("depth", "normal"):
        os.makedirs(root / "data" / "07" / kind)
    for i in range(LAP):
        depth = np.abs(rng.normal(size=(h, w))).astype(np.float32) * 10.0
        normal = rng.normal(size=(h, w, 3)).astype(np.float32)
        for lap in range(2):
            if lap:
                shift = 20 + 4 * i
                depth = np.roll(depth, shift, axis=1) + 0.01 * rng.normal(size=(h, w)).astype(np.float32)
                normal = np.roll(normal, shift, axis=1)
            np.save(root / "data" / "07" / "depth" / f"{i + lap * LAP:06d}.npy", depth)
            np.save(root / "data" / "07" / "normal" / f"{i + lap * LAP:06d}.npy", normal)
    # sequence 08, long enough for the demo3 thresholds (candidates are more
    # than 100 frames old): CLI_OUT frames out, then CLI_REVISITS frames
    # that revisit the first ones; its files are links into sequence 07
    for kind in ("depth", "normal"):
        os.makedirs(root / "data" / "08" / kind)
        for i in range(CLI_OUT + CLI_REVISITS):
            src = i % LAP if i < CLI_OUT else LAP + (i - CLI_OUT) % LAP
            os.symlink(root / "data" / "07" / kind / f"{src:06d}.npy",
                       root / "data" / "08" / kind / f"{i:06d}.npy")
    weights = str(root / "params.npz")
    save_params_npz(weights, _jax_params())
    return str(root / "data"), weights


def _cfgs(tree, **model_kw):
    """The same configuration for the JAX package and the port (fp32 legs)."""
    data_root, weights = tree
    kw = dict(
        channels=ChannelConfig(),
        model=ModelConfig(input_width=360, **{"leg_dtype": "float32", **model_kw}),
        train=TrainConfig(batch_size=2),
        data=DataConfig(data_root_folder=data_root, infer_seqs="07"),
        experiment=ExperimentConfig(pretrained_weightsfilename=weights),
    )
    tkw = {k: getattr(tconfig, type(v).__name__)(**vars(v)) for k, v in kw.items()}
    return OverlapNetConfig(**kw), tconfig.OverlapNetConfig(**tkw)


def _loop_poses():
    """Two laps of a 20 m circle, LAP frames each (about 10 m apart), and
    covariances whose 3-sigma ellipse (15 m) holds a few first-lap frames."""
    ang = 2 * np.pi * np.arange(N_FRAMES) / LAP
    poses = np.tile(np.eye(4), (N_FRAMES, 1, 1))
    poses[:, 0, 3] = 20.0 * np.cos(ang)
    poses[:, 1, 3] = 20.0 * np.sin(ang)
    covs = np.tile(np.eye(6) * 25.0, (N_FRAMES, 1, 1))
    return poses, covs


LOOP_GATES = dict(inactive_time=6, inactive_dist=50.0)


def _assert_same_closures(got, want, exact=False):
    assert [(c.frame, c.match) for c in got] == [(c.frame, c.match) for c in want]
    tol = 0.0 if exact else 1.0
    for a, b in zip(got, want):
        assert a.overlap == pytest.approx(b.overlap, abs=2e-5 * tol)
        assert a.yaw_deg == pytest.approx(b.yaw_deg, abs=1e-3 * tol)
        assert a.confidence == pytest.approx(b.confidence, abs=2e-5 * tol)


# -- gating and the KITTI loaders (copies) ------------------------------------


def test_gating_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = rng.normal(size=(2, 2))
        cov = a @ a.T
        e_t = gating.CovarianceEllipse.from_covariance(cov, 3.0)
        e_j = jax_gating.CovarianceEllipse.from_covariance(cov, 3.0)
        assert (e_t.width, e_t.height, e_t.angle_deg) == (e_j.width, e_j.height, e_j.angle_deg)
        dx, dy = rng.normal(size=(2, 50)) * e_j.width
        np.testing.assert_array_equal(e_t.contains(dx, dy), e_j.contains(dx, dy))
    positions = np.cumsum(rng.normal(size=(300, 2)), axis=0)
    np.testing.assert_array_equal(
        gating.trajectory_lengths(positions), jax_gating.trajectory_lengths(positions)
    )


def test_candidate_mask_matches_jax_on_a_seeded_trajectory():
    rng = np.random.default_rng(1)
    # a 300-frame random walk that keeps crossing itself
    positions = np.cumsum(rng.normal(size=(300, 2)) * 2.0, axis=0)
    traj = gating.trajectory_lengths(positions)
    selected = 0
    for idx in range(300):
        a = rng.normal(size=(2, 2)) * 4.0
        args = (idx, positions, traj)
        m_t = gating.candidate_mask(
            *args, gating.CovarianceEllipse.from_covariance(a @ a.T), 100, 50.0)
        m_j = jax_gating.candidate_mask(
            *args, jax_gating.CovarianceEllipse.from_covariance(a @ a.T), 100, 50.0)
        np.testing.assert_array_equal(m_t, m_j)
        selected += int(m_t.sum())
    assert selected > 0


def _write_kitti(folder, poses, covs):
    """poses.txt (3x4 rows), calib.txt (a Tr: line) and covariance.txt
    (n x 36) in KITTI's text formats; returns their paths."""
    paths = [str(folder / n) for n in ("poses.txt", "calib.txt", "covariance.txt")]
    np.savetxt(paths[0], poses[:, :3, :4].reshape(len(poses), 12))
    with open(paths[1], "w") as f:
        f.write("P0: 1 0 0 0 0 1 0 0 0 0 1 0\n")
        f.write("Tr: 0 -1 0 0.1 0 0 -1 0.2 1 0 0 0.3\n")
    np.savetxt(paths[2], covs.reshape(len(covs), 36))
    return paths


def test_kitti_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, :3, :4] = rng.normal(size=(5, 3, 4))
    covs = rng.normal(size=(5, 6, 6))
    p, c, v = _write_kitti(tmp_path, poses, covs)
    np.testing.assert_array_equal(kitti.load_poses(p), jax_kitti.load_poses(p))
    np.testing.assert_array_equal(kitti.load_calib(c), jax_kitti.load_calib(c))
    np.testing.assert_array_equal(kitti.load_covariances(v), jax_kitti.load_covariances(v))
    np.testing.assert_array_equal(
        kitti.poses_cam_to_velo(kitti.load_poses(p), kitti.load_calib(c)),
        jax_kitti.poses_cam_to_velo(jax_kitti.load_poses(p), jax_kitti.load_calib(c)),
    )
    scan = rng.normal(size=(7, 4)).astype(np.float32)
    scan.tofile(tmp_path / "000000.bin")
    np.testing.assert_array_equal(kitti.load_scan(str(tmp_path / "000000.bin")), scan)
    assert kitti.load_vertex(str(tmp_path / "000000.bin")).shape == (7, 4)
    assert kitti.load_files(str(tmp_path))[0].endswith("000000.bin")


# -- ShardedDescriptorDB --------------------------------------------------------


def _live(vals, *others):
    keep = np.asarray(vals) > -1.0
    return [np.asarray(x)[keep] for x in (vals, *others)]


def _assert_topk_equal(out_t, out_j):
    (v_t, g_t, y_t, c_t), (v_j, g_j, y_j, c_j) = _live(*out_t), _live(*out_j)
    np.testing.assert_array_equal(g_t, g_j)
    np.testing.assert_allclose(v_t, v_j, atol=1e-5)
    np.testing.assert_allclose(y_t, y_j, atol=1e-4)
    np.testing.assert_allclose(c_t, c_j, atol=1e-5)


@pytest.mark.parametrize("shards,leg_padding", [
    (1, "valid"), (2, "circular"), (4, "valid"), (8, "valid"),
])
def test_sharded_db_matches_jax(shards, leg_padding, tmp_path):
    jcfg = ModelConfig(input_width=360, leg_padding=leg_padding)
    w = 90 if leg_padding == "valid" else 180
    jparams = _jax_params(leg_padding)
    weights = str(tmp_path / "params.npz")
    save_params_npz(weights, jparams)
    model = build_model(tconfig.ModelConfig(input_width=360, leg_padding=leg_padding), 4,
                        device="cpu")
    model.load_state_dict(load_npz(weights))
    rng = np.random.default_rng(7)
    fvs = np.maximum(rng.normal(size=(11, w, 128)), 0).astype(np.float32)

    jdb = JaxShardedDB(make_head_apply(jcfg), jparams, _mesh(shards), capacity=21, width=w)
    tdb = ShardedDescriptorDB(model.eval().score, capacity=21, width=w, shards=shards,
                              device="cpu")
    assert tdb.capacity == jdb.capacity
    for db in (jdb, tdb):
        assert db.add(fvs[0]) == 0 and db.add(fvs[1:]) == 1 and len(db) == 11
    np.testing.assert_array_equal(tdb.feature_volumes, fvs)
    np.testing.assert_array_equal(jdb.feature_volumes, fvs)

    mask = np.zeros(21, bool)
    mask[[0, 1, 3, 6, 10, 15]] = True  # row 15 is not live
    ov_t, yaw_t, conf_t = tdb.query_all(fvs[5], mask)
    ov_j, yaw_j, conf_j = jdb.query_all(fvs[5], mask)
    assert ov_t.shape == ov_j.shape == (tdb.capacity,)
    np.testing.assert_array_equal(ov_t > -1.0, ov_j > -1.0)
    np.testing.assert_array_equal(np.flatnonzero(ov_t > -1.0), [0, 1, 3, 6, 10])
    scored = ov_j > -1.0
    np.testing.assert_allclose(ov_t, ov_j, atol=1e-5)
    np.testing.assert_allclose(yaw_t[scored], yaw_j[scored], atol=1e-4)
    np.testing.assert_allclose(conf_t[scored], conf_j[scored], atol=1e-5)
    assert not yaw_t[~scored].any() and not conf_t[~scored].any()

    # best 3 of all rows and of the mask; then k above the candidate count
    _assert_topk_equal(tdb.query_topk(fvs[4], k=3), jdb.query_topk(fvs[4], k=3))
    _assert_topk_equal(tdb.query_topk(fvs[4], k=3, candidate_mask=mask),
                       jdb.query_topk(fvs[4], k=3, candidate_mask=mask))
    few = np.zeros(21, bool)
    few[[2, 9]] = True
    out_t = tdb.query_topk(fvs[4], k=3, candidate_mask=few)
    out_j = jdb.query_topk(fvs[4], k=3, candidate_mask=few)
    assert out_t[0].shape == out_j[0].shape == (3,)
    assert (out_t[0] > -1.0).sum() == (out_j[0] > -1.0).sum() == 2
    _assert_topk_equal(out_t, out_j)
    # k is capped at the live slot bucket, as in the JAX store (:537)
    assert tdb.query_topk(fvs[4], k=64)[0].shape == (shards * jdb._slots_bucket(11),)

    # a batch of queries with a shared mask and with per-query masks
    queries = fvs[[3, 7]]
    masks = np.zeros((2, 21), bool)
    masks[0, 2:9] = True
    for m in (mask, masks):
        out_t = tdb.query_topk_batch(queries, k=3, candidate_mask=m)
        out_j = jdb.query_topk_batch(queries, k=3, candidate_mask=m)
        assert out_t[0].shape == out_j[0].shape == (2, 3)
        for qi in range(2):
            _assert_topk_equal([x[qi] for x in out_t], [x[qi] for x in out_j])
    assert np.all(out_t[0][1] == -1.0)  # the second query has no candidate

    # frame steps grow the store past its first allocation (16 rows); the
    # JAX store takes the same rows by add, then scores them the same way
    first = np.zeros(21, bool)
    first[[0, 2, 5, 9]] = True
    grows = profiling.totals().get("db.grows", 0)
    more = np.maximum(rng.normal(size=(7, w, 128)), 0).astype(np.float32)
    for i, fv in enumerate(more):
        row, (packed, _) = tdb.frame_step(None, first, fv=fv)
        assert row == jdb.add(fv) == 11 + i
        _assert_topk_equal([x[None] for x in packed.numpy()],
                           jdb.query_topk(fv, k=1, candidate_mask=first))
    assert profiling.totals()["db.grows"] > grows and len(tdb) == 18
    np.testing.assert_array_equal(tdb.feature_volumes, np.concatenate([fvs, more]))
    ov_t, yaw_t, _ = tdb.query_all(more[3], mask)
    ov_j, yaw_j, _ = jdb.query_all(more[3], mask)
    np.testing.assert_array_equal(np.flatnonzero(ov_t > -1.0), [0, 1, 3, 6, 10, 15])
    np.testing.assert_allclose(ov_t, ov_j, atol=1e-5)
    np.testing.assert_allclose(yaw_t[ov_j > -1.0], yaw_j[ov_j > -1.0], atol=1e-4)
    _assert_topk_equal(tdb.query_topk(more[3], k=5), jdb.query_topk(more[3], k=5))

    # save / restore, both ways: each store takes 7 rows the other saved
    tdb.load(fvs[:7])
    jdb.load(fvs[4:])
    tdb.save(str(tmp_path / "t.npz"))
    jdb.save(str(tmp_path / "j.npz"))
    assert jdb.restore(str(tmp_path / "t.npz")) == tdb.restore(str(tmp_path / "j.npz")) == 7
    np.testing.assert_array_equal(jdb.feature_volumes, fvs[:7])
    np.testing.assert_array_equal(tdb.feature_volumes, fvs[4:])


def test_sharded_db_store_semantics(monkeypatch):
    """Chunked scoring, ties, fillers, the k cap and the errors, on a head
    whose scores are known."""
    calls = []

    def head(fa, fb):
        calls.append(fa.shape[0])
        return fa[:, 0, :1], torch.einsum("bwc,bvc->bw", fa, fb)

    with pytest.raises(ValueError, match="2\\*\\*24"):
        ShardedDescriptorDB(head, capacity=2**24, width=1, channels=1, device="cpu")
    db = ShardedDescriptorDB(head, capacity=10, width=6, channels=2, shards=4, device="cpu")
    assert db.capacity == 12
    rng = np.random.default_rng(0)
    fv = rng.normal(size=(9, 6, 2)).astype(np.float32)
    fv[:, 0, 0] = [0.1, 0.7, 0.3, 0.7, 0.2, 0.7, 0.0, 0.5, 0.4]  # the overlaps
    db.add(fv)
    # equal overlaps rank by store order (shard-major), as lax.top_k ranks
    # the JAX store's flat rows: rows 1 and 5 (shard 1) before row 3 (shard 3)
    vals, ids, _, _ = db.query_topk(fv[0], k=4)
    np.testing.assert_array_equal(ids, [1, 5, 3, 7])
    np.testing.assert_allclose(vals, [0.7, 0.7, 0.7, 0.5])
    # k is capped at the live slot bucket (9 rows on 4 shards: 4 slots each)
    assert db.query_topk(fv[0], k=100)[0].shape == (12,)
    vals, ids, yaw, conf = db.query_topk(fv[0], k=3, candidate_mask=np.arange(9) == 4)
    np.testing.assert_array_equal(vals > -1.0, [True, False, False])
    assert ids[0] == 4 and not yaw[1:].any() and not conf[1:].any()
    # candidates go to the heads in chunks, with the same results
    full = db.query_topk(fv[2], k=9)
    monkeypatch.setattr("overlapnet_torch.lcd.descriptor_db.MAX_PAIRS_PER_CALL", 4)
    calls.clear()
    for x, y in zip(db.query_topk(fv[2], k=9), full):
        np.testing.assert_array_equal(x, y)
    assert calls == [4, 4, 1]

    with pytest.raises(RuntimeError, match="set_embedder"):
        db.frame_step(np.zeros((6, 2)), None)
    db.set_embedder(lambda x: x)
    row, (packed, event) = db.frame_step(fv[1], None)
    assert row == 9 and event is None and len(db) == 10
    assert packed.tolist()[:2] == [pytest.approx(0.7), 1.0]  # never the new row itself
    with pytest.raises(ValueError, match="embedding shape"):
        db.add(np.zeros((5, 2), np.float32))
    with pytest.raises(ValueError, match="2 candidate masks for 1 queries"):
        db.query_topk_batch(fv[:1], candidate_mask=np.ones((2, 12), bool))
    db.add(fv[:2])
    with pytest.raises(ValueError, match="capacity"):
        db.add(fv[0])
    with pytest.raises(ValueError, match="capacity"):
        db.frame_step(fv[1], None)
    with pytest.raises(ValueError, match="capacity"):
        db.load(np.zeros((13, 6, 2), np.float32))
    assert db.load(fv[:0]) == 0 and len(db) == 0


def test_sharded_constructors_default_to_cuda_and_never_fall_back(tree):
    """Infer(cfg, shards=1) and ShardedDescriptorDB() run on the card, and
    raise where none is visible (decided here, when the test runs)."""
    _, tcfg = _cfgs(tree)
    if torch.cuda.is_available():
        assert ShardedDescriptorDB(lambda fa, fb: None, capacity=4, width=6,
                                   channels=2).device.type == "cuda"
        assert Infer(tcfg, db_capacity=4, shards=1).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedDescriptorDB(lambda fa, fb: None, capacity=4, width=6, channels=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Infer(tcfg, db_capacity=4, shards=1)


# -- Infer on the sharded store -------------------------------------------------


def _frame_candidates(i):
    return list(range(max(0, i - 6), max(0, i - 2)))


def _assert_same_result(a, b, tol=1.0):
    if a is None or b is None:
        assert a is None and b is None, (a, b)
        return
    assert a[0] == b[0], (a, b)
    assert a[1] == pytest.approx(b[1], abs=2e-5 * tol)
    assert a[2] == pytest.approx(b[2], abs=1e-3 * tol)
    assert a[3] == pytest.approx(b[3], abs=2e-5 * tol)


def test_infer_sharded_matches_jax_mesh(tree):
    jcfg, tcfg = _cfgs(tree)
    ti = Infer(tcfg, db_capacity=32, device="cpu", shards=1)
    ji = JaxInfer(jcfg, db_capacity=32, mesh=_mesh(2))
    for i in range(8):
        cands = _frame_candidates(i)
        pend_t, pend_j = ti.dispatch_frame(i, cands), ji.dispatch_frame(i, cands)
        assert pend_t.frame_id == pend_j.frame_id == i
        _assert_same_result(pend_t.result, pend_j.result)
    assert len(ti.feature_volumes) == 8
    np.testing.assert_allclose(ti.feature_volumes, ji.feature_volumes,
                               atol=1e-4 * np.abs(ji.feature_volumes).max())
    # the two synchronous entry points on the maps the frames built
    assert ti.query_best(8, []) is None and ji.query_best(8, []) is None
    _assert_same_result(ti.query_best(9, [0, 2, 3, 5]), ji.query_best(9, [0, 2, 3, 5]))
    assert ti.infer_multiple(10, []) is None and ji.infer_multiple(10, []) is None
    refs = [6, 1, 4, 9]
    out_t, out_j = ti.infer_multiple(11, refs), ji.infer_multiple(11, refs)
    for x_t, x_j, atol in zip(out_t, out_j, (2e-5, 1e-3, 2e-5)):
        assert x_t.shape == x_j.shape == (len(refs),)
        np.testing.assert_allclose(x_t, x_j, atol=atol)
    assert np.all(out_t[0] > -1.0)


def _sequential_best(infer, frame_id, cands, fv=None):
    """Embed, then the argmax of infer_multiple over the candidates."""
    out = infer.infer_multiple(frame_id, cands, fv=fv)
    if out is None:
        return None
    b = int(np.argmax(out[0]))
    return cands[b], float(out[0][b]), float(out[1][b]), float(out[2][b])


def test_fused_frame_step_matches_sequential_path(tree):
    """dispatch_frame (embed + insert + masked top-1) on one shard and on 8
    == embed, then the argmax of infer_multiple, frame for frame; and a
    frame dispatched with its image in hand == the frame read from disk."""
    _, tcfg = _cfgs(tree)
    fused = Infer(tcfg, db_capacity=32, device="cpu", shards=1)
    handed = Infer(tcfg, db_capacity=32, device="cpu", shards=8)
    seq = Infer(tcfg, db_capacity=32, device="cpu")
    pending = []
    for i in range(8):
        cands = _frame_candidates(i)
        pending.append((fused.dispatch_frame(i, cands),
                        handed.dispatch_frame(i, cands, image=seq._load_image(f"{i:06d}")),
                        _sequential_best(seq, i, cands)))
    for a, b, want in pending:
        _assert_same_result(a.result, want, tol=0.0)
        _assert_same_result(b.result, want, tol=0.0)
    np.testing.assert_array_equal(fused.feature_volumes, seq.feature_volumes)
    np.testing.assert_array_equal(handed.feature_volumes, seq.feature_volumes)
    # with a precomputed embedding the same step runs without the legs
    done = fused.dispatch_frame(8, [0, 1], fv=seq.feature_volumes[3])
    _assert_same_result(done.result, _sequential_best(seq, 8, [0, 1], fv=seq.feature_volumes[3]),
                        tol=0.0)


def test_duplicate_reference_ids_each_get_their_score(tree):
    """A reference id given twice gets its score at both positions (the JAX
    engine's mesh path keeps one position per row and leaves the other at
    -1): a recorded divergence by design."""
    jcfg, tcfg = _cfgs(tree)
    ti = Infer(tcfg, db_capacity=16, device="cpu", shards=1)
    plain = Infer(tcfg, db_capacity=16, device="cpu")
    for i in range(3):
        ti.infer_multiple(i, [])
        plain.infer_multiple(i, [])
    refs = [1, 0, 1, 2, 1]
    ov, yaw, conf = ti.infer_multiple(3, refs)
    ov_p, yaw_p, conf_p = plain.infer_multiple(3, refs)
    assert np.all(ov > -1.0) and ov[0] == ov[2] == ov[4] and yaw[0] == yaw[2] == yaw[4]
    np.testing.assert_allclose(ov, ov_p, atol=1e-6)
    np.testing.assert_allclose(yaw, yaw_p, atol=1e-3)
    np.testing.assert_allclose(conf, conf_p, atol=1e-6)
    ji = JaxInfer(jcfg, db_capacity=16, mesh=_mesh(2))
    fvs = ti.feature_volumes
    for i in range(3):
        ji.add_embedding(i, fvs[i])
    ov_j = ji.infer_multiple(3, refs, fv=fvs[3])[0]
    assert (ov_j == -1.0).sum() == 2  # what the port does not carry over
    np.testing.assert_allclose(ov[ov_j > -1.0], ov_j[ov_j > -1.0], atol=2e-5)


# -- OnlineLoopCloser -----------------------------------------------------------


def _forged():
    """3 frames, frame 2 back near frame 0 (the loop of tests/test_lcd.py)."""
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[1, 0, 3] = 100.0
    poses[2, 0, 3] = 1.0
    return poses, dict(covariances=None, inactive_time=1, inactive_dist=50.0,
                       overlap_threshold=-1.0)


@pytest.fixture(scope="module")
def jax_loop_closures(tree):
    """The JAX engine's closures on the seeded two-lap loop."""
    jcfg, _ = _cfgs(tree)
    poses, covs = _loop_poses()
    closer = JaxOnlineLoopCloser(
        JaxInfer(jcfg, db_capacity=32), poses, covariances=covs, **LOOP_GATES)
    return closer.run()


def test_online_loop_closer_matches_jax_on_the_forged_loop(tree):
    jcfg, tcfg = _cfgs(tree)
    poses, kw = _forged()
    want = JaxOnlineLoopCloser(JaxInfer(jcfg, db_capacity=16, mesh=_mesh(2)), poses, **kw).run()
    infer = Infer(tcfg, db_capacity=16, device="cpu", shards=1)
    got = OnlineLoopCloser(infer, poses, **kw).run()
    assert [(c.frame, c.match) for c in got] == [(2, 0)]
    _assert_same_closures(got, want)
    assert len(infer.feature_volumes) == 3  # the cache stayed aligned


def test_online_loop_closer_matches_jax_on_a_seeded_loop(tree, jax_loop_closures):
    _, tcfg = _cfgs(tree)
    poses, covs = _loop_poses()
    closer = OnlineLoopCloser(
        Infer(tcfg, db_capacity=32, device="cpu", shards=1), poses, covariances=covs, **LOOP_GATES)
    got = closer.run()
    # every second-lap frame closes on a first-lap frame near it (with
    # these random weights not always on its twin); where it is the twin, the
    # yaw is the roll that made it, within a bin (1 bin = 4 columns = 4
    # degrees at this width)
    second_lap = [c for c in got if c.frame >= LAP]
    assert len(second_lap) == LAP
    assert all(abs(c.match - (c.frame - LAP)) <= 1 for c in second_lap[1:-1])
    twins = [c for c in second_lap if c.match == c.frame - LAP]
    assert twins
    for c in twins:
        shift = 20 + 4 * c.match
        assert abs((c.yaw_deg - shift + 180.0) % 360.0 - 180.0) <= 4.0, c
    _assert_same_closures(got, jax_loop_closures)


def test_pipelined_run_matches_stepping(tree):
    _, tcfg = _cfgs(tree)
    poses, covs = _loop_poses()
    stepped = OnlineLoopCloser(
        Infer(tcfg, db_capacity=32, device="cpu", shards=1), poses, covariances=covs, **LOOP_GATES)
    for i in range(N_FRAMES):
        stepped.step(i)
    with pytest.raises(ValueError, match="in order"):
        stepped.step(3)
    piped = OnlineLoopCloser(
        Infer(tcfg, db_capacity=32, device="cpu", shards=1), poses, covariances=covs, **LOOP_GATES)
    assert piped.run(pipeline_depth=4) is piped.closures
    assert len(stepped.closures) > 0
    _assert_same_closures(piped.closures, stepped.closures, exact=True)


def test_crash_resume_and_checkpoints_cross_engines(tree, tmp_path, jax_loop_closures):
    """A session checkpointed mid-sequence resumes in a fresh engine, in the
    other package's engine too, and finishes with the uninterrupted run's
    closures; no scan is embedded again."""
    jcfg, tcfg = _cfgs(tree)
    poses, covs = _loop_poses()
    kw = dict(covariances=covs, **LOOP_GATES)
    cut = LAP + 4  # some closures lie before the cut, some after

    def port_engine():
        return OnlineLoopCloser(Infer(tcfg, db_capacity=32, device="cpu", shards=1), poses, **kw)

    def jax_engine():
        return JaxOnlineLoopCloser(JaxInfer(jcfg, db_capacity=32), poses, **kw)

    first = port_engine()
    first.run(cut)
    assert 0 < len(first.closures) < len(jax_loop_closures)
    port_ckpt = str(tmp_path / "port_session.npz")
    first.save_checkpoint(port_ckpt)
    first_fv = first.infer.feature_volumes

    resumed = port_engine()
    assert resumed.resume(port_ckpt) == cut
    np.testing.assert_array_equal(resumed.infer.feature_volumes, first_fv)
    resumed.run()
    _assert_same_closures(resumed.closures, jax_loop_closures)
    assert len(resumed.infer.feature_volumes) == N_FRAMES

    jax_closer = jax_engine()  # the JAX engine saves a session of its own ...
    for i in range(cut):
        jax_closer.step(i)
    jax_ckpt = str(tmp_path / "jax_session.npz")
    jax_closer.save_checkpoint(jax_ckpt)
    jax_closer.closures = []  # ... then resumes the port's and finishes it
    assert jax_closer.resume(port_ckpt) == cut
    _assert_same_closures(jax_closer.closures, first.closures, exact=True)
    _assert_same_closures(jax_closer.run(), jax_loop_closures)

    back = port_engine()  # and the port resumes the JAX session
    assert back.resume(jax_ckpt) == cut
    assert len(back.closures) == len(first.closures)
    _assert_same_closures(back.run(pipeline_depth=3), jax_loop_closures)


class _StubInfer:
    """Stands in for Infer: hands out PendingFrames whose result is scripted."""

    def __init__(self, result_of):
        self.result_of = result_of
        self.dispatched = []

    def dispatch_frame(self, frame_id, candidates):
        self.dispatched.append(frame_id)

        class Pending:
            @property
            def result(pending):
                return self.result_of(frame_id)

        pending = Pending()
        pending.frame_id = frame_id
        return pending


def test_resolver_error_surfaces_after_the_dispatched_frames_are_drained():
    """A frame whose result raises stops the dispatch; the frames already
    dispatched are resolved all the same (the frame cursor is past them),
    and the error is re-raised. The JAX engine stops resolving at the error:
    a recorded divergence by design."""
    def result_of(frame_id):
        if frame_id == 2:
            raise OSError("result of frame 2 was lost")
        return (0, 0.9, 1.0, 0.5)

    stub = _StubInfer(result_of)
    closer = OnlineLoopCloser(stub, np.tile(np.eye(4), (200, 1, 1)))
    t0 = time.monotonic()
    with pytest.raises(OSError, match="frame 2"):
        closer.run(pipeline_depth=4)
    assert time.monotonic() - t0 < 5.0
    assert 2 in stub.dispatched and stub.dispatched == list(range(len(stub.dispatched)))
    assert len(stub.dispatched) < 200  # dispatch stopped
    assert [c.frame for c in closer.closures] == [f for f in stub.dispatched if f != 2]
    assert closer._next_frame == len(stub.dispatched)


def test_run_raises_within_a_deadline_when_the_resolver_stalls(monkeypatch):
    """A resolver stuck in one frame's result must not block run() forever
    (the JAX engine swallows the full queue and joins without a deadline: a
    recorded divergence by design)."""
    monkeypatch.setattr(online, "RESOLVER_DEADLINE_S", 0.3)

    def result_of(frame_id):
        time.sleep(2.0)

    closer = OnlineLoopCloser(_StubInfer(result_of), np.tile(np.eye(4), (50, 1, 1)))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="resolver thread"):
        closer.run(pipeline_depth=2)
    assert time.monotonic() - t0 < 3.0
    # and a short sequence that fits the queue: the final join has a deadline
    closer = OnlineLoopCloser(_StubInfer(result_of), np.tile(np.eye(4), (1, 1, 1)))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish"):
        closer.run(pipeline_depth=4)
    assert time.monotonic() - t0 < 3.0


def test_pending_frame_decodes_at_resolve_time(tree):
    """The row -> frame map is read when the result is read, and a frame
    with no candidates or nothing above -1 resolves to None."""
    _, tcfg = _cfgs(tree)
    infer = Infer(tcfg, db_capacity=4, device="cpu", shards=1)
    infer._row_frames = {}
    pending = PendingFrame(infer, 7, 2, packed=torch.tensor([0.5, 1.0, 45.0, 0.25]))
    infer._row_frames[1] = 42
    assert pending.result == (42, 0.5, pytest.approx(0.0), 0.25)
    assert pending.result is pending.result  # resolved once
    assert PendingFrame(infer, 7, 0, packed=torch.tensor([0.5, 1.0, 45.0, 0.25])).result is None
    assert PendingFrame(infer, 7, 2, packed=torch.tensor([-1.0, 0.0, 0.0, 0.0])).result is None
    assert LoopClosure(1, 0, 0.5, 2.0).confidence == 1.0


# -- cli lcd ----------------------------------------------------------------------


def test_cli_lcd(tree, tmp_path, capsys):
    from overlapnet_torch.cli.__main__ import main

    data_root, weights = tree
    # CLI_OUT frames along a line, 4 m apart; frame CLI_OUT + j comes back
    # to frame j. The 3-sigma ellipse (5 m) holds frames j - 1, j and j + 1,
    # of which j - 1 and j are more than 100 frames old: the candidates.
    n = CLI_OUT + CLI_REVISITS
    back = np.arange(n) >= CLI_OUT
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = 4.0 * (np.arange(n) - CLI_OUT * back)
    poses[back, 1, 3] = 0.5
    covs = np.tile(np.eye(6) * (5.0 / 3.0) ** 2, (n, 1, 1))
    calib = kitti.load_calib(_write_kitti(tmp_path, poses, covs)[1])
    # the files hold camera-frame poses: the LiDAR-frame path, carried back
    cam = np.einsum("ij,njk,kl->nil", calib, poses, np.linalg.inv(calib))
    poses_file, calib_file, cov_file = _write_kitti(tmp_path, cam, covs)
    net = tmp_path / "network.yml"
    net.write_text(yaml.safe_dump({
        "model": {"inputShape": [64, 360], "leg_dtype": "float32"},
        "data_root_folder": data_root,
        "pretrained_weightsfilename": weights,
    }))
    demo = tmp_path / "demo.yml"
    demo.write_text(yaml.safe_dump({"Demo3": {
        "network_config": str(net), "poses_file": poses_file, "calib_file": calib_file,
        "covariance_file": cov_file, "infer_seqs": "08",
    }}))
    out, session = str(tmp_path / "loop_closures.npz"), str(tmp_path / "session.npz")
    common = ["lcd", str(demo), "--device", "cpu", "--session", session, "--out", out,
              "--checkpoint-every", "40"]
    assert main(common + ["--frames", "105"]) == 0
    first = capsys.readouterr().out
    assert "resumed" not in first and f"-> {out}" in first
    with np.load(out) as data:
        assert sorted(data.files) == ["frame", "match", "overlap", "yaw_deg"]
        np.testing.assert_array_equal(data["frame"], [101, 102, 103, 104])
    assert main(common) == 0  # resumes the session and finishes the sequence
    second = capsys.readouterr().out
    assert "resumed session at frame 105 (4 closures)" in second
    assert second.count("overlap") == CLI_REVISITS  # one line per closure, resumed ones too
    with np.load(out) as data:
        frame, match, overlap, yaw = (data[k] for k in ("frame", "match", "overlap", "yaw_deg"))

    # the same closures as the engine run in one piece on the same inputs
    _, tcfg = _cfgs(tree)
    tcfg.data.infer_seqs = "08"
    want = OnlineLoopCloser(
        Infer(tcfg, db_capacity=n, device="cpu", shards=1),
        kitti.poses_cam_to_velo(kitti.load_poses(poses_file), calib), covariances=covs,
    ).run()
    np.testing.assert_array_equal(frame, [c.frame for c in want])
    np.testing.assert_array_equal(frame, np.arange(CLI_OUT, n))
    np.testing.assert_array_equal(match, [c.match for c in want])
    assert np.all((match == frame - CLI_OUT) | (match == frame - CLI_OUT - 1))
    np.testing.assert_allclose(overlap, [c.overlap for c in want], atol=1e-6)
    np.testing.assert_allclose(yaw, [c.yaw_deg for c in want], atol=1e-3)
    assert np.all((overlap > 0.3) & (overlap <= 1.0))

    capsys.readouterr()
    with pytest.raises(SystemExit) as exit_info:
        main(["lcd", str(demo), "--device", "cpu", "--mesh", "2"])
    assert exit_info.value.code == 2
    assert "the world has 1 rank" in capsys.readouterr().err
