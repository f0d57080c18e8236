"""The port's geometry (range projection, normals, GT overlap and yaw, the
image writers) against the JAX package on the CPU, on the same seeded
simulated scans at the real 64 x 900 geometry.

The pixel rule. The port takes atan2 and asin rounded from float64, so that
the card and the CPU agree; float32 ``atan2`` and ``asin`` are not correctly
rounded (scripts/rounding_probe.py measures PyTorch's), and the JAX package's
fused jit of ``range_projection`` rounds the pixel arithmetic on its own. A
point within a few 1e-6 of a row or column boundary then lands in the
neighbouring pixel: 0 or 1 pixels of each of six 130k-point sim scans had
another winner (the probe, when this was written). So ``proj_idx`` is held equal on at
least 99.99% of the pixels, not on all; where the winners agree, range,
vertex and intensity are equal bit for bit (the depth has the bits of
``jnp.linalg.norm``), and normals agree within 1e-5 where both images are
valid and the pixel and the two neighbours a normal reads have the same
winners (they had the same bits when this was written).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from overlapnet_tpu.data.gt_files import load_gt_pairs as jax_load_gt_pairs
from overlapnet_tpu.geometry import gen_data as jgen
from overlapnet_tpu.geometry import kitti as jkitti
from overlapnet_tpu.geometry import overlap as joverlap
from overlapnet_tpu.geometry import projection as jproj
from overlapnet_tpu.sim import world as jworld
from overlapnet_torch.cli.__main__ import main as cli_main
from overlapnet_torch.data.gt_files import load_gt_pairs
from overlapnet_torch.geometry import gen_data as tgen
from overlapnet_torch.geometry import overlap as toverlap
from overlapnet_torch.geometry import projection as tproj
from overlapnet_torch.sim import world as tworld

N_FRAMES, N_POINTS = 12, 20_000
PIXEL_SHARE = 0.9999  # proj_idx equal on at least this share of pixels


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def world():
    return tworld.make_world(np.random.default_rng(0), extent=60.0, n_walls=15,
                             n_cylinders=20, ground_step=1.2)


@pytest.fixture(scope="module")
def sequence(world, tmp_path_factory):
    """A 12-frame, two-lap KITTI-layout sim sequence of 20k-point scans."""
    root = str(tmp_path_factory.mktemp("seq"))
    poses = tworld.loop_trajectory(N_FRAMES, side=30.0)
    info = tworld.write_kitti_sequence(root, world, poses, seed=1, max_points=N_POINTS)
    return {**info, "root": root, "poses": poses,
            "paths": jkitti.load_files(info["scan_folder"])}


@pytest.fixture(scope="module")
def scans(sequence):
    return np.stack([jproj.pad_points(jkitti.load_scan(p), N_POINTS + 1000)
                     for p in sequence["paths"][:3]])


def test_the_sim_world_is_the_jax_packages(world):
    np.testing.assert_array_equal(
        world, jworld.make_world(np.random.default_rng(0), extent=60.0, n_walls=15,
                                 n_cylinders=20, ground_step=1.2))
    poses = tworld.loop_trajectory(7)
    np.testing.assert_array_equal(poses, jworld.loop_trajectory(7))
    a = tworld.scan_at_pose(world, poses[2], np.random.default_rng(4), max_points=5000)
    b = jworld.scan_at_pose(world, poses[2], np.random.default_rng(4), max_points=5000)
    np.testing.assert_array_equal(a, b)


def _held_to_jax(got, want):
    """The pixel rule of the module docstring; returns the share of pixels
    whose winner differs."""
    r, v, inten, idx = (x.numpy() for x in got)
    jr, jv, ji, jidx = (np.asarray(x) for x in want)
    same = idx == jidx
    assert same.mean() >= PIXEL_SHARE, same.mean()
    np.testing.assert_array_equal(r[same], jr[same])
    np.testing.assert_array_equal(v[same], jv[same])
    np.testing.assert_array_equal(inten[same], ji[same])
    assert ((idx >= 0) == (r > 0)).all() and ((r == -1) == (idx == -1)).all()
    return 1.0 - same.mean()


def test_range_projection_matches_jax(scans):
    """Three sim scans at 64 x 900, one at a time and as one (K, P, 4)
    batch: the batch gives the single scans' bits."""
    batched = tproj.range_projection(_t(scans))
    for k, pts in enumerate(scans):
        got = tproj.range_projection(_t(pts))
        _held_to_jax(got, jproj.range_projection(jnp.asarray(pts)))
        for a, b in zip(got, batched):
            assert a.shape == b.shape[1:] and a.dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b[k].numpy())
    # depth and validity alone are bit-equal, pixel by pixel
    pix, depth, valid = tproj.project_pixels(_t(scans[0]))
    jpix, jdepth, jvalid = (np.asarray(x) for x in jproj.project_pixels(jnp.asarray(scans[0])))
    np.testing.assert_array_equal(depth.numpy(), jdepth)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    assert pix.dtype == torch.int64 and (pix.numpy() == jpix).mean() >= PIXEL_SHARE


def test_depth_ties_go_to_the_lowest_index():
    """Duplicated points (exact depth ties) and a farther point in the same
    pixel: the nearest wins, among equals the lowest index, as in JAX."""
    pts = np.zeros((64, 4), np.float32)
    pts[0] = [10.0, 0.0, 0.0, 0.1]
    pts[1] = [5.0, 0.0, 0.0, 0.2]
    pts[2] = [5.0, 0.0, 0.0, 0.3]  # a copy of point 1
    pts[3] = [20.0, 1.0, 0.5, 0.4]
    pts[7] = pts[3]
    pts[9] = pts[3]
    r, v, inten, idx = (x.numpy() for x in tproj.range_projection(_t(pts)))
    assert sorted(idx[idx >= 0].tolist()) == [1, 3]
    assert inten[idx == 1].tolist() == [np.float32(0.2)]
    want = [np.asarray(x) for x in jproj.range_projection(jnp.asarray(pts))]
    for a, b in zip((r, v, inten, idx), want):
        np.testing.assert_array_equal(a, b)


def test_padding_max_range_and_empty_scans(scans):
    pts = scans[0]
    n = int((np.abs(pts[:, :3]).sum(1) > 0).sum())
    base = tproj.range_projection(_t(pts[:n]))
    padded = tproj.range_projection(_t(np.concatenate([pts[:n], np.zeros((500, 4), np.float32)])))
    for a, b in zip(base, padded):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    near = tproj.range_projection(_t(pts), max_range=10.0)
    assert near[0].max() < 10.0 and (near[0] > 0).sum() < (base[0] > 0).sum()
    _held_to_jax(near, jproj.range_projection(jnp.asarray(pts), max_range=10.0))
    empty = tproj.range_projection(_t(np.zeros((100, 4), np.float32)))
    for x in empty:
        assert (x.numpy() == -1).all()
    assert (tproj.normal_map(empty[0], empty[1]).numpy() == -1).all()


def test_normal_map_matches_jax(scans):
    """On the JAX projection's own range and vertex images, batched too."""
    r, v, _, _ = (np.asarray(x) for x in jproj.range_projection(jnp.asarray(scans[1])))
    want = np.asarray(jproj.normal_map(jnp.asarray(r), jnp.asarray(v)))
    got = tproj.normal_map(_t(r), _t(v)).numpy()
    assert got.shape == want.shape == (64, 900, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[-1] == -1).all() and ((got == -1).all(-1) == (want == -1).all(-1)).all()
    batched = tproj.normal_map(_t(np.stack([r, r])), _t(np.stack([v, v]))).numpy()
    np.testing.assert_array_equal(batched[1], got)


def test_semantic_projection_and_transform_points_match_jax(scans, sequence):
    pts = scans[2]
    rng = np.random.default_rng(5)
    probs = rng.uniform(size=(pts.shape[0], 20)).astype(np.float32)
    _, _, _, idx = tproj.range_projection(_t(pts), max_range=float("inf"))
    got = tproj.semantic_projection(_t(probs), idx).numpy()
    want = np.asarray(jproj.semantic_projection(jnp.asarray(probs), jnp.asarray(idx.numpy())))
    np.testing.assert_array_equal(got, want)
    poses = sequence["poses"]
    T = (np.linalg.inv(poses[0]) @ poses[5]).astype(np.float32)
    got = tproj.transform_points(_t(pts), _t(T)).numpy()
    want = np.asarray(jproj.transform_points(jnp.asarray(pts), jnp.asarray(T)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert not got[pts[:, :3].any(1) == 0].any()  # padding stays zero
    # one transform per scan of a batch, and TF32 settings do not reach it
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        two = tproj.transform_points(_t(np.stack([pts, pts])), _t(np.stack([np.eye(4), T])))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    np.testing.assert_array_equal(two[1].numpy(), got)
    np.testing.assert_array_equal(two[0].numpy()[:, :3], pts[:, :3])


def _gt_held_to_jax(got, want, ranges):
    """Ids and yaw bins equal; each overlap within 2 / (its query's valid
    pixel count) of the JAX one. Returns the share of equal overlaps."""
    np.testing.assert_array_equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]])
    valid = np.array([(r > 0).sum() for r in ranges])
    tol = 2.0 / np.maximum(valid[want[:, 0].astype(int)], 1)
    assert (np.abs(got[:, 2] - want[:, 2]) <= tol).all()
    return float((got[:, 2] == want[:, 2]).mean())


def test_gt_overlap_and_yaw_match_jax(sequence):
    """``com_overlap_yaw_all`` (every frame a query: 144 pairs, in chunks of
    50) and ``com_overlap_yaw`` on the 12-frame sequence. Ids and yaw bins
    are equal; overlaps within 2 pixels' worth of their query. When written,
    every one of the 144 overlaps came out exactly equal."""
    paths, poses = sequence["paths"], sequence["poses"]
    pts = joverlap.load_scans_padded(paths, N_POINTS)
    ranges = [np.asarray(jproj.range_projection(jnp.asarray(p))[0]) for p in pts]
    want = joverlap.com_overlap_yaw_all(paths, poses, points=pts, max_points=N_POINTS)
    got = toverlap.com_overlap_yaw_all(paths, poses, points=pts, chunk_size=50, device="cpu")
    assert got.shape == (N_FRAMES**2, 4) and got.dtype == np.float64
    assert _gt_held_to_jax(got, want, ranges) > 0.99
    assert np.allclose(got[got[:, 0] == got[:, 1], 2], 1.0)
    want1 = joverlap.com_overlap_yaw(paths, poses, 5, points=pts, max_points=N_POINTS)
    got1 = toverlap.com_overlap_yaw(paths, poses, 5, points=pts, device="cpu")
    _gt_held_to_jax(got1, want1, ranges)
    # from disk, and the query subset of the full table
    sub = toverlap.com_overlap_yaw_all(paths, poses, query_idxs=[3, 7], max_points=N_POINTS,
                                       device="cpu")
    np.testing.assert_array_equal(sub, got[np.isin(got[:, 0], [3, 7])])


def _images(root):
    out = {}
    for kind in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, kind))):
            out[(kind, name)] = np.load(os.path.join(root, kind, name))
    return out


def test_image_writers_match_jax(sequence, tmp_path):
    """The four writers: the same file names, and contents under the pixel
    rule (depth and intensity equal wherever the depth images agree, which
    stands for equal winners; normals within 1e-5 where both are valid and
    the three pixels they read agree; semantic probabilities equal on the
    pixel share)."""
    labels = tmp_path / "labels"
    labels.mkdir()
    rng = np.random.default_rng(9)
    for p in sequence["paths"]:
        n = jkitti.load_scan(p).shape[0]
        rng.uniform(size=(n, 20)).astype(np.float32).tofile(labels / os.path.basename(p))
    kw = dict(chunk_size=5, max_points=N_POINTS)
    outs = {}
    for name, mod, extra in (("jax", jgen, {}), ("torch", tgen, {"device": "cpu"})):
        dst = str(tmp_path / name)
        written = [
            mod.gen_depth_data(sequence["scan_folder"], dst, **kw, **extra),
            mod.gen_normal_data(sequence["scan_folder"], dst, **kw, **extra),
            mod.gen_intensity_data(sequence["scan_folder"], dst, **kw, **extra),
            mod.gen_semantic_data(str(labels), sequence["scan_folder"], dst, **kw, **extra),
        ]
        outs[name] = ([os.path.relpath(p, dst) for w in written for p in w], _images(dst))
    assert outs["torch"][0] == outs["jax"][0] and len(outs["jax"][0]) == 4 * N_FRAMES
    got, want = outs["torch"][1], outs["jax"][1]
    assert got.keys() == want.keys()
    for (kind, name), w in want.items():
        g = got[(kind, name)]
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        d_same = got[("depth", name)] == want[("depth", name)]
        assert d_same.mean() >= PIXEL_SHARE
        if kind == "normal":
            # a normal reads its pixel and the right and lower neighbours:
            # held where all three winners agree (depth equal) and both are valid
            stable = d_same & np.roll(d_same, -1, axis=1) & np.roll(d_same, -1, axis=0)
            both = stable & ~(g == -1).all(-1) & ~(w == -1).all(-1)
            np.testing.assert_allclose(g[both], w[both], rtol=0, atol=1e-5)
            assert ((g == -1).all(-1) == (w == -1).all(-1))[stable].all()
        elif kind == "semantic":
            assert (g == w).all(-1).mean() >= PIXEL_SHARE
        else:
            np.testing.assert_array_equal(g[d_same], w[d_same])


def test_gen_data_then_gen_gt_match_jax(sequence, tmp_path):
    """The slice as a whole: gen-data -> gen-gt --all-queries through each
    package's CLI on the same sequence. Both packages' ``load_gt_pairs`` read
    the port's GT files as they read the JAX package's: the same pairs, yaw
    bins and image names, overlaps within 2 pixels' worth."""
    from overlapnet_tpu.cli.__main__ import main as jax_cli

    seq_args = ["--scan-folder", sequence["scan_folder"], "--poses-file", sequence["poses_file"],
                "--calib-file", sequence["calib_file"], "--seq", "00"]
    for name, cli, extra in (("jax", jax_cli, []), ("torch", cli_main, ["--device", "cpu"])):
        dst = str(tmp_path / name)
        assert cli(["gen-data", "--scan-folder", sequence["scan_folder"], "--dst-folder", dst,
                    *extra]) == 0
        assert cli(["gen-gt", *seq_args, "--dst-folder", dst, "--all-queries", *extra]) == 0
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    pts = toverlap.load_scans_padded(sequence["paths"])
    ranges = [tproj.range_projection(_t(p))[0].numpy() for p in pts]
    for kind in ("ground_truth_overlap_yaw.npz", "train_set.npz", "validation_set.npz"):
        files = {n: str(tmp_path / n / "ground_truth" / kind) for n in ("jax", "torch")}
        for load in (load_gt_pairs, jax_load_gt_pairs):
            got, want = load([files["torch"]], shuffle=False), load([files["jax"]], shuffle=False)
            assert len(got) == len(want) > 0
            for field in ("imgf1", "imgf2", "dir1", "dir2"):
                assert list(getattr(got, field)) == list(getattr(want, field)), field
            table = lambda p: np.stack([np.asarray(p.imgf1, int), np.asarray(p.imgf2, int),  # noqa: E731
                                        p.overlap, p.orientation], axis=1)
            _gt_held_to_jax(table(got), table(want), ranges)
    depth = {n: np.load(tmp_path / n / "depth" / "000004.npy") for n in ("jax", "torch")}
    assert (depth["torch"] == depth["jax"]).mean() >= PIXEL_SHARE
