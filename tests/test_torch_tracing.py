"""The port's spans and counters (``core.profiling``) on the CPU, at the
small input_width=360 geometry (W' = 90): off, a span is a shared no-op;
under ``torch.profiler`` the online loop's and the GT engine's spans nest as
their stages do, on the dispatching thread, and the record's counts are the
work each stage did, for the traced stretch alone."""

import concurrent.futures
import json
import os

import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from overlapnet_torch.cli.__main__ import main as cli_main
from overlapnet_torch.core import config as tconfig
from overlapnet_torch.core import profiling
from overlapnet_torch.geometry.overlap import com_overlap_yaw_all
from overlapnet_torch.geometry.projection import MAX_RANGE
from overlapnet_torch.lcd import descriptor_db, gating
from overlapnet_torch.lcd.infer import Infer
from overlapnet_torch.lcd.online import OnlineLoopCloser
from overlapnet_torch.models import init_params

H, W, W_OUT, C = 64, 360, 90, 128
MAP, FRAMES = 24, 3  # map frames put in directly; frames run through the loop
CHUNK = 8  # pairs a head call, in place of the store's 256 (CPU heads are slow)
GATES = dict(inactive_time=5, inactive_dist=2.0)


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """An online loop over a straight route at 0.5 m a frame, past its map:
    the map's frames go in as seeded embeddings, the loop's frames (one for
    each test, and FRAMES more) are read from disk. Returns the loop and the
    poses."""
    root = tmp_path_factory.mktemp("loop")
    n = MAP + 1 + FRAMES
    rng = np.random.default_rng(3)
    for kind in ("depth", "normal"):
        os.makedirs(root / "00" / kind)
    for f in range(MAP, n):
        np.save(root / "00" / "depth" / f"{f:06d}.npy",
                np.abs(rng.normal(size=(H, W))).astype(np.float32) * 10.0)
        np.save(root / "00" / "normal" / f"{f:06d}.npy",
                rng.normal(size=(H, W, 3)).astype(np.float32))
    cfg = tconfig.OverlapNetConfig(
        model=tconfig.ModelConfig(input_width=W, leg_dtype="float32"),
        data=tconfig.DataConfig(data_root_folder=str(root), infer_seqs="00"))
    infer = Infer(cfg, db_capacity=n, device="cpu")  # the seeded init
    for f in range(MAP):
        infer.add_embedding(f, torch.from_numpy(rng.normal(size=(W_OUT, C)).astype(np.float32)))
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = 0.5 * np.arange(n)
    closer = OnlineLoopCloser(infer, poses, **GATES)
    closer._next_frame = MAP
    return closer, poses


def _candidates(poses, frame):
    return int(gating.candidate_mask(
        frame, poses[:, :2, 3], gating.trajectory_lengths(poses[:, :2, 3]),
        gating.CovarianceEllipse(np.inf, np.inf, 0.0), **GATES).sum())


def _rows(prof, prefixes):
    """The profiler's host rows whose names start with ``prefixes``, as
    (name, start ns, end ns, thread)."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type().name == "CPU" and e.name().startswith(prefixes)]


def _parent(rows, row):
    """The innermost other row on the same thread that covers ``row``."""
    name, s, e, tid = row
    cover = [r for r in rows if r is not row and r[3] == tid and r[1] <= s and e <= r[2]]
    return min(cover, key=lambda r: r[2] - r[1])[0] if cover else None


def test_span_off_enters_no_record_function(loop, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd._profiler_enabled()
    closer, _ = loop
    before_totals, before_record = profiling.totals(), profiling.record()
    assert profiling.span("a") is profiling.span("b", device=True)
    with profiling.span("test.off", device=True):
        profiling.count("test.off", 3)
    closer.run(closer._next_frame + 1)
    after = profiling.totals()
    assert after["test.off"] - before_totals.get("test.off", 0) == 3
    assert after["lcd.frames"] - before_totals.get("lcd.frames", 0) == 1
    assert after["model.scans"] - before_totals.get("model.scans", 0) == 1
    assert profiling.record() == before_record


def test_online_loop_spans_nest_and_count_the_frame_work(loop, monkeypatch):
    monkeypatch.setattr(descriptor_db, "MAX_PAIRS_PER_CALL", CHUNK)
    closer, poses = loop
    first = closer._next_frame
    want = [_candidates(poses, f) for f in range(first, first + FRAMES)]
    assert min(want) > 2 * CHUNK and any(n % CHUNK for n in want)  # full chunks and a part
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        closer.run(first + FRAMES, pipeline_depth=2)
    rec = profiling.record()
    rows = _rows(prof, ("lcd.", "db.", "model."))
    parents = {}
    for row in rows:
        parents.setdefault(row[0], set()).add(_parent(rows, row))
    assert parents == {
        "lcd.frame": {None}, "lcd.handover": {None},
        "lcd.gate": {"lcd.frame"}, "lcd.dispatch": {"lcd.frame"},
        "lcd.load_image": {"lcd.dispatch"}, "db.frame_step": {"lcd.dispatch"},
        "model.legs": {"db.frame_step"}, "db.insert": {"db.frame_step"},
        "model.heads": {"db.frame_step"}, "db.fetch": {"db.frame_step"},
    }
    dispatcher = {r[3] for r in rows if r[0] == "lcd.frame"}
    assert len(dispatcher) == 1 and {r[3] for r in rows} == dispatcher
    assert sum(r[0] == "lcd.frame" for r in rows) == FRAMES
    chunks = sum(-(-n // CHUNK) for n in want)
    assert rec["counts"] == {
        "lcd.frames": FRAMES, "lcd.candidates": sum(want), "model.scans": FRAMES,
        "model.pairs": sum(want), "model.head_calls": chunks,
    }
    assert rec["device_ms"] == {}  # no card: no device span was timed


def _gt_inputs(n=8, spacing=30.0, points=600):
    """Scans of points within 20 m of their frame's origin, frames
    ``spacing`` m apart on a line: near pairs overlap, far ones are gated."""
    rng = np.random.default_rng(5)
    pts = np.zeros((n, points, 4), np.float32)
    pts[:, :, :3] = rng.uniform(-20.0, 20.0, size=(n, points, 3)) * [1.0, 1.0, 0.1]
    pts[:, :, 3] = 1.0
    pts[:, points - 50:] = 0.0  # padding
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = spacing * np.arange(n)
    return pts, poses


def test_gt_engine_counts_its_gate_and_its_useful_pairs():
    pts, poses = _gt_inputs()
    n = len(poses)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        table = com_overlap_yaw_all([""] * n, poses, query_idxs=[0, 3, 7], leg_output_width=W_OUT,
                                    chunk_size=4, points=pts, device="cpu")
    counts = profiling.record()["counts"]
    radius = np.linalg.norm(pts[:, :, :3], axis=2).max(axis=1)
    q, r = table[:, 0].astype(int), table[:, 1].astype(int)
    live = np.abs(poses[q, 0, 3] - poses[r, 0, 3]) - radius[r] < MAX_RANGE + 1.0
    assert 0 < live.sum() < len(table)
    assert counts == {"gt.calls": 1, "gt.pairs": len(table), "gt.live_pairs": int(live.sum()),
                      "gt.nonzero_pairs": int(np.count_nonzero(table[live, 2] > 0))}
    assert 0 < counts["gt.nonzero_pairs"]
    assert not np.any(table[~live, 2])
    rows = _rows(prof, ("gt.",))
    assert {r[0]: _parent(rows, r) for r in rows} == {
        "gt.call": None, "gt.prepare": "gt.call", "gt.dispatch": "gt.call",
        "gt.fetch": "gt.call", "gt.yaw_table": "gt.call"}


@pytest.mark.parametrize("between", ["untraced", "trace"])
def test_a_second_traced_stretch_records_only_its_own_counts(between, tmp_path):
    if between == "untraced":
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.count("test.stretch", 5)
        profiling.count("test.stretch", 7)  # with no profiler active
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("test.stretch"):
                profiling.count("test.stretch", 2)
    else:  # back to back, with nothing between
        with profiling.trace(str(tmp_path / "one")):
            profiling.count("test.stretch", 5)
        with profiling.trace(str(tmp_path / "two")):
            profiling.count("test.stretch", 2)
    assert profiling.record()["counts"] == {"test.stretch": 2}


def test_a_device_counter_reads_in_totals_and_in_the_stretch_that_used_it():
    """A kernel adds to a device counter on the device (a CPU tensor stands
    in for it here): ``totals()`` reads its whole value, ``record()`` what
    the traced stretch added from its first use on."""
    t = profiling.device_counter("test.device", "cpu")
    t.add_(2)  # before any profiler
    before = profiling.totals()["test.device"]
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("test.calls")
        profiling.device_counter("test.device", "cpu").add_(3)
        profiling.device_counter("test.device", "cpu").add_(1)
    assert profiling.record()["counts"] == {"test.calls": 1, "test.device": 4}
    assert profiling.totals()["test.device"] == before + 4
    assert profiling.device_counter("test.device", "cpu") is t


def test_a_thread_outside_the_profiler_leaves_the_stretch_open():
    def worker():
        with profiling.span("test.worker"):
            profiling.count("test.worker")
        return torch.autograd._profiler_enabled()

    before = profiling.totals().get("test.worker", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("test.thread", 2)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            covered = pool.submit(worker).result()
        profiling.count("test.thread", 3)
    want = {"test.thread": 5} | ({"test.worker": 1} if covered else {})
    assert profiling.record()["counts"] == want
    assert profiling.totals()["test.worker"] == before + 1


def _kitti_files(root, n):
    """poses.txt, calib.txt (identity Tr) and covariance.txt of ``n`` frames
    4 m apart on a line, in KITTI's text formats."""
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = 4.0 * np.arange(n)
    paths = [str(root / f) for f in ("poses.txt", "calib.txt", "covariance.txt")]
    np.savetxt(paths[0], poses[:, :3, :4].reshape(n, 12))
    with open(paths[1], "w") as f:
        f.write("Tr: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    np.savetxt(paths[2], np.tile(np.eye(6), (n, 1, 1)).reshape(n, 36))
    return paths


@pytest.mark.parametrize("command", ["lcd", "gen-gt"])
def test_cli_profile_dir_writes_the_trace_and_the_record(command, tmp_path):
    n = 4
    poses, calib, covs = _kitti_files(tmp_path, n)
    rng = np.random.default_rng(6)
    prof = tmp_path / "prof"
    if command == "lcd":
        for kind in ("depth", "normal"):
            os.makedirs(tmp_path / "00" / kind)
        for f in range(n):
            np.save(tmp_path / "00" / "depth" / f"{f:06d}.npy",
                    np.abs(rng.normal(size=(H, W))).astype(np.float32))
            np.save(tmp_path / "00" / "normal" / f"{f:06d}.npy",
                    rng.normal(size=(H, W, 3)).astype(np.float32))
        (tmp_path / "network.yml").write_text(yaml.safe_dump({
            "model": {"inputShape": [H, W], "leg_dtype": "float32"},
            "data_root_folder": str(tmp_path)}))
        (tmp_path / "demo.yml").write_text(yaml.safe_dump({"Demo3": {
            "network_config": str(tmp_path / "network.yml"), "poses_file": poses,
            "calib_file": calib, "covariance_file": covs, "infer_seqs": "00"}}))
        argv = ["lcd", str(tmp_path / "demo.yml"), "--no-mesh", "--device", "cpu",
                "--out", str(tmp_path / "closures.npz")]
        want = {"lcd.frames": n, "model.scans": n}
    else:
        os.makedirs(tmp_path / "velodyne")
        for f in range(n):
            pts = rng.uniform(-20.0, 20.0, size=(500, 4)).astype(np.float32)
            pts.tofile(tmp_path / "velodyne" / f"{f:06d}.bin")
        argv = ["gen-gt", "--scan-folder", str(tmp_path / "velodyne"), "--poses-file", poses,
                "--calib-file", calib, "--dst-folder", str(tmp_path / "gt"), "--all-queries",
                "--device", "cpu"]
        want = {"gt.calls": 1, "gt.pairs": n * n}
    assert cli_main(argv + ["--profile-dir", str(prof)]) == 0
    assert sorted(os.listdir(prof)) == ["key_averages.txt", "record.json", "trace.json"]
    with open(prof / "record.json") as f:
        counts = json.load(f)["counts"]
    assert want.items() <= counts.items(), counts
