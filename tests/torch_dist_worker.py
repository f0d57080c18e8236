"""One rank of the port's multi-process tests (tests/test_torch_parallel.py).

Run as (one process per rank, gloo on the CPU):

  OVERLAPNET_COORDINATOR=127.0.0.1:<port> OVERLAPNET_NUM_PROCESSES=2 \\
  OVERLAPNET_PROCESS_ID=<rank> python tests/torch_dist_worker.py <out_dir> <data_dir>

Each rank joins the group through ``core.distributed.maybe_initialize_distributed``
(the bootstrap the CLI runs), runs every case on a mesh of the two ranks
and, on rank 0, on a mesh of one rank, and writes its results to
``<out_dir>/rank<r>.npz`` for the test process to hold against the JAX
package's multi-device paths. ``<data_dir>`` holds what the test process
wrote first: seeded scans with a pair list and GT (``write_data``) and a
weights export of the JAX package (``params.npz``).

The inputs are made here from seeds with numpy; the test process imports
this module to make the same ones. It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from overlapnet_torch.backend import pose_graph as tpg  # noqa: E402
from overlapnet_torch.core.config import ChannelConfig, OverlapNetConfig  # noqa: E402
from overlapnet_torch.data.dataset import PairImageDataset  # noqa: E402
from overlapnet_torch.data.gt_files import PairList  # noqa: E402

W_IN, W_OUT = 360, 90
DB_CAP = 21
N_PAIRS = 12  # three batches of 4
N_SCANS = 5
FRAMES = 6


# -- inputs, shared with the test process --------------------------------------


def small_cfg(batch_size: int = 4, **train_kw) -> OverlapNetConfig:
    """The small geometry (W' = 90) with fp32 legs."""
    cfg = OverlapNetConfig()
    cfg.model = dataclasses.replace(cfg.model, input_width=W_IN, leg_dtype="float32")
    cfg.train = dataclasses.replace(cfg.train, batch_size=batch_size, **train_kw)
    return cfg


def make_batch(b: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=(b, 64, W_IN, 4)).astype(np.float32)
    x2 = np.roll(x1, 30, axis=2) + 0.3 * rng.normal(size=x1.shape).astype(np.float32)
    return {
        "x1": x1,
        "x2": x2.astype(np.float32),
        "overlap": rng.uniform(0.2, 1.0, size=(b,)).astype(np.float32),
        "orientation": rng.integers(0, W_OUT, size=(b,)).astype(np.int32),
    }


def masked_batch() -> dict:
    """Every pair above the yaw-label threshold sits in the first half (rank
    0's block): the global orientation mean divides by 2 pairs, a mean of the
    ranks' own means would halve it."""
    batch = make_batch(4, seed=11)
    batch["overlap"] = np.array([0.9, 0.85, 0.1, 0.2], np.float32)
    return batch


def eval_batches() -> list[dict]:
    """A batch of 3 and a ragged batch of 2 (padded to the mesh size)."""
    out = [make_batch(3, seed=5), make_batch(1, seed=6)]
    for b in out:
        b["overlap"] = np.clip(b["overlap"] + 0.3, 0, 1)
    return out


def db_inputs() -> dict:
    rng = np.random.default_rng(7)
    fvs = np.maximum(rng.normal(size=(11, W_OUT, 128)), 0).astype(np.float32)
    mask = np.zeros(DB_CAP, bool)
    mask[[0, 1, 3, 6, 10, 15]] = True  # row 15 is not live
    odd = np.zeros(DB_CAP, bool)
    odd[[1, 3, 5, 9]] = True  # every candidate on shard 1
    few = np.zeros(DB_CAP, bool)
    few[[2, 9]] = True
    masks = np.zeros((2, DB_CAP), bool)
    masks[0, 2:9] = True  # the second query has no candidate
    return {"fvs": fvs, "mask": mask, "odd": odd, "few": few, "masks": masks}


def frame_inputs() -> tuple[np.ndarray, list[list[int]]]:
    """Images of FRAMES frames (the later ones rolled copies of the first
    ones) and each frame's candidate rows: none, all on shard 0, all on
    shard 1, and all earlier rows."""
    rng = np.random.default_rng(9)
    base = rng.normal(size=(3, 64, W_IN, 4)).astype(np.float32)
    images = np.concatenate([base, np.roll(base, 40, axis=2) + 0.05 * base])
    candidates = [[], [0], [0], [0, 2], [1, 3], [0, 1, 2, 3, 4]]
    return images, candidates


def frame_mask(rows: list[int], capacity: int) -> np.ndarray:
    mask = np.zeros(capacity, bool)
    mask[rows] = True
    return mask


def square_trajectory(side: int = 25) -> np.ndarray:
    poses = [np.zeros(3)]
    for leg in range(4):
        theta = leg * np.pi / 2
        for _ in range(side):
            x, y, _ = poses[-1]
            poses.append(np.array([x + np.cos(theta), y + np.sin(theta), theta]))
    return np.array(poses)


def loop_graph() -> tuple[tpg.PoseGraph, np.ndarray]:
    """tests/test_backend.py's mesh-parity graph (a drifted square loop with
    five closures; 105 edges, not divisible by 2) and its initial poses."""
    gt = square_trajectory()
    rng = np.random.default_rng(0)
    est = [gt[0].copy()]
    for k in range(1, len(gt)):
        rel = tpg.relative_pose(gt[k - 1], gt[k]).numpy().astype(np.float64)
        rel[2] += 0.004 + rng.normal(0, 1e-4)
        x, y, th = est[-1]
        est.append(np.array([x + rel[0] * np.cos(th) - rel[1] * np.sin(th),
                             y + rel[0] * np.sin(th) + rel[1] * np.cos(th), th + rel[2]]))
    est = np.array(est)
    n = len(gt)
    pairs = np.array([[0, n - 1], [0, n - 2], [1, n - 1], [2, n - 1], [3, n - 1]])
    z = np.stack([tpg.relative_pose(gt[a], gt[b]).numpy() for a, b in pairs])
    graph = tpg.odometry_edges(est).merged(tpg.relative_pose_edges(pairs, z, n))
    return graph, est


def head_inputs() -> tuple[np.ndarray, ...]:
    """tests/test_parallel.py's channel-sharded head inputs (C = 128)."""
    rng = np.random.default_rng(0)
    fa = rng.normal(size=(2, W_OUT, 128)).astype(np.float32)
    fb = rng.normal(size=(2, W_OUT, 128)).astype(np.float32)
    kernel = (rng.normal(size=(1, 15, 128, 64)) * 0.05).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    return fa, fb, kernel, bias


def write_data(root: str) -> None:
    """N_SCANS seeded scans (depth + normal) of sequence 07."""
    rng = np.random.default_rng(3)
    for kind, ch in (("depth", None), ("normal", 3)):
        os.makedirs(os.path.join(root, "07", kind), exist_ok=True)
        for i in range(N_SCANS):
            shape = (64, W_IN) if ch is None else (64, W_IN, ch)
            np.save(os.path.join(root, "07", kind, f"{i:06d}.npy"),
                    rng.normal(size=shape).astype(np.float32))


PG_SHORT = dict(iterations=2, cg_iters=20)  # a solve short enough not to amplify rounding

CLI_OUT, CLI_BACK = 101, 4  # `cli lcd`'s sequence: out along a line, then back


def write_cli_data(root: str) -> None:
    """For ``cli train``: GT of sequence 07 and ``net_dist.yml`` /
    ``net_one.yml`` (experiments under ``exp_dist`` / ``exp_one``). For ``cli
    lcd``: sequence 08 (links to 07's scans), its poses, calibration and
    covariances, ``net_lcd.yml`` (the JAX weights export ``params.npz``) and
    ``demo.yml``."""
    import yaml

    from overlapnet_torch.data.gt_files import save_gt_files

    rng = np.random.default_rng(5)
    i1, i2 = rng.integers(0, N_SCANS, 8), rng.integers(0, N_SCANS, 8)
    table = np.stack([i1, i2, rng.uniform(0, 1, 8), rng.integers(0, 360, 8)], axis=1)
    save_gt_files(os.path.join(root, "07", "ground_truth"), "07", table, table, table[:3])
    model = {"inputShape": [64, W_IN, 4], "leg_dtype": "float32"}
    for name in ("dist", "one"):
        with open(os.path.join(root, f"net_{name}.yml"), "w") as f:
            yaml.safe_dump({
                "data_root_folder": root, "experiments_path": os.path.join(root, f"exp_{name}"),
                "testname": "mini", "training_seqs": "07", "batch_size": 2, "no_epochs": 2,
                "no_batches_in_epoch": 2, "no_test_pairs": 3, "learning_rate": 0.001,
                "model": model, "use_depth": True, "use_normals": True}, f)

    n = CLI_OUT + CLI_BACK
    for kind in ("depth", "normal"):
        os.makedirs(os.path.join(root, "08", kind))
        for i in range(n):
            os.symlink(os.path.join(root, "07", kind, f"{i % N_SCANS:06d}.npy"),
                       os.path.join(root, "08", kind, f"{i:06d}.npy"))
    back = np.arange(n) >= CLI_OUT
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = 4.0 * (np.arange(n) - CLI_OUT * back)
    poses[back, 1, 3] = 0.5
    np.savetxt(os.path.join(root, "poses.txt"), poses[:, :3, :4].reshape(n, 12))
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write("P0: 1 0 0 0 0 1 0 0 0 0 1 0\nTr: 0 -1 0 0.1 0 0 -1 0.2 1 0 0 0.3\n")
    np.savetxt(os.path.join(root, "covariance.txt"),
               np.tile(np.eye(6) * (5.0 / 3.0) ** 2, (n, 1, 1)).reshape(n, 36))
    with open(os.path.join(root, "net_lcd.yml"), "w") as f:
        yaml.safe_dump({"model": {"inputShape": [64, W_IN], "leg_dtype": "float32"},
                        "data_root_folder": root,
                        "pretrained_weightsfilename": os.path.join(root, "params.npz")}, f)
    with open(os.path.join(root, "demo.yml"), "w") as f:
        yaml.safe_dump({"Demo3": {
            "network_config": os.path.join(root, "net_lcd.yml"), "infer_seqs": "08",
            **{k: os.path.join(root, f"{v}.txt") for k, v in (
                ("poses_file", "poses"), ("calib_file", "calib"),
                ("covariance_file", "covariance"))}}}, f)


def lcd_args(root: str, out: str, *extra: str) -> list[str]:
    return ["lcd", os.path.join(root, "demo.yml"), "--device", "cpu", "--out", out, *extra]


def infer_cfg(root: str) -> OverlapNetConfig:
    """``Infer`` over sequence 07's scans with the JAX weights export."""
    cfg = small_cfg()
    cfg.data.data_root_folder, cfg.data.infer_seqs = root, "07"
    cfg.experiment.pretrained_weightsfilename = os.path.join(root, "params.npz")
    return cfg


def infer_results(infer) -> np.ndarray:
    """Frames 0-4 through ``dispatch_frame`` (candidates: every frame two or
    more back), ``query_best`` and ``infer_multiple``, as rows [match,
    overlap, yaw_deg, confidence] (NaN for no result); then ``infer_one``
    and ``infer_multiple_vs_multiple``, as rows [-1, overlap, yaw_deg, 0]."""
    rows = [infer.dispatch_frame(i, list(range(i - 1))).result for i in range(N_SCANS)]
    rows.append(infer.query_best(5, [0, 2, 3], fv=infer.feature_volumes[1]))
    ov, yaw, conf = infer.infer_multiple(6, [4, 1, 3], fv=infer.feature_volumes[2])
    rows += [(r, o, y, c) for r, o, y, c in zip([4, 1, 3], ov, yaw, conf)]
    ov, yaw = infer.infer_one("000000", "000003")
    rows.append((-1, ov, yaw[0], 0))
    ov, yaw = infer.infer_multiple_vs_multiple(["000001", "000002", "000004"], [0, 1], [2, 0])
    rows += [(-1, o, y, 0) for o, y in zip(ov, yaw)]
    return np.array([[np.nan] * 4 if r is None else list(r) for r in rows], np.float64)


def pair_dataset(root: str) -> PairImageDataset:
    """N_PAIRS seeded pairs over the scans, rotated as rotate_data=1 draws."""
    rng = np.random.default_rng(4)
    i1, i2 = rng.integers(0, N_SCANS, N_PAIRS), rng.integers(0, N_SCANS, N_PAIRS)
    pairs = PairList(["%06d" % i for i in i1], ["%06d" % i for i in i2],
                     ["07"] * N_PAIRS, ["07"] * N_PAIRS,
                     rng.uniform(0, 1, N_PAIRS), rng.integers(0, 360, N_PAIRS).astype(float))
    return PairImageDataset(root, pairs, ChannelConfig(), height=64, width=W_IN,
                            rotate_data=1, seed=7, leg_output_width=W_OUT)


# -- the rank's cases -----------------------------------------------------------


def _params(prefix: str, state) -> dict:
    return {f"{prefix}/p/{k}": v.detach().numpy() for k, v in state.params.items()}


def _metrics(prefix: str, metrics: dict) -> dict:
    return {f"{prefix}/m/{k}": np.asarray(float(v)) for k, v in metrics.items()}


def _same_bits(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a) and a.keys() == b.keys()


def train_cases(mesh, one, data_dir: str) -> dict:
    from overlapnet_torch.data.dataset import ResidentPairs
    from overlapnet_torch.train import trainer as tt

    res = {}
    for name, cfg, batch in (
        ("dp", small_cfg(), make_batch(4)),
        ("masked", small_cfg(mask_zero_orientation=True), masked_batch()),
    ):
        state, tx = tt.create_train_state(cfg, 100, 0, device="cpu")
        state, metrics = tt.make_train_step(cfg, tx, mesh)(state, batch)
        res |= _params(name, state) | _metrics(name, metrics)

    # resident steps, K = 2 per call: one stacked call and one single step
    cfg = small_cfg(steps_per_dispatch=2, rotate_training_data=1)
    trainer = tt.Trainer(cfg, steps_per_epoch=3, mesh=mesh)
    resident = ResidentPairs(pair_dataset(data_dir), mesh=mesh)
    metrics = trainer.run_epoch_resident(resident, 4, epoch=0, shuffle=False)
    res |= _params("resident", trainer.state) | {
        "resident/epoch_loss": np.asarray(metrics["epoch_loss"]),
        "resident/steps": np.asarray(trainer.state.step)}

    metrics = tt.Trainer(small_cfg(), steps_per_epoch=1, mesh=mesh).evaluate(eval_batches())
    res |= {f"eval/{k}": np.asarray(v) for k, v in metrics.items()}

    if one.member:  # a gloo group of one rank against no mesh at all
        cfg, batch = small_cfg(mask_zero_orientation=True), masked_batch()
        states = []
        for m in (one, None):
            state, tx = tt.create_train_state(cfg, 100, 0, device="cpu")
            state, metrics = tt.make_train_step(cfg, tx, m)(state, batch)
            states.append((state.params, metrics))
        res["one/train_equal"] = np.asarray(
            _same_bits(states[0][0], states[1][0]) and _same_bits(states[0][1], states[1][1]))
    return res


def db_cases(mesh, one, data_dir: str, out_dir: str) -> dict:
    from overlapnet_torch.lcd.descriptor_db import ShardedDescriptorDB
    from overlapnet_torch.lcd.infer import Infer
    from overlapnet_torch.models import build_model
    from overlapnet_torch.weights import load_npz

    model = build_model(small_cfg().model, 4, device="cpu")
    model.load_state_dict(load_npz(os.path.join(data_dir, "params.npz")))
    model.eval()
    x = db_inputs()
    fvs = x["fvs"]
    res = {}
    db = ShardedDescriptorDB(model.score, capacity=DB_CAP, width=W_OUT, mesh=mesh)
    assert db.add(fvs[0]) == 0 and db.add(fvs[1:]) == 1
    res["db/local_rows"] = np.asarray(int((db._fv.abs().sum((2, 3)) > 0).sum()))
    res["db/feature_volumes"] = db.feature_volumes
    res["db/all"] = np.stack(db.query_all(fvs[5], x["mask"]))
    for name, kw in (("top3", {}), ("top3_mask", {"candidate_mask": x["mask"]}),
                     ("top3_odd", {"candidate_mask": x["odd"]}),
                     ("top3_few", {"candidate_mask": x["few"]}), ("top64", {"k": 64})):
        res[f"db/{name}"] = np.stack(db.query_topk(fvs[4], **{"k": 3, **kw}))
    res["db/batch"] = np.stack(db.query_topk_batch(fvs[[3, 7]], k=3, candidate_mask=x["masks"]))

    path = os.path.join(out_dir, "db.npz")
    db.save(path)
    again = ShardedDescriptorDB(model.score, capacity=DB_CAP, width=W_OUT, mesh=mesh)
    res["db/restored_rows"] = np.asarray(again.restore(path))
    res["db/restored_top3"] = np.stack(again.query_topk(fvs[4], k=3))

    # Infer on the mesh: fused frames, then the synchronous entry points
    infer = Infer(infer_cfg(data_dir), db_capacity=16, mesh=mesh)
    res["infer/frames"] = infer_results(infer)

    images, candidates = frame_inputs()
    stores = {"frames": mesh, **({"frames_one": one} if one.member else {})}
    for name, m in stores.items():
        fdb = ShardedDescriptorDB(model.score, capacity=16, width=W_OUT, mesh=m)
        fdb.set_embedder(model.encode)
        res[f"db/{name}"] = np.stack([
            fdb.frame_step(img, frame_mask(rows, fdb.capacity))[1][0].numpy()
            for img, rows in zip(images, candidates)])
    if one.member:  # the same frames through the one-device store
        fdb = ShardedDescriptorDB(model.score, capacity=16, width=W_OUT, shards=1, device="cpu")
        fdb.set_embedder(model.encode)
        res["db/frames_nomesh"] = np.stack([
            fdb.frame_step(img, frame_mask(rows, fdb.capacity))[1][0].numpy()
            for img, rows in zip(images, candidates)])
    return res


def backend_and_head_cases(mesh, one) -> dict:
    from overlapnet_torch.kernels.delta_conv1 import delta_conv1
    from overlapnet_torch.ops.correlation import circular_correlation
    from overlapnet_torch.parallel.mesh import all_reduce_sum

    graph, est = loop_graph()
    poses, chi2 = tpg.optimize_pose_graph(graph, est, iterations=10, cg_iters=100,
                                          mesh=mesh, device="cpu")
    res = {"pg/poses": poses, "pg/chi2": chi2}
    res["pg/poses64"], _ = tpg.optimize_pose_graph(graph, est, mesh=mesh, dtype=torch.float64,
                                                   **PG_SHORT)
    if one.member:
        got = tpg.optimize_pose_graph(graph, est, iterations=10, cg_iters=100, mesh=one)
        want = tpg.optimize_pose_graph(graph, est, iterations=10, cg_iters=100, device="cpu")
        res["one/pg_equal"] = np.asarray(all(np.array_equal(a, b) for a, b in zip(got, want)))

    # the channel-sharded head: each rank holds C / D channels of both
    # volumes and of the kernel; both contractions are summed over the ranks
    fa, fb, kernel, _ = (torch.from_numpy(a) for a in head_inputs())
    c = fa.shape[-1] // mesh.size
    part = slice(mesh.rank * c, (mesh.rank + 1) * c)
    res["head/delta"] = all_reduce_sum(
        mesh, delta_conv1(fa[..., part], fb[..., part], kernel[:, :, part], None)).numpy()
    res["head/corr"] = all_reduce_sum(
        mesh, circular_correlation(fa[..., part], fb[..., part])).numpy()
    return res


def cli_cases(data_dir: str, out_dir: str) -> dict:
    """``cli train`` over the two ranks, then ``--resume``; ``cli lcd`` on a
    mesh of both ranks (with a session file) and on a mesh of rank 0 alone
    (rank 1 sits out)."""
    from overlapnet_torch.cli.__main__ import main as cli_main

    yml = os.path.join(data_dir, "net_dist.yml")
    out = lambda name: os.path.join(out_dir, name)  # noqa: E731
    return {
        "cli/train": np.asarray(cli_main(["train", yml, "--device", "cpu"])),
        "cli/resume": np.asarray(cli_main(["train", yml, "--device", "cpu", "--resume"])),
        "cli/lcd2": np.asarray(cli_main(lcd_args(
            data_dir, out("lcd2.npz"), "--mesh", "2", "--session", out("session2.npz"),
            "--checkpoint-every", "60"))),
        "cli/lcd1": np.asarray(cli_main(lcd_args(data_dir, out("lcd1.npz"), "--mesh", "1"))),
    }


E2E = dict(n_frames=8, epochs=1, batch_size=4,
           model_overrides={"input_width": W_IN, "leg_dtype": "float32"})


def e2e_case(mesh, out_dir: str) -> dict:
    """``run_e2e`` on the mesh: rank 0 makes the sequence and the GT, the
    training is data-parallel, every rank serves and solves on its own."""
    from overlapnet_torch.sim.e2e import run_e2e

    metrics = run_e2e(os.path.join(out_dir, "e2e"), mesh=mesh, **E2E)
    return {f"e2e/{k}": np.asarray(float(v)) for k, v in metrics.items()
            if isinstance(v, (int, float, np.number))}


def main(out_dir: str, data_dir: str) -> int:
    torch.set_num_threads(1)  # the test run keeps every core busy already
    from overlapnet_torch.core.distributed import maybe_initialize_distributed, world
    from overlapnet_torch.parallel.mesh import (
        make_mesh, pad_to_multiple, put_replicated, put_sharded_dim, shard_batch)

    assert maybe_initialize_distributed(), "the bootstrap did not start"
    rank, size = world()
    mesh = make_mesh(device="cpu")
    one = make_mesh(1, device="cpu")  # rank 0 alone; the others are outside it
    assert mesh.size == size and mesh.rank == rank and one.member == (rank == 0)

    padded, n = pad_to_multiple(np.arange(15).reshape(5, 3), mesh.size)
    res = {
        "mesh/n": np.asarray(n),
        "mesh/block": shard_batch(mesh, {"x": padded})["x"].numpy(),
        "mesh/replicated": put_replicated(mesh, padded).numpy(),
        "mesh/block_dim1": put_sharded_dim(mesh, np.arange(24).reshape(3, 4, 2), dim=1).numpy(),
    }
    res |= train_cases(mesh, one, data_dir)
    res |= db_cases(mesh, one, data_dir, out_dir)
    res |= backend_and_head_cases(mesh, one)
    res |= cli_cases(data_dir, out_dir)
    res |= e2e_case(mesh, out_dir)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
