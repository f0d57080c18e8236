"""End-to-end pipeline on a synthetic world: the framework's accuracy harness.

Port of the JAX package's ``sim/e2e.py``. The reference's accuracy numbers
require KITTI sequence downloads (reference README.md:137-141), so this
module measures accuracy on a procedurally generated sequence instead,
exercising every production component in order:

  sim scans -> projection images -> GT overlap/yaw -> balanced train/val
  npz -> training -> testing.py-equivalent metrics -> covariance-gated
  online LCD -> loop-closure precision/recall/F1 + yaw RMSE -> pose-graph
  optimization -> ATE before/after.

Every stage runs on ``device`` ("cuda" by default; raises without a card).

Run:  python -m overlapnet_torch.sim.e2e --work-dir /tmp/e2e --frames 64
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time

import numpy as np

SEQ = "00"


def _stamp_matches(path: str, params: dict) -> bool:
    try:
        with open(path) as f:
            return json.load(f) == params
    except (OSError, ValueError):
        return False


def _write_stamp(path: str, params: dict) -> None:
    with open(path, "w") as f:
        json.dump(params, f)


def generate_sequence(work_dir: str, n_frames: int, seed: int = 0, laps: float = 2.0,
                      device="cuda"):
    """Simulated KITTI-layout sequence + preprocessed channel images.

    Returns (files dict, sensor poses (n, 4, 4)). The sequence is reused only
    if a params stamp matches (frames, seed, laps) — changing any of them
    regenerates instead of silently serving stale data, and drops any GT
    derived from the old sequence."""
    from overlapnet_torch.geometry.gen_data import gen_depth_data, gen_normal_data
    from overlapnet_torch.sim.world import loop_trajectory, make_world, write_kitti_sequence

    seq_dir = os.path.join(work_dir, SEQ)
    files = {
        "scan_folder": os.path.join(seq_dir, "velodyne"),
        "poses_file": os.path.join(seq_dir, "poses.txt"),
        "calib_file": os.path.join(seq_dir, "calib.txt"),
        "covariance_file": os.path.join(seq_dir, "covariance.txt"),
    }
    poses = loop_trajectory(n_frames, laps=laps)
    stamp = os.path.join(seq_dir, "sequence_params.json")
    params = {"n_frames": n_frames, "seed": seed, "laps": laps}
    if _stamp_matches(stamp, params) and os.path.isdir(os.path.join(seq_dir, "depth")):
        print(f"reusing existing sequence in {seq_dir}")
        return files, poses

    # stale GT belongs to the old sequence — remove it with the scans
    gt_dir = os.path.join(seq_dir, "ground_truth")
    if os.path.isdir(gt_dir):
        shutil.rmtree(gt_dir)
    rng = np.random.default_rng(seed)
    world = make_world(rng)
    write_kitti_sequence(seq_dir, world, poses, seed=seed)
    gen_depth_data(files["scan_folder"], seq_dir, device=device)
    gen_normal_data(files["scan_folder"], seq_dir, device=device)
    _write_stamp(stamp, params)
    return files, poses


def build_gt(
    work_dir: str,
    files: dict,
    poses: np.ndarray,
    leg_output_width: int = 360,
    query_stride: int = 1,
    seed: int = 0,
    device="cuda",
) -> dict[str, str]:
    """All-queries GT overlap/yaw -> balanced/split demo4-style npz files.

    The reference's demo4 computes GT for frame 0 only
    (demo4_gen_gt_files.py:66-74); training data needs every query frame, so
    this runs the all-pairs resident-points com_overlap_yaw_all (scans loaded
    once, pairs scored in on-device chunks)."""
    from overlapnet_torch.data import normalize_overlap_distribution, save_gt_files, split_train_val
    from overlapnet_torch.geometry import kitti
    from overlapnet_torch.geometry.overlap import com_overlap_yaw_all

    gt_dir = os.path.join(work_dir, SEQ, "ground_truth")
    full_npz = os.path.join(gt_dir, "ground_truth_overlap_yaw.npz")
    gt_stamp = os.path.join(gt_dir, "gt_params.json")
    gt_params = {
        "query_stride": query_stride,
        "leg_output_width": leg_output_width,
        "seed": seed,
    }
    if os.path.exists(full_npz) and _stamp_matches(gt_stamp, gt_params):
        print(f"reusing existing GT in {gt_dir}")
        return {
            "train_set": os.path.join(gt_dir, "train_set.npz"),
            "validation_set": os.path.join(gt_dir, "validation_set.npz"),
            "ground_truth_overlap_yaw": full_npz,
            "gt_table": np.load(full_npz, allow_pickle=True)["overlaps"],
        }

    scan_paths = kitti.load_files(files["scan_folder"])
    t0 = time.perf_counter()
    gt = com_overlap_yaw_all(
        scan_paths, poses,
        query_idxs=range(0, len(scan_paths), query_stride),
        leg_output_width=leg_output_width,
        device=device,
    )
    dt = time.perf_counter() - t0
    print(f"GT: {len(gt)} pairs in {dt:.1f}s ({len(gt) / dt:.1f} pairs/s)")
    balanced = normalize_overlap_distribution(gt, rng=np.random.default_rng(seed))
    train, val = split_train_val(balanced, rng=np.random.default_rng(seed))
    out = save_gt_files(gt_dir, SEQ, gt, train, val)
    _write_stamp(gt_stamp, gt_params)
    out["gt_table"] = gt
    return out


def make_config(work_dir: str, model_overrides: dict | None = None, device="cuda",
                **train_overrides):
    from overlapnet_torch.core.config import OverlapNetConfig
    from overlapnet_torch.core.device import resolve_device

    cfg = OverlapNetConfig()
    cfg.data.data_root_folder = work_dir
    cfg.data.infer_seqs = SEQ
    cfg.experiment.experiments_path = os.path.join(work_dir, "exp")
    cfg.experiment.pretrained_weightsfilename = ""
    # Trainability defaults (see CorrelationHead 'cosine' and
    # TrainConfig.grad_clip_norm docstrings): raw correlation logits saturate
    # at init and the resulting gradient spike kills the ReLUs.
    cfg.model = dataclasses.replace(
        cfg.model,
        correlation_normalize="cosine",
        correlation_stop_gradient=True,
    )
    cfg.train.optimizer = "adam"
    cfg.train.grad_clip_norm = 1.0
    cfg.train.mask_zero_orientation = True
    # Soft yaw supervision down to the LCD acceptance threshold: the
    # reference's hard 0.7 cutoff leaves yaw untrained exactly where
    # closures are accepted (0.3-0.7 overlap).
    cfg.train.yaw_soft_overlap_min = 0.3
    # The JAX package keys this on its backend (1 on the CPU, 8 elsewhere);
    # the port's K steps per call are a plain loop with the results of K
    # single steps, so only the grouping of the epoch's steps follows it.
    cfg.train.steps_per_dispatch = 1 if resolve_device(device).type == "cpu" else 8
    # 1e-3 Adam still collapses the ReLUs on this net; 3e-4 trains stably.
    cfg.train.learning_rate = 3e-4
    if model_overrides:
        cfg.model = dataclasses.replace(cfg.model, **model_overrides)
    for k, v in train_overrides.items():
        setattr(cfg.train, k, v)
    return cfg


def _writer_first(mesh, fn):
    """``fn()`` on the writing rank first; the other ranks call it once its
    files are there, and reuse them (the stamps match)."""
    from overlapnet_torch.parallel.mesh import barrier, is_writer

    if is_writer(mesh):
        out = fn()
        barrier(mesh)
        return out
    barrier(mesh)
    return fn()


def train_and_eval(
    cfg, gt_paths: dict, time_budget_s: float = 0.0, work_dir: str | None = None,
    device=None, mesh=None,
) -> dict | None:
    """Train on the synthetic GT; returns metrics incl. the untrained
    baseline (proof the accuracy comes from learning, not the harness).

    ``time_budget_s`` > 0 enables chunked execution: the trainer saves a
    checkpoint (``step_<n>.pt``: params, optimizer state, step) and
    ``train_partial.json`` after every epoch under ``work_dir``, and returns
    None once the budget is spent; a rerun of the same call resumes exactly
    where it stopped.

    With a ``mesh`` training and evaluation are data-parallel over its
    ranks (``device`` must be the rank's); rank 0 writes the checkpoints and
    every rank returns the same results."""
    from overlapnet_torch.data import load_gt_pairs
    from overlapnet_torch.parallel.mesh import barrier, is_writer
    from overlapnet_torch.data.dataset import PairImageDataset, ResidentPairs
    from overlapnet_torch.models import leg_output_width
    from overlapnet_torch.train.trainer import Trainer

    t_start = time.perf_counter()

    pairs = load_gt_pairs([gt_paths["train_set"]], shuffle=True,
                          rng=np.random.default_rng(cfg.train.seed))
    val_pairs = load_gt_pairs([gt_paths["validation_set"]], shuffle=False)
    ds_kwargs = dict(
        channels=cfg.channels,
        height=cfg.model.input_height,
        width=cfg.model.input_width,
    )
    train_ds = PairImageDataset(
        cfg.data.image_root, pairs,
        rotate_data=cfg.train.rotate_training_data,
        seed=cfg.train.seed,
        adjust_yaw_labels=cfg.train.rotate_adjust_yaw_labels,
        leg_output_width=leg_output_width(cfg.model),
        **ds_kwargs,
    )
    val_ds = PairImageDataset(cfg.data.image_root, val_pairs, **ds_kwargs)

    steps_per_epoch = max(1, len(pairs) // cfg.train.batch_size)
    trainer = Trainer(cfg, steps_per_epoch=steps_per_epoch, device=device, mesh=mesh)

    def val_batches():
        return val_ds.batches(cfg.train.batch_size)

    results = {"n_train_pairs": len(pairs), "n_val_pairs": len(val_pairs)}

    # chunked-resume state (only with a time budget + work dir)
    ckpt_dir = side_path = None
    start_epoch = 0
    if time_budget_s > 0 and work_dir:
        from overlapnet_torch.train.checkpoint import (
            latest_step,
            restore_checkpoint,
            save_checkpoint,
        )

        ckpt_dir = os.path.join(work_dir, "train_ckpt")
        side_path = os.path.join(work_dir, "train_partial.json")
        if latest_step(ckpt_dir) is not None:
            restore_checkpoint(ckpt_dir, trainer.state)
            start_epoch = trainer.state.step // steps_per_epoch
            with open(side_path) as f:
                results.update(json.load(f))
            print(f"resumed training at epoch {start_epoch}")
    if start_epoch == 0:
        results["untrained"] = trainer.evaluate(val_batches())

    # device-resident training: scan images live on the device once (float32,
    # as the JAX harness keeps them); steps ship only indices
    resident = ResidentPairs(train_ds, device=trainer.device, mesh=mesh)
    for epoch in range(start_epoch, cfg.train.no_epochs):
        m = trainer.run_epoch_resident(resident, cfg.train.batch_size, epoch)
        print(f"epoch {epoch}: loss {m.get('epoch_loss', float('nan')):.4f} "
              f"({m.get('train_pairs_per_sec', 0):.1f} pairs/s)", flush=True)
        results[f"epoch{epoch}_loss"] = m.get("epoch_loss")
        if ckpt_dir is not None:
            if is_writer(mesh):
                save_checkpoint(ckpt_dir, trainer.state)
                with open(side_path, "w") as f:
                    json.dump({k: v for k, v in results.items()
                               if not isinstance(v, dict)}
                              | {"untrained": results["untrained"]}, f)
            barrier(mesh)
            if (time.perf_counter() - t_start) > time_budget_s:
                print(f"time budget spent after epoch {epoch}; "
                      "rerun to resume", flush=True)
                return None
    results["trained"] = trainer.evaluate(val_batches())
    results["params"] = trainer.state.params
    return results


def run_lcd(cfg, params, poses: np.ndarray, gt_table: np.ndarray,
            covariance_file: str | None = None,
            overlap_threshold: float = 0.3, device="cuda") -> dict:
    """Online LCD with the trained net; precision/recall/F1 against the
    simulator's GT overlap, yaw RMSE on true positives."""
    from overlapnet_torch.geometry import kitti
    from overlapnet_torch.geometry.rotations import relative_yaw
    from overlapnet_torch.lcd.gating import CovarianceEllipse, candidate_mask, trajectory_lengths
    from overlapnet_torch.lcd.infer import Infer
    from overlapnet_torch.lcd.online import OnlineLoopCloser

    n = len(poses)
    # dense GT overlap lookup
    gt_overlap = np.zeros((n, n))
    q, r = gt_table[:, 0].astype(int), gt_table[:, 1].astype(int)
    gt_overlap[q, r] = gt_table[:, 2]

    covs = kitti.load_covariances(covariance_file) if covariance_file else None
    infer = Infer(cfg, params=params, db_capacity=max(16, n), device=device)
    closer = OnlineLoopCloser(
        infer, poses, covariances=covs, overlap_threshold=overlap_threshold,
        inactive_time=min(100, n // 4), inactive_dist=50.0,
    )
    closures = closer.run()

    # ground truth positives under the SAME gating the engine used
    positions = poses[:, :2, 3]
    traj = trajectory_lengths(positions)
    positive_frames = set()
    for idx in range(n):
        ellipse = (
            CovarianceEllipse.from_covariance(covs[idx][:2, :2], closer.nstd)
            if covs is not None
            else CovarianceEllipse(np.inf, np.inf, 0.0)
        )
        mask = candidate_mask(
            idx, positions, traj, ellipse, closer.inactive_time, closer.inactive_dist
        )
        cands = np.flatnonzero(mask)
        if len(cands) and gt_overlap[idx, cands].max() > overlap_threshold:
            positive_frames.add(idx)

    tp = [c for c in closures if gt_overlap[c.frame, c.match] > overlap_threshold]
    fp = [c for c in closures if gt_overlap[c.frame, c.match] <= overlap_threshold]
    detected_frames = {c.frame for c in tp}
    precision = len(tp) / len(closures) if closures else 0.0
    recall = (
        len(detected_frames & positive_frames) / len(positive_frames)
        if positive_frames
        else 0.0
    )
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0

    # yaw RMSE (circular, degrees) over true positives
    errs = []
    details = []
    for c in tp:
        # LoopClosure.yaw_deg convention: candidates are the LEFT leg and
        # the query the RIGHT (reference infer.py:186-190), so the serving
        # stack estimates yaw(inv(P_match) @ P_frame) — the pose of the
        # current frame in the matched frame — which is exactly the
        # measurement of the pose-graph edge (match -> frame,
        # backend.closures_to_edges). The truth must use the same order;
        # the reversed order silently scored every +/-90-degree closure as
        # a ~180-degree error in earlier rounds.
        true_yaw = np.degrees(relative_yaw(poses[c.match], poses[c.frame]))
        d = abs(c.yaw_deg - true_yaw) % 360.0
        errs.append(min(d, 360.0 - d))
        details.append([
            c.frame, c.match, round(c.overlap, 4),
            round(float(gt_overlap[c.frame, c.match]), 4),
            round(c.yaw_deg, 2), round(float(true_yaw), 2),
            round(errs[-1], 2), round(c.confidence, 4),
        ])
    yaw_rmse = float(np.sqrt(np.mean(np.square(errs)))) if errs else float("nan")
    yaw_p = (
        {f"yaw_err_p{p}_deg": float(np.percentile(errs, p)) for p in (50, 90, 99)}
        if errs else {}
    )

    return {
        **yaw_p,
        # per-TP rows [frame, match, pred_ov, gt_ov, pred_yaw, true_yaw,
        # circ_err_deg, conf] — the diagnosis surface for yaw quality
        "closure_details": details,
        "n_closures": len(closures),
        "true_positives": len(tp),
        "false_positives": len(fp),
        "positive_frames": len(positive_frames),
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "yaw_rmse_deg": yaw_rmse,
        "closures": closures,
    }


def drifted_odometry(gt: np.ndarray, yaw_drift: float = 0.003, seed: int = 0) -> np.ndarray:
    """Integrate the (N, 3) ground truth's relative motions with a constant
    yaw bias plus noise, composed in float64 from float32 relative poses and
    angles, as the JAX harness composes them."""
    from overlapnet_torch.backend.pose_graph import relative_pose, wrap_angle

    rng = np.random.default_rng(seed)
    rels = relative_pose(gt[:-1], gt[1:]).numpy().astype(np.float64)
    est = [gt[0].copy()]
    for rel in rels:
        rel = rel + np.array([0.0, 0.0, yaw_drift + rng.normal(0, 1e-4)])
        x, y, th = est[-1]
        est.append(
            np.array([
                x + rel[0] * np.cos(th) - rel[1] * np.sin(th),
                y + rel[0] * np.sin(th) + rel[1] * np.cos(th),
                float(wrap_angle(th + rel[2])),
            ])
        )
    return np.array(est)


def run_pose_graph(poses: np.ndarray, closures, yaw_drift: float = 0.003,
                   seed: int = 0, device="cuda") -> dict:
    """Drifted odometry + detected closures -> optimized trajectory; ATE
    before/after (the framework's north-star backend metric)."""
    from overlapnet_torch.backend import (
        absolute_trajectory_error,
        closures_to_edges,
        odometry_edges,
        optimize_pose_graph,
    )
    from overlapnet_torch.backend.pose_graph import poses_se3_to_se2

    gt = poses_se3_to_se2(poses)
    est = drifted_odometry(gt, yaw_drift, seed)
    odo = odometry_edges(est)
    ate_before = absolute_trajectory_error(est, gt)["ate_rmse"]
    if closures:
        graph = odo.merged(closures_to_edges(closures, len(gt)))
        # annealed Tukey: detector yaw outliers get rejected, not averaged in
        optimized, _ = optimize_pose_graph(
            graph, est, iterations=30, cg_iters=200,
            robust_delta=3.0, robust_kernel="tukey", robust_anneal_start=300.0,
            device=device,
        )
        ate_after = absolute_trajectory_error(optimized, gt)["ate_rmse"]
    else:
        ate_after = ate_before
    return {"ate_before_m": float(ate_before), "ate_after_m": float(ate_after)}


def run_e2e(
    work_dir: str,
    n_frames: int = 64,
    epochs: int = 6,
    batch_size: int = 8,
    seed: int = 0,
    model_overrides: dict | None = None,
    query_stride: int = 1,
    time_budget_s: float = 0.0,
    device=None,
    mesh=None,
    **train_overrides,
) -> dict | None:
    """The full pipeline on ``device`` ("cuda" by default); returns a flat
    metrics dict (see the module docstring). With ``time_budget_s`` > 0,
    returns None when the training budget ran out mid-way — rerun the same
    call to resume from the epoch checkpoint.

    With a ``mesh`` (every rank calls): rank 0 makes the sequence and the
    GT and the others reuse them, training is data-parallel over the mesh,
    and every rank serves and solves the pose graph on its own device (the
    JAX harness serves on a one-device mesh); rank 0 writes the files."""
    from overlapnet_torch.models import leg_output_width
    from overlapnet_torch.parallel.mesh import device_of, is_writer
    from overlapnet_torch.train.checkpoint import save_params_npz

    device = device_of(device, mesh)
    os.makedirs(work_dir, exist_ok=True)
    files, poses = _writer_first(
        mesh, lambda: generate_sequence(work_dir, n_frames, seed=seed, device=device))
    cfg = make_config(
        work_dir, model_overrides, device=device,
        batch_size=batch_size, no_epochs=epochs, seed=seed,
        **train_overrides,
    )
    gt_paths = _writer_first(mesh, lambda: build_gt(
        work_dir, files, poses,
        leg_output_width=leg_output_width(cfg.model),
        query_stride=query_stride, seed=seed, device=device,
    ))
    train_results = train_and_eval(
        cfg, gt_paths, time_budget_s=time_budget_s, work_dir=work_dir, device=device,
        mesh=mesh,
    )
    if train_results is None:
        return None
    params = train_results.pop("params")
    # save the trained params right away: the LCD/backend phases can then be
    # rerun standalone (run_lcd/run_pose_graph) without repeating the
    # training if anything downstream is interrupted
    if is_writer(mesh):
        save_params_npz(os.path.join(work_dir, "trained_params.npz"), params)
    lcd = run_lcd(cfg, params, poses, gt_paths["gt_table"],
                  covariance_file=files["covariance_file"], device=device)
    closures = lcd.pop("closures")
    backend = run_pose_graph(poses, closures, seed=seed, device=device)

    return {
        "frames": n_frames,
        **{f"train_{k}": v for k, v in train_results.items()
           if not isinstance(v, dict)},
        **{f"untrained_{k}": v for k, v in train_results["untrained"].items()},
        **{f"trained_{k}": v for k, v in train_results["trained"].items()},
        **{f"lcd_{k}": v for k, v in lcd.items()},
        **backend,
    }


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--release-epoch", type=int, default=-1,
                    help="TrainConfig.correlation_release_epoch")
    ap.add_argument("--yaw-soft-min", type=float, default=-1.0,
                    help="TrainConfig.yaw_soft_overlap_min (soft yaw "
                    "supervision floor; -1 = reference hard cutoff)")
    ap.add_argument("--circular-legs", action="store_true",
                    help="ModelConfig.leg_padding='circular' (the flagship "
                    "accuracy recipe, BASELINE.md)")
    ap.add_argument("--rotate-data", type=int, default=0)
    ap.add_argument("--adjust-yaw-labels", action="store_true")
    ap.add_argument("--out", default="", help="write the metrics JSON here")
    ap.add_argument("--time-budget-min", type=float, default=0.0,
                    help="chunked mode: checkpoint each epoch and exit "
                    "(rc 3) when the budget is spent; rerun to resume")
    ap.add_argument("--device", default="cuda",
                    help="where every stage runs (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    metrics = run_e2e(
        args.work_dir, n_frames=args.frames, epochs=args.epochs,
        batch_size=args.batch_size, seed=args.seed,
        model_overrides=(
            {"leg_padding": "circular"} if args.circular_legs else None
        ),
        time_budget_s=args.time_budget_min * 60.0,
        device=args.device,
        correlation_release_epoch=args.release_epoch,
        rotate_training_data=args.rotate_data,
        rotate_adjust_yaw_labels=args.adjust_yaw_labels,
        yaw_soft_overlap_min=args.yaw_soft_min,
    )
    if metrics is None:
        print("training time budget spent; rerun the same command to resume",
              flush=True)
        return 3
    line = json.dumps(metrics, default=float)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
