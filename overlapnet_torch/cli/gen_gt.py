"""gen-gt: ground-truth overlap/yaw generation for a sequence.

Equivalent of reference demo/demo4_gen_gt_files.py:42-114: load KITTI poses +
calibration, convert camera poses to the LiDAR frame rebased on frame 0,
compute per-frame overlap and yaw bins against the query frame, rebalance the
overlap distribution, split train/val, and write the three npz files.

Usage:
  python -m overlapnet_torch.cli gen-gt <demo.yml>   (Demo4 block)
  python -m overlapnet_torch.cli gen-gt --scan-folder S --poses-file P
      --calib-file C --dst-folder D [--seq 07] [--frame-idx 0]
      [--all-queries [--query-stride K]] [--device cuda|cpu]
      [--profile-dir DIR]

``--profile-dir`` traces the table's computation with torch.profiler
(``core.profiling.trace``): ``trace.json``, ``key_averages.txt`` and
``record.json`` (the engine's counters: pairs, pairs past the far-pair gate,
pairs of overlap above 0) land there.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import yaml

from overlapnet_torch.core.profiling import trace
from overlapnet_torch.data.balancing import normalize_overlap_distribution, split_train_val
from overlapnet_torch.data.gt_files import save_gt_files
from overlapnet_torch.geometry import kitti
from overlapnet_torch.geometry.overlap import com_overlap_yaw, com_overlap_yaw_all


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="gen-gt", description=__doc__)
    ap.add_argument("config", nargs="?", help="demo.yml with a Demo4 block")
    ap.add_argument("--scan-folder")
    ap.add_argument("--poses-file")
    ap.add_argument("--calib-file")
    ap.add_argument("--dst-folder")
    ap.add_argument("--seq", default="07")
    ap.add_argument("--frame-idx", type=int, default=0,
                    help="query frame (reference demo4 uses frame 0)")
    ap.add_argument("--all-queries", action="store_true",
                    help="full N x N GT (every frame as query; training data)")
    ap.add_argument("--query-stride", type=int, default=1,
                    help="with --all-queries: take every k-th query frame")
    ap.add_argument("--leg-output-width", type=int, default=360)
    ap.add_argument("--plot", default="",
                    help="save a trajectory plot colored by overlap (demo4 vis_gt)")
    ap.add_argument("--device", default="cuda",
                    help="where the pairs are scored (default cuda; raises without a card)")
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler trace of the GT computation, with the "
                         "engine's spans and counters, into this dir")
    args = ap.parse_args(argv)

    scan_folder, poses_file = args.scan_folder, args.poses_file
    calib_file, dst_folder = args.calib_file, args.dst_folder
    if args.config:
        with open(args.config) as f:
            d4 = (yaml.safe_load(f) or {}).get("Demo4", {})
        scan_folder = scan_folder or d4.get("scan_folder")
        poses_file = poses_file or d4.get("poses_file")
        calib_file = calib_file or d4.get("calib_file")
        dst_folder = dst_folder or d4.get("dst_folder")
    if not all([scan_folder, poses_file, calib_file, dst_folder]):
        ap.error("need scan-folder, poses-file, calib-file, dst-folder")

    scan_paths = kitti.load_files(scan_folder)
    T_cam_velo = kitti.load_calib(calib_file)
    poses = kitti.poses_cam_to_velo(kitti.load_poses(poses_file), T_cam_velo)
    print(f"{len(scan_paths)} scans, {len(poses)} poses")

    with trace(args.profile_dir or None):
        if args.all_queries:
            import time

            t0 = time.perf_counter()
            gt = com_overlap_yaw_all(
                scan_paths, poses,
                query_idxs=range(0, len(scan_paths), args.query_stride),
                leg_output_width=args.leg_output_width,
                device=args.device,
            )
            dt = time.perf_counter() - t0
            print(f"GT: {len(gt)} pairs in {dt:.1f}s ({len(gt) / dt:.1f} pairs/s)")
        else:
            gt = com_overlap_yaw(
                scan_paths, poses, frame_idx=args.frame_idx,
                leg_output_width=args.leg_output_width, device=args.device,
            )
    print(f"ground truth: {len(gt)} pairs, "
          f"overlap mean {gt[:, 2].mean():.3f} max {gt[:, 2].max():.3f}")

    balanced = normalize_overlap_distribution(gt)
    train, val = split_train_val(balanced)
    out_dir = os.path.join(dst_folder, "ground_truth")
    paths = save_gt_files(out_dir, args.seq, gt, train, val)
    for name, p in paths.items():
        print(f"wrote {name}: {p}")

    if args.plot:
        # Trajectory scatter colored by overlap vs the query frame
        # (reference demo4_gen_gt_files.py:18-39 vis_gt).
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        rows = gt[gt[:, 0] == args.frame_idx]
        xy = poses[rows[:, 1].astype(int), :2, 3]
        plt.figure(figsize=(7, 7))
        sc = plt.scatter(xy[:, 0], xy[:, 1], c=rows[:, 2], s=6, cmap="viridis")
        plt.colorbar(sc, label=f"overlap with frame {args.frame_idx}")
        plt.axis("equal")
        plt.xlabel("X [m]")
        plt.ylabel("Y [m]")
        plt.savefig(args.plot, dpi=150)
        print(f"plot -> {args.plot}")
    return 0
