"""sim: generate a synthetic KITTI-layout sequence from the procedural world.

No reference counterpart — the reference depends on downloadable KITTI
archives (reference README.md:137-141); this produces a self-contained
sequence (scans, poses, calib, covariances, and optionally channel images
projected on ``--device``) so every other command works offline:

  python -m overlapnet_torch.cli sim --dst-folder data/synth/00 --frames 64
  python -m overlapnet_torch.cli sim --dst-folder data/synth/00 --frames 64 --images
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="sim", description=__doc__)
    ap.add_argument("--dst-folder", required=True)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--laps", type=float, default=2.0)
    ap.add_argument("--side", type=float, default=55.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--images", action="store_true",
                    help="also generate depth/normal/intensity images")
    ap.add_argument("--device", default="cuda",
                    help="where the images are projected (default cuda; raises "
                    "without a card)")
    args = ap.parse_args(argv)

    from overlapnet_torch.sim import loop_trajectory, make_world, write_kitti_sequence

    rng = np.random.default_rng(args.seed)
    world = make_world(rng)
    poses = loop_trajectory(args.frames, side=args.side, laps=args.laps)
    files = write_kitti_sequence(args.dst_folder, world, poses, seed=args.seed)
    print(f"{args.frames} scans -> {files['scan_folder']}")

    if args.images:
        from overlapnet_torch.geometry.gen_data import (
            gen_depth_data,
            gen_intensity_data,
            gen_normal_data,
        )

        for gen in (gen_depth_data, gen_normal_data, gen_intensity_data):
            gen(files["scan_folder"], args.dst_folder, device=args.device)
        print(f"depth/normal/intensity images -> {args.dst_folder}")
    return 0
