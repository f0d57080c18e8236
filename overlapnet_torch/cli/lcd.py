"""lcd: online loop-closure detection over a sequence.

Headless equivalent of reference demo/demo3_lcd.py:179-223: covariance
search-ellipse gating + descriptor-DB scoring per frame; prints accepted
closures and writes them to ``loop_closures.npz`` (frame, match, overlap,
yaw_deg) — the input of the pose-graph backend. Pass --plot to also save a
trajectory figure with closure markers.

The descriptor map is sharded over a mesh of ranks (``--mesh N``, 0 = every
rank the ``OVERLAPNET_*`` variables started; one process is a mesh of one):
every rank embeds each frame and scores its own rows, and the ranks' best
rows are merged. Ranks past N sit out. Rank 0 prints the closures and writes
the outputs and the session.

Usage:
  python -m overlapnet_torch.cli lcd <demo.yml>   (Demo3 block)
      [--frames N] [--out loop_closures.npz] [--plot traj.png]
      [--animate run.gif] [--session session.npz] [--mesh N] [--no-mesh]
      [--device cuda|cpu] [--profile-dir DIR]

``--profile-dir`` traces the run with torch.profiler (``core.profiling.
trace``): ``trace.json``, ``key_averages.txt`` and ``record.json`` (the
loop's counters and its legs' and heads' device milliseconds) land there.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import yaml

from overlapnet_torch.core.config import load_config
from overlapnet_torch.core.distributed import world
from overlapnet_torch.core.profiling import trace
from overlapnet_torch.geometry import kitti
from overlapnet_torch.lcd.infer import Infer
from overlapnet_torch.lcd.online import OnlineLoopCloser
from overlapnet_torch.parallel.mesh import is_writer, make_mesh


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="lcd", description=__doc__)
    ap.add_argument("config", help="demo.yml with a Demo3 block")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default="loop_closures.npz")
    ap.add_argument("--plot", default="")
    ap.add_argument("--animate", default="",
                    help="save a demo3-style animated GIF of the run "
                         "(trajectory + search ellipse + closures)")
    ap.add_argument("--animate-frames", type=int, default=120,
                    help="max animation frames (sequence is strided to fit)")
    ap.add_argument(
        "--session", default="",
        help="session checkpoint path: resumed from if it exists, written "
             "after every --checkpoint-every frames (crash recovery)",
    )
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help="shard the descriptor map over a mesh of the first N ranks "
             "(0 = all ranks; one card per rank); serving runs the fused "
             "non-blocking frame step on the sharded store",
    )
    ap.add_argument(
        "--no-mesh", action="store_true",
        help="keep the whole map on this process's card (one shard, the same "
             "non-blocking frame step; no mesh)",
    )
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler trace of the run, with the loop's "
                         "spans and counters, into this dir")
    args = ap.parse_args(argv)
    n_ranks = world()[1]
    if args.mesh > n_ranks:
        ap.error(f"--mesh {args.mesh}: the world has {n_ranks} rank(s); start one "
                 "process per rank with the OVERLAPNET_* variables")
    mesh = None
    if not args.no_mesh:
        mesh = make_mesh(args.mesh or n_ranks, device=args.device)
        if not mesh.member:
            return 0  # this rank is past the mesh: it sits out

    with open(args.config) as f:
        d3 = (yaml.safe_load(f) or {}).get("Demo3", {})

    net_cfg = load_config(d3["network_config"])
    net_cfg.data.infer_seqs = d3.get("infer_seqs", net_cfg.data.infer_seqs)

    T_cam_velo = kitti.load_calib(d3["calib_file"])
    poses = kitti.poses_cam_to_velo(
        kitti.load_poses(d3["poses_file"]), T_cam_velo
    )
    covs = kitti.load_covariances(d3["covariance_file"])

    n = args.frames if args.frames is not None else len(poses)
    infer = Infer(net_cfg, db_capacity=max(16, n),
                  device=args.device if mesh is None else None, mesh=mesh)
    say = print if is_writer(mesh) else (lambda *a, **k: None)
    closer = OnlineLoopCloser(infer, poses[:n], covariances=covs[:n])
    if args.session and os.path.exists(args.session):
        start = closer.resume(args.session)
        say(f"resumed session at frame {start} ({len(closer.closures)} closures)")
    # pipelined frame windows (closer.run keeps frames in flight on the
    # device); checkpoints land at window boundaries
    printed = 0
    with trace(args.profile_dir or None):
        while closer._next_frame < n:
            end = min(n, closer._next_frame + args.checkpoint_every)
            closer.run(end)
            for closure in closer.closures[printed:]:
                say(
                    f"frame {closure.frame:6d} -> {closure.match:6d}  "
                    f"overlap {closure.overlap:.3f}  yaw {closure.yaw_deg:+.0f} deg"
                )
            printed = len(closer.closures)
            if args.session:
                closer.save_checkpoint(args.session)
    if args.session:
        closer.save_checkpoint(args.session)

    closures = closer.closures
    if not is_writer(mesh):
        return 0
    np.savez(
        args.out,
        frame=np.array([c.frame for c in closures]),
        match=np.array([c.match for c in closures]),
        overlap=np.array([c.overlap for c in closures]),
        yaw_deg=np.array([c.yaw_deg for c in closures]),
    )
    print(f"{len(closures)} loop closures -> {args.out}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        xy = poses[:n, :2, 3]
        plt.figure(figsize=(8, 8))
        plt.plot(xy[:, 0], xy[:, 1], "-", lw=1, label="trajectory")
        for c in closures:
            plt.plot(
                [xy[c.frame, 0], xy[c.match, 0]],
                [xy[c.frame, 1], xy[c.match, 1]],
                "r-", lw=0.8,
            )
        plt.axis("equal")
        plt.legend()
        plt.title(f"Loop closures ({len(closures)})")
        plt.savefig(args.plot, dpi=150)
        print(f"plot -> {args.plot}")

    if args.animate:
        # Animated view of the run (reference demo3_lcd.py:23-47
        # AnimatedLCD): trajectory drawn incrementally, the 3-sigma search
        # ellipse at the current frame, accepted closures as red chords.
        # Rendered offline to a GIF (headless framework; PillowWriter needs
        # no ffmpeg).
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.animation as animation
        import matplotlib.pyplot as plt
        from matplotlib.patches import Ellipse

        from overlapnet_torch.lcd.gating import CovarianceEllipse

        xy = poses[:n, :2, 3]
        by_frame = {}
        for c in closures:
            by_frame.setdefault(c.frame, []).append(c)
        step_stride = max(1, n // min(n, args.animate_frames))
        frames = list(range(0, n, step_stride))

        fig, ax = plt.subplots(figsize=(7, 7))
        pad = 10.0
        ax.set_xlim(xy[:, 0].min() - pad, xy[:, 0].max() + pad)
        ax.set_ylim(xy[:, 1].min() - pad, xy[:, 1].max() + pad)
        ax.set_aspect("equal")
        (traj_line,) = ax.plot([], [], "-", lw=1, color="C0")
        (cur_pt,) = ax.plot([], [], "o", color="C1", ms=5)
        chords = []

        def update(i):
            idx = frames[i]
            traj_line.set_data(xy[: idx + 1, 0], xy[: idx + 1, 1])
            cur_pt.set_data([xy[idx, 0]], [xy[idx, 1]])
            for f in range(max(0, idx - step_stride + 1), idx + 1):
                for c in by_frame.get(f, ()):
                    chords.append(ax.plot(
                        [xy[c.frame, 0], xy[c.match, 0]],
                        [xy[c.frame, 1], xy[c.match, 1]],
                        "r-", lw=0.8,
                    )[0])
            for p in list(ax.patches):
                p.remove()
            if covs is not None:
                e = CovarianceEllipse.from_covariance(
                    covs[idx][:2, :2], closer.nstd
                )
                ax.add_patch(Ellipse(
                    xy[idx], e.width, e.height, angle=e.angle_deg,
                    fill=False, color="C2", lw=1.0,
                ))
            ax.set_title(f"frame {idx} — {sum(len(v) for k, v in by_frame.items() if k <= idx)} closures")
            return [traj_line, cur_pt]

        anim = animation.FuncAnimation(fig, update, frames=len(frames))
        anim.save(args.animate, writer=animation.PillowWriter(fps=10))
        print(f"animation -> {args.animate}")
    return 0
