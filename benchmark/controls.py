"""The controls of ``correct``: the plain reference put in the program's
place one precision step below what the program runs each part in
(``reference.model.CONTROL``; TF32 for the GT engine's float32 move of the
points), and the faults a cell can have, each judged by the cell's own
comparison. The benchmark's runs do not run this; it gives the upper
readings of the limits.

    python -m benchmark.controls --workload <cell> --seeds 1 2 3

prints one JSON line per seed and reading. It needs the card, like a run,
and runs at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from benchmark import harness, synth
from benchmark.reference import gt as ref_gt
from benchmark.reference import model as ref


def lcd_control(run) -> dict:
    drv = run.spec.driver
    drv.write_window_images(run, run.workdir)
    poses = drv.route(run)
    m = run.mix["map_frames"]
    frames = range(m, min(run.mix["frames"], m + run.mix["control_frames"]))
    fake = [drv.Answer(f, drv.candidates(run, poses, f), None) for f in frames]
    judged = [a.frame for a in drv.sample(run, fake)]
    return drv.control(run, judged, ref.CONTROL)


def train_controls(run) -> dict:
    drv = run.spec.driver
    state = drv.setup(run)
    keep = {"taken": state["taken"], "steps_per_epoch": state["steps_per_epoch"],
            "scan_ids": state["scan_ids"]}
    prog = state["program"]
    state.clear()
    torch.cuda.empty_cache()
    out = {"program": drv.readings(run, keep, prog, per_step=True),
           "control": drv.readings(run, keep, None, ref.CONTROL, per_step=True),
           "half_batch": drv.readings(run, keep, None, ref.REFERENCE,
                                      keep_pairs=len(keep["taken"][0]["i1"]) // 2,
                                      per_step=True)}
    # a step that leaves the state unchanged reads update_gap 1 by measure
    return out


def gt_control(run) -> dict:
    drv = run.spec.driver
    mix = run.mix
    poses = drv.route(run)
    points = synth.street_scans(poses, mix["valid_points"], mix["max_points"],
                                synth.generator(run.seed, run.device, 4000),
                                run.device).cpu().numpy()
    q = np.concatenate([drv.block_queries(run, b) for b in range(mix["control_blocks"])])
    n = mix["frames"]
    rows = np.zeros((len(q) * n, 4))
    rows[:, 0], rows[:, 1] = np.repeat(q, n), np.tile(np.arange(n), len(q))
    rows[:, 3] = ref_gt.yaw_bins(poses[rows[:, 0].astype(int)], poses[rows[:, 1].astype(int)],
                                 ref.geometry(run.config)["out_width"])
    rows = drv.sample_pairs(run, [rows])
    return drv.readings(run, rows, points, None, ref_gt.CONTROL)


KINDS = {"lcd_replay": lcd_control, "train_resident": train_controls, "gt_blocks": gt_control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.controls", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.controls: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.find_cell(args.workload)
    for seed in args.seeds:
        workdir = tempfile.mkdtemp(prefix="overlapnet-control-")
        try:
            run = harness.Run(spec, seed, torch.device("cuda"), workdir)
            got = KINDS[spec.mix["kind"]](run)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": got}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, "-m", "benchmark.controls", *sys.argv[1:]],
                  dict(os.environ, PYTHONHASHSEED="0"))
    sys.exit(main())
