"""infer: overlap + relative yaw for one scan pair, on the port.

Equivalent of reference demo/demo2_infer.py:15-49.

Usage:
  python -m overlapnet_torch.cli infer <network.yml> [scan1] [scan2]
      [--data-root R] [--infer-seqs S] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from overlapnet_torch.core.config import load_config
from overlapnet_torch.lcd.infer import Infer


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="infer", description=__doc__)
    ap.add_argument("config")
    ap.add_argument("scan1", nargs="?", default="000000.bin")
    ap.add_argument("scan2", nargs="?", default="000001.bin")
    ap.add_argument("--data-root", default="")
    ap.add_argument("--infer-seqs", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    if args.data_root:
        cfg.data.data_root_folder = args.data_root
    if args.infer_seqs is not None:
        cfg.data.infer_seqs = args.infer_seqs

    infer = Infer(cfg, device=args.device)
    overlap, yaw = infer.infer_one(args.scan1, args.scan2)
    print(f"Overlap:  {float(overlap):.6f}")
    print(f"Yaw [deg]: {int(yaw[0])}")
    return 0
