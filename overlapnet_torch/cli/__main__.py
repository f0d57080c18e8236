"""CLI dispatcher of the PyTorch port.

Commands (reference counterparts in parentheses):

  gen-data   preprocess scans into channel images   (demo1_gen_data.py)
  infer      overlap+yaw for one scan pair          (demo2_infer.py)
  lcd        online loop-closure detection          (demo3_lcd.py)
  gen-gt     ground-truth overlap/yaw generation    (demo4_gen_gt_files.py)
  train      train from a network.yml               (training.py)
  pack       build per-sequence image packs         (no reference counterpart)
  evaluate   overlap/yaw accuracy on a GT npz        (testing.py)
  sim        synthetic KITTI-layout sequence        (no reference counterpart)

Each runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "gen-data":
        from overlapnet_torch.cli.gen_data import main as run
    elif cmd == "infer":
        from overlapnet_torch.cli.infer_pair import main as run
    elif cmd == "lcd":
        from overlapnet_torch.cli.lcd import main as run
    elif cmd == "gen-gt":
        from overlapnet_torch.cli.gen_gt import main as run
    elif cmd == "train":
        from overlapnet_torch.cli.train import main as run
    elif cmd == "pack":
        from overlapnet_torch.cli.pack import main as run
    elif cmd == "evaluate":
        from overlapnet_torch.cli.evaluate import main as run
    elif cmd == "sim":
        from overlapnet_torch.cli.sim import main as run
    else:
        print(f"Unknown command: {cmd}\n{__doc__}")
        return 2
    return run(rest) or 0


if __name__ == "__main__":
    sys.exit(main())
