"""pack: build per-sequence memmap image packs for fast training IO.

No reference counterpart (the reference np.loads every image every epoch);
see data/pack.py.

Usage:
  python -m overlapnet_torch.cli pack <network.yml> --out-dir PACKS [--seqs 07 08]
"""

from __future__ import annotations

import argparse

from overlapnet_torch.core.config import load_config
from overlapnet_torch.data.pack import SequencePack


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="pack", description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--seqs", nargs="*", default=None)
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    seqs = args.seqs if args.seqs else list(cfg.data.training_seqs) + list(
        cfg.data.testing_seqs
    )
    for seq in seqs:
        pack = SequencePack.build(
            cfg.data.image_root,
            seq,
            cfg.channels,
            args.out_dir,
            cfg.model.input_height,
            cfg.model.input_width,
        )
        print(f"packed {seq}: {len(pack)} scans -> {args.out_dir}")
    return 0
