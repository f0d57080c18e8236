"""gen-data: preprocess raw scans into projected channel images.

Equivalent of reference demo/demo1_gen_data.py:50-77 (batch drivers in
src/utils/gen_*_data.py), driven either by a demo.yml-style config
(``Demo1`` block) or by explicit flags.

Usage:
  python -m overlapnet_torch.cli gen-data <demo.yml> [--device cuda|cpu]
  python -m overlapnet_torch.cli gen-data --scan-folder S --dst-folder D
      [--semantic-folder P] [--normalize-depth] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import yaml

from overlapnet_torch.geometry.gen_data import (
    gen_depth_data,
    gen_intensity_data,
    gen_normal_data,
    gen_semantic_data,
)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="gen-data", description=__doc__)
    ap.add_argument("config", nargs="?", help="demo.yml with a Demo1 block")
    ap.add_argument("--scan-folder")
    ap.add_argument("--dst-folder")
    ap.add_argument("--semantic-folder", default="")
    ap.add_argument("--normalize-depth", action="store_true")
    ap.add_argument("--plot", default="", help="save a demo1-style figure of the first scan's images")
    ap.add_argument("--device", default="cuda",
                    help="where the scans are projected (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    scan_folder, dst_folder, semantic_folder = (
        args.scan_folder, args.dst_folder, args.semantic_folder
    )
    if args.config:
        with open(args.config) as f:
            demo1 = (yaml.safe_load(f) or {}).get("Demo1", {})
        scan_folder = scan_folder or demo1.get("scan_folder")
        dst_folder = dst_folder or demo1.get("dst_folder")
        semantic_folder = semantic_folder or demo1.get("semantic_folder", "")
    if not scan_folder or not dst_folder:
        ap.error("need --scan-folder and --dst-folder (or a config file)")

    kw = dict(device=args.device)
    depth = gen_depth_data(scan_folder, dst_folder, normalize=args.normalize_depth, **kw)
    print(f"depth: {len(depth)} images")
    normal = gen_normal_data(scan_folder, dst_folder, **kw)
    print(f"normal: {len(normal)} images")
    intensity = gen_intensity_data(scan_folder, dst_folder, **kw)
    print(f"intensity: {len(intensity)} images")
    import os

    if semantic_folder and os.path.isdir(semantic_folder):
        semantic = gen_semantic_data(semantic_folder, scan_folder, dst_folder, **kw)
        print(f"semantic: {len(semantic)} images")

    if args.plot:
        # Row-per-channel figure of the first scan (reference
        # demo1_gen_data.py:18-47 show_images).
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        rows = [
            ("range image", np.load(depth[0])),
            ("normal image", (np.load(normal[0]) + 1.0) / 2.0),
            ("intensity image", np.load(intensity[0])),
        ]
        fig, axes = plt.subplots(len(rows), 1, figsize=(10, 1.6 * len(rows)))
        for ax, (title, img) in zip(np.atleast_1d(axes), rows):
            ax.imshow(np.clip(img, 0, None), aspect="auto")
            ax.set_title(title, fontsize=8)
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=150)
        print(f"plot -> {args.plot}")
    return 0
