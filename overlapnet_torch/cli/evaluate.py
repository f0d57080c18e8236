"""evaluate: the quantitative evaluation harness.

Equivalent of reference src/two_heads/testing.py:54-352: select the GT npz
source (testing_seqs -> full ground_truth_overlap_yaw.npz; training_seqs ->
validation_set.npz; else testdata_npzfile), compute each unique scan's leg
embedding once, score every pair on the cached embeddings, and report
overlap mean/max/RMS plus circular yaw RMS over pairs with overlap > 0.7;
results go to ``validation_results.npz`` (same keys as the JAX package's)
and ``validation.jsonl``.

Usage:
  python -m overlapnet_torch.cli evaluate <network.yml>
      [--weights params.npz|checkpoint_dir] [--pack-dir PACKS]
      [--max-pairs N] [--plot] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from overlapnet_torch.core.config import load_config
from overlapnet_torch.core.device import resolve_device
from overlapnet_torch.core.metrics import MetricWriter, setup_logging
from overlapnet_torch.data.dataset import FeatureVolumePairs, PairImageDataset, unique_scans
from overlapnet_torch.data.gt_files import PairList, load_gt_pairs

# Pairs per FeatureVolumePairs batch (the head pass scores it in chunks of
# DescriptorDB's MAX_PAIRS_PER_CALL).
PAIRS_PER_BATCH = 4096


def npz_selection(cfg) -> list[str]:
    """Test npz paths, three modes (reference testing.py:70-92)."""
    root = cfg.data.data_root_folder
    if cfg.data.testing_seqs:
        return [
            os.path.join(root, s, "ground_truth/ground_truth_overlap_yaw.npz")
            for s in cfg.data.testing_seqs
        ]
    if cfg.data.training_seqs:
        return [
            os.path.join(root, s, "ground_truth/validation_set.npz")
            for s in cfg.data.training_seqs
        ]
    return [cfg.data.testdata_npzfile]


@torch.inference_mode()
def evaluate(cfg, params=None, pack_dir: str = "", max_pairs: int | None = None,
             device="cuda"):
    """Run the leg-once / head-per-pair evaluation on ``device`` ("cuda" by
    default; raises if no card is visible); returns (metrics dict, results
    dict with per-pair arrays). ``params`` is an ``OverlapNet`` state_dict;
    a seeded init when None."""
    from overlapnet_torch.data.pack import open_packs
    from overlapnet_torch.lcd.descriptor_db import DescriptorDB
    from overlapnet_torch.models import build_model, leg_output_width
    from overlapnet_torch.ops.yaw import peak_to_degrees, ref_bins_to_degrees
    from overlapnet_torch.train.evaluate import overlap_metrics, yaw_metrics

    device = resolve_device(device)
    pairs = load_gt_pairs(npz_selection(cfg), shuffle=False)
    limit = min(
        len(pairs), cfg.train.no_test_pairs,
        max_pairs if max_pairs is not None else len(pairs),
    )
    if limit == 0:
        return {}, {"pred_overlap": np.zeros(0, np.float32)}
    pairs = pairs[np.arange(limit)]

    model = build_model(cfg.model, cfg.num_input_channels, device=device)
    if params is not None:
        model.load_state_dict(params)
    model.eval()

    # Leg pass: one embedding per unique scan (reference testing.py:237-263),
    # kept on the device.
    scans, idx1, idx2 = unique_scans(pairs)
    packs = open_packs(pack_dir, sorted({d for d, _ in scans})) if pack_dir else None
    scan_pairs = PairList(
        [n for _, n in scans], [], [d for d, _ in scans], [],
        np.zeros(len(scans)), np.zeros(len(scans)),
    )
    ds = PairImageDataset(
        cfg.data.image_root, scan_pairs, cfg.channels,
        cfg.model.input_height, cfg.model.input_width, packs=packs,
    )
    bsz = max(1, cfg.train.batch_size)
    fvs = []
    for s in range(0, len(scans), bsz):
        imgs = np.stack([ds._cache.get(d, n) for d, n in scans[s : s + bsz]])
        fvs.append(model.encode(torch.from_numpy(imgs).to(device)).float())
    fvs = torch.cat(fvs)

    # Head pass over all pairs on the cached embeddings (testing.py:269-272),
    # batched through the descriptor-reuse generator (reference
    # ImagePairOverlapSequenceFeatureVolume.py:36-47). score_volumes only
    # reads the model: the store itself stays empty.
    db = DescriptorDB(model.score, capacity=1, width=leg_output_width(cfg.model),
                      channels=model.legs.out_channels, device=device)
    pred_overlap = np.zeros(limit, np.float32)
    pred_yaw = np.zeros(limit, np.float32)  # sub-bin peak positions
    s = 0
    for batch in FeatureVolumePairs(fvs, idx1, idx2, device=device).batches(PAIRS_PER_BATCH):
        k = batch["fa"].shape[0]
        pred_overlap[s : s + k], pred_yaw[s : s + k], _ = db.score_volumes(
            batch["fa"], batch["fb"]
        )
        s += k

    # yaw metrics in physical degrees: peaks decode through the model's
    # yaw_space, GT bins through the reference npz convention (ops/yaw.py).
    pred_deg = peak_to_degrees(pred_yaw, cfg.model).numpy()
    true_deg = ref_bins_to_degrees(pairs.orientation, cfg.model).numpy()
    metrics = overlap_metrics(pred_overlap, pairs.overlap)
    ym = yaw_metrics(pred_deg, true_deg, pairs.overlap, 360)
    metrics.update({f"yaw_{k}" if not k.startswith("yaw") else k: v for k, v in ym.items()})
    results = {
        "pred_overlap": pred_overlap,
        "pred_orientation": pred_yaw,
        "pred_yaw_deg": pred_deg,
        "true_yaw_deg": true_deg,
        "true_overlap": np.asarray(pairs.overlap),
        "true_orientation": np.asarray(pairs.orientation),
        "pair_idx1": idx1,
        "pair_idx2": idx2,
    }
    return metrics, results


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="evaluate", description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--weights", default="")
    ap.add_argument("--pack-dir", default="")
    ap.add_argument("--max-pairs", type=int, default=None)
    ap.add_argument("--plot", action="store_true",
                    help="save overlap/yaw error histograms (testing.py:295-336)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    if args.weights:
        cfg.experiment.pretrained_weightsfilename = args.weights
    exp_dir = os.path.join(
        cfg.experiment.experiments_path, cfg.experiment.testname
    )
    logger = setup_logging(exp_dir, filename=f"validation_{cfg.experiment.testname}.log")
    writer = MetricWriter(exp_dir, name="validation")

    params = None
    if cfg.experiment.pretrained_weightsfilename:
        from overlapnet_torch.lcd.infer import Infer

        params = Infer(cfg, db_capacity=1, device=args.device)._load_params()

    metrics, results = evaluate(cfg, params, args.pack_dir, args.max_pairs, device=args.device)
    for k, v in metrics.items():
        logger.info("  %s: %s", k, v)
    writer.write(0, metrics, phase="test")
    writer.close()
    out = os.path.join(exp_dir, "validation_results.npz")
    np.savez(out, **results)
    logger.info("results -> %s", out)

    if args.plot and len(results["pred_overlap"]):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        diffs = np.abs(results["pred_overlap"] - results["true_overlap"])
        plt.figure()
        plt.hist(diffs, bins=10)
        plt.xlabel("error in overlap percentage")
        plt.ylabel("number of pairs")
        plt.savefig(os.path.join(exp_dir, "overlap_error_histogram.png"), dpi=150)

        mask = results["true_overlap"] > cfg.train.min_overlap_for_angle
        d = np.abs(results["pred_yaw_deg"] - results["true_yaw_deg"])[mask]
        circ = np.minimum(d, 360.0 - d)
        if len(circ):
            plt.figure()
            plt.hist(circ, bins=90)
            plt.xlabel("circular yaw error [deg]")
            plt.ylabel("number of pairs")
            plt.savefig(os.path.join(exp_dir, "yaw_error_histogram.png"), dpi=150)
        logger.info("histograms -> %s", exp_dir)
    return 0
