"""Trainability A/B: reference-parity training config vs this framework's.

Port of the JAX package's ``sim/trainability_ab.py``. The framework deviates
from strict reference parity in four knobs (core/config.py, models/heads.py
CorrelationHead 'cosine' docstring): correlation normalize none->cosine
(+stop-gradient into the legs), Adagrad (lr 1e-3, reference
training.py:253) -> Adam (lr 3e-4), and group-wise grad clipping. This
experiment trains BOTH configs from the same seed on the same synthetic GT
with the same budget and reports both metric curves.

Run:  python -m overlapnet_torch.sim.trainability_ab --work-dir <dir> \
          [--frames 128] [--epochs 20] [--out TRAINABILITY_AB.json] [--device cuda]
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from overlapnet_torch.sim.e2e import build_gt, generate_sequence, make_config


def train_one(name: str, cfg, gt_paths: dict, device="cuda") -> dict:
    from overlapnet_torch.data import load_gt_pairs
    from overlapnet_torch.data.dataset import PairImageDataset, ResidentPairs
    from overlapnet_torch.train.trainer import Trainer

    pairs = load_gt_pairs([gt_paths["train_set"]], shuffle=True,
                          rng=np.random.default_rng(cfg.train.seed))
    val_pairs = load_gt_pairs([gt_paths["validation_set"]], shuffle=False)
    ds_kwargs = dict(channels=cfg.channels, height=cfg.model.input_height,
                     width=cfg.model.input_width)
    train_ds = PairImageDataset(
        cfg.data.image_root, pairs, rotate_data=cfg.train.rotate_training_data,
        seed=cfg.train.seed, **ds_kwargs)
    val_ds = PairImageDataset(cfg.data.image_root, val_pairs, **ds_kwargs)

    trainer = Trainer(cfg, steps_per_epoch=max(1, len(pairs) // cfg.train.batch_size),
                      device=device)
    resident = ResidentPairs(train_ds, device=trainer.device)
    out = {"config": {
        "correlation_normalize": cfg.model.correlation_normalize,
        "correlation_stop_gradient": cfg.model.correlation_stop_gradient,
        "optimizer": cfg.train.optimizer,
        "learning_rate": cfg.train.learning_rate,
        "grad_clip_norm": cfg.train.grad_clip_norm,
        "mask_zero_orientation": cfg.train.mask_zero_orientation,
    }, "epoch_loss": [], "epoch_grad_norm": []}
    for epoch in range(cfg.train.no_epochs):
        m = trainer.run_epoch_resident(resident, cfg.train.batch_size, epoch)
        out["epoch_loss"].append(m.get("epoch_loss"))
        out["epoch_grad_norm"].append(m.get("grad_norm"))
        print(f"[{name}] epoch {epoch}: loss {m.get('epoch_loss'):.4f} "
              f"grad_norm {m.get('grad_norm'):.2f}", flush=True)
    out["final"] = trainer.evaluate(val_ds.batches(cfg.train.batch_size))
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    from overlapnet_torch.models import leg_output_width

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="where both runs train (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    files, poses = generate_sequence(args.work_dir, args.frames, seed=args.seed,
                                     device=args.device)
    base = make_config(args.work_dir, device=args.device, batch_size=args.batch_size,
                       no_epochs=args.epochs, seed=args.seed)
    gt_paths = build_gt(args.work_dir, files, poses,
                        leg_output_width=leg_output_width(base.model),
                        seed=args.seed, device=args.device)

    # A: strict reference parity (training.py:253-259 + generateNet.py:343)
    parity = make_config(args.work_dir, device=args.device, batch_size=args.batch_size,
                         no_epochs=args.epochs, seed=args.seed)
    parity.model = dataclasses.replace(
        parity.model, correlation_normalize="none",
        correlation_stop_gradient=False)
    parity.train.optimizer = "adagrad"
    parity.train.learning_rate = 1e-3
    parity.train.grad_clip_norm = 0.0
    parity.train.mask_zero_orientation = False

    results = {
        "frames": args.frames, "epochs": args.epochs, "seed": args.seed,
        "A_reference_parity": train_one("A:parity", parity, gt_paths, args.device),
        "B_trainability": train_one("B:trainability", base, gt_paths, args.device),
    }
    line = json.dumps(results, default=float)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
