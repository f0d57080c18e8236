"""train: full training run from a network.yml-style config.

Equivalent of reference src/two_heads/training.py:96-420: GT npz selection
(per-sequence ``ground_truth/{train,validation}_set.npz`` via training_seqs,
or explicit traindata/validationdata npz files), per-epoch training with the
reference's LR schedule/losses, per-epoch validation metrics (overlap
mean/max/RMS, yaw RMS at overlap thresholds), a checkpoint and a flat-key
``params.npz`` per epoch, and jsonl metric logs.

Training is data-parallel over a mesh of the ranks that the ``OVERLAPNET_*``
variables started (``core/distributed.py``; one process per card), as the
JAX CLI's is over its devices: the mesh takes the largest rank count that
divides ``batch_size``. Ranks past it cannot sit out of the process group's
collectives, so a world that count does not fill is an argument error that
names the count to launch. Rank 0 writes the checkpoints, weights and logs;
the other ranks wait for it at a barrier and read the checkpoints on
``--resume``. One process with no such variables is a mesh of one rank.
``--single-device`` trains with no mesh.

Usage:
  python -m overlapnet_torch.cli train <network.yml> [--pack-dir PACKS]
      [--resume] [--no-resident] [--single-device] [--device cuda|cpu]
      [--profile-dir DIR]

``--pack-dir`` reads the scans of every sequence that has a pack there
(``cli pack``) from it; the others from their per-image files.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from overlapnet_torch.core.config import load_config
from overlapnet_torch.core.distributed import world
from overlapnet_torch.core.metrics import MetricWriter, setup_logging
from overlapnet_torch.core.profiling import trace
from overlapnet_torch.data.dataset import PairImageDataset, ResidentPairs, unique_scans
from overlapnet_torch.data.gt_files import load_gt_pairs
from overlapnet_torch.data.pack import open_packs
from overlapnet_torch.parallel.mesh import barrier, is_writer, make_mesh

# the deduplicated scan set goes to the device when it is smaller than this
RESIDENT_LIMIT_BYTES = 4e9


def npz_selection(cfg) -> tuple[list[str], list[str]]:
    """Train/validation GT npz paths (reference training.py:110-134)."""
    root = cfg.data.data_root_folder
    if cfg.data.training_seqs:
        train = [
            os.path.join(root, s, "ground_truth/train_set.npz")
            for s in cfg.data.training_seqs
        ]
        val = [
            os.path.join(root, s, "ground_truth/validation_set.npz")
            for s in cfg.data.training_seqs
        ]
        return train, val
    return [cfg.data.traindata_npzfile], [cfg.data.validationdata_npzfile]


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="train", description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--pack-dir", default="",
                    help="directory of sequence packs (cli pack) to read scans from")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda; raises without a card)")
    ap.add_argument(
        "--profile-dir",
        default="",
        help="capture a torch.profiler device trace of the first epoch into this dir",
    )
    ap.add_argument(
        "--tensorboard",
        action="store_true",
        help="mirror metrics to TensorBoard event files under the exp dir",
    )
    ap.add_argument(
        "--no-resident",
        action="store_true",
        help="disable the device-resident training store (stream host batches "
        "even when the deduplicated scan set fits in device memory)",
    )
    ap.add_argument("--single-device", action="store_true",
                    help="train on one device, with no mesh")
    args = ap.parse_args(argv)

    from overlapnet_torch.models import leg_output_width
    from overlapnet_torch.train.checkpoint import (
        latest_step,
        restore_checkpoint,
        save_checkpoint,
        save_params_npz,
    )
    from overlapnet_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    if args.single_device:
        mesh = None
    else:
        # the largest rank count that divides the batch (even DP sharding)
        n_ranks = world()[1]
        while n_ranks > 1 and cfg.train.batch_size % n_ranks:
            n_ranks -= 1
        if n_ranks != world()[1]:
            ap.error(f"batch_size {cfg.train.batch_size} splits evenly over {n_ranks} "
                     f"of the {world()[1]} ranks: launch {n_ranks}")
        mesh = make_mesh(n_ranks, device=args.device)
    exp_dir = os.path.join(cfg.experiment.experiments_path, cfg.experiment.testname)
    logger = setup_logging(exp_dir if is_writer(mesh) else None)
    writer = (MetricWriter(exp_dir, tensorboard=True if args.tensorboard else None)
              if is_writer(mesh) else None)
    logger.info("Using configuration file %s", args.config)

    train_npz, val_npz = npz_selection(cfg)
    pairs = load_gt_pairs(train_npz, shuffle=True,
                          rng=np.random.default_rng(cfg.train.seed))
    val_pairs = load_gt_pairs(val_npz, shuffle=False)
    n_train = min(len(pairs), cfg.train.batch_size * cfg.train.no_batches_in_epoch)
    pairs = pairs[np.arange(n_train)]
    n_val = min(len(val_pairs), cfg.train.no_test_pairs)
    val_pairs = val_pairs[np.arange(n_val)]
    logger.info("training pairs: %d, validation pairs: %d", n_train, n_val)

    seqs = set(pairs.dir1) | set(pairs.dir2) | set(val_pairs.dir1) | set(val_pairs.dir2)
    packs = open_packs(args.pack_dir, sorted(seqs)) if args.pack_dir else None
    want = (cfg.model.input_height, cfg.model.input_width, cfg.channels.num_channels)
    for seq, pack in (packs or {}).items():
        if tuple(pack.data.shape[1:]) != want:
            ap.error(f"--pack-dir: the pack of {seq} holds {tuple(pack.data.shape[1:])} "
                     f"images, the config's input is {want}")
    ds_kwargs = dict(
        channels=cfg.channels,
        height=cfg.model.input_height,
        width=cfg.model.input_width,
        packs=packs,
    )
    train_ds = PairImageDataset(
        cfg.data.image_root, pairs,
        rotate_data=cfg.train.rotate_training_data,
        seed=cfg.train.seed,
        adjust_yaw_labels=cfg.train.rotate_adjust_yaw_labels,
        leg_output_width=leg_output_width(cfg.model),
        **ds_kwargs,
    )
    val_ds = PairImageDataset(cfg.data.image_root, val_pairs, **ds_kwargs)

    steps_per_epoch = max(1, n_train // cfg.train.batch_size)
    trainer = Trainer(cfg, steps_per_epoch=steps_per_epoch,
                      device=args.device if mesh is None else None, mesh=mesh)

    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    if args.resume and latest_step(ckpt_dir) is not None:
        restore_checkpoint(ckpt_dir, trainer.state)
        logger.info("resumed from step %d", trainer.state.step)

    # device-resident fast path: when the deduplicated scan set fits in
    # device memory, put it there once and train on index batches (steps
    # ship O(batch) integers instead of full images). The store is float32
    # whatever train.input_dtype says, as the JAX CLI builds it.
    resident = None
    if not args.no_resident:
        n_unique = len(unique_scans(pairs)[0])
        footprint = (
            n_unique * cfg.model.input_height * cfg.model.input_width
            * cfg.channels.num_channels * 4
        )
        if footprint < RESIDENT_LIMIT_BYTES:
            resident = ResidentPairs(train_ds, device=trainer.device, mesh=mesh)
            logger.info(
                "device-resident training store: %d scans, %.1f MB",
                n_unique, footprint / 1e6,
            )
        else:
            logger.info(
                "scan footprint %.1f GB > 4 GB; streaming host batches",
                footprint / 1e9,
            )

    start_epoch = trainer.state.step // steps_per_epoch
    for epoch in range(start_epoch, cfg.train.no_epochs):
        with trace(args.profile_dir if epoch == start_epoch else None):
            if resident is not None:
                metrics = trainer.run_epoch_resident(resident, cfg.train.batch_size, epoch)
            else:
                metrics = trainer.run_epoch(
                    train_ds.batches(
                        cfg.train.batch_size, epoch=epoch, shuffle=True,
                        drop_remainder=True, input_dtype=cfg.train.input_dtype, mesh=mesh,
                    ),
                    epoch=epoch,
                )
        logger.info("epoch %d: loss %.5f", epoch, metrics.get("epoch_loss", float("nan")))
        step = trainer.state.step
        if writer is not None:
            writer.write(step, {**metrics, "epoch": epoch}, phase="train")
            save_checkpoint(ckpt_dir, trainer.state)
            save_params_npz(os.path.join(exp_dir, "params.npz"), trainer.state.params)
        barrier(mesh)

        if n_val:
            val_metrics = trainer.evaluate(val_ds.batches(cfg.train.batch_size))
            if writer is not None:
                writer.write(step, {**val_metrics, "epoch": epoch}, phase="validation")
            logger.info(
                "epoch %d validation: overlap RMS %.4f max %.4f",
                epoch,
                val_metrics.get("overlap_rms_error", float("nan")),
                val_metrics.get("overlap_max_error", float("nan")),
            )
    if writer is not None:
        writer.close()
    logger.info("done; device %s, weights in %s", trainer.device, exp_dir)
    return 0
