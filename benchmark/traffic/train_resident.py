"""Training on one's own sequences: ``Trainer.run_epoch_resident`` over
``ResidentPairs``, whole epochs back to back.

Set-up writes ``scans`` seeded scans as the per-channel ``.npy`` files that
``PairImageDataset`` reads (the class-probability images are links into a
seeded pool of ``probability_pool``, so a run writes less; every scan is
still distinct in its depth, normals and intensity), draws ``pairs`` pairs
of distinct scans with overlaps uniform over [0, 1] and yaw bins uniform
over the circle, builds the trainer, loads the benchmark's weights, and
holds the scans resident as ``cli train`` does. It then drives the trainer
through its first ``check_steps`` steps through the window's own call and
feed (one batch each, recorded), and hands the same trainer to the window.

End-to-end: ``train_pairs_per_s``, the pairs of all optimizer steps of the
window's epochs (each ends in a fetch of its losses) over their time.

The check follows those first steps with the plain reference from the same
weights and batches: each step's loss, each leaf's gradient norm at the
first step (from the optimizer's accumulator, which holds g*g after one
Adagrad step), and each leaf's change after the steps.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from benchmark import synth
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

SCAN_BLOCK = 32


class FirstSteps:
    """The window's feed, one recorded batch per epoch call."""

    def __init__(self, resident, batches):
        self.images = resident.images
        self._batches = iter(batches)
        self.taken = []

    def batches(self, batch_size, epoch=0, shuffle=False, drop_remainder=False, **kw):
        b = next(self._batches)
        self.taken.append(b)
        yield b


def scan_kinds(run, block: int) -> dict[str, torch.Tensor]:
    g = ref.geometry(run.config)
    n = min(SCAN_BLOCK, run.mix["scans"] - block * SCAN_BLOCK)
    return synth.range_images(n, run.config, g["height"], g["width"],
                              synth.generator(run.seed, run.device, 3000 + block), run.device)


def write_scans(run, root: str) -> None:
    mix = run.mix
    pool = mix["probability_pool"]
    for block in range(-(-mix["scans"] // SCAN_BLOCK)):
        kinds = scan_kinds(run, block)
        for kind, x in kinds.items():
            os.makedirs(os.path.join(root, "00", kind), exist_ok=True)
            host = x.cpu().numpy()
            for k in range(host.shape[0]):
                i = block * SCAN_BLOCK + k
                path = os.path.join(root, "00", kind, f"{i:06d}.npy")
                if kind == "probability" and i >= pool:
                    os.symlink(os.path.join(root, "00", kind, f"{i % pool:06d}.npy"), path)
                else:
                    np.save(path, host[k])


def read_scans(run, ids) -> torch.Tensor:
    """(k, H, W, C) scans as the reference reads them from disk."""
    out = []
    for i in ids:
        parts = []
        for kind, _ in synth.CHANNEL_ORDER:
            p = os.path.join(run.workdir, "00", kind, f"{int(i):06d}.npy")
            if os.path.exists(p):
                x = np.load(p)
                parts.append(x[..., None] if x.ndim == 2 else x)
        out.append(np.concatenate(parts, axis=-1))
    return torch.from_numpy(np.stack(out)).to(run.device)


def pairs_of(run):
    """Pairs of distinct scans, overlap uniform over [0, 1], yaw bin
    uniform over the leg output's bins."""
    mix, r = run.mix, synth.rng(run.seed, 7)
    n, s = mix["pairs"], mix["scans"]
    i1 = r.integers(0, s, n)
    i2 = (i1 + r.integers(1, s, n)) % s
    overlap = r.uniform(0.0, 1.0, n)
    yaw = r.integers(0, ref.geometry(run.config)["out_width"], n).astype(np.float64)
    return i1, i2, overlap, yaw


def setup(run) -> dict:
    from overlapnet_torch.core.config import config_from_dict
    from overlapnet_torch.data.dataset import PairImageDataset, ResidentPairs, unique_scans
    from overlapnet_torch.data.gt_files import PairList
    from overlapnet_torch.models import leg_output_width
    from overlapnet_torch.train.trainer import Trainer

    mix, dev = run.mix, run.device
    cfg = config_from_dict(run.config)
    cfg.data.data_root_folder = run.workdir
    write_scans(run, run.workdir)
    i1, i2, overlap, yaw = pairs_of(run)
    names = [f"{i:06d}" for i in range(mix["scans"])]
    pairs = PairList([names[i] for i in i1], [names[i] for i in i2],
                     ["00"] * len(i1), ["00"] * len(i1), overlap, yaw)
    ds = PairImageDataset(cfg.data.image_root, pairs, cfg.channels,
                          height=cfg.model.input_height, width=cfg.model.input_width,
                          rotate_data=cfg.train.rotate_training_data, seed=cfg.train.seed,
                          adjust_yaw_labels=cfg.train.rotate_adjust_yaw_labels,
                          leg_output_width=leg_output_width(cfg.model))
    batch = cfg.train.batch_size
    trainer = Trainer(cfg, steps_per_epoch=len(pairs) // batch, device=dev)
    weights = synth.init_weights(run.config, run.seed, dev)
    trainer.state.model.load_state_dict(weights)
    resident = ResidentPairs(ds, device=dev)

    # the first steps, through the window's call and feed, recorded
    first = FirstSteps(resident, resident.batches(batch, epoch=0, shuffle=True,
                                                  drop_remainder=True))
    params0 = {k: v.detach().clone() for k, v in trainer.state.model.named_parameters()}
    losses, grad_norms = [], None
    for _ in range(mix["check_steps"]):
        out = trainer.run_epoch_resident(first, batch, epoch=0)
        losses.append(out["loss"])
        if grad_norms is None:
            acc = trainer.state.opt_state["sum_of_squares"]
            grad_norms = {k: float(torch.sqrt(v.double().sum())) for k, v in acc.items()}
    change = {k: float((v.detach().double() - params0[k].double()).norm())
              for k, v in trainer.state.model.named_parameters()}
    run.sync()
    # the resident store's row of each scan: the sorted unique (dir, name)
    scan_ids = np.array([int(name) for _, name in unique_scans(pairs)[0]])
    return {"trainer": trainer, "resident": resident, "batch": batch, "scan_ids": scan_ids,
            "program": {"losses": losses, "grad_norms": grad_norms, "change": change},
            "taken": first.taken, "steps_per_epoch": len(pairs) // batch}


def window(run, state, seconds: float, tracer) -> dict:
    trainer, resident, batch = state["trainer"], state["resident"], state["batch"]
    epoch, steps = 1, 0
    t0 = time.perf_counter()
    while True:
        with tracer.span("epoch"):
            trainer.run_epoch_resident(resident, batch, epoch=epoch)
        steps += state["steps_per_epoch"]
        epoch += 1
        if time.perf_counter() - t0 >= seconds:
            break
    dt = time.perf_counter() - t0
    run.counts.update(attempted=steps, failed=0, steps=steps, pairs=steps * batch,
                      batch=batch)
    return {"train_pairs_per_s": steps * batch / dt}


def leaf_gap(prog: dict, want: dict, keep: list[str]) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference leaf's norm and the median leaf's."""
    med = float(np.median([want[k] for k in keep]))
    return max(abs(prog[k] - want[k]) / max(want[k], med) for k in keep)


def readings(run, state, prog: dict, prec=ref.REFERENCE, keep_pairs=None,
             per_step=False) -> dict:
    """The compared numbers of ``prog`` (losses, grad_norms, change per
    leaf) against the plain reference over the recorded batches.
    ``prec``/``keep_pairs`` put the reference, at that precision or with
    that fault, in the program's place (for the controls)."""
    weights = synth.init_weights(run.config, run.seed, run.device)
    rows = np.unique(np.concatenate([np.concatenate([b["i1"], b["i2"]]) for b in state["taken"]]))
    scans = read_scans(run, state["scan_ids"][rows])  # each distinct scan once
    at = {int(r): k for k, r in enumerate(rows)}

    def side(idx):
        return scans[torch.as_tensor([at[int(i)] for i in idx], device=run.device)]

    batches = [(side(b["i1"]), side(b["i2"]),
                torch.as_tensor(b["overlap"], device=run.device).float(),
                torch.as_tensor(b["orientation"], device=run.device)) for b in state["taken"]]
    spe = state["steps_per_epoch"]
    losses, g1, after = ref_train.run_steps(run.config, weights, batches, spe)
    want_g = {k: float(v.double().norm()) for k, v in g1.items()}
    want_d = {k: float((after[k].double() - weights[k].double()).norm()) for k in weights}
    if prog is None:  # the reference in the program's place
        p_losses, p_g1, p_after = ref_train.run_steps(run.config, weights, batches, spe, prec,
                                                      keep_pairs)
        prog = {"losses": p_losses,
                "grad_norms": {k: float(v.double().norm()) for k, v in p_g1.items()},
                "change": {k: float((p_after[k].double() - weights[k].double()).norm())
                           for k in weights}}
    med_g = float(np.median(list(want_g.values())))
    # leaves whose reference gradient is nought to rounding move by
    # round-off alone under Adagrad: out, by a rule on the reference
    keep = [k for k, v in want_g.items() if v >= 1e-3 * med_g]
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], losses)]
    out = {"loss_gap_by_step": steps} if per_step else {}
    return out | {
        "loss_gap": max(steps),
        "grad_norm_gap": leaf_gap(prog["grad_norms"], want_g, keep),
        "update_gap": leaf_gap(prog["change"], want_d, keep),
    }


def check(run, state) -> dict[str, tuple[float, float]]:
    lim = run.mix["limits"]
    prog = state["program"]
    keep = {"taken": state["taken"], "steps_per_epoch": state["steps_per_epoch"],
            "scan_ids": state["scan_ids"]}
    state.clear()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    got = readings(run, keep, prog)
    # the steps' losses are read but not compared (PERF.md, section 2)
    return {k: (got[k], lim[k]) for k in lim}
