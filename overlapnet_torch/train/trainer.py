"""Training loop, on one device or data-parallel over a mesh of ranks.

Replaces the reference's single-GPU keras ``fit_generator`` epoch loop
(reference: training.py:336-420) and mirrors the JAX package's
``train/trainer.py`` name by name: ``make_optimizer``, ``TrainState``,
``make_train_step``, ``make_resident_train_step``,
``make_resident_multi_step``, ``make_eval_step`` and ``Trainer``.

Optimizer parity: keras Adagrad(lr) with zero-initialized accumulator and
eps=1e-7 (training.py:253) is ``acc += g*g; p -= lr * g * rsqrt(acc + eps)``
where acc > 0 (the rule of optax.adagrad(initial_accumulator_value=0,
eps=1e-7)), written out here: ``torch.optim.Adagrad`` divides by
``sqrt(acc) + eps`` and differs from the first step on. LR schedule from
train.schedule, read at the step count before the update. Loss weights 5:1
(training.py:257). The 'Fixed' legs variant (generateNet.py:222-324) is a
mask on the update instead of a duplicate frozen module.

The parameters live in the model and every step updates them and the
optimizer state in place; a step hands back the state it was given.

Data parallelism (``mesh=``, the counterpart of the JAX trainer's
``in_shardings``): every rank holds the same parameters and optimizer state
and gets the same GLOBAL batch; it takes its block of the batch
(``parallel.mesh.put_sharded``), forms its share of the global-batch loss
(``losses.combined_loss(mesh=)``) and its gradients, and one SUM all-reduce
of one flat bucket (gradients and the loss values) gives every rank the
global batch's gradients before ``grad_norm`` and the group-wise clip. The
update then runs alike on every rank, so parameters stay bit-equal across
ranks. A mesh of one rank gives the bits of no mesh.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

from overlapnet_torch.core.config import OverlapNetConfig
from overlapnet_torch.core.profiling import count, span
from overlapnet_torch.models import OverlapNet, build_model, leg_output_width
from overlapnet_torch.ops.correlation import subbin_peak
from overlapnet_torch.ops.yaw import peak_to_degrees, ref_bins_to_degrees, target_bins
from overlapnet_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce_sum,
    device_of,
    pad_to_multiple,
    put_sharded_dim,
)
from overlapnet_torch.train.evaluate import overlap_metrics, yaw_metrics
from overlapnet_torch.train.losses import combined_loss, orientation_target
from overlapnet_torch.train.schedule import reference_lr_schedule

ADAGRAD_EPS = 1e-7
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ORIENT_PREFIX = "orientation_head."
LEGS_PREFIX = "legs."

OptState = dict  # {"sum_of_squares": {name: tensor}} | {"mu", "nu": {...}, "count": int}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (a 0-d tensor)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class Optimizer:
    """The optax chain of the JAX trainer written out: group-wise clip by
    global norm -> Adagrad or Adam -> schedule, with frozen legs masked out
    of all three. ``update`` changes parameters and state in place."""

    def __init__(self, kind: str, schedule: Callable[[int], float],
                 clip_norm: float = 0.0, freeze_legs: bool = False):
        if kind not in ("adagrad", "adam"):
            raise ValueError(f"unknown optimizer {kind!r} (adagrad|adam)")
        self.kind = kind
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.freeze_legs = freeze_legs

    def trained(self, names: Iterable[str]) -> list[str]:
        return [n for n in names if not (self.freeze_legs and n.startswith(LEGS_PREFIX))]

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        zeros = lambda: {n: torch.zeros_like(params[n]) for n in self.trained(params)}  # noqa: E731
        if self.kind == "adagrad":
            return {"sum_of_squares": zeros()}
        return {"mu": zeros(), "nu": zeros(), "count": 0}

    def _clipped(self, grads: Mapping[str, torch.Tensor], names: list[str]):
        """The orientation head's few parameters see CE gradients orders of
        magnitude above the conv stack's; one global norm would let them
        scale the leg and overlap gradients down every step. Each group is
        clipped by its own norm: ``(g / norm) * max`` where norm >= max."""
        if self.clip_norm <= 0:
            return grads
        out = dict(grads)
        groups = ([n for n in names if n.startswith(ORIENT_PREFIX)],
                  [n for n in names if not n.startswith(ORIENT_PREFIX)])
        for group in groups:
            if not group:
                continue
            norm = global_norm(grads[n] for n in group)
            keep = norm < self.clip_norm
            for n in group:
                out[n] = torch.where(keep, grads[n], (grads[n] / norm) * self.clip_norm)
        return out

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], state: OptState, step: int) -> None:
        """One update at step count ``step`` (the count before it). The
        elementwise rules run as multi-tensor (``torch._foreach``) calls: a
        handful of launches for the whole model instead of some per tensor."""
        names = self.trained(params)
        grads = self._clipped(grads, names)
        lr = self.schedule(step)
        ps, gs = [params[n] for n in names], [grads[n] for n in names]
        if self.kind == "adagrad":
            # acc += g*g; p -= lr * g * where(acc > 0, rsqrt(acc + eps), 0)
            accs = [state["sum_of_squares"][n] for n in names]
            torch._foreach_addcmul_(accs, gs, gs)
            upd = torch._foreach_add(accs, ADAGRAD_EPS)
            torch._foreach_rsqrt_(upd)
            torch._foreach_mul_(upd, torch._foreach_sign(accs))  # acc >= 0: 1 where acc > 0
            torch._foreach_mul_(upd, gs)
        else:
            state["count"] += 1
            mus, nus = [state["mu"][n] for n in names], [state["nu"][n] for n in names]
            torch._foreach_mul_(mus, ADAM_B1)
            torch._foreach_add_(mus, gs, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nus, ADAM_B2)
            torch._foreach_addcmul_(nus, gs, gs, value=1.0 - ADAM_B2)
            # mu_hat / (sqrt(nu_hat) + eps), bias-corrected by the count
            upd = torch._foreach_div(mus, 1.0 - ADAM_B1 ** state["count"])
            denom = torch._foreach_div(nus, 1.0 - ADAM_B2 ** state["count"])
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(ps, upd)


def make_optimizer(cfg: OverlapNetConfig, steps_per_epoch: int) -> Optimizer:
    schedule = reference_lr_schedule(
        cfg.train.learning_rate, cfg.train.lr_alpha, steps_per_epoch
    )
    return Optimizer(cfg.train.optimizer, schedule, cfg.train.grad_clip_norm,
                     freeze_legs=not cfg.model.legs_trainable)


@dataclasses.dataclass
class TrainState:
    """Model (its parameters), optimizer state and step count."""

    model: OverlapNet
    opt_state: OptState
    step: int = 0

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return self.model.state_dict()


def create_train_state(
    cfg: OverlapNetConfig, steps_per_epoch: int, seed: int = 0, device="cuda"
) -> tuple[TrainState, Optimizer]:
    model = build_model(cfg.model, cfg.num_input_channels, seed, device=device).train()
    tx = make_optimizer(cfg, steps_per_epoch)
    return TrainState(model, tx.init(dict(model.named_parameters())), 0), tx


def _on_device(batch: Mapping, device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def _local(batch: Mapping, mesh: Mesh | None, device: torch.device, dim: int = 0) -> dict:
    """The tensors of a step on ``device``: the whole batch, or with a mesh
    this rank's block of dimension ``dim`` of the global batch."""
    with span("train.batch"):
        if mesh is None:
            return _on_device(batch, device)
        return {k: put_sharded_dim(mesh, v, dim) for k, v in batch.items()}


def _loss(cfg: OverlapNetConfig, model: OverlapNet, x1, x2, overlap, orientation,
          mesh: Mesh | None = None):
    output_size = leg_output_width(cfg.model)
    # one leg pass over both sides of the pairs: the legs share their
    # weights, and half the launches is what the host-bound step gains from
    n = x1.shape[0]
    volumes = model.encode(torch.cat([x1, x2]))
    overlap_pred, orient_logits = model.score(
        volumes[:n], volumes[n:], cfg.model.correlation_stop_gradient)
    target_vec = orientation_target(target_bins(orientation, cfg.model), overlap, output_size)
    return combined_loss(
        overlap_pred,
        orient_logits,
        overlap,
        target_vec,
        pos_weight=float(output_size),  # network_output_size (training.py:243)
        min_overlap_for_angle=cfg.train.min_overlap_for_angle,
        overlap_weight=cfg.train.overlap_loss_weight,
        orientation_weight=cfg.train.orientation_loss_weight,
        mask_zero_orientation=cfg.train.mask_zero_orientation,
        soft_overlap_min=cfg.train.yaw_soft_overlap_min,
        mesh=mesh,
    )


def _sum_over_ranks(mesh: Mesh, tensors: list[torch.Tensor]) -> None:
    """One SUM all-reduce of ``tensors`` (gradients and loss values) as one
    flat bucket, copied back in place: every rank gets the global batch's.
    The tensors keep their strides, so a norm sums in the same order as
    without a mesh."""
    flat = all_reduce_sum(mesh, torch.cat([t.reshape(-1) for t in tensors]))
    torch._foreach_copy_(
        tensors, [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)])


def loss_and_grads(cfg: OverlapNetConfig, model: OverlapNet, x1, x2, overlap, orientation,
                   mesh: Mesh | None = None):
    """Forward and backward of one batch (tensors on the model's device):
    ({loss, overlap_loss, orientation_loss, grad_norm} as detached 0-d
    tensors, {parameter name: gradient}). A parameter the loss does not
    reach has a zero gradient; ``grad_norm`` is the global norm of the raw
    gradients, frozen legs included. With a ``mesh`` the tensors are this
    rank's block of the global batch and both results are the global
    batch's, alike on every rank."""
    total, metrics = _loss(cfg, model, x1, x2, overlap.float(), orientation, mesh)
    params = dict(model.named_parameters())
    found = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), found)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mesh is not None:
        _sum_over_ranks(mesh, [*grads.values(), *metrics.values()])
    metrics["grad_norm"] = global_norm(grads.values())
    return metrics, grads


def _apply_step(cfg, tx: Optimizer, state: TrainState, x1, x2, overlap, orientation,
                mesh: Mesh | None = None):
    with span("train.step"):
        count("train.steps")
        count("train.pairs", x1.shape[0])
        metrics, grads = loss_and_grads(cfg, state.model, x1, x2, overlap, orientation, mesh)
        tx.update(dict(state.model.named_parameters()), grads, state.opt_state, state.step)
        state.step += 1
        return state, metrics


def make_train_step(
    cfg: OverlapNetConfig, tx: Optimizer, mesh: Mesh | None = None
) -> Callable[[TrainState, Mapping], tuple[TrainState, dict]]:
    """The train step on host batches.

    Batch dict: x1, x2 (B, H, W, C) range-image pairs; overlap (B,);
    orientation (B,) integer yaw bins; numpy arrays or tensors. Returns the
    state (updated in place) and {loss, overlap_loss, orientation_loss,
    grad_norm} as 0-d tensors on the model's device. With a ``mesh`` every
    rank passes the same global batch (B divisible by the mesh size) and
    trains on its block."""

    def step_fn(state: TrainState, batch):
        device = next(state.model.parameters()).device
        b = _local(batch, mesh, device)
        return _apply_step(cfg, tx, state, b["x1"], b["x2"], b["overlap"], b["orientation"],
                           mesh)

    return step_fn


def roll_columns(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``np.roll(x[n], +shift[n], axis=1)`` for every image of (N, H, W, C):
    out[n, :, j] = x[n, :, (j - shift[n]) % W]."""
    n, h, w, c = x.shape
    cols = torch.remainder(torch.arange(w, device=x.device)[None, :] - shift[:, None], w)
    return x.gather(2, cols.to(torch.int64)[:, None, :, None].expand(n, h, w, c))


def _resident_step_fn(cfg: OverlapNetConfig, tx: Optimizer, mesh: Mesh | None):
    """The resident step on a batch already on the images' device (this
    rank's block with a mesh)."""

    def step_fn(state: TrainState, images: torch.Tensor, b):
        x1 = images[b["i1"].to(torch.int64)]
        x2 = roll_columns(images[b["i2"].to(torch.int64)], b["shift"])
        return _apply_step(cfg, tx, state, x1, x2, b["overlap"], b["orientation"], mesh)

    return step_fn


def make_resident_train_step(cfg: OverlapNetConfig, tx: Optimizer, mesh: Mesh | None = None):
    """Train step over a device-resident scan store (data.dataset.
    ResidentPairs): signature (state, images (N, H, W, C) on the device,
    batch {i1, i2, shift, overlap, orientation}). Pair gathers and the
    rotate_data circular shift (host semantics: np.roll(x2, +shift, axis=1))
    run on the device, so only O(batch) integers cross the link. With a
    ``mesh`` the images are replicated and each rank takes its block of the
    global index batch."""
    step_fn = _resident_step_fn(cfg, tx, mesh)

    def single(state: TrainState, images: torch.Tensor, batch):
        return step_fn(state, images, _local(batch, mesh, images.device))

    return single


def make_resident_multi_step(cfg: OverlapNetConfig, tx: Optimizer, mesh: Mesh | None = None):
    """K train steps per call over stacked index batches (each leaf (K, B)):
    (state, images, batches) -> (state, {loss (K,), grad_norm (K,)}). The
    JAX package scans them inside one dispatch to save a link round trip
    per step; eager PyTorch has no such round trip, so this is a plain loop
    with the results of K single steps. With a ``mesh`` dimension 1 (the
    batch) is sharded."""
    step_fn = _resident_step_fn(cfg, tx, mesh)

    def multi_fn(state: TrainState, images: torch.Tensor, batches):
        batches = _local(batches, mesh, images.device, dim=1)
        k = len(next(iter(batches.values())))
        losses, gnorms = [], []
        for i in range(k):
            state, metrics = step_fn(state, images, {key: v[i] for key, v in batches.items()})
            losses.append(metrics["loss"])
            gnorms.append(metrics["grad_norm"])
        return state, {"loss": torch.stack(losses), "grad_norm": torch.stack(gnorms)}

    return multi_fn


def make_eval_step(cfg: OverlapNetConfig, mesh: Mesh | None = None):
    """Forward giving (overlap (B,), yaw peak (B,) float sub-bin positions)
    for the validation metrics of the reference epoch loop
    (training.py:352-416). The sub-bin parabolic peak replaces the raw
    argmax (same convention as serving, ops.correlation.subbin_peak). With a
    ``mesh`` each rank scores its block of the global batch (B divisible by
    the mesh size) and every rank gets all B results."""

    @torch.inference_mode()
    def eval_fn(model: OverlapNet, batch):
        device = next(model.parameters()).device
        b = _local({"x1": batch["x1"], "x2": batch["x2"]}, mesh, device)
        overlap_pred, orient_logits = model(b["x1"], b["x2"])
        overlap, peak = overlap_pred.reshape(-1), subbin_peak(orient_logits)
        if mesh is not None:  # (D, 2, B/D) in rank order -> (2, B)
            out = all_gather(mesh, torch.stack([overlap.float(), peak]))
            overlap, peak = out.transpose(0, 1).reshape(2, -1)
        return overlap, peak

    return eval_fn


@dataclasses.dataclass
class Trainer:
    """Epoch-driven trainer mirroring the reference loop: per-epoch training,
    checkpoint save, validation metrics (overlap mean/max/RMS; yaw RMS at
    overlap thresholds 0.3-0.9, reference training.py:336-420). Runs on
    ``device`` ("cuda" by default; raises if no card is visible), or
    data-parallel over ``mesh`` on its rank's device; then every rank passes
    the same global batches."""

    cfg: OverlapNetConfig
    steps_per_epoch: int
    device: str | torch.device | None = None
    # cap on dispatched steps the device has not finished: bounds the
    # memory held by queued batches without a host wait per step
    pipeline_depth: int = 32
    mesh: Mesh | None = None

    def __post_init__(self):
        if (
            self.cfg.train.rotate_adjust_yaw_labels
            and self.cfg.train.rotate_training_data > 0
            and self.cfg.model.yaw_space == "reference"
        ):
            raise ValueError(
                "rotate_adjust_yaw_labels=True requires yaw_space="
                "'calibrated' (shift-adjusted labels are contradictory "
                "supervision in the reference yaw space)"
            )
        self.device = device_of(self.device, self.mesh)
        self.state, self.tx = create_train_state(
            self.cfg, self.steps_per_epoch, self.cfg.train.seed, self.device)
        self.eval_step = make_eval_step(self.cfg, self.mesh)
        self._steps: dict[tuple[str, bool], Callable] = {}

    def _released_cfg(self) -> OverlapNetConfig:
        """Config copy with the correlation stop-gradient lifted (staged yaw
        training, TrainConfig.correlation_release_epoch)."""
        return dataclasses.replace(
            self.cfg,
            model=dataclasses.replace(self.cfg.model, correlation_stop_gradient=False),
        )

    def _release_active(self, epoch: int) -> bool:
        r = self.cfg.train.correlation_release_epoch
        return r >= 0 and epoch >= r and self.cfg.model.correlation_stop_gradient

    def _step_fn(self, kind: str, released: bool) -> Callable:
        """The step of ``kind`` ('host', 'resident', 'resident_multi') for
        the given release state, built once."""
        key = (kind, released)
        if key not in self._steps:
            make = {"host": make_train_step, "resident": make_resident_train_step,
                    "resident_multi": make_resident_multi_step}[kind]
            self._steps[key] = make(self._released_cfg() if released else self.cfg, self.tx,
                                    self.mesh)
        return self._steps[key]

    def run_epoch(self, batches, epoch: int = 0) -> dict:
        step = self._step_fn("host", self._release_active(epoch))
        return self._run_loop(batches, lambda b: step(self.state, b))

    def run_epoch_resident(
        self, resident, batch_size: int, epoch: int = 0, shuffle: bool = True
    ) -> dict:
        """Epoch over a data.dataset.ResidentPairs store: per-step host
        traffic is O(batch) integers; K = TrainConfig.steps_per_dispatch
        optimizer steps ride each call; images never leave the device."""
        k = max(1, self.cfg.train.steps_per_dispatch)
        released = self._release_active(epoch)
        single = self._step_fn("resident", released)
        multi = self._step_fn("resident_multi", released) if k > 1 else None

        def grouped():
            group = []
            for b in resident.batches(
                batch_size, epoch=epoch, shuffle=shuffle, drop_remainder=True
            ):
                if k == 1:
                    yield ("single", b)
                    continue
                group.append(b)
                if len(group) == k:
                    yield ("multi", {key: np.stack([g[key] for g in group]) for key in group[0]})
                    group = []
            for b in group:  # tail: single steps
                yield ("single", b)

        def step(item):
            kind, b = item
            fn = multi if kind == "multi" else single
            return fn(self.state, resident.images, b)

        return self._run_loop(grouped(), step)

    def _run_loop(self, batches, step) -> dict:
        """Drive steps from ``batches``; items may be plain batch dicts (one
        step each) or ("multi", stacked-dict) tuples whose leaves have a
        (K, B) leading shape (K steps). Losses stay on the device and are
        fetched once, at the end."""
        losses = []
        last_metrics = {}
        count = n_items = 0
        in_flight = collections.deque()
        t0 = time.perf_counter()
        for batch in batches:
            payload = batch[1] if isinstance(batch, tuple) else batch
            fused = isinstance(batch, tuple) and batch[0] == "multi"
            leaf = next(iter(payload.values()))
            n_items += int(np.prod(leaf.shape[:2]) if fused else leaf.shape[0])
            self.state, metrics = step(batch)
            losses.append(metrics["loss"])
            last_metrics = metrics
            count += 1
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
                in_flight.append(event)
                if len(in_flight) > self.pipeline_depth:
                    in_flight.popleft().synchronize()
        if count:
            flat = torch.cat([v.reshape(-1) for v in losses]).cpu().numpy()
            dt = time.perf_counter() - t0
            last_metrics = {k: v.reshape(-1)[-1].item() for k, v in last_metrics.items()}
            last_metrics.update(
                epoch_loss=float(flat.mean()),
                train_pairs_per_sec=n_items / dt,
                sec_per_dispatch=dt / count,
            )
        return {k: float(v) for k, v in last_metrics.items()}

    def evaluate(self, batches) -> dict:
        """Validation metrics over an iterable of eval batches (each with
        x1, x2, overlap, orientation host arrays). With a mesh, evaluation
        is sharded like training: a ragged batch is padded to a multiple of
        the mesh size and the results trimmed after."""
        pred_overlap, pred_yaw, true_overlap, true_yaw = [], [], [], []
        for batch in batches:
            x1, x2 = batch["x1"], batch["x2"]
            n = len(x1)
            if self.mesh is not None:
                x1, _ = pad_to_multiple(np.asarray(x1), self.mesh.size)
                x2, _ = pad_to_multiple(np.asarray(x2), self.mesh.size)
            ov, yaw = self.eval_step(self.state.model, {"x1": x1, "x2": x2})
            pred_overlap.append(ov[:n])
            pred_yaw.append(yaw[:n])
            true_overlap.append(np.asarray(batch["overlap"]))
            true_yaw.append(np.asarray(batch["orientation"]))
        pred_overlap = torch.cat(pred_overlap).float().cpu().numpy()
        pred_yaw = torch.cat(pred_yaw).float().cpu().numpy()
        true_overlap = np.concatenate(true_overlap)
        true_yaw = np.concatenate(true_yaw)

        # yaw metrics in physical degrees: predictions decode through the
        # model's yaw_space (sub-bin peak -> degrees), GT bins through the
        # reference npz convention. Circular wrap at 360 degrees.
        pred_deg = peak_to_degrees(pred_yaw, self.cfg.model).numpy()
        true_deg = ref_bins_to_degrees(true_yaw, self.cfg.model).numpy()
        metrics = overlap_metrics(pred_overlap, true_overlap)
        for thr in [0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]:
            m = yaw_metrics(pred_deg, true_deg, pred_overlap, 360, overlap_threshold=thr)
            if m:
                metrics[f"yaw_rms@{thr}"] = m["rms_error"]
        return metrics
