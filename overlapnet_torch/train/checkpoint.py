"""Checkpoint save/restore.

The reference saves a full keras HDF5 model once per epoch, overwriting in
place, with no optimizer state or step counter (reference training.py:346-349).
Here a checkpoint is one ``step_<step>.pt`` file (``torch.save`` of the
parameters, the optimizer state and the step count, all on the CPU) in a
directory that keeps the last ``max_to_keep`` steps. The JAX package's orbax
directories are another format and are not read here; parameters cross
between the packages as the flat-key .npz of ``save_params_npz`` /
``load_params_npz``, which both packages write and read.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Mapping

import numpy as np
import torch

from overlapnet_torch.train.trainer import TrainState
from overlapnet_torch.weights import load_npz, params_to_jax

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir) if (m := _STEP_FILE.match(f)))


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(ckpt_dir: str, state: TrainState, max_to_keep: int = 3) -> int:
    """Save the train state at its current step; returns the step saved."""
    os.makedirs(ckpt_dir, exist_ok=True)
    step = int(state.step)
    payload = {"step": step, "params": _to_cpu(state.params),
               "opt_state": _to_cpu(state.opt_state)}
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=ckpt_dir)
    os.close(fd)
    try:
        torch.save(payload, tmp)
        os.replace(tmp, _path(ckpt_dir, step))  # a reader sees all or nothing
    except BaseException:
        os.unlink(tmp)
        raise
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.unlink(_path(ckpt_dir, old))
    return step


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str, step: int | None = None) -> dict:
    """The saved {step, params, opt_state} (CPU tensors) of ``step``, the
    latest by default."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"No checkpoint found in {ckpt_dir}")
    return torch.load(_path(ckpt_dir, step), map_location="cpu", weights_only=True)


def restore_checkpoint(
    ckpt_dir: str, target: TrainState, step: int | None = None
) -> TrainState:
    """Restore a train state (latest step by default) into ``target``: its
    model, optimizer state and step are overwritten in place, on the
    target's device."""
    saved = load_checkpoint(ckpt_dir, step)
    target.model.load_state_dict(saved["params"])
    device = next(target.model.parameters()).device
    if saved["opt_state"].keys() != target.opt_state.keys():
        raise ValueError(
            f"checkpoint optimizer state {sorted(saved['opt_state'])} does not fit "
            f"the trainer's {sorted(target.opt_state)}"
        )
    for slot, value in saved["opt_state"].items():
        if not isinstance(value, Mapping):
            target.opt_state[slot] = value
            continue
        if value.keys() != target.opt_state[slot].keys():
            raise ValueError(f"checkpoint {slot} covers other parameters than the trainer's")
        for name, t in value.items():
            target.opt_state[slot][name].copy_(t.to(device))
    target.step = int(saved["step"])
    return target


def save_params_npz(path: str, params: Mapping[str, torch.Tensor]) -> None:
    """Flat-key .npz export of a state_dict in the JAX package's key names
    and layouts: its ``load_params_npz`` reads the file."""
    np.savez(path, **params_to_jax(params))


def load_params_npz(
    path: str, target: Mapping[str, torch.Tensor] | None = None
) -> dict[str, torch.Tensor]:
    """Load a flat-key .npz export (written by either package) as a
    state_dict; with ``target``, names and shapes must fit it."""
    loaded = load_npz(path)
    if target is not None:
        if loaded.keys() != target.keys():
            raise ValueError(
                f"{path}: parameters {sorted(loaded.keys() ^ target.keys())} do not fit")
        for name, t in target.items():
            if loaded[name].shape != t.shape:
                raise ValueError(
                    f"Shape mismatch for {name}: {tuple(loaded[name].shape)} vs {tuple(t.shape)}")
            loaded[name] = loaded[name].to(t.dtype)
    return loaded
