"""Weights between the JAX package's flat-key .npz and a torch state_dict.

The JAX package exports parameters as a flat-key .npz
(``params/legs/s_conv1/kernel``, ...; its train/checkpoint.py
``save_params_npz``). Layouts differ:

- conv kernels are HWIO there and OIHW here;
- ``overlap_output`` is a Dense with an (in, out) kernel applied after an
  NHWC flatten; here it is (out, in), and the head permutes its activation
  to NHWC before flattening so that the rows line up;
- biases and ``orientation_head/logit_scale`` (cosine mode only) carry over
  as they are.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_PREFIX = "params/"


def _to_torch(path: str, arr: np.ndarray) -> np.ndarray:
    if path.endswith("/kernel"):
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if arr.ndim == 2:
            return arr.T  # (in, out) -> (out, in)
        raise ValueError(f"unexpected kernel rank {arr.ndim} for {path}")
    return arr


def _to_jax(path: str, arr: np.ndarray) -> np.ndarray:
    if path.endswith("/kernel"):
        if arr.ndim == 4:
            return arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        if arr.ndim == 2:
            return arr.T
        raise ValueError(f"unexpected kernel rank {arr.ndim} for {path}")
    return arr


def params_from_jax(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat JAX keys -> ``OverlapNet`` state_dict (CPU tensors)."""
    out = {}
    for key, arr in flat.items():
        if not key.startswith(_PREFIX):
            raise KeyError(f"not a parameter key: {key!r}")
        path = key[len(_PREFIX):]
        name = path.replace("/kernel", "/weight").replace("/", ".")
        # a C-ordered copy; keeps 0-d arrays 0-d (logit_scale)
        out[name] = torch.from_numpy(np.array(_to_torch(path, np.asarray(arr)), order="C"))
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """``OverlapNet`` state_dict -> flat JAX keys (inverse of
    :func:`params_from_jax`)."""
    out = {}
    for name, t in state_dict.items():
        path = name.replace(".", "/")
        if path.endswith("/weight"):
            path = path[: -len("/weight")] + "/kernel"
        out[_PREFIX + path] = np.array(_to_jax(path, t.detach().cpu().numpy()), order="C")
    return out


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """Read a flat-key .npz export into a state_dict."""
    with np.load(path) as data:
        return params_from_jax({k: data[k] for k in data.files})

