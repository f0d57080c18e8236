"""Import reference Keras HDF5 weights (model_geo.weight) by layer name.

The reference's de-facto checkpoint schema is layer-name keyed HDF5
(reference: training.py:349 saves the full model; infer.py:117-122 and
testing.py:201-204 load with by_name=True). Layer names: legs
``s_conv1..s_conv10`` (+ ``s_conv3a``), overlap head ``c_conv1..c_conv3`` +
``overlap_output``; the orientation head has no parameters
(generateNet.py:161-217, 96-114, 327-354).

Keras Conv2D kernels are HWIO and Dense kernels (in, out); the port's are
OIHW and (out, in), so the import is a name-mapped copy through the layout
conversion of ``weights.py``:

  keras s_convN/kernel:0  -> legs.s_convN.weight
  keras c_conv1/kernel:0  -> overlap_head.c_conv1.weight
  keras overlap_output/...-> overlap_head.overlap_output.{weight,bias}

Supports both ``model.save()`` files (weights under the ``model_weights``
group) and ``save_weights()`` files (layer groups at the root).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from overlapnet_torch.weights import params_from_jax


def _weight_group(f):
    return f["model_weights"] if "model_weights" in f else f


def read_keras_weights(path: str) -> dict[str, np.ndarray]:
    """Flatten a Keras HDF5 weight file into {layer/varname: array}."""
    import h5py

    out: dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        g = _weight_group(f)
        layer_names = [
            n.decode() if isinstance(n, bytes) else str(n)
            for n in g.attrs.get("layer_names", list(g.keys()))
        ]
        for layer in layer_names:
            if layer not in g:
                continue
            lg = g[layer]
            weight_names = [
                n.decode() if isinstance(n, bytes) else str(n)
                for n in lg.attrs.get("weight_names", [])
            ]
            if not weight_names:  # fall back to walking the group
                def visit(name, obj):
                    if hasattr(obj, "shape"):
                        weight_names.append(name)

                lg.visititems(visit)
            for wn in weight_names:
                key = wn.rsplit(":", 1)[0]  # strip ':0'
                arr = np.asarray(lg[wn])
                out[key if "/" in key else f"{layer}/{key}"] = arr
    return out


def _var_key(name: str) -> str:
    """Map keras variable names to 'kernel' / 'bias'."""
    if name in ("kernel", "bias"):
        return name
    if "kernel" in name.lower() or name == "W":
        return "kernel"
    if "bias" in name.lower() or name == "b":
        return "bias"
    return name


def import_keras_weights(
    path: str, params: Mapping[str, torch.Tensor], strict: bool = True
) -> dict[str, torch.Tensor]:
    """Load reference Keras weights into a state_dict of the siamese model.
    Returns a new state_dict; unmatched model parameters stay at their
    current values (like keras by_name loading).

    Args:
      path: HDF5 weight file (model.save or save_weights format).
      params: target state_dict from ``models.init_params``.
      strict: if True, raise when a matched layer's shapes disagree.
    """
    # keras "layer/var" -> loaded array, keyed on last two path components
    by_layer_var: dict[tuple[str, str], np.ndarray] = {}
    for key, arr in read_keras_weights(path).items():
        parts = key.split("/")
        layer, var = parts[-2] if len(parts) >= 2 else parts[0], parts[-1]
        by_layer_var[(layer, _var_key(var))] = arr

    out, matched = dict(params), []
    for name, current in params.items():
        parts = name.split(".")
        layer, var = parts[-2], "kernel" if parts[-1] == "weight" else parts[-1]
        arr = by_layer_var.get((layer, var))
        if arr is None:
            continue
        key = "params/" + "/".join(parts[:-1] + [var])
        converted = params_from_jax({key: arr})[name] if arr.ndim in (0, 1, 2, 4) else None
        if converted is None or converted.shape != current.shape:
            if strict:
                raise ValueError(
                    f"Shape mismatch for {layer}/{var}: file {arr.shape} vs model "
                    f"{tuple(current.shape)} (OIHW / (out, in))"
                )
            continue
        matched.append(f"{layer}/{var}")
        out[name] = converted.to(dtype=current.dtype, device=current.device)
    if strict and not matched:
        raise ValueError(f"No layers of {path} matched the model")
    return out
