"""Preprocessed channel images on disk -> one (H, W, C) scan image.

The disk contract of the reference (``<root>/<seq>/<kind>/<name>.npy``,
ImagePairOverlapOrientationSequence.py:142-207) and the JAX package's
``data/dataset.py``; only the two functions serving needs.
"""

from __future__ import annotations

import os

import numpy as np

from overlapnet_torch.core.config import ChannelConfig


def load_channel_image(
    image_root: str, seq_dir: str, kind: str, name: str
) -> np.ndarray:
    """Load one channel image ``<root>/<seq>/<kind>/<name>.npy`` (.npz
    fallback like the reference's probability/intensity paths)."""
    base = os.path.join(image_root, seq_dir, kind, name)
    if os.path.exists(base + ".npy"):
        return np.load(base + ".npy")
    return np.load(base + ".npz")["arr_0"]


def assemble_scan_image(
    image_root: str,
    seq_dir: str,
    name: str,
    channels: ChannelConfig,
    height: int,
    width: int,
) -> np.ndarray:
    """Stack the configured channels into one (H, W, C) float32 image, in the
    reference's channel order (depth, normal, probability, intensity)."""
    out = np.zeros((height, width, channels.num_channels), np.float32)
    c = 0
    for kind, nch in channels.channel_kinds():
        img = load_channel_image(image_root, seq_dir, kind, name)
        if img.ndim == 2:
            img = img[..., None]
        out[:, :, c : c + nch] = img[:height, :width, :nch]
        c += nch
    return out
