"""Per-sequence packed image files (memory-mapped IO fast path), a copy of
the JAX package's ``data/pack.py`` with the port's imports: the file format
is the same, so either package opens a pack the other wrote.

The reference's generator issues one ``np.load`` per channel image per pair
per epoch (reference ImagePairOverlapOrientationSequence.py:142-207) — the
per-image disk I/O is one of its hot loops (SURVEY.md §3). A SequencePack
stores a whole sequence's assembled (H, W, C) inputs as one contiguous
``.npy`` plus a sidecar index, opened with ``mmap_mode='r'`` so batch
assembly is pure memcpy from page cache.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Sequence

import numpy as np

from overlapnet_torch.core.config import ChannelConfig


class SequencePack:
    """A memory-mapped (N, H, W, C) image pack for one sequence."""

    def __init__(self, data: np.ndarray, names: Sequence[str]):
        self._data = data
        self._names = list(names)
        self._index = {n: i for i, n in enumerate(self._names)}

    @property
    def names(self) -> list[str]:
        return self._names

    @property
    def data(self) -> np.ndarray:
        return self._data

    def __len__(self) -> int:
        return len(self._names)

    def image(self, name: str) -> np.ndarray:
        return np.asarray(self._data[self._index[name]])

    @staticmethod
    def pack_paths(out_dir: str, seq: str) -> tuple[str, str]:
        return (
            os.path.join(out_dir, f"{seq}.pack.npy"),
            os.path.join(out_dir, f"{seq}.pack.json"),
        )

    @classmethod
    def build(
        cls,
        image_root: str,
        seq: str,
        channels: ChannelConfig,
        out_dir: str,
        height: int = 64,
        width: int = 900,
    ) -> "SequencePack":
        """Assemble every scan of ``<image_root>/<seq>`` into one pack file."""
        from overlapnet_torch.data.dataset import assemble_scan_image

        kind0 = channels.channel_kinds()[0][0]
        scan_dir = os.path.join(image_root, seq, kind0)
        names = sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(scan_dir)
            if f.endswith((".npy", ".npz"))
        )
        os.makedirs(out_dir, exist_ok=True)
        data_path, index_path = cls.pack_paths(out_dir, seq)
        arr = np.lib.format.open_memmap(
            data_path,
            mode="w+",
            dtype=np.float32,
            shape=(len(names), height, width, channels.num_channels),
        )
        for i, name in enumerate(names):
            arr[i] = assemble_scan_image(
                image_root, seq, name, channels, height, width
            )
        arr.flush()
        with open(index_path, "w") as f:
            json.dump({"seq": seq, "names": names}, f)
        return cls(np.load(data_path, mmap_mode="r"), names)

    @classmethod
    def open(cls, out_dir: str, seq: str) -> "SequencePack":
        data_path, index_path = cls.pack_paths(out_dir, seq)
        with open(index_path) as f:
            meta = json.load(f)
        return cls(np.load(data_path, mmap_mode="r"), meta["names"])


def open_packs(pack_dir: str, seqs: Sequence[str]) -> Mapping[str, SequencePack]:
    """Open packs for each sequence that has one; missing packs are skipped
    (the dataset falls back to per-image loading for those)."""
    packs = {}
    for seq in seqs:
        data_path, index_path = SequencePack.pack_paths(pack_dir, seq)
        if os.path.exists(data_path) and os.path.exists(index_path):
            packs[seq] = SequencePack.open(pack_dir, seq)
    return packs
