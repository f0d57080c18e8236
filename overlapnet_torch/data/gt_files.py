"""Ground-truth pair-file (.npz) schema I/O.

Schema parity with the reference (reference: src/two_heads/
overlap_orientation_npz_file2string_string_nparray.py:8-76,
demo/demo4_gen_gt_files.py:96-109):

- new format: key ``overlaps`` (n, 4) float [f1_idx, f2_idx, overlap, yaw_bin]
  and key ``seq`` (n, 2) str sequence directory names;
- old format: a single unnamed (n, 4) array, sequence dirs empty.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class PairList:
    """A list of scan pairs with ground truth, in loader order.

    ``imgf1/imgf2`` are '%06d'-formatted scan ids; ``dir1/dir2`` the sequence
    directory names ('' for old-format files) — together they address
    ``<root>/<dir>/<kind>/<imgf>.npy`` images.
    """

    imgf1: list[str]
    imgf2: list[str]
    dir1: list[str]
    dir2: list[str]
    overlap: np.ndarray  # (n,)
    orientation: np.ndarray  # (n,) yaw bin indices (float in the files)

    def __len__(self) -> int:
        return len(self.imgf1)

    def __getitem__(self, sel) -> "PairList":
        idx = np.asarray(sel)
        take = lambda xs: [xs[i] for i in idx]
        return PairList(
            take(self.imgf1), take(self.imgf2), take(self.dir1), take(self.dir2),
            self.overlap[idx], self.orientation[idx],
        )

    def shuffled(self, rng: np.random.Generator) -> "PairList":
        return self[rng.permutation(len(self))]


def load_gt_pairs(
    npz_paths: Sequence[str],
    shuffle: bool = True,
    rng: np.random.Generator | None = None,
) -> PairList:
    """Load and concatenate GT pair files (both formats); optional per-file
    shuffle like the reference loader."""
    if rng is None:
        rng = np.random.default_rng(0)
    parts: list[PairList] = []
    for path in npz_paths:
        h = np.load(path, allow_pickle=True)
        if len(h.files) == 1:
            arr = h[h.files[0]]
            n = arr.shape[0]
            part = PairList(
                np.char.mod("%06d", arr[:, 0].astype(np.int64)).tolist(),
                np.char.mod("%06d", arr[:, 1].astype(np.int64)).tolist(),
                [""] * n,
                [""] * n,
                arr[:, 2].astype(np.float64),
                arr[:, 3].astype(np.float64),
            )
        else:
            arr = h["overlaps"]
            seq = h["seq"]
            part = PairList(
                np.char.mod("%06d", arr[:, 0].astype(np.int64)).tolist(),
                np.char.mod("%06d", arr[:, 1].astype(np.int64)).tolist(),
                [str(s) for s in seq[:, 0]],
                [str(s) for s in seq[:, 1]],
                arr[:, 2].astype(np.float64),
                arr[:, 3].astype(np.float64),
            )
        if shuffle:
            part = part.shuffled(rng)
        parts.append(part)

    return PairList(
        sum((p.imgf1 for p in parts), []),
        sum((p.imgf2 for p in parts), []),
        sum((p.dir1 for p in parts), []),
        sum((p.dir2 for p in parts), []),
        np.concatenate([p.overlap for p in parts]) if parts else np.zeros(0),
        np.concatenate([p.orientation for p in parts]) if parts else np.zeros(0),
    )


def save_gt_files(
    out_dir: str,
    seq: str,
    ground_truth: np.ndarray,
    train_set: np.ndarray,
    validation_set: np.ndarray,
) -> dict[str, str]:
    """Write the three demo4-style npz files (reference
    demo4_gen_gt_files.py:96-109): ``train_set.npz``, ``validation_set.npz``,
    ``ground_truth_overlap_yaw.npz`` — each new-format with 'overlaps' (n, 4)
    and 'seq' (n, 2)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, arr in [
        ("train_set", train_set),
        ("validation_set", validation_set),
        ("ground_truth_overlap_yaw", ground_truth),
    ]:
        seqs = np.asarray([[seq, seq]] * len(arr), dtype=str).reshape(len(arr), 2)
        path = os.path.join(out_dir, f"{name}.npz")
        np.savez_compressed(path, overlaps=np.asarray(arr, dtype=np.float64), seq=seqs)
        paths[name] = path
    return paths
