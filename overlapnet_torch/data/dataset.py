"""Host-side input pipeline: scan images from disk, pair-image batches for
training and evaluation, and the device-resident training store.

Re-design of the reference's keras Sequence generators (reference:
src/two_heads/ImagePairOverlapOrientationSequence.py:87-212), after the JAX
package's ``data/dataset.py``:

- the reference ``np.load``s every channel image from disk for every pair in
  every epoch; here scans are assembled once into an in-host-RAM cache (a
  KITTI sequence is ~1 GB at 64x900x4 fp32) or memory-mapped from a
  per-sequence pack file (``pack.py``), and pairs index into it; packed
  sides of a batch are gathered by the native library (``native.py``, the
  roll fused into the copy);
- batches are materialized by a background thread (double buffering) so the
  device does not wait on IO;
- the random right-image circular-shift augmentation (rotate_data 0/1/2,
  reference :42-53, 75-80, 209-212) is reproduced exactly, including the
  reference quirk that the yaw label is NOT adjusted for the shift;
- ``ResidentPairs`` keeps the deduplicated scans on the device, so a step
  ships only pair indices, shifts and labels;
- ``FeatureVolumePairs`` batches pairs of leg embeddings that stay on the
  device (evaluation scores every pair on cached embeddings).
"""

from __future__ import annotations

import os
import queue
import random
import threading
from typing import TYPE_CHECKING, Iterator, Mapping

import numpy as np
import torch

from overlapnet_torch.core.config import ChannelConfig
from overlapnet_torch.core.device import resolve_device
from overlapnet_torch.data import native
from overlapnet_torch.data.gt_files import PairList
from overlapnet_torch.parallel.mesh import all_gather, device_of

if TYPE_CHECKING:
    from overlapnet_torch.data.pack import SequencePack


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


def epoch_order(n: int, epoch: int, shuffle: bool, mesh=None) -> np.ndarray:
    """Pair order of an epoch. The seed is the JAX package's expression, so
    both packages shuffle alike inside one process; Python salts ``hash`` of
    a tuple holding a str per process, so the order is not reproducible
    across processes unless PYTHONHASHSEED is set. On a ``mesh`` every rank
    takes rank 0's seed (one gather per shuffled epoch, which waits for it),
    so the ranks draw the same global batches whatever their salts."""
    order = np.arange(n)
    if shuffle:
        seed = hash(("epoch", epoch)) % (2**32)
        if mesh is not None and mesh.group is not None:
            seed = int(all_gather(mesh, torch.tensor(seed, device=mesh.device))[0])
        np.random.default_rng(seed).shuffle(order)
    return order


def batch_starts(n: int, batch_size: int, drop_remainder: bool,
                 max_batches: int | None) -> list[int]:
    starts = list(range(0, n, batch_size))
    if drop_remainder:
        starts = [s for s in starts if s + batch_size <= n]
    return starts if max_batches is None else starts[:max_batches]


class _ScanCache:
    """Thread-safe cache of assembled (H, W, C) scan images keyed by
    (seq_dir, name); backed by per-image files or a pack memmap (whose rows
    come back as read-only views)."""

    def __init__(self, image_root, channels, height, width, packs=None):
        self._root = image_root
        self._channels = channels
        self._h, self._w = height, width
        self._packs = packs or {}
        self._cache: dict[tuple[str, str], np.ndarray] = {}
        self._lock = threading.Lock()

    def get(self, seq_dir: str, name: str) -> np.ndarray:
        key = (seq_dir, name)
        with self._lock:
            img = self._cache.get(key)
        if img is not None:
            return img
        if seq_dir in self._packs:
            img = self._packs[seq_dir].image(name)
        else:
            img = assemble_scan_image(self._root, seq_dir, name, self._channels, self._h, self._w)
        with self._lock:
            self._cache[key] = img
        return img


class PairImageDataset:
    """Batches of (x1, x2, overlap, orientation) for a list of scan pairs.

    Args mirror the reference generator's (ImagePairOverlapOrientation
    Sequence.py:17-55); ``orientation`` stays an integer yaw-bin per pair
    (the trainer builds the target vector on the device, train/losses.py).
    ``packs`` maps a sequence directory to its ``SequencePack``: scans of
    those sequences are read from the pack, and a batch's packed sides are
    gathered by ``native.gather_batch``.
    """

    def __init__(
        self,
        image_root: str,
        pairs: PairList,
        channels: ChannelConfig,
        height: int = 64,
        width: int = 900,
        rotate_data: int = 0,
        seed: int = 1234,
        packs: Mapping[str, SequencePack] | None = None,
        adjust_yaw_labels: bool = False,
        leg_output_width: int = 360,
    ):
        self.pairs = pairs
        self.width = width
        self.rotate_data = rotate_data
        # Reference quirk: rotate_data rolls the right image but leaves the
        # yaw label untouched, so the aug only serves overlap robustness.
        # adjust_yaw_labels=True moves the label by -round(shift * W'/W)
        # leg-output bins (rolling fb by +s' shifts the circular-correlation
        # peak to argmax - s'), turning the same aug into yaw training signal.
        self.adjust_yaw_labels = adjust_yaw_labels
        self.leg_output_width = leg_output_width
        self._packs = packs or {}
        self._cache = _ScanCache(image_root, channels, height, width, packs)
        self._rng = random.Random(seed)
        self._shifts = self._draw_shifts()

        # pack row of each pair side (-1: not packed)
        def rows(dirs, names):
            out = np.full(len(names), -1, np.int64)
            for i, (d, n) in enumerate(zip(dirs, names)):
                pack = self._packs.get(d)
                if pack is not None and n in pack._index:
                    out[i] = pack._index[n]
            return out

        self._rows1 = rows(pairs.dir1, pairs.imgf1)
        self._rows2 = rows(pairs.dir2, pairs.imgf2) if pairs.imgf2 else np.zeros(0, np.int64)

    def _draw_shifts(self) -> np.ndarray:
        # randint(0, width) inclusive, like the reference (:51-53).
        return np.array(
            [self._rng.randint(0, self.width) for _ in range(len(self.pairs))]
        )

    def __len__(self) -> int:
        return len(self.pairs)

    def _adjusted_orientation(self, idx: np.ndarray) -> np.ndarray:
        """Yaw labels for pair indices ``idx``, shift-corrected when
        ``adjust_yaw_labels`` is on (leg-output-bin space, see __init__)."""
        ori = np.asarray(self.pairs.orientation[idx], np.int32)
        if self.rotate_data > 0 and self.adjust_yaw_labels:
            wp = self.leg_output_width
            s_bins = np.round(self._shifts[idx] * (wp / self.width)).astype(np.int32)
            ori = np.mod(ori - s_bins, wp).astype(np.int32)
        return ori

    def _gather_side(self, idx, dirs, names, pack_rows, shifts) -> np.ndarray:
        """One side of a batch, a fresh array: packed scans through the
        native gather (roll fused), one call per sequence; the rest through
        the scan cache."""
        out = None
        packed = pack_rows[idx] >= 0
        by_seq: dict[str, list[int]] = {}
        for k, i in enumerate(idx):
            if packed[k]:
                by_seq.setdefault(dirs[i], []).append(k)
        for seq, ks in by_seq.items():
            sh = shifts[idx[ks]] if shifts is not None else None
            got = native.gather_batch(self._packs[seq].data, pack_rows[idx[ks]], sh)
            if out is None:
                out = np.empty((len(idx),) + got.shape[1:], np.float32)
            out[ks] = got
        for k, i in enumerate(idx):
            if packed[k]:
                continue
            img = self._cache.get(dirs[i], names[i])
            if shifts is not None:
                img = np.roll(img, int(shifts[i]), axis=1)
            if out is None:
                out = np.empty((len(idx),) + img.shape, np.float32)
            out[k] = img
        return out

    def batches(
        self,
        batch_size: int,
        epoch: int = 0,
        shuffle: bool = False,
        drop_remainder: bool = False,
        prefetch: int = 2,
        max_batches: int | None = None,
        input_dtype: str = "float32",
        mesh=None,
    ) -> Iterator[dict]:
        """Yield batch dicts {x1, x2, overlap, orientation} (host numpy),
        assembled by a background thread.

        ``input_dtype='bfloat16'`` casts the image tensors on the host,
        which halves the host-to-device copy at about 3 significant digits
        of range precision; numpy has no bfloat16, so x1 and x2 are then
        ``torch.bfloat16`` CPU tensors. With a ``mesh`` every rank gets the
        same global batches (``epoch_order``)."""
        if input_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"input_dtype {input_dtype!r} (float32|bfloat16)")
        if self.rotate_data == 2 and epoch > 0:
            self._shifts = self._draw_shifts()
        order = epoch_order(len(self.pairs), epoch, shuffle, mesh)
        starts = batch_starts(len(order), batch_size, drop_remainder, max_batches)

        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def make_batch(start: int) -> dict:
            idx = order[start : start + batch_size]
            p = self.pairs
            shifts = self._shifts if self.rotate_data > 0 else None
            x1 = self._gather_side(idx, p.dir1, p.imgf1, self._rows1, None)
            x2 = self._gather_side(idx, p.dir2, p.imgf2, self._rows2, shifts)
            if input_dtype == "bfloat16":
                x1 = torch.from_numpy(x1).to(torch.bfloat16)
                x2 = torch.from_numpy(x2).to(torch.bfloat16)
            return {
                "x1": x1,
                "x2": x2,
                "overlap": np.asarray(p.overlap[idx], np.float32),
                "orientation": self._adjusted_orientation(idx),
            }

        def worker():
            try:
                for s in starts:
                    if stop.is_set():
                        return
                    q.put(make_batch(s))
                q.put(None)
            except Exception as e:  # handed to the consumer, which re-raises
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            # Drain so the worker's blocked put() can observe the stop flag.
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


class ResidentPairs:
    """Device-resident training store (no reference counterpart).

    The host pipeline ships two full images per pair per step. Here the
    deduplicated scan images are put on the device ONCE, as one
    (N, H, W, C) tensor in float32 or bfloat16, and each step ships only
    integer pair indices, rotation shifts and labels. Pair gathers and the
    rotate_data circular-shift augmentation happen on the device inside the
    train step (trainer.make_resident_train_step).

    Augmentation/shuffle semantics match PairImageDataset exactly (same
    shift draws, same epoch shuffle streams), so the two paths are
    interchangeable. ``device`` is "cuda" by default and raises if no card
    is visible. With a ``mesh`` the store is replicated on every rank's
    device; every rank draws the same global index batches (same seed, same
    shifts) and the train step takes the rank's block of them.
    """

    def __init__(self, ds: PairImageDataset, device=None, input_dtype: str = "float32",
                 mesh=None):
        if input_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"input_dtype {input_dtype!r} (float32|bfloat16)")
        device = device_of(device, mesh)
        self._ds = ds
        self._mesh = mesh
        scans, self.idx1, self.idx2 = unique_scans(ds.pairs)
        imgs = torch.from_numpy(np.stack([ds._cache.get(d, n) for d, n in scans]))
        if input_dtype == "bfloat16":
            imgs = imgs.to(torch.bfloat16)
        self.images = imgs.to(device)
        self.n_scans = imgs.shape[0]

    def __len__(self) -> int:
        return len(self._ds.pairs)

    def batches(
        self,
        batch_size: int,
        epoch: int = 0,
        shuffle: bool = False,
        drop_remainder: bool = False,
        max_batches: int | None = None,
    ) -> Iterator[dict]:
        """Yield index batches {i1, i2, shift, overlap, orientation} (host
        numpy, tiny). Shift semantics = PairImageDataset: right image
        np.roll(+shift) when rotate_data > 0, else shift 0."""
        ds = self._ds
        if ds.rotate_data == 2 and epoch > 0:
            ds._shifts = ds._draw_shifts()
        order = epoch_order(len(ds.pairs), epoch, shuffle, self._mesh)
        p = ds.pairs
        shifts = ds._shifts if ds.rotate_data > 0 else np.zeros(len(p), np.int32)
        for s in batch_starts(len(order), batch_size, drop_remainder, max_batches):
            idx = order[s : s + batch_size]
            yield {
                "i1": np.asarray(self.idx1[idx], np.int32),
                "i2": np.asarray(self.idx2[idx], np.int32),
                "shift": np.asarray(shifts[idx], np.int32),
                "overlap": np.asarray(p.overlap[idx], np.float32),
                "orientation": ds._adjusted_orientation(idx),
            }


class FeatureVolumePairs:
    """Pair batches over precomputed leg feature volumes — the descriptor-
    reuse path of evaluation (reference
    ImagePairOverlapSequenceFeatureVolume.py:9-47).

    The volumes and the pair indices live on ``device`` ("cuda" by default;
    raises if no card is visible), so a batch's rows are gathered there and
    nothing but the labels crosses to or from the host. ``feature_volumes``
    is a numpy array or a tensor (moved only if it lies elsewhere); batches
    yield {fa, fb} (B, W', C) tensors on the device and, when given, overlap
    and orientation as host arrays.
    """

    def __init__(
        self,
        feature_volumes,  # (N, W', C)
        idx1: np.ndarray,
        idx2: np.ndarray,
        overlap: np.ndarray | None = None,
        orientation: np.ndarray | None = None,
        device="cuda",
    ):
        device = resolve_device(device)
        self.fv = torch.as_tensor(feature_volumes, device=device)
        self.idx1 = torch.as_tensor(np.asarray(idx1, np.int64), device=device)
        self.idx2 = torch.as_tensor(np.asarray(idx2, np.int64), device=device)
        self.overlap = overlap
        self.orientation = orientation

    def __len__(self) -> int:
        return len(self.idx1)

    def batches(self, batch_size: int) -> Iterator[dict]:
        for s in range(0, len(self), batch_size):
            sl = slice(s, s + batch_size)
            batch = {
                "fa": self.fv[self.idx1[sl]],
                "fb": self.fv[self.idx2[sl]],
            }
            if self.overlap is not None:
                batch["overlap"] = np.asarray(self.overlap[sl], np.float32)
            if self.orientation is not None:
                batch["orientation"] = np.asarray(self.orientation[sl], np.int32)
            yield batch


def unique_scans(pairs: PairList) -> tuple[list[tuple[str, str]], np.ndarray, np.ndarray]:
    """Deduplicate the scans referenced by a pair list.

    Returns (scans, idx1, idx2): ``scans`` is the sorted unique list of
    (seq_dir, name); idx1/idx2 map each pair's left/right scan into it (the
    argsort/searchsorted indexing of reference testing.py:237-248), so each
    scan is stored exactly once.
    """
    keys = sorted(
        set(zip(pairs.dir1, pairs.imgf1)) | set(zip(pairs.dir2, pairs.imgf2))
    )
    lookup = {k: i for i, k in enumerate(keys)}
    idx1 = np.array([lookup[k] for k in zip(pairs.dir1, pairs.imgf1)], np.int64)
    idx2 = np.array([lookup[k] for k in zip(pairs.dir2, pairs.imgf2)], np.int64)
    return keys, idx1, idx2
