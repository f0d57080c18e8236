"""Descriptor database: cached leg embeddings scored by the pairwise heads.

The store is a float32 (rows, W', C) tensor on the serving device that grows
by doubling up to ``capacity``. Scoring runs the heads on the device and
brings back only per-pair results: overlap, sub-bin yaw peak and yaw
confidence.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from overlapnet_torch.ops.correlation import subbin_peak, yaw_confidence

# Pairs per head call: bounds the c_conv1 output (B x 360 x 24 x 64 fp32,
# 566 MB at B = 256) however many candidates a query has.
MAX_PAIRS_PER_CALL = 256


class DescriptorDB:
    """Single-device descriptor DB.

    Args:
      head_apply: (fa, fb) -> (overlap (B, 1), orientation logits (B, W')),
        e.g. ``OverlapNet.score``.
      capacity: maximum number of stored embeddings.
      width, channels: embedding shape (reference: 360, 128).
      device: where the store lives and the heads run.
    """

    def __init__(
        self,
        head_apply: Callable,
        capacity: int = 8192,
        width: int = 360,
        channels: int = 128,
        device="cpu",
    ):
        self._head = head_apply
        self._capacity = capacity
        self.device = torch.device(device)
        self._fv = torch.zeros((0, width, channels), device=self.device)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    @property
    def feature_volumes(self) -> np.ndarray:
        return self._fv[: self._n].cpu().numpy()

    def _tensor(self, x) -> torch.Tensor:
        """A float32 tensor on the DB's device from an array or tensor."""
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _rows(self, idxs) -> torch.Tensor:
        """Row indices checked on the host against the live rows (an index
        out of range on the device would fault the card, not raise)."""
        idxs = np.asarray(idxs, np.int64)
        if idxs.size and (idxs.min() < 0 or idxs.max() >= self._n):
            raise IndexError(f"row index out of range for {self._n} rows")
        return torch.as_tensor(idxs, device=self.device)

    def _reserve(self, n: int) -> None:
        """Grow the store (doubling, capped at capacity) to hold n rows."""
        if n > self._capacity:
            raise ValueError(f"DescriptorDB capacity {self._capacity} exceeded")
        if n <= self._fv.shape[0]:
            return
        rows = min(self._capacity, max(n, 2 * self._fv.shape[0], 16))
        grown = torch.zeros((rows,) + self._fv.shape[1:], device=self.device)
        grown[: self._n] = self._fv[: self._n]
        self._fv = grown

    def add(self, fv) -> int:
        """Append one (W', C) or a batch (K, W', C) of embeddings; returns the
        first new index."""
        fv = self._tensor(fv)
        if fv.dim() == 2:
            fv = fv[None]
        k = fv.shape[0]
        self._reserve(self._n + k)
        self._fv[self._n : self._n + k] = fv
        first = self._n
        self._n += k
        return first

    def load(self, fv) -> int:
        """Replace the whole store with ``fv`` (N, W', C); returns N."""
        fv = self._tensor(fv)
        if fv.shape[0] > self._capacity:
            raise ValueError(
                f"bulk load of {fv.shape[0]} rows exceeds capacity "
                f"{self._capacity}"
            )
        if fv.shape[1:] != self._fv.shape[1:]:
            raise ValueError(
                f"embedding shape {tuple(fv.shape[1:])} does not match the DB's "
                f"(W', C) = {tuple(self._fv.shape[1:])} — was this cache built "
                "with a different input_width/model?"
            )
        self._n = 0
        self.add(fv)
        return self._n

    def save(self, path: str) -> None:
        """Persist the live embeddings to ``path`` (.npz), the format the JAX
        package's DescriptorDB writes and reads."""
        np.savez_compressed(path, feature_volumes=self.feature_volumes)

    def restore(self, path: str) -> int:
        """Load embeddings saved by :meth:`save`; returns the row count."""
        with np.load(path) as data:
            return self.load(data["feature_volumes"])

    @torch.inference_mode()
    def _score(self, fa: torch.Tensor, fb: torch.Tensor):
        """Heads on device tensors, in chunks of MAX_PAIRS_PER_CALL pairs;
        returns host (overlap, yaw_peak, yaw_confidence)."""
        outs = []
        for i in range(0, fa.shape[0], MAX_PAIRS_PER_CALL):
            overlap, logits = self._head(
                fa[i : i + MAX_PAIRS_PER_CALL], fb[i : i + MAX_PAIRS_PER_CALL]
            )
            outs.append(torch.stack(
                [overlap.reshape(-1), subbin_peak(logits), yaw_confidence(logits)]
            ))
        res = torch.cat(outs, dim=1).cpu().numpy()
        return res[0], res[1], res[2]

    def score_volumes(self, fa, fb) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Score explicit (n, W', C) left/right feature-volume batches;
        returns (overlap (n,), yaw_peak (n,) float sub-bin positions,
        yaw_confidence (n,))."""
        if len(fa) == 0:
            return (np.zeros(0, np.float32),) * 3
        return self._score(self._tensor(fa), self._tensor(fb))

    def score_pairs(self, idx1, idx2) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Score stored pairs; returns (overlap (n,), yaw_peak (n,) float
        sub-bin positions, yaw_confidence (n,))."""
        if len(idx1) == 0:
            return (np.zeros(0, np.float32),) * 3
        return self._score(self._fv[self._rows(idx1)], self._fv[self._rows(idx2)])

    def query(self, query_fv, candidate_idxs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Score one query embedding against stored candidates.

        Returns (overlaps (k,), yaw_peaks (k,), yaw_confidences (k,));
        candidates are the *left* input and the query the *right*, matching
        reference infer.infer_multiple (infer.py:186-190).
        """
        if len(candidate_idxs) == 0:
            return (np.zeros(0, np.float32),) * 3
        fa = self._fv[self._rows(candidate_idxs)]
        q = self._tensor(query_fv)
        return self._score(fa, q[None].expand_as(fa))
