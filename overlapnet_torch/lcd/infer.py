"""Inference engine / serving API on one device.

API-parity re-design of the reference ``Infer`` class (reference
src/two_heads/infer.py:22-265): leg/head factorization with an incremental
embedding cache, the three entry points (``infer_one``, ``infer_multiple``,
``infer_multiple_vs_multiple``), ``create_feature_volumes``, ``query_best``
and the synchronous ``dispatch_frame``. The embedding cache is a
``DescriptorDB`` on the serving device. Weights load from the flat-key .npz
export (``weights.py``).
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np
import torch

from overlapnet_torch.core.config import OverlapNetConfig
from overlapnet_torch.data.dataset import assemble_scan_image
from overlapnet_torch.lcd.descriptor_db import DescriptorDB
from overlapnet_torch.models import build_model, leg_output_width
from overlapnet_torch.ops.yaw import peak_to_degrees
from overlapnet_torch.weights import load_npz

# Scans per leg call in create_feature_volumes.
MAX_SCANS_PER_CALL = 64


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when no card is visible
    (the port never moves a CUDA request to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Infer was asked for a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


class PendingFrame:
    """Result of :meth:`Infer.dispatch_frame`. Off a mesh the frame is
    scored synchronously, so :attr:`result` is already resolved:
    (match_frame_id, overlap, yaw_deg, confidence) or None."""

    def __init__(self, frame_id: int, result):
        self.frame_id = frame_id
        self.result = result


class Infer:
    """Overlap + yaw inference between LiDAR scans.

    Args:
      cfg: full framework config. Scan inputs are read as preprocessed
        channel images from ``cfg.data.data_root_folder/cfg.data.infer_seqs``
        (same disk contract as the reference, infer.py:143-148).
      params: optional ``OverlapNet`` state_dict; otherwise loaded from
        ``cfg.experiment.pretrained_weightsfilename`` (a flat-key .npz), or a
        seeded fresh init when that names no file.
      db_capacity: maximum number of cached embeddings.
      device: where the model and the embedding cache live ("cuda" by
        default; raises if no card is visible).
    """

    def __init__(
        self,
        cfg: OverlapNetConfig,
        params: Mapping[str, torch.Tensor] | None = None,
        db_capacity: int = 8192,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_size = leg_output_width(cfg.model)
        self.model = build_model(cfg.model, cfg.num_input_channels)
        self.model.load_state_dict(params if params is not None else self._load_params())
        self.model.to(self.device).eval()
        self._db = DescriptorDB(
            self.model.score, capacity=db_capacity, width=self.output_size,
            channels=self.model.legs.out_channels, device=self.device,
        )
        # frame-id -> db row; infer_multiple appends one embedding per call
        # so ids stay aligned like the reference's list (infer.py:184-185).
        self._frame_rows: dict[int, int] = {}
        self._row_frames: dict[int, int] = {}

    # -- weights ---------------------------------------------------------

    def _load_params(self) -> Mapping[str, torch.Tensor]:
        path = self.cfg.experiment.pretrained_weightsfilename
        if path:
            if path.endswith(".npz") and os.path.exists(path):
                return load_npz(path)
            if os.path.isfile(path) and path.endswith((".weight", ".h5", ".hdf5")):
                raise NotImplementedError(
                    f"{path}: Keras HDF5 weights load in the port's training "
                    "slice (not yet ported); export them to a flat-key .npz "
                    "with the JAX package first"
                )
            if os.path.isdir(path):
                raise NotImplementedError(
                    f"{path}: checkpoint directories load in the port's "
                    "training slice (not yet ported); export the params to a "
                    "flat-key .npz with the JAX package first"
                )
        print("Pre-trained weights was not found in:", path)
        return self.model.state_dict()  # the seeded init of build_model

    # -- feature volumes -------------------------------------------------

    @property
    def feature_volumes(self) -> np.ndarray:
        return self._db.feature_volumes

    def _load_image(self, name: str) -> np.ndarray:
        return assemble_scan_image(
            self.cfg.data.data_root_folder,
            self.cfg.data.infer_seqs,
            os.path.basename(name).replace(".bin", ""),
            self.cfg.channels,
            self.cfg.model.input_height,
            self.cfg.model.input_width,
        )

    @torch.inference_mode()
    def create_feature_volumes(self, filenames: Sequence[str]) -> np.ndarray:
        """Leg embeddings for named scans of the infer sequence
        (reference infer.py:240-265). Names without extension, e.g. '000000'.
        """
        imgs = np.stack([self._load_image(n) for n in filenames])
        out = []
        for i in range(0, len(imgs), MAX_SCANS_PER_CALL):
            x = torch.from_numpy(imgs[i : i + MAX_SCANS_PER_CALL]).to(self.device)
            out.append(self.model.encode(x).cpu())
        return torch.cat(out).numpy()

    # -- the reference entry points --------------------------------------

    def _yaw_degrees(self, yaw_peaks) -> np.ndarray:
        # Decode sub-bin correlation peaks through the model's yaw_space
        # (ops/yaw.py): 'reference' reproduces yaw = 180 - argmax
        # (infer.py:158); 'calibrated' (default) divides by the measured
        # bins-per-degree factor.
        return peak_to_degrees(yaw_peaks, self.cfg.model).numpy()

    def infer_one(self, filepath1: str, filepath2: str):
        """Overlap and yaw for one scan pair; returns (overlap, yaw_deg)
        with the reference's left/right convention (file2 is the left leg,
        infer.py:140-158)."""
        fv = self.create_feature_volumes([filepath2, filepath1])
        overlap, yaw_peaks, _ = self._db.score_volumes(fv[[0]], fv[[1]])
        return overlap[0], self._yaw_degrees(yaw_peaks)

    def add_embedding(self, frame_id: int, fv) -> int:
        """Insert a precomputed (W', C) embedding for ``frame_id`` into the
        map store (frame-id <-> row mapping maintained); returns the row."""
        row = self._db.add(fv)
        self._frame_rows[int(frame_id)] = row
        self._row_frames[row] = int(frame_id)
        return row

    def _embed_and_add(self, current_frame_id: int, fv=None):
        """Embed the current frame (unless ``fv`` is given), append it to
        the map store, and record the frame-id <-> row mapping; returns the
        embedding."""
        if fv is None:
            fv = self.create_feature_volumes([str(current_frame_id).zfill(6)])[0]
        self.add_embedding(current_frame_id, fv)
        return fv

    def _rows_of(self, frame_ids: Sequence[int]) -> np.ndarray:
        return np.array([self._frame_rows[int(f)] for f in frame_ids], np.int64)

    def infer_multiple(
        self, current_frame_id: int, reference_frame_id: Sequence[int], fv=None
    ):
        """Current frame versus already-seen frames (the LCD hot path,
        reference infer.py:162-203). Computes and caches the current frame's
        embedding; returns (overlaps, yaws, yaw_confidences) or None if no
        references."""
        fv = self._embed_and_add(current_frame_id, fv)
        if len(reference_frame_id) == 0:
            return None
        overlaps, yaw_peaks, confs = self._db.query(
            fv, self._rows_of(reference_frame_id)
        )
        return overlaps, self._yaw_degrees(yaw_peaks), confs

    def query_best(
        self, current_frame_id: int, candidate_frame_ids: Sequence[int], fv=None
    ):
        """Embed + cache the current frame, then return the best candidate
        as (match_frame_id, overlap, yaw_deg, confidence), or None when
        there are no candidates."""
        fv = self._embed_and_add(current_frame_id, fv)
        if len(candidate_frame_ids) == 0:
            return None
        rows = self._rows_of(candidate_frame_ids)
        overlaps, yaw_peaks, confs = self._db.query(fv, rows)
        b = int(np.argmax(overlaps))
        return (
            self._row_frames[int(rows[b])],
            float(overlaps[b]),
            float(self._yaw_degrees(yaw_peaks[b])),
            float(confs[b]),
        )

    def dispatch_frame(
        self, current_frame_id: int, candidate_frame_ids: Sequence[int],
        image: np.ndarray | None = None, fv=None,
    ) -> PendingFrame:
        """One serving frame: embed, insert, score against the candidates
        (:meth:`query_best`). ``image`` is used when given instead of the
        frame's image on disk. The result comes back resolved."""
        if fv is None and image is not None:
            with torch.inference_mode():
                x = torch.as_tensor(image, dtype=torch.float32, device=self.device)
                fv = self.model.encode(x[None])[0]
        result = self.query_best(current_frame_id, candidate_frame_ids, fv=fv)
        return PendingFrame(current_frame_id, result)

    # -- serving-session checkpoint ---------------------------------------

    def save_cache(self, path: str) -> None:
        """Persist the embedding cache + frame-id mapping (.npz), in the
        JAX package's format."""
        ids = np.array(sorted(self._frame_rows), np.int64)
        np.savez_compressed(
            path,
            feature_volumes=self._db.feature_volumes,
            frame_ids=ids,
            frame_rows=self._rows_of(ids),
        )

    def restore_cache(self, path: str) -> int:
        """Load a cache saved by :meth:`save_cache`; returns #embeddings."""
        with np.load(path) as data:
            n = self._db.load(data["feature_volumes"])
            self._frame_rows = {
                int(i): int(r) for i, r in zip(data["frame_ids"], data["frame_rows"])
            }
        self._row_frames = {r: i for i, r in self._frame_rows.items()}
        return n

    def infer_multiple_vs_multiple(
        self,
        file_names: Sequence[str],
        first_idxs: Sequence[int],
        second_idxs: Sequence[int],
    ):
        """Arbitrary M-vs-N pair scoring over a shared scan list
        (reference infer.py:205-238)."""
        if len(first_idxs) != len(second_idxs):
            raise ValueError(
                "first_idxs and second_idxs must have the same size"
            )
        fv = self.create_feature_volumes(file_names)
        if len(second_idxs) == 0:
            return None
        # reference pairs: left = second_idxs, right = first_idxs
        # (infer.py:227-230)
        overlaps, yaw_peaks, _ = self._db.score_volumes(
            fv[np.asarray(second_idxs)], fv[np.asarray(first_idxs)]
        )
        return overlaps, self._yaw_degrees(yaw_peaks)
