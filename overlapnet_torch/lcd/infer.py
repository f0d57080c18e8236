"""Inference engine / serving API, on one device or over a mesh of ranks.

API-parity re-design of the reference ``Infer`` class (reference
src/two_heads/infer.py:22-265): leg/head factorization with an incremental
embedding cache, the three entry points (``infer_one``, ``infer_multiple``,
``infer_multiple_vs_multiple``), ``create_feature_volumes``, ``query_best``
and ``dispatch_frame``. The embedding cache is a ``DescriptorDB`` on the
serving device or, with ``shards``, a ``ShardedDescriptorDB`` (with ``mesh``
one shard on each rank); on either, ``dispatch_frame`` is the store's fused
frame step and does not wait for the device. Weights load from the
flat-key .npz export (``weights.py``), a reference Keras HDF5 file
(``train/import_keras.py``) or a checkpoint directory of this package's
trainer (``train/checkpoint.py``).
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np
import torch

from overlapnet_torch.core.config import OverlapNetConfig
from overlapnet_torch.core.profiling import span
from overlapnet_torch.data.dataset import assemble_scan_image
from overlapnet_torch.lcd.descriptor_db import DescriptorDB, ShardedDescriptorDB
from overlapnet_torch.models import build_model, leg_output_width
from overlapnet_torch.ops.yaw import peak_to_degrees
from overlapnet_torch.parallel.mesh import Mesh, device_of, save_npz
from overlapnet_torch.weights import load_npz

# Scans per leg call in create_feature_volumes.
MAX_SCANS_PER_CALL = 64


class PendingFrame:
    """Deferred result of :meth:`Infer.dispatch_frame`. A frame holds its
    own (4,) host tensor [overlap, row_id, yaw_peak, yaw_confidence] and, on
    a card, the event recorded behind the copy that fills it; :attr:`result`
    waits for that frame alone, on first access. Reading it launches
    nothing, so any thread may."""

    def __init__(self, infer: "Infer", frame_id: int, n_candidates: int,
                 packed: torch.Tensor, event=None):
        self._infer = infer
        self.frame_id = frame_id
        self._n_candidates = n_candidates
        self._packed = packed
        self._event = event
        self._result = None
        self._done = False

    @property
    def result(self):
        """(match_frame_id, overlap, yaw_deg, confidence), or None when the
        frame had no candidates or nothing scored above -1."""
        if not self._done:
            if self._event is not None:
                self._event.synchronize()
            val, gid, yaw, conf = self._packed.tolist()
            self._packed = self._event = None
            self._done = True
            if self._n_candidates and val > -1.0:
                self._result = (
                    self._infer._row_frames[int(gid)],
                    val,
                    float(self._infer._yaw_degrees(yaw)),
                    conf,
                )
        return self._result


class Infer:
    """Overlap + yaw inference between LiDAR scans.

    Args:
      cfg: full framework config. Scan inputs are read as preprocessed
        channel images from ``cfg.data.data_root_folder/cfg.data.infer_seqs``
        (same disk contract as the reference, infer.py:143-148).
      params: optional ``OverlapNet`` state_dict; otherwise loaded from
        ``cfg.experiment.pretrained_weightsfilename`` (a flat-key .npz, a
        Keras .weight/.h5/.hdf5 file or a checkpoint directory of this
        package), or a seeded fresh init when that names no file.
      db_capacity: maximum number of cached embeddings.
      device: where the model and the embedding cache live ("cuda" by
        default; raises if no card is visible); with a mesh, the rank's.
      shards: None keeps the map in a ``DescriptorDB``, which grows as
        frames come; a number keeps it in a ``ShardedDescriptorDB`` with that
        many row-interleaved shards (all on ``device``), allocated at
        capacity, which also reduces ``infer_multiple`` and ``query_best``
        to the best k on the device. On both, ``dispatch_frame`` is the
        fused frame step and does not wait for the device.
      mesh: keeps the map in a ``ShardedDescriptorDB`` with one shard on
        each rank of this ``parallel.mesh.Mesh`` (the JAX ``Infer(mesh=)``).
        Every rank then makes the same calls; the model is replicated.
    """

    def __init__(
        self,
        cfg: OverlapNetConfig,
        params: Mapping[str, torch.Tensor] | None = None,
        db_capacity: int = 8192,
        device=None,
        shards: int | None = None,
        mesh: Mesh | None = None,
    ):
        if mesh is not None and shards is not None:
            raise ValueError("shards= is the one-device store; a mesh sets its own")
        self.cfg = cfg
        self.mesh = mesh
        self.shards = shards if mesh is None else mesh.size
        self.device = device_of(device, mesh)
        self.output_size = leg_output_width(cfg.model)
        self.model = build_model(cfg.model, cfg.num_input_channels, device=self.device)
        self.model.load_state_dict(params if params is not None else self._load_params())
        self.model.eval()
        store = dict(
            capacity=db_capacity, width=self.output_size,
            channels=self.model.legs.out_channels, device=self.device,
        )
        if self.shards is None:
            self._db = DescriptorDB(self.model.score, **store)
        else:
            self._db = ShardedDescriptorDB(self.model.score, shards=shards, mesh=mesh, **store)
        self._db.set_embedder(self.model.encode)
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
                from overlapnet_torch.train.import_keras import import_keras_weights

                return import_keras_weights(path, self.model.state_dict())
            if os.path.isdir(path):
                from overlapnet_torch.train.checkpoint import latest_step, load_checkpoint

                if latest_step(path) is not None:
                    return load_checkpoint(path)["params"]
                raise NotImplementedError(
                    f"{path} holds no checkpoint of this package (step_<n>.pt). An "
                    "orbax directory of the JAX package cannot be read here: export "
                    "its params with that package's train.checkpoint.save_params_npz "
                    "and name the .npz"
                )
        print("Pre-trained weights was not found in:", path)
        return self.model.state_dict()  # the seeded init of build_model

    # -- feature volumes -------------------------------------------------

    @property
    def feature_volumes(self) -> np.ndarray:
        return self._db.feature_volumes

    def _load_image(self, name: str) -> np.ndarray:
        with span("lcd.load_image"):
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
        with span("lcd.embed"):
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

    def _mask_of(self, rows: np.ndarray) -> np.ndarray:
        """Global-row candidate mask of the store."""
        mask = np.zeros(self._db.capacity, bool)
        mask[rows] = True
        return mask

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
        ref_rows = self._rows_of(reference_frame_id)
        if self.shards is None:
            overlaps, yaw_peaks, confs = self._db.query(fv, ref_rows)
        else:
            # top-k with k >= #candidates: every masked candidate comes back
            # and only O(k) values cross to the host. Fillers (overlap -1)
            # are dropped; a reference id given twice gets its score at both
            # positions.
            vals, gids, yaw_k, conf_k = self._db.query_topk(
                fv, k=len(ref_rows), candidate_mask=self._mask_of(ref_rows)
            )
            overlaps = np.full(len(ref_rows), -1.0, np.float32)
            yaw_peaks = np.zeros(len(ref_rows), np.float32)
            confs = np.zeros(len(ref_rows), np.float32)
            for v, g, y, c in zip(vals, gids, yaw_k, conf_k):
                if v > -1.0:
                    at = ref_rows == g
                    overlaps[at], yaw_peaks[at], confs[at] = v, y, c
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
        if self.shards is None:
            overlaps, yaw_peaks, confs = self._db.query(fv, rows)
            b = int(np.argmax(overlaps))
            best_row = int(rows[b])
        else:  # mask and argmax stay on the device: k = 1 values come back
            overlaps, gids, yaw_peaks, confs = self._db.query_topk(
                fv, k=1, candidate_mask=self._mask_of(rows)
            )
            b, best_row = 0, int(gids[0])
        return (
            self._row_frames[best_row],
            float(overlaps[b]),
            float(self._yaw_degrees(yaw_peaks[b])),
            float(confs[b]),
        )

    def dispatch_frame(
        self, current_frame_id: int, candidate_frame_ids: Sequence[int],
        image: np.ndarray | None = None, fv=None,
    ) -> PendingFrame:
        """Dispatch one serving frame: embed, insert, score against the
        candidates, as the store's fused frame step (``frame_step``), which
        does not wait for the device. ``image`` is used when given instead of
        the frame's image on disk; with a precomputed embedding ``fv`` the
        legs do not run.

        The returned :class:`PendingFrame` resolves on first access to
        ``.result``, to what :meth:`query_best` gives (of equal overlaps, the
        candidate first in the store's row order: the lowest row, on the
        plain store and on one shard). Candidate gating depends only on
        poses, not on earlier results, so consecutive frames can be
        dispatched back to back and resolved later
        (``lcd.online.OnlineLoopCloser.run``)."""
        with span("lcd.dispatch"):
            if image is None and fv is None:
                image = self._load_image(str(current_frame_id).zfill(6))
            mask = self._mask_of(self._rows_of(candidate_frame_ids))
            row, (packed, event) = self._db.frame_step(image, mask, fv=fv)
            self._frame_rows[int(current_frame_id)] = row
            self._row_frames[row] = int(current_frame_id)
            return PendingFrame(self, current_frame_id, len(candidate_frame_ids), packed, event)

    # -- serving-session checkpoint ---------------------------------------

    def save_cache(self, path: str, **extra: np.ndarray) -> None:
        """Persist the embedding cache + frame-id mapping (.npz), in the
        JAX package's format, with ``extra`` arrays beside them. On a mesh
        every rank calls it; rank 0 writes and every rank returns once the
        file is there."""
        ids = np.array(sorted(self._frame_rows), np.int64)
        save_npz(self.mesh, path, feature_volumes=self._db.feature_volumes,
                 frame_ids=ids, frame_rows=self._rows_of(ids), **extra)

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
