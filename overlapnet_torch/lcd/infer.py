"""Inference engine / serving API, on one device or over a mesh of ranks.

API-parity re-design of the reference ``Infer`` class (reference
src/two_heads/infer.py:22-265): leg/head factorization with an incremental
embedding cache, the three entry points (``infer_one``, ``infer_multiple``,
``infer_multiple_vs_multiple``), ``create_feature_volumes``, ``query_best``
and ``dispatch_frame``. The embedding cache is a ``ShardedDescriptorDB``: one
shard on the serving device by default, ``shards`` of them there, or one on
each rank of a ``mesh``. ``dispatch_frame`` is the store's fused frame step
and does not wait for the device; ``query_best`` is that step's result.
Weights load from the flat-key .npz export (``weights.py``), a reference
Keras HDF5 file (``train/import_keras.py``) or a checkpoint directory of
this package's trainer (``train/checkpoint.py``).
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np
import torch

from overlapnet_torch.core.config import OverlapNetConfig
from overlapnet_torch.core.profiling import span
from overlapnet_torch.data.dataset import assemble_scan_image
from overlapnet_torch.lcd.descriptor_db import ShardedDescriptorDB
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
      shards: the number of row-interleaved shards of the map store, all on
        ``device`` (1 when None). The store grows as frames come, whatever
        the number; the answers do not depend on it, save which of equal
        overlaps wins (the first in store order, shard-major).
      mesh: keeps one shard of the map on each rank of this
        ``parallel.mesh.Mesh`` (the JAX ``Infer(mesh=)``). Every rank then
        makes the same calls; the model is replicated.
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
            raise ValueError("shards= lays the map out on one device; a mesh sets its own")
        self.cfg = cfg
        self.mesh = mesh
        self.device = device_of(device, mesh)
        self.output_size = leg_output_width(cfg.model)
        self.model = build_model(cfg.model, cfg.num_input_channels, device=self.device)
        self.model.load_state_dict(params if params is not None else self._load_params())
        self.model.eval()
        self._db = ShardedDescriptorDB(
            self.model.score, capacity=db_capacity, width=self.output_size,
            channels=self.model.legs.out_channels, shards=shards,
            device=self.device, mesh=mesh,
        )
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
        # a reference id given twice gets its score at both positions
        overlaps, yaw_peaks, confs = self._db.query_rows(fv, self._rows_of(reference_frame_id))
        return overlaps, self._yaw_degrees(yaw_peaks), confs

    def query_best(
        self, current_frame_id: int, candidate_frame_ids: Sequence[int], fv=None
    ):
        """Embed + cache the current frame, then return the best candidate
        as (match_frame_id, overlap, yaw_deg, confidence), or None when
        there are no candidates: the frame step's result
        (:meth:`dispatch_frame`), waited for."""
        return self.dispatch_frame(current_frame_id, candidate_frame_ids, fv=fv).result

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
        ``.result``, to (match_frame_id, overlap, yaw_deg, confidence), or
        None when there are no candidates; of equal overlaps, the candidate
        first in the store's row order wins (the lowest row, on one shard).
        Candidate gating depends only on poses, not on earlier results, so
        consecutive frames can be dispatched back to back and resolved later
        (``lcd.online.OnlineLoopCloser.run``)."""
        with span("lcd.dispatch"):
            if image is None and fv is None:
                image = self._load_image(str(current_frame_id).zfill(6))
            mask = np.zeros(self._db.capacity, bool)
            mask[self._rows_of(candidate_frame_ids)] = True
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
