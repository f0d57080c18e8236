"""Descriptor database: cached leg embeddings scored by the pairwise heads.

One store, ``_Store``, keeps float32 (W', C) embeddings on the serving
device with rows interleaved over D shards: global row ``i`` lives in shard
``i % D`` at slot ``i // D``, so the live prefix of the map is always
balanced over the shards. Without a mesh this process holds all D shards,
one (D, slots, W', C) tensor; on a mesh of D ranks (the JAX store sharded on
the device axis) rank d holds only shard d. The slots grow by doubling up to
``capacity``. Stored rows are gathered on the device and scored against a
query in head calls of at most MAX_PAIRS_PER_CALL pairs; only per-pair
results come back: overlap, sub-bin yaw peak and yaw confidence.

``DescriptorDB`` is the store with one shard and the JAX package's
single-device queries; ``ShardedDescriptorDB`` takes D shards or a mesh and
the JAX sharded store's best-k queries. Both have the online loop closer's
fused frame step (embed + insert + masked top-1, ``frame_step``), which
never waits for the device: the best candidate's four numbers land in
page-locked memory behind an event.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from overlapnet_torch.core.profiling import count, span
from overlapnet_torch.ops.correlation import subbin_peak, yaw_confidence
from overlapnet_torch.parallel.mesh import Mesh, all_gather, all_reduce_sum, device_of, save_npz

# Pairs per head call: bounds the c_conv1 output (B x 360 x 24 x 64 fp32,
# 566 MB at B = 256) however many candidates a query has.
MAX_PAIRS_PER_CALL = 256


def _packed_topk(scores: torch.Tensor, gids: torch.Tensor, k: int) -> torch.Tensor:
    """The best ``k`` columns of ``scores`` (3, n) = [overlap, yaw_peak,
    yaw_confidence] as one (4, k) float32 tensor [overlap, row_id, yaw_peak,
    yaw_confidence], best first. Ties go to the lower column (a stable sort),
    and slots past n hold overlap -1, row 0, peak 0, confidence 0."""
    n = scores.shape[1]
    out = scores.new_zeros((4, k))
    out[0] = -1.0
    kk = min(k, n)
    if kk:
        order = torch.sort(scores[0], descending=True, stable=True).indices[:kk]
        out[0, :kk] = scores[0, order]
        out[1, :kk] = gids[order].float()
        out[2:, :kk] = scores[1:, order]
    return out


def _merge_topk(gathered: torch.Tensor, k: int) -> torch.Tensor:
    """The best ``k`` of every rank's packed top-k, (D, 4, k) -> (4, k). In
    rank order a stable sort meets equal overlaps in store order (shard,
    then slot), so the result is the one store's."""
    cols = gathered.transpose(0, 1).reshape(4, -1)
    return _packed_topk(torch.cat([cols[:1], cols[2:]]), cols[1], k)


class _Store:
    """The descriptor store (module docstring); arguments as
    :class:`ShardedDescriptorDB`'s.

    On a mesh every rank makes the same calls with the same arguments, as
    the JAX package's processes do: an added row is kept by the rank that
    owns it, each rank scores its own masked live rows, and the ranks'
    results are gathered. Results equal the one-device store's with D
    shards, up to the rounding of the heads on other batch sizes.

    Candidates are chosen by a GLOBAL-row mask, host data, so the rows and
    their count are known without asking the device; only live masked rows
    are scored, and of equal overlaps the row first in store order
    (shard-major) wins.
    """

    _leg_embed: Callable | None = None

    def __init__(
        self,
        head_apply: Callable,
        capacity: int = 8192,
        width: int = 360,
        channels: int = 128,
        shards: int | None = None,
        device=None,
        mesh: Mesh | None = None,
    ):
        d = int((1 if mesh is None else mesh.size) if shards is None else shards)
        if d < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if mesh is not None and d != mesh.size:
            raise ValueError(f"{d} shards on a mesh of {mesh.size} ranks")
        self._head = head_apply
        self._mesh = mesh
        self._n_dev = d
        # the shards this process holds: all of them, or the rank's
        self._first, n_local = (0, d) if mesh is None else (mesh.rank, 1)
        self._slots_cap = (capacity + d - 1) // d
        if self.capacity >= 2**24:
            # the frame step carries the row id in a float32
            raise ValueError(f"capacity {self.capacity} must be below 2**24 rows")
        self.device = device_of(device, mesh)
        self._fv = torch.zeros((n_local, 0, width, channels), device=self.device)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return self._n_dev * self._slots_cap

    # -- storage -------------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        """A float32 tensor on the store's device from an array or tensor."""
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _upload(self, x) -> torch.Tensor:
        """A host array or tensor on the store's device, without waiting for
        the device: on a card the bytes go through page-locked memory with a
        non-blocking copy (the host allocator keeps that block until the
        copy has run); on the CPU an array is wrapped, not copied."""
        t = torch.as_tensor(x)
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.contiguous().pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _reserve(self, n: int) -> None:
        """Grow the shards held here (doubling their slots, capped at
        capacity, 16 rows at least) to hold n rows."""
        if n > self.capacity:
            raise ValueError(f"{type(self).__name__} capacity {self.capacity} exceeded")
        d, slots = self._n_dev, self._fv.shape[1]
        if -(-n // d) <= slots:
            return
        grown_slots = min(self._slots_cap, max(-(-n // d), 2 * slots, -(-16 // d)))
        live = -(-self._n // d)
        # a normal tensor also when the frame step grows it (under inference
        # mode), so that rows can be written outside that mode too
        with span("db.grow"), torch.inference_mode(False):
            grown = torch.zeros((self._fv.shape[0], grown_slots, *self._fv.shape[2:]),
                                device=self.device)
            grown[:, :live] = self._fv[:, :live]
            self._fv = grown
        count("db.grows")

    def add(self, fv) -> int:
        """Append one (W', C) or a batch (K, W', C) of embeddings; returns the
        first new row."""
        with span("db.insert"):
            fv = self._tensor(fv)
            if fv.dim() == 2:
                fv = fv[None]
            if fv.shape[1:] != self._fv.shape[2:]:
                raise ValueError(
                    f"embedding shape {tuple(fv.shape[1:])} does not match the DB's "
                    f"(W', C) = {tuple(self._fv.shape[2:])} — was this cache built "
                    "with a different input_width/model?"
                )
            k = fv.shape[0]
            self._reserve(self._n + k)
            # each shard held here keeps its rows: every D-th, in slot order
            for local in range(self._fv.shape[0]):
                mine = slice((self._first + local - self._n) % self._n_dev, k, self._n_dev)
                slot0 = (self._n + mine.start) // self._n_dev
                self._fv[local, slot0 : slot0 + len(range(k)[mine])] = fv[mine]
            first = self._n
            self._n += k
            return first

    def load(self, fv) -> int:
        """Replace the whole store with ``fv`` (N, W', C); returns N. On a
        mesh every rank loads the same rows and keeps its own."""
        if len(fv) > self.capacity:
            raise ValueError(f"bulk load of {len(fv)} rows exceeds capacity {self.capacity}")
        self._n = 0
        self.add(fv)
        return self._n

    @property
    def feature_volumes(self) -> np.ndarray:
        """Live embeddings in global row order (copied to the host: O(n)). On
        a mesh the ranks' shards are gathered first: every rank must ask."""
        shards = self._fv[:, : -(-self._n // self._n_dev)]
        if self._mesh is not None:
            shards = all_gather(self._mesh, shards[0])
        live = shards.transpose(0, 1).reshape(-1, *self._fv.shape[2:])
        return live[: self._n].cpu().numpy()

    def save(self, path: str) -> None:
        """Persist the live embeddings in global row order to ``path`` (.npz),
        the format both DBs of the JAX package write and read. On a mesh
        rank 0 writes and every rank returns once the file is there."""
        save_npz(self._mesh, path, feature_volumes=self.feature_volumes)

    def restore(self, path: str) -> int:
        """Load embeddings saved by :meth:`save`; returns the row count."""
        with np.load(path) as data:
            return self.load(data["feature_volumes"])

    # -- scoring -------------------------------------------------------------

    def _flat(self, rows: np.ndarray) -> np.ndarray:
        """Global rows held here -> row indices of this process's store
        viewed as (local shards * slots, W', C)."""
        return (rows % self._n_dev - self._first) * self._fv.shape[1] + rows // self._n_dev

    def _live_rows(self, candidate_mask) -> np.ndarray:
        """Live global rows a (capacity,)-or-shorter bool mask selects (all
        live rows for None)."""
        if candidate_mask is None:
            return np.arange(self._n, dtype=np.int64)
        return np.flatnonzero(np.asarray(candidate_mask, bool)[: self._n])

    def _candidate_rows(self, candidate_mask) -> np.ndarray:
        """The live masked rows held here, in store order: shard-major, which
        is the order in which equal overlaps are ranked."""
        rows = self._live_rows(candidate_mask)
        if self._mesh is not None:
            rows = rows[rows % self._n_dev == self._first]
        return rows[np.argsort(self._flat(rows), kind="stable")]

    def _heads(self, n: int, pairs: Callable[[slice], tuple]) -> torch.Tensor:
        """Device scores (3, n) = [overlap, yaw_peak, yaw_confidence] of n
        pairs, through head calls of at most MAX_PAIRS_PER_CALL pairs;
        ``pairs(s)`` gives the (left, right) volumes of the pairs in slice
        ``s``."""
        outs = []
        for i in range(0, n, MAX_PAIRS_PER_CALL):
            overlap, logits = self._head(*pairs(slice(i, i + MAX_PAIRS_PER_CALL)))
            outs.append(torch.stack(
                [overlap.reshape(-1), subbin_peak(logits), yaw_confidence(logits)]
            ))
        return torch.cat(outs, dim=1)

    def _score_rows(self, query: torch.Tensor, rows: np.ndarray):
        """Score the (W', C) device ``query`` (right input) against stored
        global ``rows`` held here (left input), each chunk's rows gathered
        for its head call. Returns device tensors: scores (3, n) =
        [overlap, yaw_peak, yaw_confidence] and the rows as int64. Nothing
        here waits for the device."""
        if len(rows) == 0:
            return (self._fv.new_zeros((3, 0)),
                    torch.zeros(0, dtype=torch.int64, device=self.device))
        idx = self._upload(np.stack([self._flat(rows), rows]))
        flat = self._fv.view(-1, *self._fv.shape[-2:])

        def pairs(s):
            fa = flat.index_select(0, idx[0, s])
            return fa, query[None].expand_as(fa)

        return self._heads(len(rows), pairs), idx[1]

    @staticmethod
    def _fetch(scores: torch.Tensor) -> np.ndarray:
        with span("db.fetch"):
            return scores.cpu().numpy()

    @torch.inference_mode()
    def query_rows(self, query_fv, rows) -> np.ndarray:
        """Host scores (3, len(rows)) = [overlap, yaw_peak, yaw_confidence]
        of the (W', C) query (right input) against stored global ``rows``
        (left input) as given: a row listed twice has its scores at both
        places, a row that is not live reads 0. Each live row is scored
        once, by the process that holds it; on a mesh every rank must ask,
        and the ranks' (3, capacity) tables are summed (a row is filled on
        its owner's rank only, so adding the zeros is exact)."""
        rows = np.asarray(rows, np.int64)
        mask = np.zeros(self.capacity, bool)
        mask[rows] = True
        scores, idx = self._score_rows(self._tensor(query_fv), self._candidate_rows(mask))
        table = scores.new_zeros((3, self.capacity))
        table[:, idx] = scores
        if self._mesh is not None:
            all_reduce_sum(self._mesh, table)
        return self._fetch(table)[:, rows]

    @torch.inference_mode()
    def score_volumes(self, fa, fb) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Score explicit (n, W', C) left/right feature-volume batches (no
        stored rows; on a mesh, on this rank alone); returns (overlap (n,),
        yaw_peak (n,) float sub-bin positions, yaw_confidence (n,))."""
        if len(fa) == 0:
            return (np.zeros(0, np.float32),) * 3
        fa, fb = self._tensor(fa), self._tensor(fb)
        return tuple(self._fetch(self._heads(len(fa), lambda s: (fa[s], fb[s]))))

    # -- the online loop closer's frame step ----------------------------------

    def set_embedder(self, leg_apply: Callable) -> None:
        """Register the leg function, images (B, H, W, C) -> (B, W', C'),
        that :meth:`frame_step` embeds with (e.g. ``OverlapNet.encode``)."""
        self._leg_embed = leg_apply

    @torch.inference_mode()
    def frame_step(self, image, candidate_mask, fv=None) -> tuple[int, tuple]:
        """Embed ``image``, append the embedding as the next row, and score
        it against the live masked rows, as one run of device work with no
        host synchronisation. Requires :meth:`set_embedder`, unless the
        (W', C) embedding ``fv`` is given: then ``image`` is not read and the
        legs do not run.

        Returns (row, (packed, event)). ``packed`` is a (4,) float32 host
        tensor [overlap, row_id, yaw_peak, yaw_confidence] owned by this
        frame; overlap is -1 when no live masked candidate exists. On a card
        it is page-locked memory that a non-blocking copy fills: read it
        only after ``event.synchronize()``. On the CPU the step has run by
        the time it returns and ``event`` is None. The candidate mask indexes
        GLOBAL rows and cannot select the new row; of equal overlaps the
        row first in the store's order wins. The store grows in the step
        when it must: the caching allocator orders the reuse of the old
        block after the frames still in flight on the stream.

        On a mesh every rank embeds the image (the leg is replicated, as in
        the JAX step) and only the owning rank stores the row. Every rank
        takes part in the gather of the ranks' best rows on every frame, also
        with no candidate of its own (it offers overlap -1), so no rank waits
        on the host; on NCCL the collective is enqueued on the stream.
        """
        with span("db.frame_step"):
            if fv is None and self._leg_embed is None:
                raise RuntimeError("frame_step needs set_embedder() first")
            row = self._n
            if row >= self.capacity:
                raise ValueError(f"{type(self).__name__} capacity exceeded")
            rows = self._candidate_rows(candidate_mask)
            if fv is None:
                fv = self._leg_embed(self._upload(np.asarray(image, np.float32))[None])[0]
            else:
                fv = self._upload(fv).float().contiguous()
            self.add(fv)
            scores, gids = self._score_rows(fv, rows)
            with span("db.fetch"):
                best = _packed_topk(scores, gids, 1)
                if self._mesh is not None:
                    best = _merge_topk(all_gather(self._mesh, best), 1)
                best = best[:, 0]
                if best.device.type != "cuda":
                    return row, (best, None)
                packed = torch.empty(4, dtype=torch.float32, pin_memory=True)
                packed.copy_(best, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(best.device))
                return row, (packed, event)


class DescriptorDB(_Store):
    """The store with one shard, and the JAX package's single-device
    ``DescriptorDB`` queries.

    Args:
      head_apply: (fa, fb) -> (overlap (B, 1), orientation logits (B, W')),
        e.g. ``OverlapNet.score``.
      capacity: maximum number of stored embeddings (below 2**24).
      width, channels: embedding shape (reference: 360, 128).
      device: where the store lives and the heads run ("cuda" by default;
        raises if no card is visible).
    """

    def __init__(
        self,
        head_apply: Callable,
        capacity: int = 8192,
        width: int = 360,
        channels: int = 128,
        device="cuda",
    ):
        super().__init__(head_apply, capacity, width, channels, shards=1, device=device)

    def _checked(self, idxs) -> np.ndarray:
        """Row indices checked on the host against the live rows (an index
        out of range on the device would fault the card, not raise)."""
        idxs = np.asarray(idxs, np.int64)
        if idxs.size and (idxs.min() < 0 or idxs.max() >= self._n):
            raise IndexError(f"row index out of range for {self._n} rows")
        return idxs

    @torch.inference_mode()
    def score_pairs(self, idx1, idx2) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Score stored pairs (left ``idx1``, right ``idx2``); returns
        (overlap (n,), yaw_peak (n,) float sub-bin positions,
        yaw_confidence (n,))."""
        if len(idx1) == 0:
            return (np.zeros(0, np.float32),) * 3
        idx = self._upload(np.stack([self._checked(idx1), self._checked(idx2)]))
        flat = self._fv[0]
        scores = self._heads(len(idx1), lambda s: (flat.index_select(0, idx[0, s]),
                                                   flat.index_select(0, idx[1, s])))
        return tuple(self._fetch(scores))

    def query(self, query_fv, candidate_idxs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Score one query embedding against stored candidates.

        Returns (overlaps (k,), yaw_peaks (k,), yaw_confidences (k,));
        candidates are the *left* input and the query the *right*, matching
        reference infer.infer_multiple (infer.py:186-190).
        """
        return tuple(self.query_rows(query_fv, self._checked(candidate_idxs)))


class ShardedDescriptorDB(_Store):
    """The store with ``shards`` row-interleaved shards on one device, or
    one on each rank of a ``mesh``, and the JAX package's
    ``ShardedDescriptorDB`` queries: the best k rows reduced on the device.

    Queries take a GLOBAL-row candidate mask, (capacity,) bool or
    (Q, capacity) per query; results are what scoring every live row and
    masking the rest to -1 would give.

    Args:
      head_apply: (fa, fb) -> (overlap (B, 1), orientation logits (B, W')),
        e.g. ``OverlapNet.score``.
      capacity: maximum number of stored embeddings (rounded up to a
        multiple of ``shards``).
      width, channels: embedding shape (reference: 360, 128).
      shards: number of row-interleaved shards D (1 by default; the mesh's
        size with a mesh).
      device: where the store lives and the heads run ("cuda" by default;
        raises if no card is visible); with a mesh, the rank's device.
      mesh: a ``parallel.mesh.Mesh`` whose ranks hold one shard each.
    """

    def _slots_bucket(self, n: int) -> int:
        """Smallest power-of-two slot count covering n rows (>= 1 per shard)."""
        need = max(1, -(-n // self._n_dev))
        b = 1
        while b < need:
            b *= 2
        return min(b, self._slots_cap)

    def _masks(self, candidate_mask, qn: int) -> list:
        """One mask (or None) per query from a shared or per-query mask."""
        if candidate_mask is None:
            return [None] * qn
        candidate_mask = np.asarray(candidate_mask, bool)
        if candidate_mask.ndim == 1:
            return [candidate_mask] * qn
        if candidate_mask.shape[0] != qn:
            raise ValueError(
                f"{candidate_mask.shape[0]} candidate masks for {qn} queries"
            )
        return list(candidate_mask)

    @torch.inference_mode()
    def query_topk_batch(
        self, queries, k: int = 8, candidate_mask=None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Global best-k rows for a (Q, W', C) stack of queries; one transfer
        to the host for all of them. ``candidate_mask`` may be (capacity,)
        shared or (Q, capacity) per-query, indexed by GLOBAL row id. Returns
        (overlaps, row_ids, yaw_peaks, yaw_confidences), each (Q, k) with k
        capped at the live slot bucket; slots holding no live masked row
        come back with overlap -1."""
        queries = self._tensor(queries)
        if queries.dim() == 2:
            queries = queries[None]
        k = min(k, self._n_dev * self._slots_bucket(self._n))
        packed = torch.stack([
            _packed_topk(*self._score_rows(q, self._candidate_rows(m)), k)
            for q, m in zip(queries, self._masks(candidate_mask, queries.shape[0]))
        ])  # (Q, 4, k)
        if self._mesh is not None:
            gathered = all_gather(self._mesh, packed)  # (D, Q, 4, k)
            packed = torch.stack([_merge_topk(gathered[:, i], k) for i in range(len(packed))])
        packed = packed.cpu().numpy()
        return (packed[:, 0], packed[:, 1].astype(np.int32), packed[:, 2],
                packed[:, 3])

    def query_topk(
        self, query_fv, k: int = 8, candidate_mask=None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Global best-k rows for one query, reduced on the device: only
        (k,)-sized arrays cross to the host. Returns (overlaps, row_ids,
        yaw_peaks, yaw_confidences); slots holding no live masked row come
        back with overlap -1 (ignore them when fewer than k rows score)."""
        vals, gid, yaw, conf = self.query_topk_batch(
            self._tensor(query_fv)[None], k=k, candidate_mask=candidate_mask
        )
        return vals[0], gid[0], yaw[0], conf[0]

    def query_all(
        self, query_fv, candidate_mask=None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Score the query against every live masked row. Returns host
        (overlaps, yaw_peaks, yaw_confidences), each (capacity,), indexed by
        global row; rows that were not scored hold overlap -1, peak 0 and
        confidence 0."""
        rows = self._live_rows(candidate_mask)
        out = np.zeros((3, self.capacity), np.float32)
        out[0] = -1.0
        out[:, rows] = self.query_rows(query_fv, rows)
        return out[0], out[1], out[2]
