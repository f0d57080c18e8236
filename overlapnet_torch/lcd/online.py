"""Online loop-closure detection over a scan sequence.

Headless re-design of the reference's animated demo3 loop
(reference demo/demo3_lcd.py:23-177): per frame, gate candidates by the
pose-covariance search ellipse and inactive-map constraints, score them
against the descriptor DB, and accept the best candidate above the overlap
threshold. Returns structured loop-closure edges (the input to the pose-graph
backend) instead of a matplotlib animation.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from overlapnet_torch.core.profiling import count, span
from overlapnet_torch.lcd.gating import (
    CovarianceEllipse,
    candidate_mask,
    trajectory_lengths,
)
from overlapnet_torch.lcd.infer import Infer

# Longest that :meth:`OnlineLoopCloser.run` waits on its resolver thread (a
# full queue, the final join) before it gives the thread up as stalled.
RESOLVER_DEADLINE_S = 60.0


@dataclass
class LoopClosure:
    """One detected loop: query frame, matched frame, overlap, yaw degrees,
    and antipodal-aware yaw confidence (softmax peak mass x secondary-peak
    margin, ops.correlation.yaw_confidence; ~0 when a competing correlation
    peak rivals the winner).

    ``yaw_deg`` is the yaw of ``frame`` expressed in ``match``'s frame,
    i.e. yaw(inv(P_match) @ P_frame): serving scores candidates as the LEFT
    leg and the query as the RIGHT (reference infer.py:186-190), and the
    pose-graph edge (match -> frame) consumes exactly this measurement."""

    frame: int
    match: int
    overlap: float
    yaw_deg: float
    confidence: float = 1.0


@dataclass
class OnlineLoopCloser:
    """Streaming LCD engine with the reference demo3 thresholds
    (demo3_lcd.py:53-55): inactive_time 100 frames, inactive_dist 50 m,
    overlap threshold 0.3, 3-sigma search ellipse."""

    infer: Infer
    poses: np.ndarray  # (n, 4, 4) LiDAR-frame poses
    covariances: np.ndarray | None = None  # (n, 6, 6)
    inactive_time: int = 100
    inactive_dist: float = 50.0
    overlap_threshold: float = 0.3
    nstd: float = 3.0
    closures: list[LoopClosure] = field(default_factory=list)

    def __post_init__(self):
        self._positions = self.poses[:, :2, 3]
        self._traj_length = trajectory_lengths(self._positions)
        self._next_frame = 0

    def _dispatch(self, idx: int):
        """Gate candidates for frame ``idx`` and dispatch its (fused,
        non-blocking) scoring step; returns the PendingFrame. Gating depends
        only on poses/covariances — never on earlier results — which is what
        makes frame pipelining legal."""
        if idx != self._next_frame:
            raise ValueError(
                f"frames must be processed in order (expected {self._next_frame}, "
                f"got {idx})"
            )
        self._next_frame += 1

        with span("lcd.frame"):
            with span("lcd.gate"):
                if self.covariances is not None:
                    ellipse = CovarianceEllipse.from_covariance(
                        self.covariances[idx][:2, :2], self.nstd
                    )
                else:
                    # No covariance stream: unbounded search space (gating by
                    # inactive-map constraints only).
                    ellipse = CovarianceEllipse(np.inf, np.inf, 0.0)

                mask = candidate_mask(
                    idx,
                    self._positions,
                    self._traj_length,
                    ellipse,
                    self.inactive_time,
                    self.inactive_dist,
                )
                candidates = np.flatnonzero(mask).tolist()
            count("lcd.frames")
            count("lcd.candidates", len(candidates))
            return self.infer.dispatch_frame(idx, candidates)

    def _resolve(self, pending) -> LoopClosure | None:
        result = pending.result
        if result is None:
            return None
        match_frame, overlap, yaw_deg, conf = result
        if overlap > self.overlap_threshold:
            closure = LoopClosure(
                frame=pending.frame_id,
                match=int(match_frame),
                overlap=float(overlap),
                yaw_deg=float(yaw_deg),
                confidence=float(conf),
            )
            self.closures.append(closure)
            return closure
        return None

    def step(self, idx: int) -> LoopClosure | None:
        """Process frame ``idx`` synchronously (must be called for every
        frame in order so the embedding cache stays index-aligned,
        demo3_lcd.py:88-89, 121-123). Returns the accepted closure, if any.
        For throughput, prefer :meth:`run` — it pipelines frames."""
        return self._resolve(self._dispatch(idx))

    def run(
        self, n_frames: int | None = None, pipeline_depth: int = 8
    ) -> list[LoopClosure]:
        """Process all frames with up to ``pipeline_depth`` frames in
        flight: frame i+1's gating needs only poses, so its fused step is
        dispatched before frame i's result is read, on either store of
        ``Infer``. Reading (a wait on that frame's event, which releases the
        GIL) runs on a RESOLVER THREAD, so the next frames' gating, image
        loading and dispatch run on the host while the device scores the
        frames before them. The resolver launches no device work. Results
        resolve in frame order on the single resolver; closures are
        identical to the sequential loop.

        If resolving a frame raises, dispatch stops, the frames already
        dispatched (they are in the map, and the frame cursor is past them)
        are still resolved, and the first error is re-raised. A resolver that
        makes no progress for RESOLVER_DEADLINE_S raises RuntimeError instead
        of blocking forever."""
        n = n_frames if n_frames is not None else len(self.poses)
        work: queue.Queue = queue.Queue(maxsize=max(1, pipeline_depth))
        errors: list[Exception] = []

        def resolver():
            while True:
                p = work.get()
                if p is None:
                    return
                try:
                    self._resolve(p)
                except Exception as e:  # re-raised by run(); keep draining
                    errors.append(e)

        t = threading.Thread(target=resolver, daemon=True)

        def hand_over(item) -> None:
            deadline = time.monotonic() + RESOLVER_DEADLINE_S
            with span("lcd.handover"):
                while True:
                    try:
                        work.put(item, timeout=min(0.5, RESOLVER_DEADLINE_S))
                        return
                    except queue.Full:
                        if time.monotonic() >= deadline:
                            raise RuntimeError(
                                f"the resolver thread took no frame for "
                                f"{RESOLVER_DEADLINE_S} s"
                            ) from None

        t.start()
        try:
            for idx in range(self._next_frame, n):
                if errors:
                    break
                hand_over(self._dispatch(idx))
        finally:
            hand_over(None)
            t.join(RESOLVER_DEADLINE_S)
            if t.is_alive():
                raise RuntimeError(
                    f"the resolver thread did not finish within "
                    f"{RESOLVER_DEADLINE_S} s"
                )
        if errors:
            raise errors[0]
        return self.closures

    # -- fault tolerance ---------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Persist the full session state: frame cursor, accepted closures,
        and the embedding cache (via ``Infer.save_cache``), in the JAX
        package's file format: either engine resumes a session the other
        saved, without re-embedding historical scans."""
        closures = np.array(
            [[c.frame, c.match, c.overlap, c.yaw_deg, c.confidence]
             for c in self.closures],
            np.float64,
        ).reshape(-1, 5)
        self.infer.save_cache(path, next_frame=np.int64(self._next_frame), closures=closures)

    def resume(self, path: str) -> int:
        """Restore state saved by :meth:`save_checkpoint`; returns the next
        frame index to process (pass frames >= this to :meth:`step`)."""
        self.infer.restore_cache(path)
        with np.load(path) as data:
            self._next_frame = int(data["next_frame"])
            self.closures = [
                LoopClosure(int(f), int(m), float(o), float(y), float(c))
                for f, m, o, y, c in data["closures"]
            ]
        return self._next_frame
