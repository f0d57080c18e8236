"""Ground-truth overlap / yaw computation on the device.

The JAX package's ``geometry/overlap.py`` (after reference
src/utils/com_overlap_yaw.py) in PyTorch: for a query frame, every reference
scan is transformed into the query frame, re-projected, and overlap =
|{px : r_ref > 0 and |r_ref - r_cur| < 1 m}| / |{px : r_cur > 0}|
(com_overlap_yaw.py:44-45).

The whole sequence is loaded once and kept resident on the device as one
(N, P, 4) tensor (as three (N, P) coordinate planes); (query, reference)
pairs are scored K at a time in one batched pass with on-device gathers,
using only the pass-1 min-depth z-buffer of ``geometry.projection``. Every
chunk is enqueued before the one fetch of all results, and the chunk loop
makes no host synchronisation.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from overlapnet_torch.core.device import resolve_device
from overlapnet_torch.core.profiling import count, span
from overlapnet_torch.geometry import kitti
from overlapnet_torch.geometry.projection import (
    DEFAULT_MAX_POINTS,
    MAX_RANGE,
    PROJ_H,
    PROJ_W,
    min_depth_image,
    pad_points,
    pixels_of,
    project_pixels,
)
from overlapnet_torch.geometry.rotations import relative_yaw, yaw_to_bin


def load_scans_padded(
    scan_paths: Sequence[str],
    max_points: int = DEFAULT_MAX_POINTS,
    io_workers: int = 16,
) -> np.ndarray:
    """Load a whole sequence into one (N, max_points, 4) array.

    Uses the native C++ parallel reader (native/batcher.cc ov_read_scans)
    when built, else a Python thread pool."""
    from overlapnet_torch.data import native

    if native.available():
        return native.read_scans(list(scan_paths), max_points, n_threads=io_workers)

    def load(path):
        return pad_points(kitti.load_scan(path).astype(np.float32), max_points)

    out = np.empty((len(scan_paths), max_points, 4), np.float32)
    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        for i, pts in enumerate(pool.map(load, scan_paths)):
            out[i] = pts
    return out


def ranges_chunk(points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(K, P, 4) scans -> ((K, H*W) range images, (K,) valid-pixel counts,
    (K,) max point radius, which the exact far-pair gate uses).

    The range image is ``range_projection``'s proj_range from its pass 1
    alone: a pixel is hit exactly when some valid point (finite depth) lands
    in it, and its value is then that pass's minimum."""
    n_pix = PROJ_H * PROJ_W
    pix, depth, valid = project_pixels(points)
    win = min_depth_image(pix, depth, valid, n_pix)[:, :n_pix]
    rng_img = torch.where(torch.isfinite(win), win, torch.full((), -1.0, device=win.device))
    radius = torch.linalg.vector_norm(points[..., :3], dim=-1).amax(dim=-1)
    return rng_img, (rng_img > 0).sum(dim=1).float(), radius


def pair_chunk(
    planes: tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # (N, P) x, y, z
    ranges_all: torch.Tensor,  # (N, H*W) per-frame range images
    valid_all: torch.Tensor,   # (N,) valid-pixel counts
    q_ids: torch.Tensor,       # (K,) query frame ids
    r_ids: torch.Tensor,       # (K,) reference frame ids
    transforms: torch.Tensor,  # (K, 4, 4) float32 inv(pose_q) @ pose_r
) -> torch.Tensor:
    """Overlap of K (query, reference) pairs, (K,) float32, on the device.

    Overlap needs only the pass-1 min-depth z-buffer of the re-projected
    reference scan (reference com_overlap_yaw.py:44-52 compares range
    values), so this skips ``range_projection``'s winner-index pass and its
    gathers: one scatter-min per pair. min is order-independent, so the
    per-pixel value equals ``range_projection``'s proj_range wherever that is
    > 0, and an empty pixel (inf here, -1 there) never satisfies |ref - cur| <
    1 against a valid cur: the counts are the same.

    The transform is explicit fp32 multiply-adds (``transform_points``'s
    rule, no TF32), on the x, y and z planes only. What a chunk holds on the device, at P points a scan: the
    gathered and transformed coordinates (6 K P floats), the float64 terms
    of the depth, the int64 pixel ids (K P) and the (K, H*W + 1) buffer; at
    K = 256 and P = 140,000 about 0.9 GB of float32 coordinates and 0.3 GB
    of pixel ids, a few GB at the peak with the float64 temporaries.
    """
    n_pix = ranges_all.shape[1]
    xs, ys, zs = (p[r_ids] for p in planes)
    valid_pt = (xs != 0) | (ys != 0) | (zs != 0)
    t = transforms[:, :3, :, None]  # (K, 3, 4, 1)
    zero = torch.zeros((), dtype=torch.float32, device=xs.device)
    x, y, z = (torch.where(valid_pt, xs * t[:, r, 0] + ys * t[:, r, 1] + zs * t[:, r, 2]
                           + t[:, r, 3], zero) for r in range(3))
    del xs, ys, zs
    pix, depth, valid = pixels_of(x, y, z)
    del x, y, z
    win = min_depth_image(pix, depth, valid, n_pix)[:, :n_pix]
    cur = ranges_all[q_ids]
    close = torch.isfinite(win) & ((win - cur).abs() < 1.0)
    # max(valid, 1): a query frame with zero valid pixels (an empty scan) gets
    # overlap 0, as the far-pair gate gives it
    return close.sum(dim=1) / torch.clamp(valid_all[q_ids], min=1.0)


def dispatch_chunks(planes, ranges_dev, valid_dev, q_live, r_live, inv_poses, poses,
                    chunk_size: int) -> list[torch.Tensor]:
    """Enqueue ``pair_chunk`` over the live pairs, ``chunk_size`` at a time;
    returns the chunks' device results, unfetched. Everything it reads is on
    the device already (ids, poses), so the loop never waits on the host's
    side of a copy or on a result."""
    chunks = []
    for s in range(0, q_live.shape[0], chunk_size):
        qc, rc = q_live[s : s + chunk_size], r_live[s : s + chunk_size]
        T = torch.bmm(inv_poses[qc], poses[rc]).float()  # float64 product, as numpy's
        chunks.append(pair_chunk(planes, ranges_dev, valid_dev, qc, rc, T))
    return chunks


def _relative_yaws(poses_q: np.ndarray, poses_r: np.ndarray) -> np.ndarray:
    """Vectorized yaw of inv(pose_q) @ pose_r for stacked (K, 4, 4) poses.

    Same formula as rotations.euler_angles_from_rotation_matrix's main branch
    (reference utils.py:189-214); pairs in the gimbal-lock branch
    (|R20| ~= 1, pitch +-90 deg, never reached by ground vehicles) fall back
    to the exact scalar path.
    """
    R = np.einsum("kji,kjl->kil", poses_q[:, :3, :3], poses_r[:, :3, :3])
    r20 = np.clip(R[:, 2, 0], -1.0, 1.0)
    safe = np.abs(r20) < 1.0 - 1e-8
    yaw = np.where(safe, np.arctan2(R[:, 1, 0], R[:, 0, 0]), 0.0)
    if not safe.all():
        for k in np.flatnonzero(~safe):
            yaw[k] = relative_yaw(poses_q[k], poses_r[k])
    return yaw


def com_overlap_yaw_all(
    scan_paths: Sequence[str],
    poses: np.ndarray,
    query_idxs: Sequence[int] | None = None,
    leg_output_width: int = 360,
    chunk_size: int = 256,
    max_points: int = DEFAULT_MAX_POINTS,
    io_workers: int = 16,
    points: np.ndarray | None = None,
    device="cuda",
) -> np.ndarray:
    """Ground-truth overlap and yaw for queries x all frames.

    Args:
      query_idxs: query frame ids (default: every frame, the full N x N GT
        table the training pipeline needs).
      points: optional pre-loaded (N, P, 4) padded scans (skips disk).
      device: where the scans live and the pairs are scored ("cuda" by
        default; raises without a card).

    Returns an (len(query_idxs) * n, 4) float64 array with rows
    [query_idx, reference_idx, overlap, yaw_bin], the row contract of
    reference com_overlap_yaw.py:10-68, concatenated over queries.

    One small early fetch (each frame's max point radius, for the far-pair
    gate); then every chunk is enqueued before one fetch of all results.
    """
    device = resolve_device(device)
    n = len(scan_paths)
    if query_idxs is None:
        query_idxs = range(n)
    query_idxs = np.asarray(list(query_idxs), np.int32)
    with span("gt.call"):
        count("gt.calls")
        with span("gt.prepare"):
            if points is None:
                points = load_scans_padded(scan_paths, max_points, io_workers)
            pts_dev = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)

            # per-frame range images, valid counts and radii, in chunks of scans
            ranges, valids, radii = [], [], []
            for s in range(0, n, chunk_size):
                r, v, rad = ranges_chunk(pts_dev[s : s + chunk_size])
                ranges.append(r)
                valids.append(v)
                radii.append(rad)
            ranges_dev, valid_dev = torch.cat(ranges), torch.cat(valids)
            # the one early sync: per-frame max point radius for the far-pair gate
            radius_host = torch.cat(radii).cpu().numpy().astype(np.float64)
            planes = tuple(pts_dev[..., i].contiguous() for i in range(3))
            del pts_dev

            q_ids = np.repeat(query_idxs, n).astype(np.int32)
            r_ids = np.tile(np.arange(n, dtype=np.int32), len(query_idxs))
            n_pairs = len(q_ids)
            inv_poses = np.linalg.inv(poses)

            # Exact far-pair gate: every reference point sits within radius R of the
            # reference origin, so its depth in the query frame is >= |t| - R; if
            # that already exceeds the projection's max_range, no re-projected point
            # is valid and the overlap is identically zero (reference utils.py:76
            # range filter): skip it. The 1 m slack absorbs the f32 round-off between
            # this f64 host check and the device. |R_q^T (t_r - t_q)| == |t_r - t_q|:
            # the gate needs only translation norms.
            t_norm = np.linalg.norm(poses[r_ids][:, :3, 3] - poses[q_ids][:, :3, 3], axis=1)
            live_pos = np.flatnonzero(t_norm - radius_host[r_ids] < MAX_RANGE + 1.0)
        count("gt.pairs", n_pairs)
        count("gt.live_pairs", len(live_pos))

        overlaps = np.zeros(n_pairs)
        if len(live_pos):
            def dev(a, dtype):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

            with span("gt.dispatch"):
                chunks = dispatch_chunks(
                    planes, ranges_dev, valid_dev, dev(q_ids[live_pos], torch.int64),
                    dev(r_ids[live_pos], torch.int64), dev(inv_poses, torch.float64),
                    dev(poses, torch.float64), chunk_size)
            with span("gt.fetch"):  # the single fetch of all chunk results
                live = torch.cat(chunks).cpu().numpy()
            overlaps[live_pos] = live
            count("gt.nonzero_pairs", int(np.count_nonzero(live > 0)))

        with span("gt.yaw_table"):
            yaws = _relative_yaws(poses[q_ids], poses[r_ids])
            half = leg_output_width // 2
            yaw_bins = np.trunc(-(yaws / np.pi) * half + half)

            gt = np.zeros((n_pairs, 4))
            gt[:, 0] = q_ids
            gt[:, 1] = r_ids
            gt[:, 2] = overlaps
            gt[:, 3] = yaw_bins
            return gt


def com_overlap_yaw(
    scan_paths: Sequence[str],
    poses: np.ndarray,
    frame_idx: int,
    leg_output_width: int = 360,
    chunk_size: int = 32,
    max_points: int = DEFAULT_MAX_POINTS,
    io_workers: int = 8,
    points: np.ndarray | None = None,
    device="cuda",
) -> np.ndarray:
    """Ground truth overlap and yaw of one frame vs. all frames.

    Same contract as reference com_overlap_yaw.py:10-68. Returns an (n, 4)
    array with rows [current_frame_idx, reference_frame_idx, overlap, yaw_bin].
    The scalar ``yaw_to_bin`` is kept for the single-query path so the
    reference's exact int() truncation applies; the vectorized path in
    :func:`com_overlap_yaw_all` uses np.trunc (bit-identical for the
    attainable range).
    """
    gt = com_overlap_yaw_all(
        scan_paths,
        poses,
        query_idxs=[frame_idx],
        leg_output_width=leg_output_width,
        chunk_size=chunk_size,
        max_points=max_points,
        io_workers=io_workers,
        points=points,
        device=device,
    )
    # re-derive bins through the scalar reference formula (exactness guard)
    for i in range(len(gt)):
        gt[i, 3] = yaw_to_bin(relative_yaw(poses[frame_idx], poses[int(gt[i, 1])]),
                              leg_output_width)
    return gt

