"""Offline preprocessing: scan folders -> projected channel images (.npy).

The JAX package's ``geometry/gen_data.py`` (batch equivalents of reference
src/utils/gen_{depth,normal,intensity,semantic}_data.py) in PyTorch: a thread
pool streams the .bin files from disk, scans are padded to a fixed point
count and projected K at a time on the device (``range_projection`` and
``normal_map`` batch over K; the last chunk is simply shorter). Output file
layout and values as the reference's (same names, same -1 empty-pixel
convention):

  <dst>/depth/<name>.npy      (H, W)      float32 range, -1 empty
  <dst>/normal/<name>.npy     (H, W, 3)   float32 normals, -1 invalid
  <dst>/intensity/<name>.npy  (H, W)      float32 remission, -1 empty
  <dst>/semantic/<name>.npy   (H, W, 20)  float32 probabilities, -1 empty

Naming: depth/normal/intensity use the running index like gen_depth_data.py
(:41); semantic uses the scan basename (gen_semantic_data.py:48-50); both
agree on standard KITTI folders (files are already %06d-ordered).

Every writer takes ``device`` ("cuda" by default; raises without a card)
besides the JAX writers' keywords (chunk_size, max_points, io_workers).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np
import torch

from overlapnet_torch.core.device import resolve_device
from overlapnet_torch.geometry.kitti import load_files, load_scan
from overlapnet_torch.geometry.projection import (
    DEFAULT_MAX_POINTS,
    normal_map,
    pad_points,
    range_projection,
    semantic_projection,
)


def _project_chunk(points: torch.Tensor, max_range: float = 50.0):
    """(K, N, 4) padded scans -> (range (K,H,W), normal (K,H,W,3),
    intensity (K,H,W), idx (K,H,W)), on the points' device."""
    r, v, inten, idx = range_projection(points, max_range=max_range)
    return r, normal_map(r, v), inten, idx


def _run_batched(
    scan_paths: Sequence[str],
    consume: Callable[[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray], None],
    chunk_size: int = 8,
    max_points: int = DEFAULT_MAX_POINTS,
    io_workers: int = 8,
    max_range: float = 50.0,
    device="cuda",
) -> None:
    """Stream scans from disk, project on the device in chunks, hand each
    frame's host results to ``consume(idx, range, normal, intensity,
    proj_idx)``."""
    device = resolve_device(device)

    def load(path):
        return pad_points(load_scan(path).astype(np.float32), max_points)

    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        loaded = pool.map(load, scan_paths)
        chunk, ids = [], []

        def flush():
            if not ids:
                return
            batch = torch.from_numpy(np.stack(chunk)).to(device)
            out = [t.cpu().numpy() for t in _project_chunk(batch, max_range=max_range)]
            for j, i in enumerate(ids):
                consume(i, *(a[j] for a in out))
            chunk.clear()
            ids.clear()

        for i, pts in enumerate(loaded):
            chunk.append(pts)
            ids.append(i)
            if len(ids) == chunk_size:
                flush()
        flush()


def _dst(dst_folder: str, kind: str) -> str:
    out = os.path.join(dst_folder, kind)
    os.makedirs(out, exist_ok=True)
    return out


def gen_depth_data(
    scan_folder: str, dst_folder: str, normalize: bool = False, **kw
) -> list[str]:
    """Range images for every scan (reference gen_depth_data.py:10-47)."""
    out = _dst(dst_folder, "depth")
    scan_paths = load_files(scan_folder)
    written = []

    def consume(i, r, n, inten, idx):
        img = r / np.max(r) if normalize else r
        path = os.path.join(out, str(i).zfill(6))
        np.save(path, img)
        written.append(path + ".npy")

    _run_batched(scan_paths, consume, **kw)
    return written


def gen_normal_data(scan_folder: str, dst_folder: str, **kw) -> list[str]:
    """Normal maps for every scan (reference gen_normal_data.py:10-44)."""
    out = _dst(dst_folder, "normal")
    scan_paths = load_files(scan_folder)
    written = []

    def consume(i, r, n, inten, idx):
        path = os.path.join(out, str(i).zfill(6))
        np.save(path, n)
        written.append(path + ".npy")

    _run_batched(scan_paths, consume, **kw)
    return written


def gen_intensity_data(scan_folder: str, dst_folder: str, **kw) -> list[str]:
    """Remission images for every scan (reference gen_intensity_data.py:10-41)."""
    out = _dst(dst_folder, "intensity")
    scan_paths = load_files(scan_folder)
    written = []

    def consume(i, r, n, inten, idx):
        path = os.path.join(out, str(i).zfill(6))
        np.save(path, inten)
        written.append(path + ".npy")

    _run_batched(scan_paths, consume, **kw)
    return written


def gen_semantic_data(
    semantic_folder: str, scan_folder: str, dst_folder: str, num_classes: int = 20, **kw
) -> list[str]:
    """Semantic probability images (reference gen_semantic_data.py:11-57):
    per-point (N, 20) probabilities gathered through the projection's winning
    point index, with max_range=inf. The projection runs on ``device``; the
    gather runs on the host, where the probabilities were read."""
    out = _dst(dst_folder, "semantic")
    prob_paths = load_files(semantic_folder)
    scan_paths = load_files(scan_folder)
    written = []

    def consume(i, r, n, inten, idx):
        probs = np.fromfile(prob_paths[i], dtype=np.float32).reshape((-1, num_classes))
        img = semantic_projection(torch.from_numpy(probs), torch.from_numpy(idx),
                                  num_classes).numpy()
        base = os.path.basename(scan_paths[i]).replace(".bin", "")
        path = os.path.join(out, base)
        np.save(path, img)
        written.append(path + ".npy")

    _run_batched(scan_paths, consume, max_range=float("inf"), **kw)
    return written
