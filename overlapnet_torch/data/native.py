"""ctypes bindings for the native data-path library (``native/batcher.cc``).

The JAX package's ``data/native.py`` with the same contract: multi-threaded
batch gathering with the circular-shift augmentation fused into the row copy
(``gather_batch``) and parallel KITTI scan reading (``read_scans``); numpy
does the same work when the library has not been built. ``build()`` compiles
the same ``native/batcher.cc`` with g++ and the flags of ``native/Makefile``
into the port's git-ignored ``overlapnet_torch/_build/native/<hash>/``,
keyed by a hash of the source and the flags, written atomically; nothing is
written into ``native/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "batcher.cc")
BUILD_DIR = os.path.join(_PKG, "_build", "native")
# native/Makefile's CXXFLAGS and LDFLAGS, with its opt-in -march=native: the
# library is built on the machine that uses it
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread"]

_lib = None
_lib_lock = threading.Lock()


def library_path() -> str:
    """Where ``build()`` puts the library for this source and these flags."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, digest[:16], "libovbatcher.so")


def build(force: bool = False) -> str:
    """Compile the native library (idempotent); returns its path."""
    out = library_path()
    if force or not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
        os.close(fd)
        try:
            subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, SOURCE],
                           check=True, capture_output=True)
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            return None
        lib = ctypes.CDLL(path)
        lib.ov_gather_batch.restype = ctypes.c_int
        lib.ov_gather_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.ov_read_scans.restype = ctypes.c_int
        lib.ov_read_scans.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def gather_batch(
    src: np.ndarray,
    idx: np.ndarray,
    shifts: np.ndarray | None = None,
    out: np.ndarray | None = None,
    n_threads: int = 8,
) -> np.ndarray:
    """dst[b] = np.roll(src[idx[b]], shifts[b], axis=1), native when built,
    numpy otherwise. The result is a fresh writable array (``src`` may be a
    read-only pack memmap).

    Args:
      src: (N, H, W, C) float32 C-contiguous (pack memmap or array).
      idx: (B,) integer rows.
      shifts: (B,) int column shifts or None.
    """
    idx = np.ascontiguousarray(idx, np.int64)
    b = len(idx)
    n, h, w, c = src.shape
    if out is None:
        out = np.empty((b, h, w, c), np.float32)
    lib = _load()
    if lib is None or src.dtype != np.float32 or not src.flags.c_contiguous:
        for k in range(b):
            img = src[idx[k]]
            out[k] = np.roll(img, int(shifts[k]), axis=1) if shifts is not None else img
        return out
    sh_ptr = None
    if shifts is not None:
        shifts = np.ascontiguousarray(shifts, np.int32)
        sh_ptr = shifts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    rc = lib.ov_gather_batch(
        _fptr(src), n, h, w, c,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sh_ptr, b, _fptr(out), n_threads,
    )
    if rc != 0:
        raise IndexError("ov_gather_batch: index out of range")
    return out


def read_scans(
    paths: list[str], max_points: int, n_threads: int = 8
) -> np.ndarray:
    """Parallel KITTI .bin reader -> (n, max_points, 4) float32 zero-padded
    (pad_points semantics). numpy does it when the library is absent."""
    n = len(paths)
    out = np.zeros((n, max_points, 4), np.float32)
    lib = _load()
    if lib is None:
        from overlapnet_torch.geometry.kitti import load_scan
        from overlapnet_torch.geometry.projection import pad_points

        for i, p in enumerate(paths):
            out[i] = pad_points(load_scan(p), max_points)
        return out
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.ov_read_scans(arr, n, _fptr(out), max_points, n_threads)
    if failures:
        raise IOError(f"ov_read_scans: {failures} files failed to read")
    return out
