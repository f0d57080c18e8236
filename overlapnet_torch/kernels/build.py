"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled for Hopper (``sm_90a``) into ``overlapnet_torch/_build/<hash>/``,
keyed by a hash of the source, and loaded as a shared library. A failed
build raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

from overlapnet_torch.core.profiling import count, span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, digest[:16], f"lib{name}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path. nvcc's ``-Xptxas -v`` report (registers,
    shared memory, spills) is kept beside the library as ``.log``."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v",
           "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    with span("kernels.build"):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    count("kernels.builds")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    with open(out[: -len(".so")] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build_all() -> dict[str, str]:
    """Build every ``csrc/*.cu`` at once, one nvcc process each; returns
    {name: library path}."""
    names = sorted(f[: -len(".cu")] for f in os.listdir(CSRC) if f.endswith(".cu"))
    with ThreadPoolExecutor(len(names)) as ex:
        return dict(zip(names, ex.map(build, names)))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(build(name))
