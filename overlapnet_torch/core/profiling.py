"""Tracing and step-timing hooks.

The reference has no profiling of any kind (only keras ``verbose=1`` progress
bars, reference infer.py:156, testing.py:263). Here, after the JAX package's
``core/profiling.py``: a ``torch.profiler`` trace context that writes a
chrome trace and a table of device time by kernel, plus a lightweight step
timer that accumulates wall time and derives throughput counters without
forcing a device sync on every step.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace(out_dir: str | None):
    """torch.profiler over the block, written to ``out_dir`` as a chrome
    trace (``trace.json``, for Perfetto or chrome://tracing) and a table of
    device time by kernel (``key_averages.txt``); nothing when unset."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    with open(os.path.join(out_dir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))


@dataclass
class StepTimer:
    """Accumulate per-step wall times and derive items/s.

    Asynchronous-launch aware: ``stop`` waits for the device only when
    ``sync`` is passed (a tensor: the current stream of its device is
    synchronised, so the interval covers the work queued before it), and
    never otherwise, so a loop that fetches once per epoch pays nothing per
    step.
    """

    steps: int = 0
    items: int = 0
    total_s: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, items: int = 0, sync: torch.Tensor | None = None) -> float:
        if sync is not None and sync.device.type == "cuda":
            torch.cuda.current_stream(sync.device).synchronize()
        dt = time.perf_counter() - self._t0
        self.steps += 1
        self.items += items
        self.total_s += dt
        return dt

    @property
    def items_per_sec(self) -> float:
        return self.items / self.total_s if self.total_s > 0 else 0.0

    @property
    def sec_per_step(self) -> float:
        return self.total_s / self.steps if self.steps else 0.0

    def summary(self, prefix: str = "") -> dict:
        p = f"{prefix}_" if prefix else ""
        return {
            f"{p}steps": self.steps,
            f"{p}sec_per_step": self.sec_per_step,
            f"{p}items_per_sec": self.items_per_sec,
        }
