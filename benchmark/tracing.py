"""The traced window: torch.profiler over the window, the benchmark's own
spans around its calls into the program, and the reductions from them.

A span is ``record_function("bench.<name>")`` in the traced run, so it lands
in the same timeline as the device's kernel and copy rows; untraced runs
pay nothing for it. Readers in ``benchmark/metrics`` see a ``Trace``.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch

SPAN_PREFIX = "bench."


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def clipped(intervals: list[tuple[float, float]], lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(clipped(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


@dataclass
class Trace:
    """What a traced window leaves, in microseconds on the profiler's clock:
    device rows (kernels, copies, sets) as (name, start, end), host
    operator rows likewise, the benchmark's spans, the window's bounds, and
    the counts the driver kept."""

    device: list[tuple[str, float, float]] = field(default_factory=list)
    host_ops: list[tuple[str, float, float]] = field(default_factory=list)
    spans: list[tuple[str, float, float]] = field(default_factory=list)
    start_us: float = 0.0
    end_us: float = 0.0
    counts: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def device_intervals(self, names=None):
        return [(s, e) for n, s, e in self.device if names is None or any(k in n for k in names)]

    def busy_s(self, names=None) -> float:
        return union_length(clipped(self.device_intervals(names), self.start_us,
                                    self.end_us)) / 1e6

    def top_device_ops(self, k: int = 10) -> list[list]:
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps_by_host(self, k: int = 10, longest: int = 2000) -> list[list]:
        """Device idle time in the window's ``longest`` gaps, summed by the
        latest-starting host row (operator or span) that covers each gap's
        middle: the innermost one on the thread that launches."""
        hosts = sorted(self.host_ops + self.spans, key=lambda r: r[1])
        starts = [h[1] for h in hosts]
        found = sorted(gaps(self.device_intervals(), self.start_us, self.end_us),
                       key=lambda g: g[0] - g[1])[:longest]
        by = {}
        for s, e in found:
            mid = 0.5 * (s + e)
            name = "(no host row)"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - 2000), -1):
                if hosts[j][2] >= mid:
                    name = hosts[j][0]
                    break
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]


class Tracer:
    """Spans for the drivers; a profiler over the window when ``enabled``."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.trace: Trace | None = None
        self._prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        if self.enabled:
            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        """The measured window: the profiler (when enabled) starts before
        and stops after it, and a span named ``window`` marks its bounds."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):  # the profiler's own start-up, outside the window
            self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        try:
            with torch.profiler.record_function(SPAN_PREFIX + "window"):
                yield
                self._sync()
        finally:
            self._prof.__exit__(None, None, None)
        self.trace = self._reduce(self._prof)

    @staticmethod
    def _reduce(prof) -> Trace:
        """Rows of the raw profiler results (no event tree is built), in
        microseconds from the first row."""
        tr = Trace()
        raw = prof.profiler.kineto_results.events()
        base = min((ev.start_ns() for ev in raw), default=0)
        for ev in raw:
            name = ev.name()
            s = (ev.start_ns() - base) / 1e3
            e = s + ev.duration_ns() / 1e3
            on_device = ev.device_type().name == "CUDA"
            if on_device and (name.startswith(SPAN_PREFIX) or ev.is_user_annotation()):
                continue  # a span's mark on the device's timeline, not work
            if on_device:
                tr.device.append((name, s, e))
            elif name == SPAN_PREFIX + "window":
                tr.start_us, tr.end_us = s, e
            elif name.startswith(SPAN_PREFIX):
                tr.spans.append((name, s, e))
            else:
                tr.host_ops.append((name, s, e))
        return tr
