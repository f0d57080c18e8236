"""What the readers of the program's own spans and counters share.

The program (``overlapnet_torch.core.profiling``) marks its stages with
``record_function`` rows, which the traced window keeps among its host rows
(``Trace.host_ops``) on the clock of the device's rows, and keeps a record
of the traced stretch: its counters and the device milliseconds of its
device spans. A program without them gives nothing here, and its readers
return None.
"""

from __future__ import annotations

import bisect

from benchmark.tracing import clipped, gaps, union_length

# Host rows of the CUDA runtime and driver calls that put one row each on the
# device: cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, cudaMemsetAsync...
LAUNCH = ("Launch", "Memcpy", "Memset")


def record() -> dict | None:
    """The program's record of the traced window, or None when the program
    keeps none."""
    try:
        from overlapnet_torch.core.profiling import record as program_record
    except ImportError:
        return None
    return program_record()


def on_card(run, trace) -> bool:
    """Whether the run's device is a card and the trace holds device rows."""
    return run.device.type == "cuda" and bool(trace.device)


def spans(trace, name: str) -> list[tuple[float, float]]:
    """(start, end) in microseconds of the program's ``name`` rows."""
    return [(s, e) for n, s, e in trace.host_ops if n == name]


def idle_us(trace, intervals: list[tuple[float, float]]) -> list[float]:
    """For each (start, end), the microseconds inside it and the window in
    which no device row ran."""
    idle = gaps(trace.device_intervals(), trace.start_us, trace.end_us)
    return [union_length(clipped(idle, lo, hi)) for lo, hi in intervals]


def launched_rows(trace, intervals: list[tuple[float, float]]) -> list[list | None]:
    """For each host (start, end), the device rows, as (start, end), of the
    launches made inside it; all None where the window's launches and rows
    differ in number (a graph's one launch of many rows, a call missed).

    The k-th launch of the window made the k-th row to start, as one stream
    runs its rows in the order they were launched. Rows are paired by order,
    not by time: the profiler's device clock strays from its host clock by
    tens of microseconds, some hundreds at times.
    """
    calls = sorted(s for n, s, _ in trace.host_ops
                   if n.startswith("cu") and any(k in n for k in LAUNCH) and "HostFunc" not in n)
    rows = sorted((s, e) for _, s, e in trace.device)
    if len(calls) != len(rows):
        return [None] * len(intervals)
    return [rows[bisect.bisect_left(calls, lo):bisect.bisect_right(calls, hi)]
            for lo, hi in intervals]
