"""Spans, counters and the profiler trace of the port.

The reference has no profiling of any kind (only keras ``verbose=1`` progress
bars, reference infer.py:156, testing.py:263). Here the port's layers mark
their boundaries with two calls:

- ``span(name)`` around a stage. With no ``torch.profiler`` session active it
  is one flag check and a shared no-op context. Under a profiler it is
  ``torch.profiler.record_function(name)``: a row of the profiler's own
  timeline, on the clock of the device's kernel and copy rows, so the
  device's idle stretches fall under the stage that left them. With
  ``device=True`` it also records a pair of CUDA events on the current
  stream around the block; their elapsed time is taken only when the
  record is read, so the span adds no host synchronisation.
- ``count(name, n)`` adds to the process's totals (always on, one dict
  add, for operators and ``chip_smoke.py``) and, under a profiler, to the
  record of the traced stretch.
- ``device_counter(name, device)`` is a counter that a kernel adds to on
  the device, for what only the device knows (which path K1 took). The
  host never waits for it on the way: ``totals()`` and ``record()`` copy
  it to the host when they are read, and only then.

``record()`` gives the current traced stretch's counts and each device
span's total device milliseconds. A stretch starts at the first span or
count made under a profiler when none is open, and at the start of
``trace``; it ends when the thread that started it makes a span or count
with no profiler active, or when the record is read. So the record holds
one stretch's events also when a process traces several. The profiler's
state is per thread: a thread it does not cover (a build pool, the online
loop's resolver) neither ends a stretch nor adds to its record.

``trace(out_dir)`` runs the profiler over a block and writes ``trace.json``
(a chrome trace, for Perfetto or chrome://tracing), ``key_averages.txt``
(device time by kernel) and ``record.json`` (the record).

The names (PERF.md, section 3, lists each with the metric or use that
reads it): ``lcd.*`` the online loop and the serving engine, ``db.*`` the
descriptor store, ``model.*`` the legs and heads, ``k1.*``/``k2.*``/
``k3.*``/``kernels.*`` the CUDA kernels and their build, ``gt.*`` the ground-truth
engine, ``train.*`` the training loop.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading

import torch

_NO_SPAN = contextlib.nullcontext()


class _Tally:
    """The process's totals and the current traced stretch's record."""

    def __init__(self):
        self.lock = threading.Lock()
        self.totals: dict[str, int] = {}
        self.counts: dict[str, int] = {}
        self.events: dict[str, list] = {}  # device span -> [(start, end) CUDA events]
        self.owner: int | None = None  # the thread whose profiler opened the stretch
        # device counters, (name, device) -> int64 tensor; and each one's
        # value where the stretch first used it (a copy on the device)
        self.device: dict[tuple[str, str], torch.Tensor] = {}
        self.bases: dict[tuple[str, str], torch.Tensor] = {}

    def restart(self) -> None:
        """Open a fresh stretch, owned by the calling thread; under ``lock``."""
        self.counts, self.events, self.bases = {}, {}, {}
        self.owner = threading.get_ident()


_tally = _Tally()


def _tracing() -> bool:
    """Whether a profiler covers the calling thread. Under one, with no
    stretch open, this call opens one; with none, on the thread that opened
    the open stretch, it ends it."""
    on = torch.autograd._profiler_enabled()
    if on:
        if _tally.owner is None:
            with _tally.lock:
                if _tally.owner is None:
                    _tally.restart()
    elif _tally.owner is not None and _tally.owner == threading.get_ident():
        with _tally.lock:
            _tally.owner = None
    return on


def span(name: str, device: bool = False):
    """A context marking a stage as ``name`` on the profiler's timeline;
    ``device`` also times the block on the current CUDA stream. A shared
    no-op context when no profiler is active."""
    if not _tracing():
        return _NO_SPAN
    return _traced_span(name, device)


@contextlib.contextmanager
def _traced_span(name: str, device: bool):
    with torch.profiler.record_function(name):
        if not device:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            with _tally.lock:
                _tally.events.setdefault(name, []).append((start, end))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``: to the process's totals, and to the
    record while a profiler covers the calling thread."""
    traced = _tracing()
    with _tally.lock:
        _tally.totals[name] = _tally.totals.get(name, 0) + n
        if traced:
            _tally.counts[name] = _tally.counts.get(name, 0) + n


def device_counter(name: str, device: torch.device | str) -> torch.Tensor:
    """The one-element int64 counter ``name`` on ``device``, zero at first
    use, for a kernel to add to. Under a profiler the traced stretch keeps
    a device-side copy of its value at the stretch's first use, so that
    ``record()`` gives what the stretch added; nothing waits for it here."""
    traced = _tracing()
    key = (name, str(torch.device(device)))
    with _tally.lock:
        t = _tally.device.get(key)
        if t is None:
            t = _tally.device[key] = torch.zeros(1, dtype=torch.int64, device=device)
        if traced and key not in _tally.bases:
            _tally.bases[key] = t.clone()
        return t


def _add_device(into: dict[str, int], pairs) -> None:
    """Adds each (name, value tensor) to ``into``: a copy to the host."""
    for name, value in pairs:
        into[name] = into.get(name, 0) + int(value.item())


def totals() -> dict[str, int]:
    """The process's counter totals since it started, device counters
    included (reading them waits for the work queued before)."""
    with _tally.lock:
        out, device = dict(_tally.totals), list(_tally.device.items())
    _add_device(out, ((name, t) for (name, _), t in device))
    return out


def record() -> dict:
    """The current traced stretch: ``{"counts": {name: n}, "device_ms":
    {span: total milliseconds}}``, the counts with what each device counter
    gained in the stretch. Reading it waits for the device spans' last
    events and the device counters, and ends the stretch: the next span or
    count under a profiler starts a fresh one."""
    with _tally.lock:
        _tally.owner = None
        counts, events = dict(_tally.counts), dict(_tally.events)
        grown = [(key[0], _tally.device[key] - base) for key, base in _tally.bases.items()]
    _add_device(counts, grown)
    device_ms = {}
    for name, pairs in events.items():
        total = 0.0
        for start, end in pairs:
            end.synchronize()
            total += start.elapsed_time(end)
        device_ms[name] = total
    return {"counts": counts, "device_ms": device_ms}


@contextlib.contextmanager
def trace(out_dir: str | None):
    """torch.profiler over the block, written to ``out_dir`` as a chrome
    trace (``trace.json``), a table of device time by kernel
    (``key_averages.txt``) and the block's record (``record.json``);
    nothing when unset."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with _tally.lock:
            _tally.restart()
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    with open(os.path.join(out_dir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    with open(os.path.join(out_dir, "record.json"), "w") as f:
        json.dump(record(), f, indent=1, sort_keys=True)
