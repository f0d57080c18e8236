"""Device milliseconds of the legs per scan in the traced window: the
union of the device rows launched inside the program's ``model.legs`` spans
(``OverlapNet.encode``), over its ``model.scans`` counter. The rows' own
lengths, not the stream's time from the first launch to the last: the legs
are launch-bound, and the profiler slows the launches, not the rows. None
off a card, where the program has no such span or record, or where the
window's launches cannot be paired with its rows
(``program_trace.launched_rows``)."""

from benchmark import program_trace
from benchmark.tracing import union_length


def read(run, trace):
    if not program_trace.on_card(run, trace):
        return None
    legs = program_trace.spans(trace, "model.legs")
    rec = program_trace.record()
    scans = rec["counts"].get("model.scans", 0) if rec else 0
    rows = program_trace.launched_rows(trace, legs)
    if not legs or scans <= 0 or rows[0] is None:
        return None
    return sum(union_length(r) for r in rows) / scans / 1e3
