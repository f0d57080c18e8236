"""Device microseconds of the heads per scored pair in the traced window:
the program's ``model.heads`` device span (CUDA events around each head
call on its stream, launch gaps included) over its ``model.pairs`` counter.
None off a card, or where the program keeps no such record."""

from benchmark import program_trace


def read(run, trace):
    rec = program_trace.record()
    if rec is None or not program_trace.on_card(run, trace):
        return None
    ms, pairs = rec["device_ms"].get("model.heads"), rec["counts"].get("model.pairs", 0)
    if ms is None or pairs <= 0:
        return None
    return 1e3 * ms / pairs
