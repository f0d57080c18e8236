"""The share of the pairs past the far-pair gate whose overlap came out
above 0, in the traced window: the program's ``gt.nonzero_pairs`` over its
``gt.live_pairs`` counter. A live pair of overlap 0 is computed for
nothing. None where the program keeps no such record."""

from benchmark import program_trace


def read(run, trace):
    rec = program_trace.record()
    if rec is None:
        return None
    live = rec["counts"].get("gt.live_pairs", 0)
    if live <= 0:
        return None
    return 100.0 * rec["counts"].get("gt.nonzero_pairs", 0) / live
