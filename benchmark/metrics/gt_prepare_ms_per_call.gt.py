"""The fixed cost of a ground-truth call: the mean length, in
milliseconds, of the window's ``gt.prepare`` spans (the upload, the range
images, the fetch of the radii, which waits for the device, and the
far-pair gate). The span ends after that wait, so its host time is wall
time. None where the program has no such span."""

from benchmark import program_trace


def read(run, trace):
    calls = program_trace.spans(trace, "gt.prepare")
    if not calls:
        return None
    return sum(e - s for s, e in calls) / len(calls) / 1e3
