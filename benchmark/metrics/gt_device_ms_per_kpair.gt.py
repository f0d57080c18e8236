"""Device-busy milliseconds per 1,000 table pairs in the traced window (the
union of the device's rows over the completed calls' pairs)."""


def read(run, trace):
    pairs = trace.counts.get("pairs", 0)
    if pairs <= 0:
        return None
    return 1e3 * trace.busy_s() / (pairs / 1e3)
