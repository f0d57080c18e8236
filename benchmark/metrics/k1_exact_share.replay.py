"""Share of the traced window's K1 calls whose every pair took K1's exact
path (bf16 operands, three bf16 products): the program's ``k1.exact_calls``
device counter over its ``k1.launches`` counter, both from the window's record.
None off a card, or where the program keeps no such counter."""

from benchmark import program_trace


def read(run, trace):
    rec = program_trace.record()
    if rec is None or not program_trace.on_card(run, trace):
        return None
    calls, exact = rec["counts"].get("k1.launches", 0), rec["counts"].get("k1.exact_calls")
    if exact is None or calls <= 0:
        return None
    return 100.0 * exact / calls
