"""K4's share of its roofline in the traced window: the least time of the
window's K4 work over the time of K4's device rows (names holding
``c_conv3_dense``: the weight's rounding, the kernel and the per-pair sums).

The least time is the larger of c_conv3's operations at the TF32 rate and
the bytes at the memory peak, each input, weight and output byte once:
X, (J, J, 128) float32 a pair; c_conv3's weight and bias and the dense's
weight and bias once a call; one float32 overlap a pair. Pairs and calls
come from the program's record (``model.pairs``, ``k4.launches``), J from
the cell's configuration. None off a card, and None unless the record
shows K4 launched once for every head call (``k4.launches`` =
``model.head_calls``): a program without K4 gives nothing here.
"""

from benchmark import accounting as acc
from benchmark import program_trace
from benchmark.reference.model import geometry

ROWS = ("c_conv3_dense",)
CIN, COUT, TAPS = 128, 256, 9


def k4_flops_per_pair(j: int) -> float:
    """c_conv3 on one pair: (J-2)^2 output rows x 256 channels x 1,152
    multiply-adds (the bias, ReLU and dense are not counted)."""
    return 2.0 * (j - 2) * (j - 2) * COUT * TAPS * CIN


def k4_bytes(pairs: int, calls: int, j: int) -> float:
    """K4's inputs and outputs once: X for every pair, the weights once a
    call, one overlap a pair."""
    weights = COUT * CIN * TAPS + COUT + (j - 2) * (j - 2) * COUT + 1
    return acc.F32 * (pairs * j * j * CIN + calls * weights + pairs)


def read(run, trace):
    rec = program_trace.record()
    if rec is None or not program_trace.on_card(run, trace):
        return None
    counts = rec["counts"]
    calls, pairs = counts.get("k4.launches", 0), counts.get("model.pairs", 0)
    if calls <= 0 or pairs <= 0 or calls != counts.get("model.head_calls", 0):
        return None
    j = geometry(run.config)["grid"]
    kernel_s = sum(e - s for n, s, e in trace.device if any(r in n for r in ROWS)) / 1e6
    least = acc.least_time_s({"tf32": pairs * k4_flops_per_pair(j)}, k4_bytes(pairs, calls, j))
    return acc.share_percent(least, kernel_s)
