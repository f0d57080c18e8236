"""The train step's share of the chip's peak in the traced window: the
least time of the forward and backward operations of every step (the legs
over both scans of each pair at the bfloat16 peak, both heads at the TF32
peak), over the traced window's length."""

from benchmark import accounting as acc
from benchmark.reference.model import geometry


def read(run, trace):
    g = geometry(run.config)
    steps, batch = trace.counts.get("steps", 0), trace.counts.get("batch", 0)
    legs = steps * 2 * batch * acc.leg_train_flops_per_scan(g["height"], g["width"],
                                                            g["channels"])
    heads = steps * batch * acc.head_train_flops_per_pair(g["out_width"], 128, g["stride"])
    return acc.share_percent(acc.least_time_s({"bf16": legs, "tf32": heads}), trace.window_s)
