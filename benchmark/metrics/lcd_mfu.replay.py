"""The frame step's share of the chip's peak in the traced window: the
least time of the model's operations over the window's frames (one scan
through the legs at the bfloat16 peak, every candidate pair through both
heads at the TF32 peak), over the traced window's length."""

from benchmark import accounting as acc
from benchmark.reference.model import geometry


def read(run, trace):
    g = geometry(run.config)
    frames, pairs = trace.counts.get("frames", 0), trace.counts.get("pairs", 0)
    legs = frames * acc.leg_flops_per_scan(g["height"], g["width"], g["channels"])
    heads = pairs * acc.head_flops_per_pair(g["out_width"], 128, g["stride"])
    return acc.share_percent(acc.least_time_s({"bf16": legs, "tf32": heads}), trace.window_s)
