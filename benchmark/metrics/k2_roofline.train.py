"""K2's share of its roofline in the traced window: the least time of the
operations and bytes of one K2 call per step (batch pairs, counted from
the shapes), over the time of K2's kernel rows (the weight and gradient
splits, both products and the ordered sums)."""

from benchmark import accounting as acc
from benchmark.reference.model import geometry

ROWS = ("split_w_kernel", "split_g_kernel", "dab_kernel", "dw_kernel", "sum_axis_kernel")


def read(run, trace):
    g = geometry(run.config)
    w, s, c = g["out_width"], g["stride"], 128
    steps, batch = trace.counts.get("steps", 0), trace.counts.get("batch", 0)
    flops = steps * batch * acc.k2_flops_per_pair(w, c, s)
    moved = steps * acc.k2_bytes(batch, w, c, s)
    kernel_s = sum(e - st for n, st, e in trace.device if any(r in n for r in ROWS)) / 1e6
    return acc.share_percent(acc.least_time_s({"tf32": flops}, moved), kernel_s)
