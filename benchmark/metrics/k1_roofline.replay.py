"""K1's share of its roofline in the traced window: the least time of the
operations and bytes of every K1 call the window's frames made (one call
per chunk of at most 256 candidates, counted from the shapes), over the
time of K1's kernel rows (the weight split and the kernel)."""

from benchmark import accounting as acc
from benchmark.reference.model import geometry

ROWS = ("delta_conv1_kernel", "split_weight_kernel")


def read(run, trace):
    g = geometry(run.config)
    w, s, c = g["out_width"], g["stride"], 128
    chunks = trace.counts.get("chunks", [])
    flops = sum(b * acc.k1_flops_per_pair(w, c, s) for b in chunks)
    moved = sum(acc.k1_bytes(b, 1, w, c, s) for b in chunks)
    kernel_s = sum(e - st for n, st, e in trace.device if any(r in n for r in ROWS)) / 1e6
    return acc.share_percent(acc.least_time_s({"tf32": flops}, moved), kernel_s)
