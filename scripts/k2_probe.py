#!/usr/bin/env python3
"""What bounds K2 (``overlapnet_torch/csrc/delta_conv1_bwd.cu``) on a CUDA card.

Run from the root of the repository, on a machine with the card and nvcc:

    python3 scripts/k2_probe.py

It builds the kernel's source and variants made from it by text edits, one
nvcc process each, and times each through the port's wrapper at W' = 360,
B = 16 and 32, in three forms: both products, P1 alone (da and db) and P2
alone (dW, the frozen-legs form), with CUDA events, in turns (each variant,
then all again in reverse order). Every variant is printed with its ptxas
lines, its HGMMA count in ``cuobjdump -sass`` and its times; the variants
that compute K2 are also held to the plain version and, on two batch
elements, to the plain version in fp64. The unedited kernel's device time by
kernel row (the pre-pass, the two products, the ordered sums) comes from
``torch.profiler``.

- ``kernel``: the source as it is;
- ``p1_mma_only``: P1 without its epilogue (no mask, no sums, nothing
  written): the TMA ring and the wgmma alone;
- ``p1_no_mask``: P1's epilogue sums the accumulators without sign(a - bb);
- ``p2_mma_only``: P2 with constant A fragments (no |a - bb| formed or
  split): the TMA ring and the wgmma alone;
- ``p2_form_only``: P2's fragments formed, no wgmma (the fragments are summed
  on the CUDA cores so that nothing is dead code);
- ``flush_16`` / ``flush_64`` / ``flush_never``: P2's accumulators flushed
  into fp32 sums every 16 / 64 left rows, or only at the end, instead of
  every 4 (time against error).

Numbers from these variants are diagnostics, not results of the port.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
C, S, F, W = 128, 15, 64, 360
COMPUTES_K2 = ("kernel", "flush_16", "flush_64", "flush_never")


def edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"k2_probe: the kernel source changed; not found once:\n{old}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    out = {"kernel": src}
    out["p1_mma_only"] = edit(
        src, "#pragma unroll\n      for (int il = 0; il < TI; ++il) {\n        float sum[2]",
        "      if (width < 0)  // never: keeps the accumulators live\n#pragma unroll\n"
        "      for (int il = 0; il < TI; ++il) {\n        float sum[2]")
    out["p1_no_mask"] = edit(src, "  return d > 0.f ? x : (d < 0.f ? -x : 0.f);",
                             "  return d == 12345.f ? 0.f : x;")
    form = """        const float d = a[il][h] - bv[q][u][h];
        hi[st][2 * u + h] = tf32_rna_abs(d);
        lo[st][2 * u + h] = tf32_rna_bits(fabsf(d) - __uint_as_float(hi[st][2 * u + h]));
"""
    out["p2_mma_only"] = edit(src, form, """        hi[st][2 * u + h] = 0x3f000000u + (uint32_t)(cc + il + q + u + h) * 8192u;
        lo[st][2 * u + h] = 0x30000000u + (uint32_t)(cc + q + h) * 8192u;
""")
    i = src.index("        wgmma_fence();\n", src.index("dw_kernel("))
    j = src.index("        wgmma_commit();\n", i)
    out["p2_form_only"] = src[:i] + """#pragma unroll
        for (int st = 0; st < 4; ++st)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * st + e] += __uint_as_float(hi[st][e]) + __uint_as_float(lo[st][e]) +
                               __uint_as_float(g_hi + g_lo);
""" + src[j:]
    for name, rows in (("flush_16", "16"), ("flush_64", "64"), ("flush_never", "1 << 28")):
        out[name] = edit(src, "constexpr int FLUSH_ROWS = 4;", f"constexpr int FLUSH_ROWS = {rows};")
    return out


def build_variant(name: str, src: str, build) -> tuple[str, str]:
    d = os.path.join(build.BUILD_DIR, "probe_k2")
    os.makedirs(d, exist_ok=True)
    cu, so = os.path.join(d, f"{name}.cu"), os.path.join(d, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return so, proc.stdout + proc.stderr


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device is visible", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from overlapnet_torch.kernels import build
    from overlapnet_torch.kernels import delta_conv1 as k1
    from overlapnet_torch.ops import delta as plain

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with open(os.path.join(build.CSRC, "delta_conv1_bwd.cu")) as f:
        srcs = variants(f.read())
    with ThreadPoolExecutor(len(srcs)) as ex:
        built = dict(zip(srcs, ex.map(lambda kv: build_variant(*kv, build), srcs.items())))
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    entries = {}
    for name, (so, log) in built.items():
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
        lines = log.splitlines()
        ptxas = {}
        for n, ln in enumerate(lines):  # the W' = 360 instantiations (JB = 3)
            for kern in ("dab_kernelILi3", "dw_kernelILi3"):
                if "Compiling entry function" in ln and kern in ln:
                    ptxas[kern] = [x.strip() for x in lines[n + 1:n + 4] if "Used" in x or "spill" in x]
        print(json.dumps({"variant": name, "ptxas": ptxas, "hgmma": sass.count("HGMMA")}), flush=True)
        fn = ctypes.CDLL(so).delta_conv1_backward
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn

    def time_ms(run, iters=20):
        for _ in range(3):
            run()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    forms = {"both": dict(), "p1": dict(need_kernel=False), "p2": dict(need_volumes=False)}
    for bsz in (16, 32):
        rng = np.random.default_rng(bsz)
        j = W // S
        a, b = (torch.from_numpy(np.maximum(rng.normal(size=(bsz, W, C)), 0)
                                 .astype(np.float32)).cuda() for _ in range(2))
        limit = np.sqrt(6.0 / (S * C + S * F))
        kern = torch.from_numpy(rng.uniform(-limit, limit, size=(S, C, F)).astype(np.float32)).cuda()
        g = torch.from_numpy(rng.normal(size=(bsz, W, j, F)).astype(np.float32)).cuda()
        ref = plain.delta_conv1_backward(a, b, kern, g, stride=S)
        ref64 = plain.delta_conv1_backward(a[:2].double(), b[:2].double(), kern.double(),
                                           g[:2].double(), stride=S)
        times, errs = {}, {}
        for name in list(entries) + list(entries)[::-1]:
            k1._entry_bwd = lambda fn=entries[name]: fn
            for form, kw in forms.items():
                run = lambda: k1.delta_conv1_backward(a, b, kern, g, stride=S, **kw)  # noqa: E731
                times.setdefault((name, form), []).append(time_ms(run))
            if name in COMPUTES_K2 and name not in errs:
                got = k1.delta_conv1_backward(a, b, kern, g, stride=S)
                got2 = k1.delta_conv1_backward(a[:2], b[:2], kern, g[:2], stride=S)
                torch.cuda.synchronize()
                errs[name] = {
                    "err_over_scale_vs_plain": {
                        what: float((x - y).abs().max() / y.abs().max())
                        for what, x, y in zip(("da", "db", "dkernel"), got, ref)},
                    "err_over_scale_vs_fp64_2_elements": {
                        what: float((x.double() - y).abs().max() / y.abs().max())
                        for what, x, y in zip(("da", "db", "dkernel"), got2, ref64)}}
        for name in entries:
            row = {"w": W, "batch": bsz, "variant": name,
                   "ms": {form: times[(name, form)] for form in forms}, "card": smi}
            row.update(errs.get(name, {}))
            print(json.dumps(row), flush=True)
        plain2 = plain.delta_conv1_backward(a[:2], b[:2], kern, g[:2], stride=S)
        print(json.dumps({"w": W, "batch": bsz, "plain_fp32_err_over_scale_vs_fp64_2_elements": {
            what: float((x.double() - y).abs().max() / y.abs().max())
            for what, x, y in zip(("da", "db", "dkernel"), plain2, ref64)}}), flush=True)

        # the unedited kernel's device time by kernel row
        k1._entry_bwd = lambda fn=entries["kernel"]: fn
        for _ in range(3):
            k1.delta_conv1_backward(a, b, kern, g, stride=S)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                k1.delta_conv1_backward(a, b, kern, g, stride=S)
            torch.cuda.synchronize()
        rows = sorted(((e.key[:70], e.count, e.self_device_time_total / 1e4)
                       for e in prof.key_averages()
                       if e.self_device_time_total > 0 and e.device_type.name == "CUDA"),
                      key=lambda r: -r[2])
        print(json.dumps({"w": W, "batch": bsz, "device_ms_per_call_by_kernel_row": rows,
                          "sum_ms": sum(r[2] for r in rows), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
