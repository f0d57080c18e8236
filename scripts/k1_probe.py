#!/usr/bin/env python3
"""What bounds K1 (``overlapnet_torch/csrc/delta_conv1.cu``) on a CUDA card.

Run from the root of the repository, on a machine with the card and nvcc:

    python3 scripts/k1_probe.py

It builds the kernel's source and variants made from it by text edits, one
nvcc process each, and times each through the port's wrapper at B = 32 and
W' = 360 and 450 (CUDA events, in turns: each variant, then all again in
reverse order). Every variant is printed with its ptxas line, its HGMMA count
in ``cuobjdump -sass`` and its times; the variants that compute K1 are also
held to the plain version and to an fp64 run on two pairs.

- ``kernel``: the source as it is;
- ``mma_only``: no fragments formed (constants instead), the wgmma as they
  are: the tensor cores' part alone;
- ``form_only``: the fragments formed, no wgmma (the fragments are summed on
  the CUDA cores so that nothing is dead code): the formation's part alone;
- ``ss_mma_only``: as ``mma_only``, but each wgmma reads A from shared memory
  (the weight tile stands in for it): the same products with both operands
  in shared memory;
- ``promote_every_3`` / ``_5`` / ``_15``: the fp32 tap sums taken every
  3 / 5 / 15 taps instead of every tap (time against error; at S = 15,
  ``_15`` sums the whole reduction in the tensor cores' accumulators).

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
C, S, F = 128, 15, 64


def edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"k1_probe: the kernel source changed; not found:\n{old}")
    return src.replace(old, new)


def consumer_span(src: str, start: str, end: str) -> tuple[int, int]:
    """[i, j) of the consumer path's text from ``start`` up to ``end``."""
    i = src.index(start, src.index("setmaxnreg.inc"))
    return i, src.index(end, i)


def variants(src: str) -> dict[str, str]:
    out = {"kernel": src}
    fi, fj = consumer_span(src, "#pragma unroll\n        for (int r = 0; r < 4; ++r) {\n"
                           "          const float* pa", "        const int s = q % STAGES;")
    out["mma_only"] = src[:fi] + """#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            hi[r][e] = 0x3f000000u + (uint32_t)(q + r + e) * 8192u;
            lo[r][e] = 0x30000000u + (uint32_t)(q + e) * 8192u;
          }
""" + src[fj:]
    mi, mj = consumer_span(src, "        wgmma_fence();\n", "        if (lane == 0) mbar_arrive")
    out["form_only"] = src[:mi] + """#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[r / 2][(r % 2) * 8 + e] += __uint_as_float(hi[r][e]) + __uint_as_float(lo[r][e]);
""" + src[mj:]
    ss_fn = """__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\\n .reg .pred p;\\n setp.ne.b32 p, %34, 0;\\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1;\\n}\\n"
      : """ + ", ".join(f'"+f"(d[{i}])' for i in range(32)) + """
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

"""
    ss = edit(out["mma_only"], "__device__ __forceinline__ void wgmma_fence()",
              ss_fn + "__device__ __forceinline__ void wgmma_fence()")
    si, sj = consumer_span(ss, "#pragma unroll\n        for (int st = 0; st < KC / 8; ++st) {",
                           "        wgmma_commit();")
    out["ss_mma_only"] = ss[:si] + """#pragma unroll
        for (int st = 0; st < KC / 8; ++st) {
          const uint64_t d_hi = kmajor_sw128_desc(w_hi + 32 * st);
          const uint64_t d_lo = kmajor_sw128_desc(w_lo + 32 * st);
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int t = 0; t < 2; ++t)
              wgmma_tf32_ss(acc[t], pass == 2 ? d_lo : d_hi, pass == 1 ? d_lo : d_hi);
        }
""" + ss[sj:]
    for every in (3, 5, 15):
        v = edit(src, "d_hi, c0 > 0 || st > 0);", f"d_hi, k % {every} > 0 || c0 > 0 || st > 0);")
        v = edit(v, "      fence_regs(acc[0]);\n      fence_regs(acc[1]);\n",
                 f"      if (k % {every} != {every - 1} && k + 1 < stride) continue;\n"
                 "      fence_regs(acc[0]);\n      fence_regs(acc[1]);\n")
        out[f"promote_every_{every}"] = edit(v, "          if (k > 0) {",
                                             f"          if (k >= {every}) {{")
    return out


def build_variant(name: str, src: str, build) -> tuple[str, str]:
    d = os.path.join(build.BUILD_DIR, "probe")
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
        print("k1_probe: no CUDA device is visible", file=sys.stderr)
        return 1
    from overlapnet_torch.kernels import build
    from overlapnet_torch.kernels import delta_conv1 as k1
    from overlapnet_torch.ops import delta as plain

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with open(os.path.join(build.CSRC, "delta_conv1.cu")) as f:
        srcs = variants(f.read())
    with ThreadPoolExecutor(len(srcs)) as ex:
        built = dict(zip(srcs, ex.map(lambda kv: build_variant(*kv, build), srcs.items())))
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    entries = {}
    for name, (so, log) in built.items():
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln]
        print(json.dumps({"variant": name, "ptxas_main_kernel": ptxas[:2],
                          "hgmma": sass.count("HGMMA")}), flush=True)
        fn = ctypes.CDLL(so).delta_conv1_forward
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
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

    computes_k1 = {"kernel", "promote_every_3", "promote_every_5", "promote_every_15"}
    for w in (360, 450):
        rng = np.random.default_rng(w)
        a, b = (torch.from_numpy(np.maximum(rng.normal(size=(32, w, C)), 0)
                                 .astype(np.float32)).cuda() for _ in range(2))
        limit = np.sqrt(6.0 / (S * C + S * F))
        kern = torch.from_numpy(rng.uniform(-limit, limit, size=(S, C, F)).astype(np.float32)).cuda()
        bias = torch.from_numpy(rng.normal(size=(F,)).astype(np.float32) * 0.1).cuda()
        ref = plain.delta_conv1(a, b, kern, bias, stride=S)
        ref64 = plain.delta_conv1(a[:2].double(), b[:2].double(), kern.double(),
                                  bias.double(), stride=S)
        times = {}
        for name in list(entries) + list(entries)[::-1]:
            k1._entry = lambda fn=entries[name]: fn
            run = lambda: k1.delta_conv1(a, b, kern, bias, stride=S)  # noqa: E731
            times.setdefault(name, []).append(time_ms(run))
            if name in computes_k1 and len(times[name]) == 1:
                out = run()
                torch.cuda.synchronize()
                times[name + ":err"] = (float((out - ref).abs().max()),
                                        float((out[:2].double() - ref64).abs().max()))
        for name in entries:
            row = {"w": w, "batch": 32, "variant": name, "ms": times[name], "card": smi}
            if name in computes_k1:
                row["max_abs_err_vs_plain"], row["max_abs_err_vs_fp64_2pairs"] = times[name + ":err"]
            print(json.dumps(row), flush=True)
        print(json.dumps({"w": w, "plain_vs_fp64_2pairs":
                          float((ref[:2].double() - ref64).abs().max())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
