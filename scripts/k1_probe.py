#!/usr/bin/env python3
"""What bounds K1 (``overlapnet_torch/csrc/delta_conv1.cu``) on a CUDA card.

Run from the root of the repository, on a machine with the card and nvcc:

    python3 scripts/k1_probe.py

It builds the kernel's source and variants made from it by text edits, one
nvcc process each, and times each through the port's wrapper (CUDA events,
in turns: each variant, then all again in reverse order) on bf16-valued
volumes (K1's exact path) at B = 32 and 256, W' = 360, and the source as it
is also on float32 volumes (the general path) at B = 32. Every variant is
printed with its ptxas lines, its HGMMA count in ``cuobjdump -sass`` and its
times; the variants that compute K1 are also held to the plain version and
to an fp64 run on two pairs.

- ``kernel``: the source as it is;
- ``mma_only``: no fragments formed (constants instead), the wgmma as they
  are: the tensor cores' part alone;
- ``form_only``: the fragments formed, no wgmma (the fragments are summed
  on the CUDA cores so that nothing is dead code): the formation's part;
- ``tma_only``: neither: the weight ring, the staged rows, the tap sums'
  adds to the totals in registers and the epilogue alone;
- ``stages_8``: a weight ring of up to 8 stages, as many as shared memory
  leaves (the source stops at 4);
- ``exact_always``: no route: every pair of bf16-valued volumes takes the
  exact path, whatever its cancellation ratio.

Last, an accuracy sweep: bf16-valued volumes at B = 16, W' = 360, ReLU'd
normals and normals of mean 1, 3, 5, 8, 10 and 30 (spread 1), through
``kernel`` and ``exact_always``; each pair's relative error against the
plain version in float64 beside its cancellation ratio (what the route
reads) and the number of pairs that took the exact path.

The pre-pass and the weight split run in every variant; their time and the
product's, by kernel row, are in ``chip_smoke.py``'s phase ``kernel`` at
B = 256. Numbers from these variants are diagnostics, not results of the
port.
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


def edit(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"k1_probe: the kernel source changed; not found {count}x:\n{old}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    form = "      form_unit<EXACT>(c, b_k, fr[u % 2], cc * KC, u);\n"
    issue = "      issue_unit<EXACT>(fr[u % 2], cur, w0, u, cc == 0 && u == 0);\n"
    out = {"kernel": src}
    out["mma_only"] = edit(src, form, """#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < U::WORDS; ++e)
          fr[u % 2][h][e] = 0x3f803f80u + (uint32_t)(k + cc + h + e) * 0x10001u;
""")
    out["form_only"] = edit(src, issue, """#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < U::WORDS; ++e)
          cur[h * 8 + e] += __uint_as_float(fr[u % 2][h][e]);
""")
    out["tma_only"] = edit(edit(src, form, ""), issue, "")
    out["stages_8"] = edit(src, "constexpr int MAX_STAGES = 4;", "constexpr int MAX_STAGES = 8;")
    out["exact_always"] = edit(src, "constexpr double ROUTE_RATIO = 8.0;",
                               "constexpr double ROUTE_RATIO = 1e30;")
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
                 if any(k in ln for k in ("Compiling", "Used", "spill", "wgmma"))]
        print(json.dumps({"variant": name, "ptxas": ptxas, "hgmma": sass.count("HGMMA")}),
              flush=True)
        fn = ctypes.CDLL(so).delta_conv1_forward
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
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

    computes_k1 = {"kernel", "stages_8", "exact_always"}
    limit = np.sqrt(6.0 / (S * C + S * F))
    for bsz, values in ((32, "bf16"), (256, "bf16"), (32, "float32")):
        w = 360
        rng = np.random.default_rng(bsz)
        a, b = (torch.from_numpy(np.maximum(rng.normal(size=(bsz, w, C)), 0)
                                 .astype(np.float32)).cuda() for _ in range(2))
        if values == "bf16":
            a, b = a.bfloat16().float(), b.bfloat16().float()
        kern = torch.from_numpy(rng.uniform(-limit, limit, size=(S, C, F)).astype(np.float32)).cuda()
        bias = torch.from_numpy(rng.normal(size=(F,)).astype(np.float32) * 0.1).cuda()
        ref = plain.delta_conv1(a, b, kern, bias, stride=S)
        ref64 = plain.delta_conv1(a[:2].double(), b[:2].double(), kern.double(),
                                  bias.double(), stride=S)
        names = list(entries) if values == "bf16" else ["kernel"]
        times = {}
        for name in names + names[::-1]:
            k1._entry = lambda fn=entries[name]: fn
            run = lambda: k1.delta_conv1(a, b, kern, bias, stride=S)  # noqa: E731
            times.setdefault(name, []).append(time_ms(run))
            if name in computes_k1 and len(times[name]) == 1:
                out = run()
                torch.cuda.synchronize()
                times[name + ":err"] = (float((out - ref).abs().max()),
                                        float((out[:2].double() - ref64).abs().max()))
        for name in names:
            row = {"w": w, "batch": bsz, "values": values, "variant": name,
                   "ms": times[name], "card": smi}
            if name in computes_k1:
                row["max_abs_err_vs_plain"], row["max_abs_err_vs_fp64_2pairs"] = times[name + ":err"]
            print(json.dumps(row), flush=True)
        print(json.dumps({"batch": bsz, "values": values, "plain_vs_fp64_2pairs":
                          float((ref[:2].double() - ref64).abs().max())}), flush=True)

    for offset in (0, 1, 3, 5, 8, 10, 30):
        rng = np.random.default_rng(100 + offset)
        a, b = (torch.from_numpy((rng.normal(size=(16, 360, C)) + offset if offset else
                                  np.maximum(rng.normal(size=(16, 360, C)), 0))
                                 .astype(np.float32)).cuda().bfloat16().float() for _ in range(2))
        kern = torch.from_numpy(rng.uniform(-limit, limit, size=(S, C, F)).astype(np.float32)).cuda()
        bias = torch.from_numpy(rng.normal(size=(F,)).astype(np.float32) * 0.1).cuda()
        ref64 = plain.delta_conv1(a.double(), b.double(), kern.double(), bias.double(), stride=S)
        rho = k1.cancellation_ratio(a, b, kern, S)
        row = {"offset": offset or "relu", "rho_min": float(rho.min()),
               "rho_max": float(rho.max()), "exact_pairs": int(k1.exact_pairs(a, b, kern, S).sum())}
        for name in ("kernel", "exact_always"):
            k1._entry = lambda fn=entries[name]: fn
            out = k1.delta_conv1(a, b, kern, bias, stride=S).double()
            err = (out - ref64).flatten(1).norm(dim=1) / ref64.flatten(1).norm(dim=1)
            row[name + "_worst_pair_rel_err"] = float(err.max())
            row[name + "_median_pair_rel_err"] = float(err.median())
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
