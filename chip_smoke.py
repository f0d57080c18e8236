#!/usr/bin/env python3
"""Drive the PyTorch port's pair-scoring serving path on one CUDA card.

Run from the root of the repository:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the time to build every CUDA kernel of the port (nvcc,
   from the sources in this checkout).
2. kernel: K1 (fused delta + c_conv1, 3xTF32 on the tensor cores) against
   its plain PyTorch version (fp32, TF32 off) within rtol/atol 1e-4 in every
   form the serving path gives it: B = 32 at W' = 360 and 450, one query
   expanded over 32 candidates (batch stride 0, as ``DescriptorDB.query``),
   no bias, B = 1, and B = 256 (the head's batch). Each form is timed with
   CUDA events; W' = 360 and 450 also time the plain version and one
   torch.matmul of the materialized contraction (the library yardstick,
   never called by the port). Bounds: operations at the TF32 dense rate
   (``bound_ms``), at three TF32 passes (``bound_3xtf32_ms``) and in fp32 on
   the CUDA cores (``bound_fp32_simt_ms``), each against the bytes bound.
3. model: the default 64x900x4 model (bf16 legs, W' = 360), seeded weights,
   served through ``Infer(device="cuda")``: infer_one, infer_multiple of one
   query against 64 references, query_best and infer_multiple_vs_multiple.
   K1's launch count must rise; overlaps must be finite in [0, 1] and agree
   with the same ``Infer`` on the CPU (|d| < 5e-3 with bf16 legs, < 1e-3 with
   fp32 legs); a self-pair's yaw must be 0. Head pairs/s at B = 256 and leg
   scans/s are printed as information.

Then the ``kernels`` line, the nvidia-smi line, and last the result line.
Any failure raises: the exit code is non-zero and no result line is printed.
It also fails when no CUDA device is visible, and when run outside a
checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
C, S, F = 128, 15, 64

# Published peaks (NVIDIA data sheets, dense, at the full power limit): fp32
# outside the tensor cores, TF32 on the tensor cores (None where none is on
# record here), and device-memory bandwidth.
PEAKS = {  # name fragment -> (fp32 FLOP/s, TF32 FLOP/s, bytes/s)
    "H100 PCIe": (51.2e12, None, 2.0e12),
    "H100 NVL": (60.0e12, None, 3.9e12),
    "H200": (67.0e12, 495e12, 4.8e12),
    "H100": (67.0e12, 495e12, 3.35e12),  # SXM
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str) -> tuple[float, float, float]:
    for frag, peaks in PEAKS.items():
        if frag in name:
            if None in peaks:
                raise RuntimeError(f"no published TF32 peak on record for {name!r}")
            return peaks
    raise RuntimeError(f"no published peaks on record for {name!r}")


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` call over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tpu_kernel_site(replaces: str) -> str:
    """'<package>/ops/pallas_delta.py:<line>' of the TPU kernel, found in this
    checkout's JAX package (read as text, not imported)."""
    rel, line = replaces.rsplit(":", 1)
    hits = [p for p in glob.glob(os.path.join(ROOT, "*", rel))
            if not p.startswith(os.path.join(ROOT, "overlapnet_torch"))]
    if len(hits) != 1:
        raise RuntimeError(f"TPU kernel source {rel} not found in the checkout: {hits}")
    with open(hits[0]) as f:
        text = f.read().splitlines()
    if "pallas_call" not in text[int(line) - 1]:
        raise RuntimeError(f"{hits[0]}:{line} is not the pallas_call")
    return f"{os.path.relpath(hits[0], ROOT)}:{line}"


def phase_env(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    for path in libs.values():
        with open(path[: -len(".so")] + ".log") as f:
            print(f.read(), file=sys.stderr, end="")
    name = torch.cuda.get_device_name(0)
    emit({
        "phase": "env", "nvidia_smi": smi, "device": name,
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "kernels_built": sorted(libs), "build_s": build_s,
    })
    return smi, name


def volume(torch, rng, bsz: int, w: int):
    """A (B, W', C) leg-feature-scale volume (ReLU outputs) on the card."""
    return torch.from_numpy(np.maximum(rng.normal(size=(bsz, w, C)), 0).astype(np.float32)).cuda()


# (form, B, W', right volume expanded from one query, bias, timed beside the
# plain version and the library call)
K1_FORMS = [
    ("b32_w360", 32, 360, False, True, True),
    ("b32_w450", 32, 450, False, True, True),
    ("query_stride0_b32_w360", 32, 360, True, True, False),
    ("no_bias_b32_w360", 32, 360, False, False, False),
    ("b1_w360", 1, 360, False, True, False),
    ("b256_w360", 256, 360, False, True, False),
]


def phase_kernel(torch, k1, plain, name, smi):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peak_fp32, peak_tf32, peak_bw = card_peaks(name)
    rows = {}
    for form, bsz, w, query, with_bias, yardsticks in K1_FORMS:
        j = w // S
        rng = np.random.default_rng(w)
        a = volume(torch, rng, bsz, w)
        b = volume(torch, rng, 1, w).expand(bsz, w, C) if query else volume(torch, rng, bsz, w)
        # glorot-scale weights, as the head's init
        limit = math.sqrt(6.0 / (S * C + S * F))
        kern = torch.from_numpy(rng.uniform(-limit, limit, size=(S, C, F)).astype(np.float32)).cuda()
        bias = torch.from_numpy(rng.normal(size=(F,)).astype(np.float32) * 0.1).cuda()
        bias = bias if with_bias else None

        out = k1.delta_conv1(a, b, kern, bias, stride=S)
        torch.cuda.synchronize()
        ref = plain.delta_conv1(a, b, kern, bias, stride=S)
        err = float((out - ref).abs().max())
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        del out, ref

        kernel_ms = time_ms(torch, lambda: k1.delta_conv1(a, b, kern, bias, stride=S), 20)
        row = {"max_abs_err": err, "ms": kernel_ms}
        if yardsticks:
            row["plain_ms"] = time_ms(
                torch, lambda: plain.delta_conv1(a, b, kern, bias, stride=S), 5)
            # library yardstick: the GEMM of the materialized abs-diff volume
            lhs = (a.repeat(1, 1, S)[:, :, None, :]
                   - b[:, : j * S].reshape(bsz, 1, j, S * C)).abs_().reshape(-1, S * C)
            wmat = kern.reshape(S * C, F)
            row["library_ms"] = time_ms(torch, lambda: torch.matmul(lhs, wmat), 5)
            row["library_lhs_gb"] = lhs.numel() * 4 / 1e9
            del lhs

        flops = 2 * bsz * w * j * S * C * F
        b_volumes = 1 if query else bsz  # an expanded volume is read once
        nbytes = 4 * ((bsz + b_volumes) * w * C + S * C * F + F * with_bias
                      + bsz * w * j * F)
        t_bytes = nbytes / peak_bw * 1e3
        t_tf32 = flops / peak_tf32 * 1e3
        row.update({
            "bound_ms": max(t_tf32, t_bytes),
            "bound_by": "operations" if t_tf32 >= t_bytes else "bytes",
            "bound_3xtf32_ms": max(3 * t_tf32, t_bytes),
            "bound_fp32_simt_ms": max(flops / peak_fp32 * 1e3, t_bytes),
        })
        rows[form] = row
        emit({
            "phase": "kernel", "kernel": "delta_conv1", "form": form, "w": w, "j": j,
            "batch": bsz, "b_batch_stride": b.stride(0), "bias": with_bias,
            "channels": C, "stride": S, "features": F, "rtol": 1e-4, "atol": 1e-4,
            **row, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "kernel_tflops": flops / kernel_ms / 1e9, "peak_tf32_tflops": peak_tf32 / 1e12,
            "share_of_3xtf32_bound": row["bound_3xtf32_ms"] / kernel_ms, "card": smi,
        })
    return rows


def head_breakdown(torch, score, fa, fb) -> dict:
    """Self device time by profiler row over one head call (torch.profiler):
    K1's kernel time and the top rows, in ms, each row tagged CUDA (a
    kernel) or CPU (an op whose device work the profiler did not split into
    kernels). None when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        score(fa, fb)
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, e.device_type.name, e.self_device_time_total / 1e3)
         for e in prof.key_averages() if e.self_device_time_total > 0),
        key=lambda r: -r[2],
    )
    if not rows:
        return {"k1_ms": None, "top": None}
    return {
        "k1_ms": sum(ms for k, _, ms in rows if "delta_conv1" in k),
        "top": [[k[:80], kind, ms] for k, kind, ms in rows[:8]],
    }


def write_scans(root: str, n: int, height: int, width: int) -> None:
    rng = np.random.default_rng(11)
    for kind in ("depth", "normal"):
        os.makedirs(os.path.join(root, "00", kind))
    for i in range(n):
        depth = np.abs(rng.normal(size=(height, width))).astype(np.float32) * 20.0
        normal = rng.normal(size=(height, width, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        np.save(os.path.join(root, "00", "depth", f"{i:06d}.npy"), depth)
        np.save(os.path.join(root, "00", "normal", f"{i:06d}.npy"), normal)


def serve(infer, names):
    """The requests of the model phase; returns their overlaps and yaws."""
    ov1, yaw1 = infer.infer_one(names[0], names[1])
    fv = infer.create_feature_volumes(names[:64])
    for i in range(64):
        infer.add_embedding(i, fv[i])
    ov_m, yaw_m, _ = infer.infer_multiple(64, list(range(64)))
    best = infer.query_best(65, list(range(0, 64, 4)))
    ov_v, yaw_v = infer.infer_multiple_vs_multiple(names[:4], [0, 1, 2, 3], [1, 1, 3, 2])
    overlaps = np.concatenate([[ov1], ov_m, [best[1]], ov_v]).astype(np.float64)
    return {"overlaps": overlaps, "yaw_vs": yaw_v, "best": best, "yaw_multi": yaw_m}


def phase_model(torch, k1, smi):
    from overlapnet_torch.core.config import OverlapNetConfig
    from overlapnet_torch.lcd.infer import Infer
    from overlapnet_torch.models import init_params

    cfg = OverlapNetConfig()
    assert cfg.model.leg_dtype == "bfloat16" and cfg.model.input_width == 900
    with tempfile.TemporaryDirectory() as tmp:
        write_scans(tmp, 66, cfg.model.input_height, cfg.model.input_width)
        cfg.data.data_root_folder, cfg.data.infer_seqs = tmp, "00"
        names = [f"{i:06d}" for i in range(66)]
        params = init_params(cfg.model, cfg.num_input_channels, seed=0)

        gpu = Infer(cfg, params=params, db_capacity=128, device="cuda")
        serve(gpu, names)  # warm-up: cuDNN plans, first launches
        gpu = Infer(cfg, params=params, db_capacity=128, device="cuda")
        k1.delta_conv1.launches = 0
        t0 = time.perf_counter()
        res = serve(gpu, names)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = k1.delta_conv1.launches
        if launches == 0:
            raise RuntimeError("the serving path launched no delta_conv1 kernel")
        pairs = 1 + 64 + 16 + 4

        ov = res["overlaps"]
        if not (np.all(np.isfinite(ov)) and np.all((ov >= 0) & (ov <= 1))):
            raise RuntimeError(f"overlaps not finite in [0, 1]: {ov}")
        self_yaw = float(res["yaw_vs"][1])  # the pair (1, 1)
        if abs(self_yaw) > 1e-2:
            raise RuntimeError(f"self-pair yaw {self_yaw} deg, expected 0")

        cpu = serve(Infer(cfg, params=params, db_capacity=128, device="cpu"), names)
        d_bf16 = float(np.abs(cpu["overlaps"] - ov).max())
        if d_bf16 >= 5e-3 or cpu["best"][0] != res["best"][0]:
            raise RuntimeError(f"bf16 legs: GPU vs CPU overlap |d| {d_bf16}, best "
                               f"{res['best'][0]} vs {cpu['best'][0]}")
        yaw_d = float(np.abs(cpu["yaw_multi"] - res["yaw_multi"]).max())

        cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, leg_dtype="float32"))
        out32 = []
        for device in ("cuda", "cpu"):
            inf = Infer(cfg32, params=params, db_capacity=8, device=device)
            ov1, _ = inf.infer_one(names[0], names[1])
            ov_v, _ = inf.infer_multiple_vs_multiple(names[:4], [0, 1, 2, 3], [1, 1, 3, 2])
            out32.append(np.concatenate([[ov1], ov_v]).astype(np.float64))
        d_fp32 = float(np.abs(out32[0] - out32[1]).max())
        if d_fp32 >= 1e-3:
            raise RuntimeError(f"fp32 legs: GPU vs CPU overlap |d| {d_fp32}")

        # information: head pairs/s at B=256, leg scans/s at B=64
        rng = np.random.default_rng(5)
        fa = torch.from_numpy(np.maximum(rng.normal(size=(256, 360, 128)), 0).astype(np.float32)).cuda()
        fb = fa.roll(1, dims=0)
        imgs = torch.from_numpy(rng.normal(size=(64, 64, 900, 4)).astype(np.float32)).cuda()
        with torch.inference_mode():
            head_ms = time_ms(torch, lambda: gpu.model.score(fa, fb), 5)
            leg_ms = time_ms(torch, lambda: gpu.model.encode(imgs), 5)
        breakdown = head_breakdown(torch, gpu.model.score, fa, fb)

    emit({
        "phase": "model", "config": "OverlapNetConfig() 64x900x4, bf16 legs, W'=360",
        "pairs_served": pairs, "serve_s": serve_s, "delta_conv1_launches": launches,
        "overlap_min": float(ov.min()), "overlap_max": float(ov.max()),
        "self_pair_yaw_deg": self_yaw, "best_match": res["best"][0],
        "gpu_vs_cpu_overlap_absdiff_bf16": d_bf16, "gate_bf16": 5e-3,
        "gpu_vs_cpu_overlap_absdiff_fp32": d_fp32, "gate_fp32": 1e-3,
        "gpu_vs_cpu_yaw_absdiff_deg_bf16": yaw_d,
        "head_pairs_per_s_b256": 256 / head_ms * 1e3, "head_ms_b256": head_ms,
        "leg_scans_per_s_b64": 64 / leg_ms * 1e3, "leg_ms_b64": leg_ms,
        "head_b256_profile": breakdown, "card": smi,
    })
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from overlapnet_torch.kernels import build
    from overlapnet_torch.kernels import delta_conv1 as k1
    from overlapnet_torch.ops import delta as plain

    smi, name = phase_env(torch, build)
    rows = phase_kernel(torch, k1, plain, name, smi)
    launches = phase_model(torch, k1, smi)
    emit({"kernels": [{
        "name": k1.NAME, "route": "cuda", "source": k1.SOURCE,
        "replaces": tpu_kernel_site(k1.REPLACES), "launches": launches,
        **{k: rows["b32_w360"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound_3xtf32_ms", "bound_fp32_simt_ms")},
        "max_abs_err_all_forms": max(r["max_abs_err"] for r in rows.values()),
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
