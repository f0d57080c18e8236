#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths (pair scoring, online loop closing)
on one CUDA card.

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

4. lcd: online loop closing at the same full width through
   ``Infer(cfg, shards=1)`` and ``OnlineLoopCloser``: a seeded 400-frame
   sequence on disk whose second half revisits the first (column-rolled
   copies plus noise), forged poses, and covariances that leave one or a
   handful of candidates per revisiting frame; and once more with no
   covariances, where late frames have more candidates than one head call
   takes. The overlap threshold is -1 so that every scored frame's best
   candidate is compared, not only the accepted ones. Gates: (a) the
   pipelined ``run(pipeline_depth=8)`` gives the closures of an engine
   stepped frame by frame (frame and match equal, the rest to 1e-6); (b) the
   fused frame step equals the sequential path (``Infer(shards=None)``
   scoring the same embeddings: overlap within 2e-5, the same match unless
   that path's own overlaps for the two ids lie within 2e-5); (c) a short
   prefix with fp32 legs agrees with the same engine on the CPU (overlap
   |d| < 1e-3); (d) the whole pipelined run raises nothing under
   ``torch.cuda.set_sync_debug_mode("error")`` and launches K1 at least once
   per frame that had candidates; (e) a revisit matched to its twin has the
   yaw of the roll that made it, within one bin. Frames/s pipelined and
   stepped, the stepped frame's latency and a profiled window's device-busy
   share are printed as information.

Then the ``kernels`` line (K1's launches are the sum over the model and lcd
phases' main-path runs), the nvidia-smi line, and last the result line.
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


# -- phase lcd ------------------------------------------------------------------

LCD_OUT = 200  # frames driven out; as many again come back over them
LCD_SPACING_M = 2.0
# 3-sigma search radius of a revisiting frame: even ones see only their twin,
# odd ones the twin and three frames either side of it
LCD_RADII_M = (1.5, 7.0)


def write_loop(root: str, height: int, width: int):
    """A seeded out-and-back sequence in the disk contract ``Infer`` reads.
    Frame LCD_OUT + j stands 0.3 m beside frame j and sees frame j's image
    rolled by ``rolls[j]`` columns, plus small noise on the depth. Returns
    (poses (n, 4, 4), covariances (n, 6, 6), rolls)."""
    rng = np.random.default_rng(23)
    for kind in ("depth", "normal"):
        os.makedirs(os.path.join(root, "00", kind))
    # Rolls of up to a fifth of the panorama either way (72 degrees: the
    # VALID legs' feature volume spans less than the full circle), and even:
    # the legs halve the width, so the features shift by whole bins.
    rolls = 2 * rng.integers(10, width // 10, size=LCD_OUT) * rng.choice([-1, 1], size=LCD_OUT)

    def save(i, depth, normal):
        np.save(os.path.join(root, "00", "depth", f"{i:06d}.npy"), depth)
        np.save(os.path.join(root, "00", "normal", f"{i:06d}.npy"), normal)

    for j in range(LCD_OUT):
        depth = np.abs(rng.normal(size=(height, width))).astype(np.float32) * 20.0
        normal = rng.normal(size=(height, width, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        save(j, depth, normal)
        noise = 0.02 * rng.normal(size=(height, width)).astype(np.float32)
        save(LCD_OUT + j, np.roll(depth, rolls[j], axis=1) + noise,
             np.roll(normal, rolls[j], axis=1))
    n = 2 * LCD_OUT
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = LCD_SPACING_M * (np.arange(n) % LCD_OUT)
    poses[LCD_OUT:, 1, 3] = 0.3
    sigma = np.array([LCD_RADII_M[i % 2] for i in range(n)]) / 3.0
    covs = np.einsum("n,ij->nij", sigma**2, np.eye(6))
    return poses, covs, rolls


def gated_candidates(gating, poses, covs, **gates) -> list[list[int]]:
    """Each frame's candidate frames under the engine's gates (the defaults
    unless ``inactive_time`` / ``inactive_dist`` are given)."""
    positions = poses[:, :2, 3]
    traj = gating.trajectory_lengths(positions)
    out = []
    for i in range(len(poses)):
        ellipse = (gating.CovarianceEllipse(np.inf, np.inf, 0.0) if covs is None else
                   gating.CovarianceEllipse.from_covariance(covs[i][:2, :2], 3.0))
        out.append(np.flatnonzero(gating.candidate_mask(i, positions, traj, ellipse, **gates)).tolist())
    return out


def same_closures(got, want, what: str) -> None:
    if [(c.frame, c.match) for c in got] != [(c.frame, c.match) for c in want]:
        raise RuntimeError(f"{what}: closures differ in frame or match")
    for a, b in zip(got, want):
        d = max(abs(a.overlap - b.overlap), abs(a.yaw_deg - b.yaw_deg),
                abs(a.confidence - b.confidence))
        if d > 1e-6:
            raise RuntimeError(f"{what}: frame {a.frame} differs by {d}: {a} vs {b}")


def against_sequential(seq_infer, closures, candidates, fvs, gate: float):
    """Gate (b): every frame's fused result against ``seq_infer`` (the plain
    store) scoring the same embeddings candidate by candidate. Returns the
    largest overlap difference and each frame's {candidate: overlap}."""
    by_frame = {c.frame: c for c in closures}
    worst, scores = 0.0, []
    for i, cands in enumerate(candidates):
        out = seq_infer.infer_multiple(i, cands, fv=fvs[i])
        scores.append({} if out is None else dict(zip(cands, out[0].tolist())))
        if out is None:
            if i in by_frame:
                raise RuntimeError(f"frame {i} closed with no candidate")
            continue
        overlaps = out[0]
        best, got = int(np.argmax(overlaps)), by_frame[i]
        worst = max(worst, abs(got.overlap - float(overlaps[best])))
        chosen = float(overlaps[cands.index(got.match)])
        if got.match != cands[best] and float(overlaps[best]) - chosen > gate:
            raise RuntimeError(f"frame {i}: fused match {got.match}, sequential {cands[best]}")
    if worst > gate:
        raise RuntimeError(f"fused vs sequential overlap |d| {worst} > {gate}")
    return worst, scores


def busy_share(torch, run) -> dict:
    """Device-busy time over the host's wall time of ``run()`` under
    torch.profiler (whose own cost lengthens the host side)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if rows else None,
            "top": [[k[:60], ms] for k, ms in rows[:6]]}


def phase_lcd(torch, k1, smi):
    from overlapnet_torch.core.config import OverlapNetConfig
    from overlapnet_torch.data.dataset import assemble_scan_image
    from overlapnet_torch.lcd import gating
    from overlapnet_torch.lcd.infer import Infer
    from overlapnet_torch.lcd.online import OnlineLoopCloser
    from overlapnet_torch.models import init_params

    cfg = OverlapNetConfig()
    n = 2 * LCD_OUT
    with tempfile.TemporaryDirectory() as tmp:
        poses, covs, rolls = write_loop(tmp, cfg.model.input_height, cfg.model.input_width)
        cfg.data.data_root_folder, cfg.data.infer_seqs = tmp, "00"
        params = init_params(cfg.model, cfg.num_input_channels, seed=0)

        def engine(covariances, config=cfg, device="cuda", frames=n, **gates):
            infer = Infer(config, params=params, db_capacity=512, device=device, shards=1)
            return OnlineLoopCloser(
                infer, poses[:frames],
                covariances=None if covariances is None else covariances[:frames],
                overlap_threshold=-1.0, **gates)

        engine(covs).run(LCD_OUT + 8)  # warm-up: cuDNN and cuFFT plans, pinned blocks
        torch.cuda.synchronize()

        # the main path: the pipelined run, with no host synchronisation (d)
        candidates = gated_candidates(gating, poses, covs)
        scored_frames = sum(1 for c in candidates if c)
        pairs = sum(len(c) for c in candidates)
        piped = engine(covs)
        k1.delta_conv1.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            piped.run(pipeline_depth=8)
            piped_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launches = k1.delta_conv1.launches
        if launches < scored_frames:
            raise RuntimeError(f"{launches} delta_conv1 launches for {scored_frames} scored frames")
        if [c.frame for c in piped.closures] != [i for i, c in enumerate(candidates) if c]:
            raise RuntimeError("not every frame with candidates gave a result")

        # (a) stepped frame by frame, with each frame's dispatch-to-result time
        stepped = engine(covs)
        latency_ms = []
        t0 = time.perf_counter()
        for i in range(n):
            t1 = time.perf_counter()
            stepped.step(i)
            latency_ms.append((time.perf_counter() - t1) * 1e3)
        stepped_s = time.perf_counter() - t0
        same_closures(piped.closures, stepped.closures, "pipelined vs stepped")
        scored_ms = np.array([latency_ms[i] for i, c in enumerate(candidates) if c])

        # (b) the sequential path on the same embeddings
        fvs = piped.infer.feature_volumes
        d_seq, _ = against_sequential(
            Infer(cfg, params=params, db_capacity=512, device="cuda"),
            piped.closures, candidates, fvs, 2e-5)

        # (e) a revisit matched to its twin has the yaw of its roll
        bin_deg = 360.0 / cfg.model.input_width * 2  # one feature column: 2 image columns
        twins = [c for c in piped.closures if c.match == c.frame - LCD_OUT]
        tight = [c for c in piped.closures if len(candidates[c.frame]) == 1]
        if not tight or any(c not in twins for c in tight):
            raise RuntimeError("a frame whose only candidate is its twin did not match it")
        yaw_err = 0.0
        for c in twins:
            want = rolls[c.match] * 360.0 / cfg.model.input_width
            yaw_err = max(yaw_err, abs((c.yaw_deg - want + 180.0) % 360.0 - 180.0))
        if yaw_err > bin_deg:
            raise RuntimeError(f"twin yaw off by {yaw_err} deg (one bin: {bin_deg})")

        # no covariances: unbounded search, late frames exceed one head call
        wide_candidates = gated_candidates(gating, poses, None)
        wide = engine(None)
        before = k1.delta_conv1.launches
        t0 = time.perf_counter()
        wide.run(pipeline_depth=8)
        torch.cuda.synchronize()
        wide_s = time.perf_counter() - t0
        wide_launches = k1.delta_conv1.launches - before
        most = max(len(c) for c in wide_candidates)
        if wide_launches <= sum(1 for c in wide_candidates if c):
            raise RuntimeError(f"no frame was scored in chunks ({most} candidates at most)")
        wide_stepped = engine(None)
        for i in range(n):
            wide_stepped.step(i)
        same_closures(wide.closures, wide_stepped.closures, "no covariances: pipelined vs stepped")
        d_seq_wide, _ = against_sequential(
            Infer(cfg, params=params, db_capacity=512, device="cuda"),
            wide.closures, wide_candidates, wide.infer.feature_volumes, 2e-5)

        # (c) an fp32-leg prefix, its gates relaxed so that it scores, against
        # the same engine on the CPU
        cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, leg_dtype="float32"))
        prefix, relaxed = 18, dict(inactive_time=4, inactive_dist=5.0)
        prefix_candidates = gated_candidates(gating, poses[:prefix], None, **relaxed)
        on = {device: engine(None, config=cfg32, device=device, frames=prefix, **relaxed)
              for device in ("cuda", "cpu")}
        for closer in on.values():
            closer.run(pipeline_depth=4)
        gpu32, cpu32 = on["cuda"].closures, on["cpu"].closures
        if [c.frame for c in gpu32] != [c.frame for c in cpu32]:
            raise RuntimeError("fp32 prefix: GPU and CPU closed different frames")
        d_cpu = max(abs(a.overlap - b.overlap) for a, b in zip(gpu32, cpu32))
        if d_cpu >= 1e-3:
            raise RuntimeError(f"fp32 prefix: GPU vs CPU overlap |d| {d_cpu}")
        d_seq32, scores32 = against_sequential(
            Infer(cfg32, params=params, db_capacity=32, device="cuda"),
            gpu32, prefix_candidates, on["cuda"].infer.feature_volumes, 2e-5)
        for a, b in zip(gpu32, cpu32):  # another match only between near-equal overlaps
            if a.match != b.match and abs(scores32[a.frame][a.match] - scores32[a.frame][b.match]) >= 1e-3:
                raise RuntimeError(f"fp32 prefix: frame {a.frame} matched {a.match}, on the CPU {b.match}")

        # information: the device's share of a pipelined window of scored
        # frames, gated and with no covariances (about 230 candidates a
        # frame), and the host's time to read one frame's image from disk
        probe = engine(covs)
        probe.run(LCD_OUT + 20)
        window = busy_share(torch, lambda: probe.run(LCD_OUT + 80))
        probe = engine(None)
        probe.run(LCD_OUT + 120)
        wide_window = busy_share(torch, lambda: probe.run(LCD_OUT + 140))
        load_ms = []
        for i in range(LCD_OUT, LCD_OUT + 50):
            t0 = time.perf_counter()
            assemble_scan_image(tmp, "00", f"{i:06d}", cfg.channels,
                                cfg.model.input_height, cfg.model.input_width)
            load_ms.append((time.perf_counter() - t0) * 1e3)

    emit({
        "phase": "lcd", "config": "OverlapNetConfig() 64x900x4, bf16 legs, W'=360, shards=1",
        "frames": n, "scored_frames": scored_frames, "pairs_scored": pairs,
        "closures": len(piped.closures), "twin_matches": len(twins),
        "delta_conv1_launches": launches, "sync_debug_mode": "error: nothing raised",
        "frames_per_s_pipelined": n / piped_s, "frames_per_s_stepped": n / stepped_s,
        "pipelined_s": piped_s, "stepped_s": stepped_s,
        "stepped_scored_frame_ms_p50": float(np.percentile(scored_ms, 50)),
        "stepped_scored_frame_ms_p99": float(np.percentile(scored_ms, 99)),
        "stepped_unscored_frame_ms_p50": float(np.percentile(latency_ms[:LCD_OUT], 50)),
        "fused_vs_sequential_overlap_absdiff": d_seq, "gate_sequential": 2e-5,
        "twin_yaw_err_deg": yaw_err, "gate_yaw_deg": bin_deg,
        "no_covariances": {
            "pairs_scored": sum(len(c) for c in wide_candidates), "most_candidates": most,
            "delta_conv1_launches": wide_launches, "frames_per_s_pipelined": n / wide_s,
            "pipelined_s": wide_s,
            "fused_vs_sequential_overlap_absdiff": d_seq_wide,
        },
        "fp32_prefix": {"frames": prefix, "pairs_scored": sum(map(len, prefix_candidates)),
                        "gpu_vs_cpu_overlap_absdiff": d_cpu, "gate": 1e-3,
                        "fused_vs_sequential_overlap_absdiff": d_seq32},
        "profiled_window_60_frames": window,
        "no_covariances_profiled_window_20_frames": wide_window,
        "host_image_load_ms_p50": float(np.percentile(load_ms, 50)), "card": smi,
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
    launches = {"model": phase_model(torch, k1, smi), "lcd": phase_lcd(torch, k1, smi)}
    emit({"kernels": [{
        "name": k1.NAME, "route": "cuda", "source": k1.SOURCE,
        "replaces": tpu_kernel_site(k1.REPLACES), "launches": sum(launches.values()),
        "launches_by_phase": launches,
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
