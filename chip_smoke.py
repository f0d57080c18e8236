#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths (pair scoring, online loop closing),
its training and data-preparation paths, its end-to-end harness (sim scans
to pose graph) and its multi-device paths on one CUDA card.

Run from the root of the repository:

    python3 chip_smoke.py

(Naming phases, as in ``python3 chip_smoke.py kernel_bwd train``, runs env
and only those, for development, and prints no result line.)

Phases, each printing one JSON line:

1. env: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the time to build every CUDA kernel of the port (nvcc,
   from the sources in this checkout).
2. kernel: K1 (fused delta + c_conv1 on the bf16 tensor cores) against its
   plain PyTorch version (fp32, TF32 off) within rtol/atol 1e-4 in every
   form the serving path gives it, on float32 volumes (K1's general path:
   B = 32 at W' = 360 and 450, one query expanded over 32 candidates (batch
   stride 0, as the store's ``_score_rows``), no bias, B = 1, and B = 256, the
   head's batch) and on bf16-valued volumes, the bf16 legs' output (its
   exact path: B = 32 and 256 at W' = 360 and 450, one query over 256
   candidates, B = 1), and on bf16-valued volumes with an offset of 3, 5,
   10 and 30 over a spread of 1 (the exact path up to a cancellation ratio
   of 8, the general path past it) and a batch of both. Each form's pairs
   (16 of them) are also held to the plain version in float64 at a relative
   norm of 1e-5, the benchmark's ``k1_err`` limit. Gates beside the error:
   the device counter ``k1.exact_calls`` shows that a call took the exact
   path on every pair exactly where ``exact_pairs`` says so, and two calls
   give the same bits. Each form is
   timed with CUDA events (at B = 256 also each kernel row, by the
   profiler); W' = 360 and 450 on float32 volumes also time the plain
   version and one torch.matmul of the materialized contraction (the
   library yardstick, never called by the port). Bounds: the path's floor
   (``floor_ms``: three bf16 products a pair on the exact path, six on the
   general one), operations at the TF32 dense rate (``bound_ms``), at three TF32
   passes (``bound_3xtf32_ms``) and in fp32 on the CUDA cores
   (``bound_fp32_simt_ms``), each against the bytes bound.
3. conv2 (run after kernel_bwd): K3, c_conv2 with its bias and ReLU (TF32
   on the tensor cores, both operands rounded to nearest, fp32 sums),
   against its plain PyTorch version in float64 on K1-shaped (B, W', J, 64)
   channels-last inputs: the head's S = 15 at W' = 360 and 450, B = 256,
   32, 17, 3 and 1, and S = 8 and 7 at W' = 360. Gates: each pair's
   relative norm of the error within 5e-4 and the error's slope on the
   output within 1e-4 (rounding to nearest, not truncation); two calls give
   the same bits; the result is (B, 128, W' // S, J) with channels-last
   strides; ``k3.launches`` rises once a call; K3 on the first b pairs of a
   256-pair input equals those rows of the whole call for every b from 1 to
   256; with cuDNN's TF32 off (K3's 3xTF32 form) each pair within 1e-5 of
   float64 and two calls with the same bits. Timed with CUDA events at B =
   256 and 32 (W' = 360), 256 (W' = 450) and 1, in both forms, beside the
   byte bound, the plain version (TF32 off) and the library call (cuDNN's
   TF32 conv + ReLU, what the head ran before K3; never called by the port);
   K3's and the library's device time alone (``device_ms``, their launches
   replayed from a CUDA graph: no host time) beside them. The phase leaves
   cuDNN's TF32 switch as it found it.
3b. conv3 (run after conv2): K4, c_conv3 with its bias and ReLU and the
   overlap dense (TF32 on the tensor cores, both operands rounded to
   nearest, fp32 sums; the sum, the dense's bias and the sigmoid in a second
   small kernel), against its plain PyTorch version in float64 on K3-shaped
   (B, J, J, 128) channels-last inputs: J = 24 (W' = 360) and 30 (W' = 450)
   at B = 256, 32 and 1, J = 24 at B = 3 and 17, and J = 6 (W' = 90) at
   B = 5. Gates on each pair's overlap: within 2e-5 of the float64 version
   on the operands rounded to TF32 to nearest, as K4 rounds them (what is
   left is its fp32 sums; bfloat16 operands, checked at B >= 32, read more),
   and within 5e-4 of the float64 version on the operands as given; two
   calls give the same bits; the result is (B, 1) float32;
   ``k4.launches`` rises once a call; K4 on the first b pairs of a 256-pair
   input equals those rows of the whole call for every b from 1 to 256;
   with cuDNN's TF32 off (3xTF32) each overlap within 2e-5 of float64 and
   two calls with the same bits. Timed at B = 256, 32 and 1 at W' = 360 and
   450, in both forms, by CUDA events and by CUDA-graph replay
   (``device_ms``), beside the bound (operations at the TF32 rate against
   bytes), the plain version (TF32 off) and the library calls the head ran
   before K4 (cuDNN's TF32 conv with its bias, the ReLU, the flatten, the
   dense and the sigmoid; never called by the port). The phase leaves
   cuDNN's TF32 switch as it found it.
4. model: the default 64x900x4 model (bf16 legs, W' = 360), seeded weights,
   served through ``Infer(device="cuda")``: infer_one, infer_multiple of one
   query against 64 references, query_best and infer_multiple_vs_multiple.
   K1's, K3's and K4's launch counts must rise; overlaps must be finite in
   [0, 1] and agree with the same ``Infer`` on the CPU (|d| < 5e-3 with bf16
   legs, < 1e-3 with fp32 legs); a self-pair's yaw must be 0; a profiled
   head call at B = 256 holds none of the library rows K3 and K4 replaced
   (cuDNN's ``convertTensor`` and fprops, the ReLU's ``clamp``, the dense's
   ``gemv``). Head pairs/s at B = 256, K1's, K3's and K4's ms in that call
   and leg scans/s are printed as information.

5. lcd: online loop closing at the same full width through
   ``Infer(cfg, shards=1)`` and ``OnlineLoopCloser``: a seeded 400-frame
   sequence on disk whose second half revisits the first (column-rolled
   copies plus noise), forged poses, and covariances that leave one or a
   handful of candidates per revisiting frame; and once more with no
   covariances, where late frames have more candidates than one head call
   takes. The overlap threshold is -1 so that every scored frame's best
   candidate is compared, not only the accepted ones. Gates: (a) the
   pipelined ``run(pipeline_depth=8)`` gives the closures of an engine
   stepped frame by frame (frame and match equal, the rest to 1e-6); (b) the
   fused frame step equals the sequential path (``Infer(cfg).infer_multiple``
   scoring the same embeddings: overlap within 2e-5, the same match unless
   that path's own overlaps for the two ids lie within 2e-5); (c) a short
   prefix with fp32 legs agrees with the same engine on the CPU (overlap
   |d| < 1e-3); (d) the whole pipelined run raises nothing under
   ``torch.cuda.set_sync_debug_mode("error")`` and launches K1 at least once
   per frame that had candidates; (e) a revisit matched to its twin has the
   yaw of the roll that made it, within one bin; (f) ``Infer(cfg)`` (no
   shards argument: what the benchmark's dense cell builds) pipelined the
   same way raises nothing under the same mode, returns every frame from
   ``dispatch_frame`` unresolved (an event behind it), and gives
   ``Infer(cfg, shards=1)``'s closures frame by frame (frame and match
   equal, the rest to 1e-6). Both keep one store, which grows in the frame
   step. Frames/s pipelined on each and stepped, the stepped frame's
   latency and a profiled window's device-busy share are printed as
   information.

6. kernel_bwd (run after kernel): K2, the backward of K1 (both products
   3xTF32 wgmma on the tensor cores behind a pre-pass that splits the
   cotangent, sums in a fixed order), against its plain PyTorch version
   ``ops.delta.delta_conv1_backward`` (fp32, TF32 off) on ReLU'd volumes, a
   quarter of whose differences are exact ties (sign(0) = 0), at B = 16 and
   32 for W' = 360, B = 16 for W' = 450, with only the weight's gradient
   asked (frozen legs), and untimed at B = 1 and B = 4. Gates, per gradient
   (da, db, dW): |kernel - plain| <= 1e-4 * (max|plain| + |plain|)
   elementwise, i.e. rtol = atol = 1e-4 after dividing by the gradient's
   largest magnitude (``max_abs_err`` is the largest error over that
   magnitude); and two calls on the same inputs give the same bits. Timed
   with CUDA events beside the plain version and the library yardstick (two
   torch.matmul over the materialized operands, never called by the port);
   bounds as for K1 (operations 4*B*W'*J*S*C*F), with the share of the
   3xTF32 bound and of the fp32 CUDA-core bound. Two more forms reach beyond
   one call of K2's C entry: C = 64 at W' = 360 (channels zero-padded to
   128) and W' = 495 (W'//S = 33: two column groups), both at B = 4.
7. train: ``OverlapNetConfig()`` at full width (bf16 legs, W' = 360, batch
   16, Adagrad), seeded weights, a seeded set of scans and column-rolled
   revisits on disk, through ``ResidentPairs`` +
   ``Trainer.run_epoch_resident`` (20 steps), ``PairImageDataset`` +
   ``Trainer.run_epoch`` (3 steps), ``Trainer.evaluate``,
   ``save_checkpoint`` -> a fresh ``Trainer`` -> ``restore_checkpoint``, and
   ``save_params_npz`` -> ``Infer``. Gates: (a) K1 is launched once per train
   step, evaluated batch and served request, K2 once per train step; (b)
   with fp32 legs and TF32 off the first step's loss and every parameter's
   gradient agree with the same ``Trainer`` on the CPU (loss |d| < 1e-4,
   relative where the loss is above 1; gradients within 2e-3 of each
   tensor's largest magnitude), and the gradients of c_conv1 and of the
   first leg conv are not zero; (c) three resident steps give the losses of
   three host-batch steps on the same pairs (the first within 1e-6, all
   within 1e-3 relative); (d) losses are finite and the mean of the last
   five is below the mean of the first five; (e) the restored trainer's next
   step equals the uninterrupted one; (f) the exported npz served by
   ``Infer`` gives the trained model's overlaps (|d| < 5e-3, bf16 legs).
   Step ms, pairs/s and a profiled window's device-busy share and top rows
   are printed as information.
8. prep: the data-preparation path through the port's CLI at full size: a
   seeded two-lap sequence of 300 sim scans (``sim/world.py`` defaults, up to
   130,000 points a scan, padded to 140,000), ``gen-data`` (64x900 depth,
   normal and intensity images), ``gen-gt --all-queries`` (300 x 300
   pairs), ``pack``, and ``train --pack-dir`` for 8 steps of
   ``OverlapNetConfig()`` (bf16 legs, W' = 360, batch 16) from host batches
   that the native batcher gathers from the packs. Gates: (a) the first 8
   scans' images on the card against the CPU (proj_idx equal on 99.99% of
   the pixels; range, vertex and intensity equal bit for bit where the
   winner is the same; normals within 1e-5 where they read the same
   winners); (b) 8 query frames against all 300 on the card against the CPU
   (ids and yaw bins equal, overlaps within 2 pixels' worth of the query),
   again with TF32 allowed for matmuls; (c) the GT chunk loop runs under
   ``torch.cuda.set_sync_debug_mode("error")``, and ``gen-gt``'s table is
   the one ``com_overlap_yaw_all`` gives on the loaded scans; (d) batches of
   ``PairImageDataset(packs=...)`` with rotate_data=1 equal the per-image
   batches bit for bit, with the native library built and loaded; (e) K1
   once and K2 once per train step (K1 also once per evaluated batch),
   finite losses. Scans/s of gen-data, GT pairs/s by CUDA events and by the
   host clock, the device time of one 256-pair GT chunk by kernel row, the
   pack's build time and ms per step from packs against the resident store
   are printed as information.
9. e2e: the sim harness ``sim.e2e.run_e2e(device="cuda")`` at full width
   (64 sim frames of up to 130,000 points, ``OverlapNetConfig()`` with
   ``make_config``'s overrides, bf16 legs, W' = 360, 6 epochs at batch 8):
   images, GT, resident training, online loop closing, pose graph. Gates:
   (a) the floors of tests/test_accuracy_floor.py (trained overlap RMS below
   0.8 of the untrained, loop-closure F1 >= 0.9, false positives <= true
   positives, yaw error p50 <= 2 degrees, ATE after <= 1.2 x before); K1
   once per train step and evaluated batch and K2 once per train step in
   training, K1 in loop closing; K1 on the trained legs' features and
   c_conv1 (each frame against the next and against the frame half the run
   away) within 1e-5 of the float64 plain version on every pair (relative
   norm), with the pairs' cancellation ratios and paths printed (also when
   a floor fails); (b) ``cli evaluate``'s ``evaluate()`` on the
   run's validation set with its ``trained_params.npz``: overlap RMS within
   1e-3 of ``Trainer.evaluate``'s; (c) the pose graph at KITTI 00's length
   (4,541 poses, 200 yaw-only closures, 5 gross outliers, 30 iterations of
   200 CG steps, annealed Tukey): the card against the same call on the CPU
   (poses within 1e-3 m and 1e-4 rad, ATE within 1e-3 m), three calls on the
   card with equal bits, the solve under
   ``torch.cuda.set_sync_debug_mode("error")``. Stage times, ms per solve on
   the card and on the CPU and a profiled one-iteration solve are printed as
   information, and the whole metrics dict.

10. dist: the multi-device layer (``parallel/mesh.py`` over
   torch.distributed). (a) One NCCL rank in this process, started by
   ``maybe_initialize_distributed`` from the ``OVERLAPNET_*`` variables: ``cli
   train`` at full width (5 steps of batch 16, each evaluated) on the mesh
   path against ``--single-device`` (cuDNN deterministic): parameters, losses
   and grad norms equal bit for bit, K1 once per step and evaluated batch
   and K2 once per step; ``Infer(mesh=make_mesh(1))`` over phase lcd's
   400-frame sequence under ``torch.cuda.set_sync_debug_mode("error")``,
   K1 at least once per scored frame, closures equal to ``Infer(shards=1)``;
   the 4,541-pose solve on the mesh equal to no mesh. (b) Two gloo ranks
   sharing the card (NCCL refuses two ranks on one card), spawned as
   ``python3 chip_smoke.py dist-rank <r> <dir>`` after the kernels are built:
   data-parallel training with fp32 legs and TF32 off, 2 x 8 pairs against
   one device at 16 (first step: loss within 1e-5 relative, every parameter
   within rtol 1e-4 / atol 1e-6; parameters bit-equal across ranks; K1 once
   per step and evaluated batch and K2 once per step on each rank); the
   rank-sharded map over the 400 frames against one device with 2 shards
   (the same frames and matches, overlaps within 1e-6, yaw within 1e-3
   degrees); the edge-sharded 4,541-pose solve equal on both ranks, and in
   float64 over 2 iterations of 20 CG steps within 1e-6 m of one device (the
   float32 solve of 30 x 200 steps against one device is printed: it
   amplifies the other order of the ranks' sums to centimetres). Step times of the default model
   and frames/s are printed beside the one-device figures as information:
   two ranks on one card measure the mechanism, not scaling.

In each launch count of the phases model, lcd, train, prep, e2e and dist
(what their main-path runs launched, counted around them), K3 and K4 are
launched exactly as often as K1, once a head call, and at least once.

Then the ``kernels`` line (K1, K2, K3 and K4; each kernel's launches are
the sums over those phases' main-path runs, by phase; phases conv2's and
conv3's own calls are not counted), the nvidia-smi line, and last the
result line.
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


def kernel_launches() -> dict:
    """K1's, K2's, K3's and K4's launches so far: the port's ``k1.launches``,
    ``k2.launches``, ``k3.launches`` and ``k4.launches`` counters
    (``overlapnet_torch.core.profiling``)."""
    from overlapnet_torch.core.profiling import totals

    t = totals()
    return {"delta_conv1": t.get("k1.launches", 0), "delta_conv1_bwd": t.get("k2.launches", 0),
            "c_conv2_relu": t.get("k3.launches", 0), "c_conv3_dense": t.get("k4.launches", 0)}


def launches_since(start: dict) -> dict:
    """Each kernel's launches since ``start`` (a ``kernel_launches()``)."""
    return {k: n - start[k] for k, n in kernel_launches().items()}


def heads_per_head_call(launches: dict, what: str) -> None:
    """Every head call on the card launches K1, then K3, then K4, once each:
    raises unless ``launches`` (a ``launches_since``) holds some K1 launches
    and as many of K3 and of K4."""
    k1, k3, k4 = (launches[k] for k in ("delta_conv1", "c_conv2_relu", "c_conv3_dense"))
    if k1 == 0 or k3 != k1 or k4 != k1:
        raise RuntimeError(f"{what}: {k3} K3 and {k4} K4 launches for {k1} K1 launches "
                           "(head calls)")


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


def tpu_kernel_site(replaces: str, marker: str = "pallas_call") -> str:
    """'<package>/ops/pallas_delta.py:<line>' of the TPU kernel, found in this
    checkout's JAX package (read as text, not imported); the line must hold
    ``marker``."""
    rel, line = replaces.rsplit(":", 1)
    hits = [p for p in glob.glob(os.path.join(ROOT, "*", rel))
            if not p.startswith(os.path.join(ROOT, "overlapnet_torch"))]
    if len(hits) != 1:
        raise RuntimeError(f"TPU kernel source {rel} not found in the checkout: {hits}")
    with open(hits[0]) as f:
        text = f.read().splitlines()
    if marker not in text[int(line) - 1]:
        raise RuntimeError(f"{hits[0]}:{line} does not hold {marker!r}")
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


def volume(torch, rng, bsz: int, w: int, c: int = C, offset=0):
    """A (B, W', C) leg-feature-scale volume on the card: ReLU outputs, or
    normals of mean ``offset`` and spread 1; "mixed": the batch's second
    half with an offset of 30."""
    x = rng.normal(size=(bsz, w, c))
    if offset == "mixed":
        x[: bsz // 2] = np.maximum(x[: bsz // 2], 0)
        x[bsz // 2:] += 30
    else:
        x = x + offset if offset else np.maximum(x, 0)
    return torch.from_numpy(x.astype(np.float32)).cuda()


def k1_pair_errors(torch, plain, out, a, b, kern, bias) -> list[float]:
    """Relative norm of K1's error on each of up to K1_FP64_PAIRS pairs
    (spread over the batch) against the plain version in float64."""
    idx = np.unique(np.linspace(0, a.shape[0] - 1, K1_FP64_PAIRS).round().astype(int))
    sel = torch.from_numpy(idx).cuda()
    ref = plain.delta_conv1(a[sel].double(), b[sel].double(), kern.double(),
                            None if bias is None else bias.double(), stride=S)
    d = (out[sel].double() - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
    return [float(x) for x in d]


# (form, B, W', right volume expanded from one query, bias, timed beside the
# plain version and the library call, volumes of bf16 values, offset).
# Float32 volumes take K1's general path, bf16-valued ones (the bf16 legs'
# output) its exact path where a pair's cancellation ratio allows. Volumes
# are ReLU'd normals, or with an offset normals of that mean and spread 1
# (features that share an offset: the exact path's worst case, which the
# ratio sends down the general path past ROUTE_RATIO); "mixed" gives the
# second half of the batch an offset of 30 and the first none.
K1_FORMS = [
    ("b32_w360", 32, 360, False, True, True, False, 0),
    ("b32_w450", 32, 450, False, True, True, False, 0),
    ("query_stride0_b32_w360", 32, 360, True, True, False, False, 0),
    ("no_bias_b32_w360", 32, 360, False, False, False, False, 0),
    ("b1_w360", 1, 360, False, True, False, False, 0),
    ("b256_w360", 256, 360, False, True, False, False, 0),
    ("bf16_b32_w360", 32, 360, False, True, False, True, 0),
    ("bf16_b32_w450", 32, 450, False, True, False, True, 0),
    ("bf16_query_stride0_b256_w360", 256, 360, True, True, False, True, 0),
    ("bf16_b1_w360", 1, 360, False, True, False, True, 0),
    ("bf16_b256_w360", 256, 360, False, True, False, True, 0),
    ("bf16_b256_w450", 256, 450, False, True, False, True, 0),
    ("bf16_offset3_b32_w360", 32, 360, False, True, False, True, 3),
    ("bf16_offset5_b32_w360", 32, 360, False, True, False, True, 5),
    ("bf16_offset10_b32_w360", 32, 360, False, True, False, True, 10),
    ("bf16_offset30_b32_w360", 32, 360, False, True, False, True, 30),
    ("bf16_offset30_query_stride0_b32_w360", 32, 360, True, True, False, True, 30),
    ("bf16_mixed_b32_w360", 32, 360, False, True, False, True, "mixed"),
]
# K1's gate on each pair against the plain version in float64: the relative
# norm of the difference, as the benchmark's k1_err reads it (its limit)
K1_REL_LIMIT = 1e-5
K1_FP64_PAIRS = 16  # pairs of a form held to the float64 plain version
# K1's kernel rows (the pre-pass, the routes, the weight split, the product)
K1_ROWS = ("split_weight_kernel_sides", "split_weight_kernel_route", "split_weight_kernel",
           "delta_conv1_kernel")


def k1_rows_ms(torch, fn, iters: int = 5) -> dict | None:
    """Device milliseconds a call of each of K1's kernel rows (profiler),
    over ``iters`` calls; None when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    got = {}
    for e in prof.key_averages():
        row = next((r for r in K1_ROWS if r in e.key), None)
        if row is not None and e.self_device_time_total > 0:
            got[row] = got.get(row, 0.0) + e.self_device_time_total / 1e3 / iters
    return got or None


def exact_calls() -> int:
    """K1's calls so far that took its exact path (the device counter)."""
    from overlapnet_torch.core.profiling import totals

    return totals().get("k1.exact_calls", 0)


def phase_kernel(torch, k1, plain, name, smi):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peak_fp32, peak_tf32, peak_bw = card_peaks(name)
    peak_bf16 = 2 * peak_tf32  # dense bf16 is twice TF32 on Hopper (989 / 495)
    rows = {}
    for form, bsz, w, query, with_bias, yardsticks, bf16, offset in K1_FORMS:
        j = w // S
        rng = np.random.default_rng(w + 1000 * bf16 + bsz + 7 * len(form))
        a = volume(torch, rng, bsz, w, offset=offset)
        b = (volume(torch, rng, 1, w, offset=offset).expand(bsz, w, C) if query
             else volume(torch, rng, bsz, w, offset=offset))
        if bf16:
            a = a.bfloat16().float()
            b = b.bfloat16().float()
        # glorot-scale weights, as the head's init
        limit = math.sqrt(6.0 / (S * C + S * F))
        kern = torch.from_numpy(rng.uniform(-limit, limit, size=(S, C, F)).astype(np.float32)).cuda()
        bias = torch.from_numpy(rng.normal(size=(F,)).astype(np.float32) * 0.1).cuda()
        bias = bias if with_bias else None
        if k1.exact_operands(a, b, S) != bf16:
            raise RuntimeError(f"{form}: exact_operands says {not bf16}")
        pairs = k1.exact_pairs(a, b, kern, S)
        exact = bool(pairs.all())
        rho = k1.cancellation_ratio(a, b, kern, S)

        before = exact_calls()
        out = k1.delta_conv1(a, b, kern, bias, stride=S)
        again = k1.delta_conv1(a, b, kern, bias, stride=S)
        torch.cuda.synchronize()
        took_exact = exact_calls() - before
        if took_exact != 2 * exact:
            raise RuntimeError(f"{form}: {took_exact} of 2 calls took the exact path on "
                               f"every pair, the volumes say {'both' if exact else 'none'}")
        if not torch.equal(out, again):
            raise RuntimeError(f"{form}: two calls of K1 gave different bits")
        ref = plain.delta_conv1(a, b, kern, bias, stride=S)
        err = float((out - ref).abs().max())
        rel_err = float((out - ref).norm() / ref.norm())
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        pair_errs = k1_pair_errors(torch, plain, out, a, b, kern, bias)
        if max(pair_errs) > K1_REL_LIMIT:
            raise RuntimeError(f"{form}: a pair's relative error {max(pair_errs)} against the "
                               f"float64 plain version passes {K1_REL_LIMIT}")
        del out, again, ref

        call = lambda: k1.delta_conv1(a, b, kern, bias, stride=S)  # noqa: E731
        kernel_ms = time_ms(torch, call, 20)
        row = {"max_abs_err": err, "rel_norm_err": rel_err, "ms": kernel_ms,
               "path": "exact" if exact else "general" if not pairs.any() else "mixed",
               "exact_pairs": int(pairs.sum()), "rho_max": float(rho.max()),
               "rho_min": float(rho.min()), "worst_pair_rel_err_fp64": max(pair_errs)}
        if bsz == 256:
            row["rows_ms"] = k1_rows_ms(torch, call)
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
        # the path's floor: three exact bf16 products a pair, or six (the
        # tensor-core work of 3xTF32)
        products = 3 + 3 * (1 - float(pairs.float().mean()))
        floor_ms = max(products * flops / peak_bf16 * 1e3, t_bytes)
        row.update({
            "bound_ms": max(t_tf32, t_bytes),
            "bound_by": "operations" if t_tf32 >= t_bytes else "bytes",
            "bound_3xtf32_ms": max(3 * t_tf32, t_bytes),
            "bound_fp32_simt_ms": max(flops / peak_fp32 * 1e3, t_bytes),
            "floor_ms": floor_ms,
        })
        rows[form] = row
        emit({
            "phase": "kernel", "kernel": "delta_conv1", "form": form, "w": w, "j": j,
            "batch": bsz, "b_batch_stride": b.stride(0), "bias": with_bias,
            "bf16_values": bf16, "offset": offset, "exact_calls_of_2": took_exact,
            "channels": C, "stride": S, "features": F, "rtol": 1e-4, "atol": 1e-4,
            **row, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "kernel_tflops": flops / kernel_ms / 1e9, "peak_tf32_tflops": peak_tf32 / 1e12,
            "share_of_floor": floor_ms / kernel_ms,
            "share_of_3xtf32_bound": row["bound_3xtf32_ms"] / kernel_ms, "card": smi,
        })
    # C = 96, which the wrapper zero-pads to the kernel's 64-channel chunks,
    # on both paths and with a query expanded over the batch; untimed
    rng = np.random.default_rng(96)
    for values in ("float32", "bf16"):
        a = volume(torch, rng, 4, 360, 96)
        b = volume(torch, rng, 1, 360, 96).expand(4, 360, 96)
        if values == "bf16":
            a, b = a.bfloat16().float(), b.bfloat16().float()
        kern = torch.from_numpy(rng.normal(size=(S, 96, F)).astype(np.float32) * 0.02).cuda()
        out = k1.delta_conv1(a, b, kern, None, stride=S)
        ref = plain.delta_conv1(a, b, kern, None, stride=S)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        emit({"phase": "kernel", "kernel": "delta_conv1", "form": f"c96_query_stride0_b4_{values}",
              "path": "exact" if k1.exact_operands(a, b, S) else "general",
              "max_abs_err": float((out - ref).abs().max()), "card": smi})
    return rows


# (form, B, W', C, only the weight's gradient asked (frozen legs), timed,
# timed beside the plain version and the library calls)
K2_FORMS = [
    ("b16_w360", 16, 360, C, False, True, True),
    ("b32_w360", 32, 360, C, False, True, True),
    ("b16_w450", 16, 450, C, False, True, False),
    ("frozen_legs_b16_w360", 16, 360, C, True, True, False),
    # a partial wave of blocks and short batch sums: one pair, and the train
    # phase's parity batch
    ("b1_w360", 1, 360, C, False, False, False),
    ("b4_w360", 4, 360, C, False, False, False),
    # shapes K1 takes beyond one call of K2's C entry: 64 channels (padded to
    # 128), and W'//S = 33 (two column groups, 32 + 1)
    ("c64_b4_w360", 4, 360, 64, False, True, False),
    ("b4_w495", 4, 495, C, False, True, False),
]
K2_GATE = 1e-4


def held_to_scale(torch, out, ref, what: str) -> float:
    """K2's gate: |out - ref| <= K2_GATE * (max|ref| + |ref|) elementwise,
    i.e. rtol = atol = 1e-4 once both are divided by the gradient's largest
    magnitude. Returns the largest absolute error over that magnitude."""
    scale = float(ref.abs().max())
    if not scale > 0:
        raise RuntimeError(f"{what}: the plain version's gradient is all zero")
    torch.testing.assert_close(out / scale, ref / scale, rtol=K2_GATE, atol=K2_GATE, msg=lambda m: f"{what}: {m}")
    return float((out - ref).abs().max()) / scale


def phase_kernel_bwd(torch, k1, plain, name, smi):
    """K2 (K1's backward) against ``ops.delta.delta_conv1_backward``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peak_fp32, peak_tf32, peak_bw = card_peaks(name)
    rows = {}
    for form, bsz, w, c, frozen, timed, yardsticks in K2_FORMS:
        j = w // S
        groups = -(-j // k1.BWD_MAX_J)  # calls of K2's C entry
        rng = np.random.default_rng(1000 + w + bsz + c)
        a, b = volume(torch, rng, bsz, w, c), volume(torch, rng, bsz, w, c)
        ties = float((a[:, :, None, :] == b[:, None, : j * S, :]).float().mean())
        if ties < 0.1:
            raise RuntimeError(f"test volumes hold too few exact ties ({ties})")
        limit = math.sqrt(6.0 / (S * c + S * F))
        kern = torch.from_numpy(rng.uniform(-limit, limit, size=(S, c, F)).astype(np.float32)).cuda()
        g = torch.from_numpy(rng.normal(size=(bsz, w, j, F)).astype(np.float32)).cuda()

        def run():
            return k1.delta_conv1_backward(a, b, kern, g, stride=S, need_volumes=not frozen)

        k_start = kernel_launches()
        got = run()
        torch.cuda.synchronize()
        counted = launches_since(k_start)["delta_conv1_bwd"]
        if counted != groups:
            raise RuntimeError(f"K2's wrapper counted {counted} launches for {groups} column groups")
        # every sum is taken in a fixed order: a second call gives the same bits
        again = run()
        torch.cuda.synchronize()
        for what, out, out2 in zip(("da", "db", "dkernel"), got, again):
            if out is not None and not torch.equal(out, out2):
                raise RuntimeError(f"{form}: two calls gave different bits for {what}")
        del again
        ref = plain.delta_conv1_backward(a, b, kern, g, stride=S)
        errs = {}
        for what, out, want in zip(("da", "db", "dkernel"), got, ref):
            if frozen and what != "dkernel":
                if out is not None:
                    raise RuntimeError(f"{form}: {what} computed though not asked for")
                continue
            errs[what] = held_to_scale(torch, out, want, f"{form} {what}")
        if not frozen:  # ties pass no gradient: db of an all-equal column pair
            zero_rows = (ref[1].abs().amax(dim=(0, 2)) == 0).nonzero().flatten().tolist()
            if zero_rows != list(range(j * S, w)):
                raise RuntimeError(f"{form}: db rows past J*S: {zero_rows}")
            if float(got[1][:, j * S:].abs().max() if w > j * S else 0.0) != 0.0:
                raise RuntimeError(f"{form}: db is not zero past J*S")
        del got, ref

        kernel_ms = time_ms(torch, run, 10) if timed else None
        row = {"max_abs_err": max(errs.values()), "err_over_scale": errs, "ms": kernel_ms}
        if yardsticks:
            row["plain_ms"] = time_ms(
                torch, lambda: plain.delta_conv1_backward(a, b, kern, g, stride=S), 3, warmup=1)
            # library yardstick: the two GEMMs over the materialized operands
            # (g @ W^T for every (i, j) row, |diff|^T @ g), without the sign
            # mask and the sums over j and i
            absd = (a.repeat(1, 1, S)[:, :, None, :]
                    - b[:, : j * S].reshape(bsz, 1, j, S * c)).abs_().reshape(-1, S * c)
            g2, wt = g.reshape(-1, F), kern.reshape(S * c, F).T.contiguous()
            gw = torch.empty((g2.shape[0], S * c), device="cuda")
            row["library_ms"] = time_ms(
                torch, lambda: (torch.matmul(g2, wt, out=gw), torch.matmul(absd.T, g2)), 3, warmup=1)
            row["library_operand_gb"] = absd.numel() * 4 / 1e9
            del absd, gw

        flops = (2 if frozen else 4) * bsz * w * j * S * c * F
        nbytes = 4 * (2 * bsz * w * c + S * c * F + bsz * w * j * F
                      + (0 if frozen else 2 * bsz * w * c) + S * c * F)
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
            "phase": "kernel_bwd", "kernel": k1.BWD_NAME, "form": form, "w": w, "j": j,
            "channels": c, "column_groups": groups,
            "batch": bsz, "only_dkernel": frozen, "exact_tie_share": ties,
            "gate": f"|d| <= {K2_GATE} * (max|ref| + |ref|) per gradient",
            "two_calls_equal_bits": True,
            **row, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "peak_tf32_tflops": peak_tf32 / 1e12, "peak_fp32_tflops": peak_fp32 / 1e12,
            **({"kernel_tflops": flops / kernel_ms / 1e9,
                "share_of_3xtf32_bound": row["bound_3xtf32_ms"] / kernel_ms,
                "share_of_fp32_simt_bound": row["bound_fp32_simt_ms"] / kernel_ms}
               if timed else {}),
            "card": smi,
        })
    return rows


# -- phase conv2 ----------------------------------------------------------------

# K3's forms: (form, B, W', S, timed). The head's are S = 15 at W' = 360
# (J = 24) and 450 (J = 30), at the head call's 256 pairs, at 32, and at the
# ragged chunks n % 256 (1, 3, 17); then another S that divides W' (8: J =
# 45) and one that does not (7: the last 3 rows of W' are read by no tap).
K3_FORMS = [
    ("b256_w360", 256, 360, 15, True),
    ("b32_w360", 32, 360, 15, True),
    ("b256_w450", 256, 450, 15, True),
    ("b32_w450", 32, 450, 15, False),
    ("b1_w360", 1, 360, 15, True),
    ("b3_w360", 3, 360, 15, False),
    ("b17_w360", 17, 360, 15, False),
    ("s8_b4_w360", 4, 360, 8, False),
    ("s7_b4_w360", 4, 360, 7, False),
]
# K3's gates against the plain version in float64 on the same inputs. TF32
# to nearest on both operands with fp32 sums: each pair's relative norm of
# the error about 3e-4 (truncating both operands instead: 7.9e-4), and the
# slope of the error on the output, sum(d * ref) / sum(ref^2), about 2e-7
# (truncation: -7.1e-4, every 960-term sum shrunk alike); a CPU emulation
# of both roundings on these volumes.
K3_REL_LIMIT = 5e-4
K3_SLOPE_LIMIT = 1e-4
# With cuDNN's TF32 off K3 runs 3xTF32, float32 accuracy: each pair within
# this of float64 (the benchmark's k1_err limit, a float32-level gate)
K3_SPLIT_REL_LIMIT = 1e-5


def phase_conv2(torch, name, smi):
    """K3 (c_conv2 + bias + ReLU) against its plain version in float64, its
    bits across calls and batch splits, and its time beside its byte bound,
    the plain version (fp32, TF32 off) and the library call (cuDNN's TF32
    conv + ReLU on the same channels-last input, what the head ran before).
    Leaves cuDNN's TF32 switch as it found it."""
    saved = torch.backends.cudnn.allow_tf32
    try:
        return conv2_forms(torch, name, smi)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of one ``fn()`` call, its launches replayed from a
    CUDA graph: no host time between them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(torch, graph.replay, 5) / iters


def conv2_forms(torch, name, smi):
    from overlapnet_torch.kernels import c_conv2_relu as k3

    # cuDNN's TF32 on, PyTorch's default and the head's (phases before this
    # one turn it off): K3's single TF32 product; each form also runs with it
    # off (3xTF32) and turns it back on
    torch.backends.cudnn.allow_tf32 = True
    _, peak_tf32, peak_bw = card_peaks(name)
    rows = {}
    for form, bsz, w, s, timed in K3_FORMS:
        j = w // S  # K1's right columns at the head's S = 15
        io = w // s
        rng = np.random.default_rng(bsz + w + 100 * s)
        # K1's output as K1 writes it, (B, W', J, 64), viewed as NCHW
        x = torch.from_numpy(rng.normal(size=(bsz, w, j, 64)).astype(np.float32)).cuda()
        xv = x.permute(0, 3, 1, 2)
        limit = math.sqrt(6.0 / (s * 64 + s * 128))
        wt = rng.uniform(-limit, limit, size=(128, 64, s, 1)).astype(np.float32)
        wt = torch.from_numpy(wt).cuda()
        bias = torch.from_numpy(rng.normal(size=(128,)).astype(np.float32) * 0.1).cuda()

        before = kernel_launches()
        out = k3.c_conv2_relu(xv, wt, bias, stride=s)
        again = k3.c_conv2_relu(xv, wt, bias, stride=s)
        torch.cuda.synchronize()
        rose = launches_since(before)["c_conv2_relu"]
        if rose != 2:
            raise RuntimeError(f"{form}: k3.launches rose by {rose}, not 2")
        if tuple(out.shape) != (bsz, 128, io, j) or not out.permute(0, 2, 3, 1).is_contiguous():
            raise RuntimeError(f"{form}: K3 gave {tuple(out.shape)} strides {out.stride()}, not "
                               f"(B, 128, W'//S, J) channels last")
        if not torch.equal(out, again):
            raise RuntimeError(f"{form}: two calls of K3 gave different bits")
        ref = k3.plain_c_conv2_relu(xv.double(), wt.double(), bias.double(), s)
        d = out.double() - ref
        pair_errs = (d.flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)).tolist()
        slope = float((d * ref).sum() / (ref * ref).sum())
        if max(pair_errs) > K3_REL_LIMIT or abs(slope) > K3_SLOPE_LIMIT:
            raise RuntimeError(f"{form}: K3 against float64: worst pair {max(pair_errs)} (limit "
                               f"{K3_REL_LIMIT}), slope {slope} (limit {K3_SLOPE_LIMIT})")
        row = {"worst_pair_rel_err_fp64": max(pair_errs), "error_slope": slope,
               "max_abs_err": float(d.abs().max())}
        # TF32 off: the 3xTF32 form
        torch.backends.cudnn.allow_tf32 = False
        split = k3.c_conv2_relu(xv, wt, bias, stride=s)
        if not torch.equal(split, k3.c_conv2_relu(xv, wt, bias, stride=s)):
            raise RuntimeError(f"{form}: two calls of K3 (3xTF32) gave different bits")
        torch.backends.cudnn.allow_tf32 = True
        d = split.double() - ref
        split_errs = (d.flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)).tolist()
        if max(split_errs) > K3_SPLIT_REL_LIMIT:
            raise RuntimeError(f"{form}: K3 with TF32 off (3xTF32) against float64: worst pair "
                               f"{max(split_errs)} (limit {K3_SPLIT_REL_LIMIT})")
        row["worst_pair_rel_err_fp64_3xtf32"] = max(split_errs)
        del again, ref, d, split
        if form == "b256_w360":
            # every batch a head call of at most 256 pairs can give, as rows
            # of one call: the same bits whatever the split
            for bb in range(1, bsz + 1):
                if not torch.equal(k3.c_conv2_relu(xv[:bb], wt, bias, stride=s), out[:bb]):
                    raise RuntimeError(f"{form}: K3 on the first {bb} pairs differs from the "
                                       f"same rows of the whole call")
            row["batches_bit_equal"] = bsz
        if timed:
            row["ms"] = time_ms(torch, lambda: k3.c_conv2_relu(xv, wt, bias, stride=s), 20)
            row["device_ms"] = graph_ms(torch, lambda: k3.c_conv2_relu(xv, wt, bias, stride=s))
            torch.backends.cudnn.allow_tf32 = False
            row["ms_3xtf32"] = time_ms(
                torch, lambda: k3.c_conv2_relu(xv, wt, bias, stride=s), 20)
            row["plain_ms"] = time_ms(
                torch, lambda: k3.plain_c_conv2_relu(xv, wt, bias, s), 10)
            torch.backends.cudnn.allow_tf32 = True
            conv = torch.nn.functional.conv2d
            row["library_ms"] = time_ms(
                torch, lambda: torch.relu(conv(xv, wt, bias, stride=(s, 1))), 10)
            row["library_device_ms"] = graph_ms(
                torch, lambda: torch.relu(conv(xv, wt, bias, stride=(s, 1))))
            nbytes = 4 * (x.numel() + wt.numel() + bias.numel() + out.numel())
            flops = 2 * bsz * io * j * 128 * 64 * s
            t_bytes, t_ops = nbytes / peak_bw * 1e3, flops / peak_tf32 * 1e3
            row.update({"bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "share_of_bound": max(t_bytes, t_ops) / row["device_ms"],
                        "mbytes": nbytes / 1e6, "gflop": flops / 1e9})
        rows[form] = row
        emit({"phase": "conv2", "kernel": k3.NAME, "form": form, "batch": bsz, "w": w,
              "stride": s, "j": j, **row, "card": smi})
        del out, x, xv
    return rows


# -- phase conv3 ----------------------------------------------------------------

# K4's forms: (form, B, W', timed). The head's J = W' // 15: 24 at W' = 360, 30
# at W' = 450 (circular legs), at the head call's 256 pairs, at 32 and at 1,
# and the ragged chunks n % 256 (3, 17); then the small test model's W' = 90
# (J = 6, many pairs a tile).
K4_FORMS = [
    ("b256_w360", 256, 360, True),
    ("b32_w360", 32, 360, True),
    ("b1_w360", 1, 360, True),
    ("b256_w450", 256, 450, True),
    ("b32_w450", 32, 450, True),
    ("b1_w450", 1, 450, True),
    ("b3_w360", 3, 360, False),
    ("b17_w360", 17, 360, False),
    ("b5_w90", 5, 90, False),
]
# K4's gates, on each pair's overlap (inputs below: logits over about +-3;
# tests/test_torch_c_conv3.py holds the same). Against the float64 plain
# version on x and c_conv3's weight rounded to TF32 to nearest, as K4 rounds
# them, what is left is K4's fp32 sums: up to 1.6e-6; bfloat16 operands read
# 6.5e-4 to 2.8e-3 there, truncated TF32 more than 1e-4.
K4_RNA_LIMIT = 2e-5
# Against the float64 plain version on the operands as given: TF32 rounding
# itself reads up to 3.0e-4.
K4_REL_LIMIT = 5e-4
# With cuDNN's TF32 off K4 runs 3xTF32, float32 accuracy: up to 4.7e-6
K4_SPLIT_LIMIT = 2e-5


def phase_conv3(torch, name, smi):
    """K4 (c_conv3 + bias + ReLU + the overlap dense) against its plain
    version in float64, its bits across calls and batch splits, and its time
    beside its TF32 bound, the plain version (fp32, TF32 off) and the library
    calls the head ran before K4 (cuDNN's TF32 conv with its bias, the ReLU,
    the flatten, the dense and the sigmoid). Leaves cuDNN's TF32 switch as
    it found it."""
    saved = torch.backends.cudnn.allow_tf32
    try:
        return conv3_forms(torch, name, smi)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def conv3_inputs(torch, bsz, j, seed):
    """K3's output as K3 lays it out, (B, J, J, 128) ReLU'd, viewed as NCHW;
    c_conv3's glorot-scale weight and a bias; a dense weight whose logits
    spread over a few units, and its bias (tests/test_torch_c_conv3.py)."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(bsz, j, j, 128)), 0).astype(np.float32)
    limit = math.sqrt(6.0 / (9 * 128 + 9 * 256))
    weight = rng.uniform(-limit, limit, size=(256, 128, 3, 3)).astype(np.float32)
    bias = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    k = (j - 2) * (j - 2) * 256
    dense_w = (rng.normal(size=(1, k)) * (4.0 / math.sqrt(k))).astype(np.float32)
    dense_b = np.array([0.1], np.float32)
    x = torch.from_numpy(x).cuda().permute(0, 3, 1, 2)
    return [x] + [torch.from_numpy(a).cuda() for a in (weight, bias, dense_w, dense_b)]


def rna_tf32(torch, t):
    """``t`` rounded to TF32 to nearest, ties away from zero (cvt.rna), as
    float64."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32).double()


def conv3_forms(torch, name, smi):
    from overlapnet_torch.kernels import c_conv3_dense as k4

    # cuDNN's TF32 on, PyTorch's default and the head's: K4's single TF32
    # product; each form also runs with it off (3xTF32)
    torch.backends.cudnn.allow_tf32 = True
    _, peak_tf32, peak_bw = card_peaks(name)
    rows = {}
    for form, bsz, w, timed in K4_FORMS:
        j = w // S
        args = conv3_inputs(torch, bsz, j, bsz + w)
        x, wt, bias, dense_w, dense_b = args

        before = kernel_launches()
        out = k4.c_conv3_dense(*args)
        again = k4.c_conv3_dense(*args)
        torch.cuda.synchronize()
        rose = launches_since(before)["c_conv3_dense"]
        if rose != 2:
            raise RuntimeError(f"{form}: k4.launches rose by {rose}, not 2")
        if tuple(out.shape) != (bsz, 1) or out.dtype != torch.float32:
            raise RuntimeError(f"{form}: K4 gave {tuple(out.shape)} {out.dtype}, not (B, 1) "
                               "float32")
        if not torch.equal(out, again):
            raise RuntimeError(f"{form}: two calls of K4 gave different bits")
        exact = [t.double() for t in args]
        ref = k4.plain_c_conv3_dense(*exact)
        ref_rna = k4.plain_c_conv3_dense(rna_tf32(torch, x), rna_tf32(torch, wt), *exact[2:])
        ref_bf16 = k4.plain_c_conv3_dense(x.bfloat16().double(), wt.bfloat16().double(),
                                          *exact[2:])
        err = float((out.double() - ref).abs().max())
        err_rna = float((out.double() - ref_rna).abs().max())
        bf16_rna = float((ref_bf16 - ref_rna).abs().max())
        if err > K4_REL_LIMIT or err_rna > K4_RNA_LIMIT:
            raise RuntimeError(f"{form}: K4 against float64: {err} (limit {K4_REL_LIMIT}), "
                               f"against TF32-rounded operands {err_rna} (limit {K4_RNA_LIMIT})")
        if bsz >= 32 and bf16_rna <= K4_RNA_LIMIT:
            raise RuntimeError(f"{form}: bfloat16 operands read {bf16_rna} against the "
                               f"TF32-rounded ones: the gate would not tell them apart")
        row = {"max_abs_err_fp64": err, "max_abs_err_vs_tf32_rna": err_rna,
               "bf16_control_vs_tf32_rna": bf16_rna,
               "tf32_rna_vs_fp64": float((ref_rna - ref).abs().max()),
               "overlap_range": [float(ref.min()), float(ref.max())]}
        # TF32 off: the 3xTF32 form
        torch.backends.cudnn.allow_tf32 = False
        split = k4.c_conv3_dense(*args)
        if not torch.equal(split, k4.c_conv3_dense(*args)):
            raise RuntimeError(f"{form}: two calls of K4 (3xTF32) gave different bits")
        torch.backends.cudnn.allow_tf32 = True
        row["max_abs_err_fp64_3xtf32"] = float((split.double() - ref).abs().max())
        if row["max_abs_err_fp64_3xtf32"] > K4_SPLIT_LIMIT:
            raise RuntimeError(f"{form}: K4 with TF32 off (3xTF32) against float64: "
                               f"{row['max_abs_err_fp64_3xtf32']} (limit {K4_SPLIT_LIMIT})")
        del again, exact, ref, ref_rna, ref_bf16, split
        if form == "b256_w360":
            # every batch a head call of at most 256 pairs can give, as rows
            # of one call: the same bits whatever the split
            for bb in range(1, bsz + 1):
                if not torch.equal(k4.c_conv3_dense(x[:bb], *args[1:]), out[:bb]):
                    raise RuntimeError(f"{form}: K4 on the first {bb} pairs differs from the "
                                       f"same rows of the whole call")
            row["batches_bit_equal"] = bsz
        if timed:
            def library():
                h = torch.relu(torch.nn.functional.conv2d(x, wt, bias))
                flat = h.permute(0, 2, 3, 1).reshape(bsz, -1)
                return torch.sigmoid(torch.nn.functional.linear(flat, dense_w, dense_b))

            row["ms"] = time_ms(torch, lambda: k4.c_conv3_dense(*args), 20)
            row["device_ms"] = graph_ms(torch, lambda: k4.c_conv3_dense(*args))
            row["library_ms"] = time_ms(torch, library, 10)
            row["library_device_ms"] = graph_ms(torch, library)
            torch.backends.cudnn.allow_tf32 = False
            row["ms_3xtf32"] = time_ms(torch, lambda: k4.c_conv3_dense(*args), 20)
            row["device_ms_3xtf32"] = graph_ms(torch, lambda: k4.c_conv3_dense(*args))
            row["plain_ms"] = time_ms(torch, lambda: k4.plain_c_conv3_dense(*args), 10)
            torch.backends.cudnn.allow_tf32 = True
            nbytes = 4 * sum(t.numel() for t in args) + 4 * bsz
            flops = 2.0 * bsz * (j - 2) * (j - 2) * 256 * 9 * 128
            t_bytes, t_ops = nbytes / peak_bw * 1e3, flops / peak_tf32 * 1e3
            row.update({"bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "share_of_bound": max(t_bytes, t_ops) / row["device_ms"],
                        "mbytes": nbytes / 1e6, "gflop": flops / 1e9})
        rows[form] = row
        emit({"phase": "conv3", "kernel": k4.NAME, "form": form, "batch": bsz, "w": w, "j": j,
              **row, "card": smi})
        del out, args, x
    return rows


# Row names of the library passes a head call ran before K3 and K4
HEAD_LIBRARY_ROWS = ("convertTensor", "fprop", "gemv", "clamp")


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
        return {"k1_ms": None, "k3_ms": None, "k4_ms": None, "library_rows": None, "top": None}
    return {
        "k1_ms": sum(ms for k, _, ms in rows if "delta_conv1" in k),
        "k3_ms": sum(ms for k, _, ms in rows if "c_conv2_relu_kernel" in k),
        "k4_ms": sum(ms for k, _, ms in rows if "c_conv3_dense" in k),
        # cuDNN's layout pass before c_conv2, which K3 replaced; cuDNN's
        # fprop of c_conv3, its bias add, the ReLU's clamp and the dense's
        # gemv, which K4 replaced
        "library_rows": [k[:80] for k, _, _ in rows
                         if any(n in k for n in HEAD_LIBRARY_ROWS)],
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


def phase_model(torch, smi):
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
        k_start = kernel_launches()
        t0 = time.perf_counter()
        res = serve(gpu, names)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = launches_since(k_start)
        heads_per_head_call(launches, "the serving path")
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
        if breakdown["library_rows"]:
            raise RuntimeError(f"a head call still runs a library pass of the overlap head: "
                               f"{breakdown['library_rows']}")

    emit({
        "phase": "model", "config": "OverlapNetConfig() 64x900x4, bf16 legs, W'=360",
        "pairs_served": pairs, "serve_s": serve_s, "launches": launches,
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


def busy_share(torch, run, top: int = 6, name_chars: int = 60) -> dict:
    """Device-busy time over the host's wall time of ``run()`` under
    torch.profiler (whose own cost lengthens the host side). Busy time is
    the sum over kernel and copy rows (device type CUDA); an operator's row
    repeats the time of the kernels it launched and is left out of the sum
    (``op_rows_device_ms`` keeps their total, for comparison)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # the profiler's own start-up, kept out of the window
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    # a span's mark on the device's timeline is no work
    rows = sorted(((e.key, e.self_device_time_total / 1e3) for e in events
                   if e.device_type.name == "CUDA" and not e.is_user_annotation),
                  key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if rows else None,
            "op_rows_device_ms": sum(e.self_device_time_total / 1e3 for e in events
                                     if e.device_type.name != "CUDA"),
            "top": [[k[:name_chars], ms] for k, ms in rows[:top]]}


def phase_lcd(torch, smi):
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

        def engine(covariances, config=cfg, device="cuda", frames=n, shards=1, **gates):
            infer = Infer(config, params=params, db_capacity=512, device=device, shards=shards)
            return OnlineLoopCloser(
                infer, poses[:frames],
                covariances=None if covariances is None else covariances[:frames],
                overlap_threshold=-1.0, **gates)

        for shards in (1, None):  # warm-up: cuDNN and cuFFT plans, pinned blocks
            engine(covs, shards=shards).run(LCD_OUT + 8)
        torch.cuda.synchronize()

        # the main path: the pipelined run, with no host synchronisation (d)
        candidates = gated_candidates(gating, poses, covs)
        scored_frames = sum(1 for c in candidates if c)
        pairs = sum(len(c) for c in candidates)
        piped = engine(covs)
        k_start = kernel_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            piped.run(pipeline_depth=8)
            piped_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launches = launches_since(k_start)
        heads_per_head_call(launches, "the pipelined run")
        if launches["delta_conv1"] < scored_frames:
            raise RuntimeError(f"{launches['delta_conv1']} delta_conv1 launches for "
                               f"{scored_frames} scored frames")
        if [c.frame for c in piped.closures] != [i for i, c in enumerate(candidates) if c]:
            raise RuntimeError("not every frame with candidates gave a result")

        # Infer without a shards argument (the dense cell's), pipelined the
        # same way: no host synchronisation, every frame dispatched
        # unresolved, and the shards=1 engine's result frame by frame
        plain = engine(covs, shards=None)
        dispatch, unresolved = plain.infer.dispatch_frame, []

        def recording(*args, **kw):
            pending = dispatch(*args, **kw)
            unresolved.append(pending._event is not None and not pending._done)
            return pending

        plain.infer.dispatch_frame = recording
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            plain.run(pipeline_depth=8)
            plain_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if len(unresolved) != n or not all(unresolved):
            raise RuntimeError(f"Infer(cfg) resolved {unresolved.count(False)} of "
                               f"{len(unresolved)} frames at dispatch")
        same_closures(plain.closures, piped.closures, "Infer(cfg) vs Infer(cfg, shards=1)")

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
        k_start = kernel_launches()
        t0 = time.perf_counter()
        wide.run(pipeline_depth=8)
        torch.cuda.synchronize()
        wide_s = time.perf_counter() - t0
        wide_launches = launches_since(k_start)
        heads_per_head_call(wide_launches, "the run without covariances")
        wide_launches = wide_launches["delta_conv1"]
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
        "launches": launches, "sync_debug_mode": "error: nothing raised",
        "frames_per_s_pipelined": n / piped_s, "frames_per_s_pipelined_plain_store": n / plain_s,
        "frames_per_s_stepped": n / stepped_s,
        "pipelined_s": piped_s, "pipelined_plain_store_s": plain_s, "stepped_s": stepped_s,
        "plain_store_frames_unresolved_at_dispatch": sum(unresolved),
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


# -- phase train ----------------------------------------------------------------

TRAIN_BASE = 12      # scans; each has a column-rolled revisit
TRAIN_BATCH = 16     # the default batch: 12 revisit pairs + 4 unrelated pairs
TRAIN_STEPS = 20     # resident steps on the repeated small set
TRAIN_HOST_STEPS = 3
GRAD_GATE = 2e-3     # GPU vs CPU gradient, over the tensor's largest magnitude


def write_train_set(root: str, height: int, width: int, out_width: int):
    """Seeded scans and column-rolled revisits on disk (as ``write_loop``
    makes them) and the pair table: scan TRAIN_BASE + j is scan j rolled by
    ``rolls[j]`` columns plus depth noise; that pair has overlap 0.9 and the
    yaw bin of its roll (reference npz convention, bin = W'/2 - yaw in
    degrees at one bin a degree); four pairs of unrelated scans have overlap
    0.05. Returns the (n, 4) table [i1, i2, overlap, yaw_bin]."""
    rng = np.random.default_rng(31)
    for kind in ("depth", "normal"):
        os.makedirs(os.path.join(root, "00", kind))
    rolls = 2 * rng.integers(10, width // 10, size=TRAIN_BASE) * rng.choice([-1, 1], size=TRAIN_BASE)
    rows = []
    for j in range(TRAIN_BASE):
        depth = np.abs(rng.normal(size=(height, width))).astype(np.float32) * 20.0
        normal = rng.normal(size=(height, width, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        noise = 0.02 * rng.normal(size=(height, width)).astype(np.float32)
        for i, (d, n) in ((j, (depth, normal)),
                          (TRAIN_BASE + j, (np.roll(depth, rolls[j], axis=1) + noise,
                                            np.roll(normal, rolls[j], axis=1)))):
            np.save(os.path.join(root, "00", "depth", f"{i:06d}.npy"), d)
            np.save(os.path.join(root, "00", "normal", f"{i:06d}.npy"), n)
        yaw_deg = rolls[j] * 360.0 / width
        rows.append([TRAIN_BASE + j, j, 0.9, round(out_width // 2 - yaw_deg) % out_width])
    for j in range(TRAIN_BATCH - TRAIN_BASE):
        rows.append([j, (j + 5) % TRAIN_BASE, 0.05, out_width // 2])
    return np.asarray(rows, np.float64)


def grads_of(torch, trainer_mod, cfg, trainer, batch):
    """One batch's loss metrics and gradients through ``trainer``'s model,
    as host float64 / CPU tensors."""
    device = trainer.device
    b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    metrics, grads = trainer_mod.loss_and_grads(
        cfg, trainer.state.model, b["x1"], b["x2"], b["overlap"], b["orientation"])
    return ({k: float(v) for k, v in metrics.items()},
            {k: g.detach().float().cpu() for k, g in grads.items()})


def phase_train(torch, smi):
    from overlapnet_torch.core.config import OverlapNetConfig
    from overlapnet_torch.data.dataset import PairImageDataset, ResidentPairs
    from overlapnet_torch.data.gt_files import load_gt_pairs, save_gt_files
    from overlapnet_torch.lcd.infer import Infer
    from overlapnet_torch.models import leg_output_width
    from overlapnet_torch.train import trainer as trainer_mod
    from overlapnet_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint, save_params_npz)

    cfg = OverlapNetConfig()
    assert (cfg.model.leg_dtype, cfg.model.input_width, cfg.train.batch_size,
            cfg.train.optimizer) == ("bfloat16", 900, TRAIN_BATCH, "adagrad")
    out_width = leg_output_width(cfg.model)
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, leg_dtype="float32"))
    # PyTorch's defaults for the main path (cuDNN may use TF32 for fp32
    # convs, matmuls stay fp32); the comparisons below turn TF32 off
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False

    with tempfile.TemporaryDirectory() as tmp:
        table = write_train_set(tmp, cfg.model.input_height, cfg.model.input_width, out_width)
        gt = save_gt_files(os.path.join(tmp, "00", "ground_truth"), "00", table, table, table)
        pairs = load_gt_pairs([gt["train_set"]], shuffle=False)
        cfg.data.data_root_folder = cfg32.data.data_root_folder = tmp
        cfg.data.infer_seqs = cfg32.data.infer_seqs = "00"

        def dataset():
            return PairImageDataset(tmp, pairs, cfg.channels, cfg.model.input_height,
                                    cfg.model.input_width, leg_output_width=out_width)

        def trainer_for(config, device="cuda"):
            # one step an epoch: the schedule leaves its warm-up after step 0
            return trainer_mod.Trainer(config, steps_per_epoch=1, device=device)

        ds = dataset()
        warm = trainer_for(cfg)  # cuDNN and cuFFT plans, first launches
        warm.run_epoch_resident(ResidentPairs(ds), TRAIN_BATCH, epoch=0)
        del warm
        torch.cuda.synchronize()

        # ---- the main path, with the launch counts read around it
        k_start = kernel_launches()
        trainer = trainer_for(cfg)
        resident = ResidentPairs(ds)
        losses, t0 = [], time.perf_counter()
        for epoch in range(TRAIN_STEPS):
            losses.append(trainer.run_epoch_resident(resident, TRAIN_BATCH, epoch)["epoch_loss"])
        resident_s = time.perf_counter() - t0
        host_losses = [
            trainer.run_epoch(ds.batches(TRAIN_BATCH, epoch=e, shuffle=True, drop_remainder=True),
                              epoch=e)["epoch_loss"]
            for e in range(TRAIN_STEPS, TRAIN_STEPS + TRAIN_HOST_STEPS)]
        eval_metrics = trainer.evaluate(ds.batches(TRAIN_BATCH))
        ckpt = os.path.join(tmp, "checkpoints")
        saved_step = save_checkpoint(ckpt, trainer.state)
        restored = trainer_for(cfg)
        restore_checkpoint(ckpt, restored.state)
        next_epoch = TRAIN_STEPS + TRAIN_HOST_STEPS
        after = [t.run_epoch_resident(resident, TRAIN_BATCH, next_epoch)
                 for t in (trainer, restored)]
        npz = os.path.join(tmp, "params.npz")
        save_params_npz(npz, trainer.state.params)
        cfg.experiment.pretrained_weightsfilename = npz
        names = [f"{i:06d}" for i in range(2 * TRAIN_BASE)]
        served = Infer(cfg, db_capacity=8, device="cuda")
        # left leg = second_idxs (the revisits, x1 of the pairs), right = first_idxs
        served_overlaps, _ = served.infer_multiple_vs_multiple(
            names, list(range(4)), list(range(TRAIN_BASE, TRAIN_BASE + 4)))
        torch.cuda.synchronize()
        launches = launches_since(k_start)

        # (a) one K1 and one K3 launch per train step, per evaluated batch
        # and per served request; one K2 launch per train step
        train_steps = TRAIN_STEPS + TRAIN_HOST_STEPS + 2
        if launches != {"delta_conv1": train_steps + 1 + 1, "delta_conv1_bwd": train_steps,
                        "c_conv2_relu": train_steps + 1 + 1,
                        "c_conv3_dense": train_steps + 1 + 1}:
            raise RuntimeError(f"launches {launches} for {train_steps} train steps, "
                               "1 evaluated batch and 1 served request")
        if saved_step != TRAIN_STEPS + TRAIN_HOST_STEPS or restored.state.step != saved_step + 1:
            raise RuntimeError(f"checkpoint steps: saved {saved_step}, restored trainer at "
                               f"{restored.state.step}")
        # (d) finite, and falling on the repeated set
        all_losses = losses + host_losses
        if not np.all(np.isfinite(all_losses)):
            raise RuntimeError(f"losses not finite: {all_losses}")
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        if not last < first:
            raise RuntimeError(f"loss did not fall: first five {first}, last five {last}")
        if not all(np.isfinite(v) for v in eval_metrics.values()):
            raise RuntimeError(f"evaluation metrics not finite: {eval_metrics}")
        # (e) the restored trainer's next step is the uninterrupted one
        d_restore = max(abs(after[0][k] - after[1][k]) for k in ("loss", "grad_norm"))
        if d_restore > 1e-4 * max(1.0, abs(after[0]["grad_norm"])):
            raise RuntimeError(f"restored trainer's next step differs: {after}")
        # (f) the exported npz, served, gives the trained model's overlaps
        (batch,) = list(ds.batches(4, max_batches=1))
        with torch.inference_mode():
            model_overlaps, _ = trainer.state.model(
                torch.from_numpy(batch["x1"]).cuda(), torch.from_numpy(batch["x2"]).cuda())
        d_served = float(np.abs(model_overlaps.flatten().cpu().numpy() - served_overlaps).max())
        if d_served >= 5e-3:  # bf16 legs at another batch size
            raise RuntimeError(f"served overlaps differ from the trained model's by {d_served}")

        # ---- (b) fp32 legs, TF32 off: the first step's loss and every
        # parameter's gradient against the same Trainer on the CPU
        torch.backends.cudnn.allow_tf32 = False
        (batch4,) = list(ds.batches(4, max_batches=1))
        on = {dev: grads_of(torch, trainer_mod, cfg32, trainer_for(cfg32, dev), batch4)
              for dev in ("cuda", "cpu")}
        # relative to the loss where it is above 1 (random weights on 20 m
        # depths give correlation logits, and so a first loss, in the hundreds)
        d_loss = (abs(on["cuda"][0]["loss"] - on["cpu"][0]["loss"])
                  / max(1.0, abs(on["cpu"][0]["loss"])))
        if d_loss >= 1e-4:
            raise RuntimeError(f"fp32 first step: GPU vs CPU loss |d| {d_loss}: {on['cuda'][0]} "
                               f"vs {on['cpu'][0]}")
        # each gradient within GRAD_GATE of its tensor's largest magnitude.
        # 2e-3, not 1e-3: the overlap loss is a sigmoid of 24 x the error, so
        # the head's gradients carry the forward's differences (K1's general
        # path on the card, |a - b| in three bf16 pieces against W in three;
        # fp32 on the CPU) some hundred times enlarged; c_conv3 was measured
        # at 1.05e-3 on an H100
        rel = {}
        for name, g_cpu in on["cpu"][1].items():
            scale = float(g_cpu.abs().max())
            d = float((on["cuda"][1][name] - g_cpu).abs().max())
            rel[name] = d / scale if scale > 0 else float(d > 0)
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
        if worst[0][1] > GRAD_GATE:
            raise RuntimeError(f"fp32 first step: gradients differ from the CPU's, relative to "
                               f"each tensor's max: {worst}")
        for name in ("overlap_head.c_conv1.weight", "legs.s_conv1.weight"):
            if not float(on["cuda"][1][name].abs().max()) > 0:
                raise RuntimeError(f"the gradient of {name} is zero on the card")

        # ---- (c) resident steps == host-batch steps on the same pairs
        # (fp32 legs, three steps each from the same weights)
        res_t, host_t = trainer_for(cfg32), trainer_for(cfg32)
        res_l = [res_t.run_epoch_resident(resident, TRAIN_BATCH, e)["epoch_loss"] for e in range(3)]
        host_l = [host_t.run_epoch(ds.batches(TRAIN_BATCH, epoch=e, shuffle=True,
                                              drop_remainder=True), epoch=e)["epoch_loss"]
                  for e in range(3)]
        # the first losses come from the same weights; the later ones follow
        # updates whose gradients cuDNN may sum in another order on each run
        d_resident = [abs(a - b) / abs(b) for a, b in zip(res_l, host_l)]
        moved = max(float((p - q).abs().max()) for p, q in
                    zip(res_t.state.params.values(), host_t.state.params.values()))
        if d_resident[0] > 1e-6 or max(d_resident) > 1e-3:
            raise RuntimeError(f"resident vs host-batch losses: {res_l} vs {host_l}")

        # ---- information: step time and pairs/s over epochs of ten steps
        # (the losses are fetched once an epoch, so the host runs ahead of
        # the device) and of one step (a fetch after every step), and a
        # profiled ten-step epoch
        torch.backends.cudnn.allow_tf32 = True
        long_ds = PairImageDataset(
            tmp, pairs[np.tile(np.arange(TRAIN_BATCH), 10)], cfg.channels,
            cfg.model.input_height, cfg.model.input_width, leg_output_width=out_width)
        long_resident = ResidentPairs(long_ds)
        epoch = next_epoch + 1
        trainer.run_epoch_resident(long_resident, TRAIN_BATCH, epoch)
        torch.cuda.synchronize()
        step_ms = trainer.run_epoch_resident(
            long_resident, TRAIN_BATCH, epoch + 1)["sec_per_dispatch"] * 1e3
        host_step_ms = trainer.run_epoch(
            long_ds.batches(TRAIN_BATCH, epoch=epoch + 2, shuffle=True, drop_remainder=True),
            epoch=epoch + 2)["sec_per_dispatch"] * 1e3
        t0 = time.perf_counter()
        for e in range(10):
            trainer.run_epoch_resident(resident, TRAIN_BATCH, epoch + 3 + e)
        fetched_step_ms = (time.perf_counter() - t0) * 1e2
        torch.cuda.reset_peak_memory_stats()
        window = busy_share(torch, lambda: trainer.run_epoch_resident(
            long_resident, TRAIN_BATCH, epoch + 13), top=14)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

    emit({
        "phase": "train", "config": "OverlapNetConfig() 64x900x4, bf16 legs, W'=360, batch 16, adagrad",
        "resident_steps": TRAIN_STEPS, "host_batch_steps": TRAIN_HOST_STEPS,
        "launches": launches, "train_steps_counted": train_steps,
        "losses": losses, "host_batch_losses": host_losses,
        "loss_first_five": first, "loss_last_five": last, "eval_metrics": eval_metrics,
        "first_20_steps_s_incl_first_launches": resident_s,
        "restored_vs_uninterrupted_absdiff": d_restore,
        "served_vs_trained_overlap_absdiff_bf16": d_served, "gate_served": 5e-3,
        "fp32_first_step": {"batch": 4, "gpu_vs_cpu_loss_diff_over_max_1_loss": d_loss,
                            "loss": on["cuda"][0]["loss"], "gate_loss": 1e-4,
                            "worst_gradients_relative_to_their_max": worst, "gate_grad": GRAD_GATE,
                            "c_conv1_grad_max": float(on["cuda"][1]["overlap_head.c_conv1.weight"].abs().max()),
                            "s_conv1_grad_max": float(on["cuda"][1]["legs.s_conv1.weight"].abs().max())},
        "resident_vs_host_batch": {"loss_reldiff_3_steps": d_resident,
                                   "gate_first": 1e-6, "gate": 1e-3,
                                   "params_max_absdiff": moved},
        "resident_step_ms": step_ms, "resident_pairs_per_s": TRAIN_BATCH / step_ms * 1e3,
        "host_batch_step_ms": host_step_ms, "host_batch_pairs_per_s": TRAIN_BATCH / host_step_ms * 1e3,
        "resident_step_ms_fetched_every_step": fetched_step_ms,
        "profiled_epoch_10_steps": window,
        "device_busy_ms_per_step": window["device_busy_ms"] / 10,
        "device_idle_share_of_unprofiled_step": 1.0 - window["device_busy_ms"] / 10 / step_ms,
        "peak_memory_gb_in_window": peak_gb, "card": smi,
    })
    return launches


# -- phase prep -----------------------------------------------------------------

PREP_FRAMES = 300     # a two-lap sim sequence: the second lap revisits the first
PREP_SEED = 6
PREP_QUERIES = 8      # query frames of the card-vs-CPU GT gate
PREP_STEPS = 8        # train steps from the packs
PIXEL_SHARE = 0.9999  # proj_idx equal on at least this share of pixels


def images_against_cpu(torch, projection, pts: np.ndarray) -> dict:
    """Gate (a): the card's range projection and normals of the scans
    ``pts`` (K, P, 4) against the same functions on the CPU. proj_idx equal
    on PIXEL_SHARE of the pixels (CUDA's asinf / atan2f differ from the
    CPU's by ulps, which moves a point at a pixel boundary); where the
    winner is the same, range, vertex and intensity equal bit for bit;
    normals within 1e-5 where both are valid and the pixel and the two
    neighbours a normal reads have the same winners."""
    out = {}
    for dev in ("cuda", "cpu"):
        r, v, inten, idx = projection.range_projection(torch.from_numpy(pts).to(dev))
        out[dev] = [x.cpu().numpy() for x in (r, v, inten, idx, projection.normal_map(r, v))]
    (r, v, inten, idx, nrm), (cr, cv, ci, cidx, cn) = out["cuda"], out["cpu"]
    same = idx == cidx
    share_diff = float(1.0 - same.mean())
    if same.mean() < PIXEL_SHARE:
        raise RuntimeError(f"images: proj_idx differs on {share_diff:.2e} of the pixels")
    for what, x, y in (("range", r, cr), ("vertex", v, cv), ("intensity", inten, ci)):
        if not np.array_equal(x[same], y[same]):
            raise RuntimeError(f"images: {what} differs where the winners agree")
    stable = same & np.roll(same, -1, axis=2) & np.roll(same, -1, axis=1)
    both = stable & ~(nrm == -1).all(-1) & ~(cn == -1).all(-1)
    d_normal = float(np.abs(nrm[both] - cn[both]).max())
    if d_normal > 1e-5 or not ((nrm == -1).all(-1) == (cn == -1).all(-1))[stable].all():
        raise RuntimeError(f"images: normals differ by {d_normal} (gate 1e-5)")
    return {"scans": len(pts), "pixels_with_another_winner_share": share_diff,
            "pixels_with_another_winner": int((~same).sum()), "normal_max_absdiff": d_normal,
            "gate_pixel_share": PIXEL_SHARE, "gate_normal": 1e-5}


def gt_against_cpu(got: np.ndarray, want: np.ndarray, valid: np.ndarray, what: str) -> dict:
    """Gate (b): ids and yaw bins equal; each overlap within 2 / (its
    query's valid pixel count) of the CPU's."""
    if not np.array_equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]]):
        raise RuntimeError(f"{what}: ids or yaw bins differ from the CPU's")
    d = np.abs(got[:, 2] - want[:, 2])
    tol = 2.0 / np.maximum(valid[want[:, 0].astype(int)], 1)
    if (d > tol).any():
        raise RuntimeError(f"{what}: overlap differs by {d.max()} (> 2 pixels of its query)")
    return {"pairs": len(got), "overlap_max_absdiff": float(d.max()),
            "overlap_max_absdiff_in_pixels": float((d / tol * 2).max()),
            "equal_overlaps_share": float((d == 0).mean())}


def phase_prep(torch, smi):
    """The data-preparation path on the card: sim scans -> gen-data ->
    gen-gt --all-queries -> pack -> train --pack-dir, through the port's CLI."""
    import json as json_mod

    from overlapnet_torch.cli.__main__ import main as cli_main
    from overlapnet_torch.core.config import OverlapNetConfig
    from overlapnet_torch.data import native
    from overlapnet_torch.data.dataset import PairImageDataset
    from overlapnet_torch.data.gt_files import load_gt_pairs
    from overlapnet_torch.data.pack import open_packs
    from overlapnet_torch.geometry import kitti, overlap, projection
    from overlapnet_torch.sim import world
    from overlapnet_torch.train.checkpoint import latest_step

    cfg = OverlapNetConfig()
    assert (cfg.model.leg_dtype, cfg.model.input_width, cfg.train.batch_size) == (
        "bfloat16", 900, 16)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        # ---- scans: a seeded two-lap sequence of up to 130,000-point scans
        t0 = time.perf_counter()
        seq = world.write_kitti_sequence(
            os.path.join(tmp, "sim"), world.make_world(np.random.default_rng(PREP_SEED)),
            world.loop_trajectory(PREP_FRAMES), seed=PREP_SEED)
        sim_s = time.perf_counter() - t0
        paths = kitti.load_files(seq["scan_folder"])
        poses = kitti.poses_cam_to_velo(kitti.load_poses(seq["poses_file"]),
                                        kitti.load_calib(seq["calib_file"]))
        points_per_scan = [os.path.getsize(p) // 16 for p in paths]
        native.build()
        if not native.available():
            raise RuntimeError("the native batcher did not load after native.build()")
        pts = overlap.load_scans_padded(paths)

        # ---- (a) the card's images against the CPU's, first 8 scans
        images = images_against_cpu(torch, projection, pts[:8])

        # ---- gen-data through the CLI: depth, normal, intensity images
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        if cli_main(["gen-data", "--scan-folder", seq["scan_folder"],
                     "--dst-folder", os.path.join(data, "00")]) != 0:
            raise RuntimeError("gen-data failed")
        gen_data_s = time.perf_counter() - t0
        depth0 = np.load(os.path.join(data, "00", "depth", "000000.npy"))
        if depth0.shape != (64, 900) or not (depth0 > 0).any():
            raise RuntimeError(f"gen-data wrote a {depth0.shape} depth image with no return")

        # ---- gen-gt --all-queries through the CLI: 300 x 300 pairs
        t0 = time.perf_counter()
        if cli_main(["gen-gt", "--scan-folder", seq["scan_folder"], "--poses-file",
                     seq["poses_file"], "--calib-file", seq["calib_file"], "--dst-folder",
                     os.path.join(data, "00"), "--seq", "00", "--all-queries"]) != 0:
            raise RuntimeError("gen-gt failed")
        gen_gt_s = time.perf_counter() - t0
        gt_dir = os.path.join(data, "00", "ground_truth")
        table = np.load(os.path.join(gt_dir, "ground_truth_overlap_yaw.npz"))["overlaps"]

        # the same table from the loaded scans, timed by CUDA events and the
        # host clock, with (c) the chunk loop under the sync debug mode
        loop = overlap.dispatch_chunks

        def no_sync_loop(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return loop(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        overlap.dispatch_chunks = no_sync_loop
        try:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            gt = overlap.com_overlap_yaw_all(paths, poses, points=pts)
            end.record()
            torch.cuda.synchronize()
            gt_host_s = time.perf_counter() - t0
            gt_device_ms = start.elapsed_time(end)
        finally:
            overlap.dispatch_chunks = loop
        if not np.array_equal(gt, table):
            raise RuntimeError("gen-gt's table differs from com_overlap_yaw_all's on the same scans")
        if not (np.isfinite(gt[:, 2]).all() and gt[:, 2].min() >= 0 and gt[:, 2].max() <= 1):
            raise RuntimeError("GT overlaps not finite in [0, 1]")
        if not np.allclose(gt[gt[:, 0] == gt[:, 1], 2], 1.0):
            raise RuntimeError("a frame's overlap with itself is not 1")
        n_pairs = len(gt)
        revisits = gt[np.abs(gt[:, 0] - gt[:, 1]) == PREP_FRAMES // 2, 2]
        # pairs the far-pair gate lets through to the device
        radius = np.sqrt((pts[..., :3].astype(np.float64) ** 2).sum(-1)).max(-1)
        t_norm = np.linalg.norm(poses[:, None, :3, 3] - poses[None, :, :3, 3], axis=-1)
        live_pairs = int((t_norm - radius[None, :] < overlap.MAX_RANGE + 1.0).sum())

        # ---- (b) 8 query frames against all 300, card against CPU, and the
        # card again with TF32 allowed for matmuls (the transform is fp32)
        queries = np.linspace(0, PREP_FRAMES - 1, PREP_QUERIES).astype(int)
        valid = np.zeros(PREP_FRAMES)
        valid[queries] = overlap.ranges_chunk(torch.from_numpy(pts[queries]))[1].numpy()
        cpu = overlap.com_overlap_yaw_all(paths, poses, query_idxs=queries, points=pts,
                                          chunk_size=128, device="cpu")
        card = overlap.com_overlap_yaw_all(paths, poses, query_idxs=queries, points=pts)
        gt_gate = gt_against_cpu(card, cpu, valid, "GT on the card")
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            card_tf32 = overlap.com_overlap_yaw_all(paths, poses, query_idxs=queries, points=pts)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        gt_gate_tf32 = gt_against_cpu(card_tf32, cpu, valid, "GT on the card, TF32 allowed")
        gt_gate_tf32["equal_to_tf32_off"] = bool(np.array_equal(card_tf32, card))

        # information: device time of one GT chunk (256 pairs of the first 16
        # frames) by kernel row
        m = min(16, PREP_FRAMES)
        sub = torch.from_numpy(pts[:m]).cuda()
        rng_img, valid_dev, _ = overlap.ranges_chunk(sub)
        planes = tuple(sub[..., i].contiguous() for i in range(3))
        q = torch.arange(m, device="cuda").repeat_interleave(m)
        r = torch.arange(m, device="cuda").repeat(m)
        pose_dev = torch.from_numpy(poses[:m]).cuda()
        T = torch.bmm(torch.linalg.inv(pose_dev)[q], pose_dev[r]).float()
        overlap.pair_chunk(planes, rng_img, valid_dev, q, r, T)
        chunk_profile = busy_share(
            torch, lambda: overlap.pair_chunk(planes, rng_img, valid_dev, q, r, T), top=16,
            name_chars=160)
        del sub, planes, rng_img

        # ---- pack through the CLI, then (d) pack batches == per-image batches
        exp = os.path.join(tmp, "exp")
        os.makedirs(exp)

        def network_yml(testname):
            path = os.path.join(exp, f"{testname}.yml")
            with open(path, "w") as f:
                json_mod.dump({  # JSON is YAML
                    "data_root_folder": data, "experiments_path": exp, "testname": testname,
                    "training_seqs": "00", "batch_size": 16, "no_epochs": 1,
                    "no_batches_in_epoch": PREP_STEPS, "no_test_pairs": 16,
                    "rotate_training_data": 1}, f)
            return path

        packs = os.path.join(tmp, "packs")
        t0 = time.perf_counter()
        if cli_main(["pack", network_yml("pack"), "--out-dir", packs]) != 0:
            raise RuntimeError("pack failed")
        pack_s = time.perf_counter() - t0
        pairs = load_gt_pairs([os.path.join(gt_dir, "train_set.npz")], shuffle=False)
        pairs = pairs[np.arange(64)]
        kw = dict(channels=cfg.channels, height=64, width=900, rotate_data=1, seed=3)
        from_packs = PairImageDataset(data, pairs, packs=open_packs(packs, ["00"]), **kw)
        per_image = PairImageDataset(data, pairs, **kw)
        if not (from_packs._rows1 >= 0).all():
            raise RuntimeError("pairs not found in the pack")
        for a, b in zip(from_packs.batches(16, shuffle=True), per_image.batches(16, shuffle=True)):
            for key in b:
                if not np.array_equal(a[key], b[key]):
                    raise RuntimeError(f"pack batches differ from per-image batches in {key}")

        # ---- (e) train from the packs through the CLI: host batches by the
        # native gather (the main path, counted), then the resident store
        def train(testname, *extra):
            yml = network_yml(testname)
            if cli_main(["train", yml, "--pack-dir", packs, *extra]) != 0:
                raise RuntimeError(f"train {testname} failed")
            out = os.path.join(exp, testname)
            with open(os.path.join(out, "metrics.jsonl")) as f:
                lines = [json_mod.loads(line) for line in f]
            return latest_step(os.path.join(out, "checkpoints")), lines

        k_start = kernel_launches()
        steps, lines = train("from_packs", "--no-resident")
        torch.cuda.synchronize()
        launches = launches_since(k_start)
        eval_batches = sum(1 for x in lines if x["phase"] == "validation")
        if steps != PREP_STEPS or launches != {"delta_conv1": steps + eval_batches,
                                               "delta_conv1_bwd": steps,
                                               "c_conv2_relu": steps + eval_batches,
                                               "c_conv3_dense": steps + eval_batches}:
            raise RuntimeError(f"launches {launches} for {steps} train steps and "
                               f"{eval_batches} evaluated batch")
        losses = [x for x in lines if x["phase"] == "train"]
        if not all(np.isfinite(x["epoch_loss"]) and np.isfinite(x["loss"]) for x in losses):
            raise RuntimeError(f"losses not finite: {losses}")
        _, resident_lines = train("resident")
        _, packs_again = train("from_packs_again", "--no-resident")
        step_ms = {name: [x for x in ls if x["phase"] == "train"][0]["sec_per_dispatch"] * 1e3
                   for name, ls in (("packs_first_run", lines), ("packs", packs_again),
                                    ("resident", resident_lines))}

    emit({
        "phase": "prep", "frames": PREP_FRAMES,
        "points_per_scan": [min(points_per_scan), max(points_per_scan)],
        "sim_write_s": sim_s, "images_vs_cpu": images,
        "gen_data_s": gen_data_s, "gen_data_scans_per_s": PREP_FRAMES / gen_data_s,
        "gen_gt_cli_s": gen_gt_s, "gt_pairs": n_pairs, "gt_pairs_scored": live_pairs,
        "gt_pairs_per_s_host_clock": n_pairs / gt_host_s,
        "gt_pairs_per_s_cuda_events": n_pairs / gt_device_ms * 1e3,
        "gt_host_s": gt_host_s, "gt_device_ms": gt_device_ms,
        "gt_overlap_mean": float(gt[:, 2].mean()),
        "gt_revisit_overlap_mean": float(revisits.mean()),
        "sync_debug_mode_chunk_loop": "error: nothing raised",
        "gt_vs_cpu": gt_gate, "gt_vs_cpu_tf32_allowed": gt_gate_tf32,
        "gt_chunk_256_pairs_profile": chunk_profile,
        "pack_s": pack_s, "pack_batches_equal_per_image": True,
        "native_available": native.available(),
        "train_from_packs": {"steps": steps, "launches": launches, "eval_batches": eval_batches,
                             "losses": [x["epoch_loss"] for x in losses]},
        "step_ms": step_ms, "card": smi,
    })
    return launches


# -- phase e2e ------------------------------------------------------------------

E2E_FRAMES, E2E_EPOCHS, E2E_BATCH = 64, 6, 8  # run_e2e's defaults
PG_POSES = 4541       # the length of KITTI sequence 00
PG_CLOSURES, PG_OUTLIERS = 200, 5
PG_SOLVE = dict(iterations=30, cg_iters=200, robust_delta=3.0, robust_kernel="tukey",
                robust_anneal_start=300.0)  # run_pose_graph's solve


def loop_graph(n: int = PG_POSES, seed: int = 7):
    """A seeded four-lap 150 m x 100 m rectangle of ``n`` SE(2) poses, its
    drifted odometry (``e2e.drifted_odometry``, 3e-4 rad of yaw bias a
    frame), PG_CLOSURES yaw-only closures between laps (true yaw plus 0.5
    degree noise) and PG_OUTLIERS gross ones (random frames, random yaw), as
    ``closures_to_edges`` weighs them. Returns (gt, odometry, graph)."""
    from overlapnet_torch.backend import closures_to_edges, odometry_edges
    from overlapnet_torch.lcd.online import LoopClosure
    from overlapnet_torch.sim.e2e import drifted_odometry

    rng = np.random.default_rng(seed)
    lap = n // 4 + 1
    a, b = 150.0, 100.0
    s = (np.arange(n) % lap) * (2 * (a + b) / lap)
    corners = np.array([[0.0, 0.0], [a, 0.0], [a, b], [0.0, b]])
    side = np.searchsorted([a, a + b, 2 * a + b], s, side="right")
    start = np.array([0.0, a, a + b, 2 * a + b])[side]
    heading = side * (np.pi / 2)
    xy = corners[side] + (s - start)[:, None] * np.column_stack([np.cos(heading), np.sin(heading)])
    gt = np.column_stack([xy, np.arctan2(np.sin(heading), np.cos(heading))])
    est = drifted_odometry(gt, yaw_drift=3e-4, seed=seed)
    frames = np.sort(rng.choice(np.arange(lap, n), PG_CLOSURES, replace=False))
    closures = []
    for f in frames:
        m = int(f - lap * rng.integers(1, f // lap + 1))
        yaw = np.degrees(np.arctan2(np.sin(gt[f, 2] - gt[m, 2]), np.cos(gt[f, 2] - gt[m, 2])))
        closures.append(LoopClosure(int(f), m, 0.8, float(yaw + rng.normal(0, 0.5))))
    for f in rng.choice(np.arange(lap, n), PG_OUTLIERS, replace=False):
        closures.append(LoopClosure(int(f), int(rng.integers(0, lap // 2)), 0.9,
                                    float(rng.uniform(-180, 180))))
    return gt, est, odometry_edges(est).merged(closures_to_edges(closures, n))


def k1_on_trained_features(torch, cfg, work: str) -> dict:
    """K1 on the features of the legs ``run_e2e`` trained (bf16 legs), with
    its trained c_conv1: each of the run's frames against the next (close
    scans, the most cancellation) and against the frame half the run away,
    every pair held to the plain version in float64 (relative norm). Also
    the pairs' cancellation ratios and how many took the exact path."""
    from overlapnet_torch.kernels import delta_conv1 as k1
    from overlapnet_torch.lcd.infer import Infer
    from overlapnet_torch.ops import delta as plain
    from overlapnet_torch.weights import load_npz

    params = load_npz(os.path.join(work, "trained_params.npz"))
    infer = Infer(cfg, params=params, db_capacity=16, device="cuda", shards=1)
    fv = torch.from_numpy(infer.create_feature_volumes(
        [f"{i:06d}" for i in range(E2E_FRAMES)])).cuda()
    head = next(mod for mod in infer.model.modules() if hasattr(mod, "c_conv1"))
    kern = head.c_conv1.weight.detach()[:, :, 0, :].permute(2, 1, 0).float().contiguous()
    bias = head.c_conv1.bias.detach().float().contiguous()
    n = fv.shape[0]
    a = torch.cat([fv, fv]).contiguous()
    b = torch.cat([fv.roll(-1, 0), fv.roll(n // 2, 0)]).contiguous()
    with torch.no_grad():
        before = exact_calls()
        out = k1.delta_conv1(a, b, kern, bias, stride=S)
        torch.cuda.synchronize()
        took_exact = exact_calls() - before
        ref = plain.delta_conv1(a.double(), b.double(), kern.double(), bias.double(), stride=S)
        errs = ((out.double() - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)).cpu()
    pairs = k1.exact_pairs(a, b, kern, S)
    rho = k1.cancellation_ratio(a, b, kern, S).cpu()
    if took_exact != int(bool(pairs.all())):
        raise RuntimeError(f"K1 on trained features: the call counted {took_exact} exact, "
                           f"{int(pairs.sum())} of {len(pairs)} pairs should take the exact path")
    exact_errs, general_errs = errs[pairs], errs[~pairs]
    return {
        "pairs": len(pairs), "exact_pairs": int(pairs.sum()),
        "bf16_values": k1.exact_operands(a, b, S),
        "rho_quantiles_0_50_90_100": [float(x) for x in torch.quantile(
            rho, torch.tensor([0.0, 0.5, 0.9, 1.0], dtype=rho.dtype))],
        "worst_pair_rel_err_fp64": float(errs.max()),
        "worst_exact_pair_rel_err_fp64": float(exact_errs.max()) if len(exact_errs) else None,
        "worst_general_pair_rel_err_fp64":
            float(general_errs.max()) if len(general_errs) else None,
        "limit": K1_REL_LIMIT,
    }


def phase_e2e(torch, smi):
    """The sim e2e harness on the card: (a) ``run_e2e`` at full width, (b)
    ``cli evaluate`` on its validation set, (c) the pose graph at KITTI 00's
    length."""
    from overlapnet_torch.backend import absolute_trajectory_error, pose_graph
    from overlapnet_torch.cli import evaluate as cli_evaluate
    from overlapnet_torch.sim import e2e
    from overlapnet_torch.weights import load_npz

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults, as a user runs it
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- (a) run_e2e, each stage timed and its launches counted
        stages = {}

        def staged(name, fn):
            def run(*args, **kw):
                before, t0 = kernel_launches(), time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                stages[name] = {"s": time.perf_counter() - t0, **launches_since(before)}
                return out
            return run

        names = ("generate_sequence", "build_gt", "train_and_eval", "run_lcd", "run_pose_graph")
        originals = {name: getattr(e2e, name) for name in names}
        for name in names:
            setattr(e2e, name, staged(name, originals[name]))
        work = os.path.join(tmp, "e2e")
        k_start = kernel_launches()
        t0 = time.perf_counter()
        try:
            m = e2e.run_e2e(work, n_frames=E2E_FRAMES, epochs=E2E_EPOCHS,
                            batch_size=E2E_BATCH, device="cuda")
        finally:
            for name in names:
                setattr(e2e, name, originals[name])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        harness = launches_since(k_start)
        floors = {
            "trained_rms_below_0.8_untrained":
                m["trained_overlap_rms_error"] < 0.8 * m["untrained_overlap_rms_error"],
            "lcd_f1_at_least_0.9": m["lcd_f1"] >= 0.9,
            "false_positives_at_most_true_positives":
                m["lcd_false_positives"] <= m["lcd_true_positives"],
            "yaw_p50_at_most_2_deg": m.get("lcd_yaw_err_p50_deg", 0.0) <= 2.0,
            "ate_after_at_most_1.2_before": m["ate_after_m"] <= 1.2 * m["ate_before_m"],
        }
        print(json.dumps({"e2e_metrics": m}, default=float), flush=True)
        cfg = e2e.make_config(work, batch_size=E2E_BATCH, no_epochs=E2E_EPOCHS)
        trained_k1 = k1_on_trained_features(torch, cfg, work)
        print(json.dumps({"k1_on_trained_features": trained_k1}), flush=True)
        if not all(floors.values()):
            raise RuntimeError(f"e2e floors failed: {floors}")
        if trained_k1["worst_pair_rel_err_fp64"] > K1_REL_LIMIT:
            raise RuntimeError(f"K1 on the trained legs' features: {trained_k1}")
        steps = E2E_EPOCHS * (m["train_n_train_pairs"] // E2E_BATCH)
        eval_batches = 2 * math.ceil(m["train_n_val_pairs"] / E2E_BATCH)  # untrained, trained
        train = stages["train_and_eval"]
        if (train["delta_conv1"], train["delta_conv1_bwd"]) != (steps + eval_batches, steps):
            raise RuntimeError(f"training launched {train} for {steps} steps and "
                               f"{eval_batches} evaluated batches")
        heads_per_head_call(train, "run_e2e's training")
        lcd = stages["run_lcd"]
        if not 0 < lcd["delta_conv1"] <= E2E_FRAMES or lcd["delta_conv1_bwd"]:
            raise RuntimeError(f"loop closing launched {lcd}")
        heads_per_head_call(lcd, "run_e2e's loop closing")
        heads_per_head_call(harness, "run_e2e")

        # ---- (b) cli evaluate's evaluate() on the run's validation set with
        # its trained_params.npz (network.yml cannot name the harness's
        # cosine head, so the harness's own config is passed)
        cfg.data.training_seqs = [e2e.SEQ]
        params = load_npz(os.path.join(work, "trained_params.npz"))
        k_start = kernel_launches()
        t0 = time.perf_counter()
        ev_metrics, ev = cli_evaluate.evaluate(cfg, params, device="cuda")
        evaluate_s = time.perf_counter() - t0
        ev_launches = launches_since(k_start)
        heads_per_head_call(ev_launches, "cli evaluate")
        d_rms = abs(ev_metrics["overlap_rms_error"] - m["trained_overlap_rms_error"])
        if len(ev["pred_overlap"]) != m["train_n_val_pairs"] or d_rms > 1e-3:
            raise RuntimeError(f"cli evaluate: {len(ev['pred_overlap'])} pairs, overlap RMS "
                               f"{ev_metrics['overlap_rms_error']} against Trainer.evaluate's "
                               f"{m['trained_overlap_rms_error']}, {ev_launches} launches")

    # ---- (c) the pose graph at KITTI 00's length: card against the CPU,
    # two card calls equal, no host sync in the solve
    gt, est, graph = loop_graph()
    t0 = time.perf_counter()
    cpu_poses, cpu_chi2 = pose_graph.optimize_pose_graph(graph, est, device="cpu", **PG_SOLVE)
    cpu_s = time.perf_counter() - t0
    solve = pose_graph._gauss_newton

    def no_sync_solve(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return solve(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    runs = []
    pose_graph._gauss_newton = no_sync_solve
    try:
        for _ in range(3):  # the first pays for cold caches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(pose_graph.optimize_pose_graph(graph, est, device="cuda", **PG_SOLVE))
            runs[-1] += (time.perf_counter() - t0,)
    finally:
        pose_graph._gauss_newton = solve
    (p1, c1, _), (p2, c2, s2), (p3, c3, s3) = runs
    if not (np.array_equal(p2, p1) and np.array_equal(p3, p1) and np.array_equal(c2, c1)):
        raise RuntimeError("two pose-graph solves on the card gave different bits")
    d_xy = float(np.abs(p1[:, :2] - cpu_poses[:, :2]).max())
    d_th = np.abs(p1[:, 2] - cpu_poses[:, 2]) % (2 * np.pi)
    d_th = float(np.minimum(d_th, 2 * np.pi - d_th).max())
    ate = {"before": absolute_trajectory_error(est, gt)["ate_rmse"],
           "cpu": absolute_trajectory_error(cpu_poses, gt)["ate_rmse"],
           "card": absolute_trajectory_error(p1, gt)["ate_rmse"]}
    if d_xy > 1e-3 or d_th > 1e-4 or abs(ate["card"] - ate["cpu"]) > 1e-3:
        raise RuntimeError(f"pose graph: card against CPU {d_xy} m, {d_th} rad, ATE {ate}")
    one_iteration = busy_share(torch, lambda: pose_graph.optimize_pose_graph(
        graph, est, device="cuda", **dict(PG_SOLVE, iterations=1)), top=8)

    emit({
        "phase": "e2e", "config": "OverlapNetConfig() 64x900x4, bf16 legs, W'=360, "
        f"make_config overrides (cosine head, adam 3e-4), {E2E_FRAMES} sim frames, "
        f"{E2E_EPOCHS} epochs, batch {E2E_BATCH}",
        "run_e2e_s": run_s, "stages": stages, "floors": floors, "launches": harness,
        "k1_on_trained_features": trained_k1,
        "train_steps": steps, "eval_batches": eval_batches,
        "lcd_f1": m["lcd_f1"], "lcd_yaw_rmse_deg": m["lcd_yaw_rmse_deg"],
        "lcd_yaw_err_p50_deg": m.get("lcd_yaw_err_p50_deg"),
        "ate_before_m": m["ate_before_m"], "ate_after_m": m["ate_after_m"],
        "trained_overlap_rms_error": m["trained_overlap_rms_error"],
        "untrained_overlap_rms_error": m["untrained_overlap_rms_error"],
        "cli_evaluate": {"s": evaluate_s, "pairs": len(ev["pred_overlap"]),
                         "launches": ev_launches, "metrics": ev_metrics,
                         "overlap_rms_vs_trainer_evaluate": d_rms},
        "pose_graph": {
            "poses": PG_POSES, "edges": graph.n_edges, **PG_SOLVE,
            "ms_per_solve_card": [s2 * 1e3, s3 * 1e3], "ms_first_solve_card": runs[0][2] * 1e3,
            "ms_per_solve_cpu": cpu_s * 1e3, "card_vs_cpu_xy_m": d_xy, "card_vs_cpu_rad": d_th,
            "ate_m": ate, "equal_bits_across_card_calls": True,
            "sync_debug_mode": "error: nothing raised", "chi2_first_last": [float(c1[0]),
                                                                           float(c1[-1])],
            "one_iteration_profile": one_iteration},
        "phase_s": time.perf_counter() - phase_t0, "card": smi,
    })
    return {k: harness[k] + ev_launches[k] for k in harness}


# -- phase dist -----------------------------------------------------------------

DIST_STEPS = 5         # resident steps of each data-parallel run
DIST_TIMED_STEPS = 10  # default-model steps timed on two ranks and on one device
DIST_RANKS = 2
DIST_DEADLINE_S = 900  # for the two rank processes together
PG_SHORT = dict(PG_SOLVE, iterations=2, cg_iters=20)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_train_yml(root: str, data: str, testname: str) -> str:
    """``cli train`` at full width: DIST_STEPS epochs of one batch of 16 (the
    16 pairs of ``write_train_set``), validated on the same 16 pairs."""
    path = os.path.join(root, f"{testname}.yml")
    with open(path, "w") as f:
        json.dump({  # JSON is YAML
            "data_root_folder": data, "experiments_path": os.path.join(root, "exp"),
            "testname": testname, "training_seqs": "00", "batch_size": TRAIN_BATCH,
            "no_epochs": DIST_STEPS, "no_batches_in_epoch": 1, "no_test_pairs": TRAIN_BATCH}, f)
    return path


def train_log(root: str, testname: str):
    """(metrics.jsonl records without their clock readings, the last
    checkpoint) of a ``cli train`` run."""
    from overlapnet_torch.train.checkpoint import load_checkpoint

    exp = os.path.join(root, "exp", testname)
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [{k: v for k, v in json.loads(line).items()
                    if k not in ("time", "train_pairs_per_sec", "sec_per_dispatch")} for line in f]
    return records, load_checkpoint(os.path.join(exp, "checkpoints"))


def dist_rank(rank: int, work: str) -> int:
    """One rank of phase dist (b): gloo, the one card shared by both ranks.
    Writes ``rank<r>.json`` and ``rank<r>.npz`` under ``work``; rank 0 also
    runs every one-device reference in its process."""
    import torch

    from overlapnet_torch.core.config import OverlapNetConfig
    from overlapnet_torch.core.distributed import maybe_initialize_distributed
    from overlapnet_torch.data.dataset import PairImageDataset, ResidentPairs
    from overlapnet_torch.data.gt_files import load_gt_pairs
    from overlapnet_torch.lcd.infer import Infer
    from overlapnet_torch.lcd.online import OnlineLoopCloser
    from overlapnet_torch.models import init_params, leg_output_width
    from overlapnet_torch.backend import pose_graph
    from overlapnet_torch.parallel.mesh import all_gather, barrier, make_mesh
    from overlapnet_torch.train import trainer as trainer_mod

    if not maybe_initialize_distributed(backend="gloo"):
        raise RuntimeError("the OVERLAPNET_* variables did not start a process group")
    mesh = make_mesh(device="cuda:0")  # NCCL takes one card a rank: two share it by gloo
    out, arrays = {"rank": rank, "world": mesh.size}, {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True

    cfg = OverlapNetConfig()
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, leg_dtype="float32"))
    out_width = leg_output_width(cfg.model)
    data = os.path.join(work, "train")
    pairs = load_gt_pairs([os.path.join(data, "00", "ground_truth", "train_set.npz")],
                          shuffle=False)
    ds = PairImageDataset(data, pairs, cfg.channels, cfg.model.input_height,
                          cfg.model.input_width, leg_output_width=out_width)

    def train(config, device, m, steps=DIST_STEPS):
        """``steps`` resident steps of batch TRAIN_BATCH (one an epoch);
        returns (trainer, per-step metrics, parameters after step 1)."""
        trainer = trainer_mod.Trainer(config, steps_per_epoch=1, device=device, mesh=m)
        resident = ResidentPairs(ds, device=device, mesh=m)
        metrics, first = [], None
        for epoch in range(steps):
            metrics.append(trainer.run_epoch_resident(resident, TRAIN_BATCH, epoch))
            if first is None:
                first = {k: v.detach().cpu().clone() for k, v in trainer.state.params.items()}
        return trainer, metrics, first

    # ---- data-parallel training, fp32 legs: the main path of this rank
    train(cfg32, None, mesh, steps=1)  # warm-up: cuDNN plans, gloo pairs
    torch.cuda.synchronize()
    k_start = kernel_launches()
    trainer, metrics, first = train(cfg32, None, mesh)
    eval_dp = trainer.evaluate(ds.batches(TRAIN_BATCH))
    torch.cuda.synchronize()
    out["train_launches"] = launches_since(k_start)
    flat = torch.cat([v.reshape(-1) for v in trainer.state.params.values()])
    gathered = all_gather(mesh, flat)
    out["params_equal_across_ranks"] = bool(torch.equal(gathered[0], gathered[1]))
    out["train_metrics"], out["eval"] = metrics, eval_dp
    if rank == 0:  # one device at the global batch, in this process
        ref, ref_metrics, ref_first = train(cfg32, "cuda:0", None)
        out["ref_train_metrics"] = ref_metrics
        out["ref_eval"] = ref.evaluate(ds.batches(TRAIN_BATCH))
        for name, got, want in (("step1", first, ref_first),
                                ("step5", trainer.state.params, ref.state.params)):
            d = {k: (got[k].float().cpu() - want[k].float().cpu()).abs() for k in got}
            out[f"params_{name}_max_abs"] = max(float(v.max()) for v in d.values())
            out[f"params_{name}_beyond_tol"] = sum(
                int((v > 1e-6 + 1e-4 * want[k].float().cpu().abs()).sum()) for k, v in d.items())
        out["n_params"] = sum(v.numel() for v in first.values())
        del ref
    del trainer
    barrier(mesh)

    # ---- step time of the default model (bf16 legs, TF32 as PyTorch's
    # defaults): two ranks at 8 pairs each on the shared card; one device
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False

    def step_ms(device, m):
        trainer = trainer_mod.Trainer(cfg, steps_per_epoch=1, device=device, mesh=m)
        resident = ResidentPairs(ds, device=device, mesh=m)
        for epoch in range(3):
            trainer.run_epoch_resident(resident, TRAIN_BATCH, epoch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for epoch in range(3, 3 + DIST_TIMED_STEPS):
            trainer.run_epoch_resident(resident, TRAIN_BATCH, epoch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / DIST_TIMED_STEPS

    out["step_ms_two_ranks"] = step_ms(None, mesh)
    barrier(mesh)
    if rank == 0:
        out["step_ms_one_device"] = step_ms("cuda:0", None)
    barrier(mesh)

    # ---- the rank-sharded map: online loop closing over the out-and-back
    # sequence of phase lcd, every frame's best candidate kept (TF32 off: the
    # ranks' head calls have other batch sizes than one device's)
    torch.backends.cudnn.allow_tf32 = False
    lcd = os.path.join(work, "lcd")
    poses = np.load(os.path.join(lcd, "poses.npy"))
    covs = np.load(os.path.join(lcd, "covs.npy"))
    cfg.data.data_root_folder, cfg.data.infer_seqs = lcd, "00"
    params = init_params(cfg.model, cfg.num_input_channels, seed=0)

    def closer(**where):
        infer = Infer(cfg, params=params, db_capacity=512, **where)
        return OnlineLoopCloser(infer, poses, covariances=covs, overlap_threshold=-1.0)

    closer(mesh=mesh).run(LCD_OUT + 8)  # warm-up
    torch.cuda.synchronize()
    barrier(mesh)
    k_start = kernel_launches()
    sharded = closer(mesh=mesh)
    t0 = time.perf_counter()
    sharded.run(pipeline_depth=8)
    torch.cuda.synchronize()
    out["lcd_s"] = time.perf_counter() - t0
    out["lcd_launches"] = {k: launches_since(k_start)[k] for k in ("delta_conv1", "c_conv2_relu",
                                                                "c_conv3_dense")}
    arrays["closures"] = np.array([[c.frame, c.match, c.overlap, c.yaw_deg, c.confidence]
                                   for c in sharded.closures], np.float64)
    barrier(mesh)
    if rank == 0:
        one = closer(device="cuda:0", shards=DIST_RANKS)
        t0 = time.perf_counter()
        one.run(pipeline_depth=8)
        torch.cuda.synchronize()
        out["ref_lcd_s"] = time.perf_counter() - t0
        arrays["ref_closures"] = np.array([[c.frame, c.match, c.overlap, c.yaw_deg, c.confidence]
                                           for c in one.closures], np.float64)
    barrier(mesh)

    # ---- the edge-sharded pose graph at KITTI 00's length
    gt, est, graph = loop_graph()
    pose_graph.optimize_pose_graph(graph, est, mesh=mesh, **dict(PG_SOLVE, iterations=1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays["poses"], arrays["chi2"] = pose_graph.optimize_pose_graph(graph, est, mesh=mesh,
                                                                     **PG_SOLVE)
    out["solve_s"] = time.perf_counter() - t0
    # the sums' order, held in float64 over a short solve: the float32 solve
    # amplifies an ulp to centimetres
    arrays["poses64"], _ = pose_graph.optimize_pose_graph(graph, est, mesh=mesh,
                                                          dtype=torch.float64, **PG_SHORT)
    barrier(mesh)
    if rank == 0:
        t0 = time.perf_counter()
        arrays["ref_poses"], arrays["ref_chi2"] = pose_graph.optimize_pose_graph(
            graph, est, device="cuda:0", **PG_SOLVE)
        out["ref_solve_s"] = time.perf_counter() - t0
        arrays["ref_poses64"], _ = pose_graph.optimize_pose_graph(
            graph, est, device="cuda:0", dtype=torch.float64, **PG_SHORT)
    barrier(mesh)
    np.savez(os.path.join(work, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=float)
    return 0


def phase_dist(torch, smi):
    """(a) one NCCL rank in this process; (b) two gloo ranks on the card."""
    import torch.distributed as dist

    from overlapnet_torch.backend import pose_graph
    from overlapnet_torch.cli.__main__ import main as cli_main
    from overlapnet_torch.core.config import OverlapNetConfig
    from overlapnet_torch.core.distributed import maybe_initialize_distributed
    from overlapnet_torch.data.gt_files import save_gt_files
    from overlapnet_torch.lcd.infer import Infer
    from overlapnet_torch.lcd.online import OnlineLoopCloser
    from overlapnet_torch.models import init_params, leg_output_width
    from overlapnet_torch.parallel.mesh import make_mesh

    phase_t0 = time.perf_counter()
    cfg = OverlapNetConfig()
    out_width = leg_output_width(cfg.model)
    launches = {"delta_conv1": 0, "delta_conv1_bwd": 0, "c_conv2_relu": 0, "c_conv3_dense": 0}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "train")
        table = write_train_set(data, cfg.model.input_height, cfg.model.input_width, out_width)
        save_gt_files(os.path.join(data, "00", "ground_truth"), "00", table, table, table)
        lcd = os.path.join(tmp, "lcd")
        poses, covs, _ = write_loop(lcd, cfg.model.input_height, cfg.model.input_width)
        np.save(os.path.join(lcd, "poses.npy"), poses)
        np.save(os.path.join(lcd, "covs.npy"), covs)

        # ---- (a) one NCCL rank: cli train on the mesh path and with
        # --single-device, the same bits; Infer on a mesh of one
        os.environ.update(OVERLAPNET_COORDINATOR=f"127.0.0.1:{free_port()}",
                          OVERLAPNET_NUM_PROCESSES="1", OVERLAPNET_PROCESS_ID="0")
        if not maybe_initialize_distributed():
            raise RuntimeError("the OVERLAPNET_* variables did not start a process group")
        try:
            backend = str(dist.get_backend())
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.deterministic = True  # two runs, the same cuDNN algorithms
            k_start = kernel_launches()
            t0 = time.perf_counter()
            if cli_main(["train", dist_train_yml(tmp, data, "mesh")]) != 0:
                raise RuntimeError("cli train on a mesh of one rank failed")
            mesh_train_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            train_launches = launches_since(k_start)
            if cli_main(["train", dist_train_yml(tmp, data, "single"), "--single-device"]) != 0:
                raise RuntimeError("cli train --single-device failed")
            torch.backends.cudnn.deterministic = False
            (log_m, ck_m), (log_s, ck_s) = train_log(tmp, "mesh"), train_log(tmp, "single")
            if not ck_m["step"] == ck_s["step"] == DIST_STEPS:
                raise RuntimeError(f"checkpoint steps {ck_m['step']}, {ck_s['step']}")
            differ = [k for k in ck_s["params"] if not torch.equal(ck_m["params"][k],
                                                                   ck_s["params"][k])]
            if differ or log_m != log_s:
                d = max(float((ck_m["params"][k] - ck_s["params"][k]).abs().max())
                        for k in ck_s["params"])
                raise RuntimeError(f"a mesh of one NCCL rank differs from no mesh: {len(differ)} "
                                   f"tensors, up to {d}; logs {log_m[-2:]} vs {log_s[-2:]}")
            if train_launches != {"delta_conv1": 2 * DIST_STEPS, "delta_conv1_bwd": DIST_STEPS,
                                  "c_conv2_relu": 2 * DIST_STEPS,
                                  "c_conv3_dense": 2 * DIST_STEPS}:
                raise RuntimeError(f"cli train on the mesh: launches {train_launches} for "
                                   f"{DIST_STEPS} steps and {DIST_STEPS} evaluated batches")

            mesh1 = make_mesh(1)
            cfg.data.data_root_folder, cfg.data.infer_seqs = lcd, "00"
            params = init_params(cfg.model, cfg.num_input_channels, seed=0)

            def closer(**where):
                infer = Infer(cfg, params=params, db_capacity=512, **where)
                return OnlineLoopCloser(infer, poses, covariances=covs, overlap_threshold=-1.0)

            closer(mesh=mesh1).run(LCD_OUT + 8)  # warm-up: NCCL's communicator, plans
            torch.cuda.synchronize()
            k_start = kernel_launches()
            on_mesh = closer(mesh=mesh1)
            torch.cuda.set_sync_debug_mode("error")
            try:
                t0 = time.perf_counter()
                on_mesh.run(pipeline_depth=8)
                torch.cuda.synchronize()
                mesh_lcd_s = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode("default")
            lcd_launches = launches_since(k_start)
            heads_per_head_call(lcd_launches, "Infer on a mesh of one rank")
            lcd_launches = lcd_launches["delta_conv1"]
            scored = len(on_mesh.closures)
            if lcd_launches < scored or scored < LCD_OUT // 2:
                raise RuntimeError(f"{lcd_launches} K1 launches for {scored} scored frames")
            one = closer(device="cuda", shards=1)
            t0 = time.perf_counter()
            one.run(pipeline_depth=8)
            torch.cuda.synchronize()
            one_lcd_s = time.perf_counter() - t0
            if [dataclasses.astuple(c) for c in on_mesh.closures] != \
                    [dataclasses.astuple(c) for c in one.closures]:
                raise RuntimeError("Infer on a mesh of one rank differs from shards=1")

            gt, est, graph = loop_graph()
            got = pose_graph.optimize_pose_graph(graph, est, mesh=mesh1, **PG_SOLVE)
            want = pose_graph.optimize_pose_graph(graph, est, device="cuda", **PG_SOLVE)
            if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError("the pose graph on a mesh of one rank differs from no mesh")
        finally:
            dist.destroy_process_group()
            for k in ("OVERLAPNET_COORDINATOR", "OVERLAPNET_NUM_PROCESSES", "OVERLAPNET_PROCESS_ID"):
                os.environ.pop(k)
        for k, v in train_launches.items():
            launches[k] += v
        launches["delta_conv1"] += lcd_launches
        launches["c_conv2_relu"] += lcd_launches
        launches["c_conv3_dense"] += lcd_launches

        # ---- (b) two gloo ranks on the one card (kernels built above)
        env = {**os.environ, "OVERLAPNET_COORDINATOR": f"127.0.0.1:{free_port()}",
               "OVERLAPNET_NUM_PROCESSES": str(DIST_RANKS)}
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(DIST_RANKS)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "dist-rank",
                                   str(r), tmp], cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT,
                                  env={**env, "OVERLAPNET_PROCESS_ID": str(r),
                                       "PYTHONHASHSEED": str(r)})
                 for r in range(DIST_RANKS)]
        t0 = time.perf_counter()
        try:
            for p in procs:
                p.wait(timeout=max(1.0, DIST_DEADLINE_S - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            text = log.read()
            log.close()
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} failed ({p.returncode}):\n{text[-6000:]}")
        ranks = []
        for r in range(DIST_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                info = json.load(f)
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as f:
                info["arrays"] = dict(f)
            ranks.append(info)
        r0, r1 = ranks

    # the gates of (b): every failure is listed in the line, then raised
    failures = []
    for info in ranks:
        if not info["params_equal_across_ranks"]:
            failures.append("two ranks' parameters differ after the data-parallel steps")
        want = {"delta_conv1": DIST_STEPS + 1, "delta_conv1_bwd": DIST_STEPS,
                "c_conv2_relu": DIST_STEPS + 1, "c_conv3_dense": DIST_STEPS + 1}
        if info["train_launches"] != want:
            failures.append(f"rank {info['rank']}: launches {info['train_launches']}, want {want}")
        lcd = info["lcd_launches"]
        if lcd["delta_conv1"] < 1 or not (lcd["c_conv2_relu"] == lcd["c_conv3_dense"]
                                           == lcd["delta_conv1"]):
            failures.append(f"rank {info['rank']}: {lcd} in the sharded map (K1 at least once, "
                            "K3 and K4 once per K1)")
        for k in launches:
            launches[k] += info["train_launches"][k] + lcd.get(k, 0)
    got, want = r0["train_metrics"][0], r0["ref_train_metrics"][0]
    d_loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    if d_loss > 1e-5:
        failures.append(f"first step: two ranks' loss {got['loss']} vs one device {want['loss']}")
    if r0["params_step1_beyond_tol"]:
        failures.append(f"first step: {r0['params_step1_beyond_tol']} parameters beyond rtol "
                        f"1e-4 / atol 1e-6 (largest |d| {r0['params_step1_max_abs']})")
    losses = np.array([[m["loss"] for m in r0[k]] for k in ("train_metrics", "ref_train_metrics")])
    for r in ranks[1:]:
        if [(m["loss"], m["grad_norm"]) for m in r["train_metrics"]] != \
                [(m["loss"], m["grad_norm"]) for m in r0["train_metrics"]]:
            failures.append("the ranks logged different losses")
    closures = [r["arrays"]["closures"] for r in ranks]
    ref = r0["arrays"]["ref_closures"]
    if not np.array_equal(closures[0], closures[1]):
        failures.append("the ranks' loop closures differ")
    same_rows = closures[0].shape == ref.shape
    if not same_rows or not np.array_equal(closures[0][:, :2], ref[:, :2]):
        failures.append("sharded map: frames or matches differ from one device's")
    d_overlap, d_yaw = ((float(np.abs(closures[0][:, c] - ref[:, c]).max()) for c in (2, 3))
                        if same_rows else (float("inf"),) * 2)
    if d_overlap > 1e-6 or d_yaw > 1e-3:
        failures.append(f"sharded map: overlap |d| {d_overlap}, yaw |d| {d_yaw} deg")
    pg = [r["arrays"]["poses"] for r in ranks]
    if not np.array_equal(pg[0], pg[1]):
        failures.append("the ranks' pose-graph solves differ")
    d_pose = float(np.abs(pg[0][:, :2] - r0["arrays"]["ref_poses"][:, :2]).max())
    d_chi2 = float(np.max(np.abs(r0["arrays"]["chi2"] / r0["arrays"]["ref_chi2"] - 1)))
    d_pose64 = float(np.abs(r0["arrays"]["poses64"][:, :2] - r0["arrays"]["ref_poses64"][:, :2]).max())
    if d_pose64 > 1e-6:
        failures.append(f"edge-sharded solve in float64: {d_pose64} m")

    emit({
        "phase": "dist", "config": "OverlapNetConfig() 64x900x4, W'=360, batch 16",
        "one_nccl_rank": {
            "backend": backend, "cli_train_launches": train_launches,
            "cli_train_mesh_equals_single_device": "bit for bit (5 steps, cudnn.deterministic)",
            "cli_train_s": mesh_train_s, "lcd_delta_conv1_launches": lcd_launches,
            "lcd_scored_frames": scored, "sync_debug_mode": "error: nothing raised",
            "lcd_frames_per_s_mesh1": 2 * LCD_OUT / mesh_lcd_s,
            "lcd_frames_per_s_shards1": 2 * LCD_OUT / one_lcd_s,
            "pose_graph_mesh1_equals_no_mesh": "bit for bit"},
        "two_gloo_ranks_one_card": {
            "train_fp32_legs_tf32_off": {
                "loss_two_ranks": losses[0].tolist(), "loss_one_device": losses[1].tolist(),
                "first_step_loss_rel_diff": d_loss,
                "params_step1_max_abs_diff": r0["params_step1_max_abs"],
                "params_step5_max_abs_diff": r0["params_step5_max_abs"],
                "params_step5_beyond_rtol1e-4_atol1e-6": r0["params_step5_beyond_tol"],
                "n_params": r0["n_params"], "params_equal_across_ranks": True,
                "eval_two_ranks": r0["eval"], "eval_one_device": r0["ref_eval"]},
            "launches_per_rank": [{"train": r["train_launches"], "lcd": r["lcd_launches"]}
                                  for r in ranks],
            "step_ms_default_model": {"two_ranks_8_pairs_each": [r["step_ms_two_ranks"] for r in ranks],
                                      "one_device_16_pairs": r0["step_ms_one_device"]},
            "lcd": {"frames": 2 * LCD_OUT, "closures": len(ref), "overlap_absdiff": d_overlap,
                    "yaw_absdiff_deg": d_yaw, "frames_per_s_two_ranks": 2 * LCD_OUT / r0["lcd_s"],
                    "frames_per_s_one_device_shards2": 2 * LCD_OUT / r0["ref_lcd_s"]},
            "pose_graph": {"poses": PG_POSES, "float32_max_abs_m": d_pose,
                           "float32_chi2_rel": d_chi2, "float64_short_max_abs_m": d_pose64,
                           "solve_s_two_ranks": r0["solve_s"], "solve_s_one_device": r0["ref_solve_s"]},
            "note": "two ranks share one card: this measures the mechanism, not scaling"},
        "failures": failures, "phase_s": time.perf_counter() - phase_t0, "card": smi,
    })
    if failures:
        raise RuntimeError("phase dist: " + "; ".join(failures))
    return launches


PHASES = ("kernel", "kernel_bwd", "conv2", "conv3", "model", "lcd", "train", "prep", "e2e",
          "dist")


def main(argv: list[str]) -> int:
    if argv[:1] == ["dist-rank"]:  # a rank process of phase dist
        return dist_rank(int(argv[1]), argv[2])
    import torch

    only = [a for a in argv if a in PHASES]
    if len(only) != len(argv):
        print(f"chip_smoke: phases are {PHASES}, got {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from overlapnet_torch.kernels import build
    from overlapnet_torch.kernels import delta_conv1 as k1
    from overlapnet_torch.ops import delta as plain

    smi, name = phase_env(torch, build)
    run = {
        "kernel": lambda: phase_kernel(torch, k1, plain, name, smi),
        "kernel_bwd": lambda: phase_kernel_bwd(torch, k1, plain, name, smi),
        "conv2": lambda: phase_conv2(torch, name, smi),
        "conv3": lambda: phase_conv3(torch, name, smi),
        "model": lambda: phase_model(torch, smi),
        "lcd": lambda: phase_lcd(torch, smi),
        "train": lambda: phase_train(torch, smi),
        "prep": lambda: phase_prep(torch, smi),
        "e2e": lambda: phase_e2e(torch, smi),
        "dist": lambda: phase_dist(torch, smi),
    }
    out = {phase: run[phase]() for phase in PHASES if not only or phase in only}
    if only:  # a part of the run, for development: no result line
        print(smi, flush=True)
        return 0
    fwd, bwd, k3_rows, k4_rows = out["kernel"], out["kernel_bwd"], out["conv2"], out["conv3"]
    main_path = ("model", "lcd", "train", "prep", "e2e", "dist")
    k1_launches = {p: out[p]["delta_conv1"] for p in main_path}
    k2_launches = {p: out[p]["delta_conv1_bwd"] for p in ("train", "prep", "e2e", "dist")}
    k3_launches = {p: out[p]["c_conv2_relu"] for p in main_path}
    k4_launches = {p: out[p]["c_conv3_dense"] for p in main_path}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound_3xtf32_ms", "bound_fp32_simt_ms")
    emit({"kernels": [{
        "name": k1.NAME, "route": "cuda", "source": k1.SOURCE,
        "replaces": tpu_kernel_site(k1.REPLACES), "launches": sum(k1_launches.values()),
        "launches_by_phase": k1_launches, "shape": "B=32, W'=360",
        **{k: fwd["b32_w360"][k] for k in keys},
        "max_abs_err_all_forms": max(r["max_abs_err"] for r in fwd.values()),
        "exact_path": {f: {k: fwd[f][k] for k in ("ms", "floor_ms", "max_abs_err")}
                       for f in ("bf16_b32_w360", "bf16_b256_w360",
                                 "bf16_query_stride0_b256_w360")},
    }, {
        "name": k1.BWD_NAME, "route": "cuda", "source": k1.BWD_SOURCE,
        "replaces": tpu_kernel_site(k1.BWD_REPLACES, marker="_core_bwd"),
        "launches": sum(k2_launches.values()), "launches_by_phase": k2_launches,
        "shape": "B=16, W'=360 (the train step's)",
        **{k: bwd["b16_w360"][k] for k in keys},
        "max_abs_err_is": "over each gradient's largest magnitude",
        "max_abs_err_all_forms": max(r["max_abs_err"] for r in bwd.values()),
        "share_of_3xtf32_bound": bwd["b16_w360"]["bound_3xtf32_ms"] / bwd["b16_w360"]["ms"],
        "ms_b32_w360": bwd["b32_w360"]["ms"], "ms_only_dkernel_b16_w360":
        bwd["frozen_legs_b16_w360"]["ms"],
        "ms_c64_b4_w360": bwd["c64_b4_w360"]["ms"], "ms_b4_w495": bwd["b4_w495"]["ms"],
    }, {
        "name": "c_conv2_relu", "route": "cuda", "source": "overlapnet_torch/csrc/c_conv2_relu.cu",
        "replaces": "none: the JAX package leaves c_conv2 to XLA",
        "launches": sum(k3_launches.values()), "launches_by_phase": k3_launches,
        "shape": "B=256, W'=360 (the head call's)",
        **{k: k3_rows["b256_w360"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "share_of_bound")},
        "share_of_bound_is": "bound_ms over device_ms_b256_w360",
        "worst_pair_rel_err_fp64_all_forms": max(
            r["worst_pair_rel_err_fp64"] for r in k3_rows.values()),
        "ms_b32_w360": k3_rows["b32_w360"]["ms"], "ms_b256_w450": k3_rows["b256_w450"]["ms"],
        "ms_b1_w360": k3_rows["b1_w360"]["ms"], "ms_3xtf32": k3_rows["b256_w360"]["ms_3xtf32"],
        **{f"device_ms_{f}": k3_rows[f]["device_ms"] for f in ("b256_w360", "b32_w360", "b1_w360")},
        **{f"library_device_ms_{f}": k3_rows[f]["library_device_ms"]
           for f in ("b256_w360", "b32_w360", "b1_w360")},
        "worst_pair_rel_err_fp64_3xtf32_all_forms": max(
            r["worst_pair_rel_err_fp64_3xtf32"] for r in k3_rows.values()),
    }, {
        "name": "c_conv3_dense", "route": "cuda",
        "source": "overlapnet_torch/csrc/c_conv3_dense.cu",
        "replaces": "none: the JAX package leaves c_conv3 and the dense to XLA",
        "launches": sum(k4_launches.values()), "launches_by_phase": k4_launches,
        "shape": "B=256, W'=360 (the head call's)",
        **{k: k4_rows["b256_w360"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms", "share_of_bound")},
        "share_of_bound_is": "bound_ms over device_ms_b256_w360",
        **{f"{k}_all_forms": max(r[k] for r in k4_rows.values())
           for k in ("max_abs_err_fp64", "max_abs_err_vs_tf32_rna", "max_abs_err_fp64_3xtf32")},
        **{f"device_ms_{f}": k4_rows[f]["device_ms"] for f in ("b256_w360", "b32_w360",
                                                               "b1_w360", "b256_w450")},
        **{f"library_device_ms_{f}": k4_rows[f]["library_device_ms"]
           for f in ("b256_w360", "b32_w360", "b1_w360", "b256_w450")},
        "device_ms_3xtf32_b256_w360": k4_rows["b256_w360"]["device_ms_3xtf32"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
