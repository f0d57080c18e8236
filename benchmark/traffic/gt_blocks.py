"""Ground-truth preparation: ``com_overlap_yaw_all`` over a sequence, a
block of query frames against every frame per call, the points handed in
as ``points=``.

Set-up makes the sequence on the device from the seed (a street along a
looping route, ``synth.street_scans``) and brings it to the host, where a
user's loader leaves it. The window walks the blocks in order (block b
holds frames 128 b .. 128 b + 127, modulo the sequence) and wraps.

End-to-end: ``gt_pairs_per_s``, the table pairs (query x reference, far
pairs included, as the user's table counts them) of the completed calls
over their time.

The check draws pairs of the window's tables from the seed and recomputes
their overlap and yaw bin with the plain reference (float64).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import synth
from benchmark.reference import gt as ref_gt
from benchmark.reference import model as ref


def route(run) -> np.ndarray:
    mix = run.mix
    return synth.loop_route(mix["frames"], mix["frames"], mix["spacing_m"], lateral=0.0,
                            sway_rad=mix["sway_rad"])


def block_queries(run, b: int) -> np.ndarray:
    n, k = run.mix["frames"], run.mix["block"]
    return (np.arange(k) + b * k) % n


def setup(run) -> dict:
    from overlapnet_torch.geometry.overlap import com_overlap_yaw_all

    mix = run.mix
    poses = route(run)
    g = synth.generator(run.seed, run.device, 4000)
    points = synth.street_scans(poses, mix["valid_points"], mix["max_points"], g,
                                run.device).cpu().numpy()
    state = {"poses": poses, "points": points, "paths": [""] * len(poses), "tables": [],
             "width": ref.geometry(run.config)["out_width"], "call": com_overlap_yaw_all}
    # warm-up: a call of one query (the per-frame range images of the whole
    # sequence, a few chunks of pairs)
    com_overlap_yaw_all(state["paths"], poses, query_idxs=[0], leg_output_width=state["width"],
                        chunk_size=mix["chunk"], points=points, device=run.device)
    return state


def window(run, state, seconds: float, tracer) -> dict:
    call, mix = state["call"], run.mix
    b, pairs = 0, 0
    t0 = time.perf_counter()
    while True:
        q = block_queries(run, b)
        with tracer.span("call"):
            table = call(state["paths"], state["poses"], query_idxs=q,
                         leg_output_width=state["width"], chunk_size=mix["chunk"],
                         points=state["points"], device=run.device)
        state["tables"].append(table)
        pairs += len(table)
        b += 1
        if time.perf_counter() - t0 >= seconds:
            break
    dt = time.perf_counter() - t0
    run.counts.update(attempted=b, failed=0, calls=b, pairs=pairs)
    return {"gt_pairs_per_s": pairs / dt}


def sample_pairs(run, tables: list[np.ndarray]) -> np.ndarray:
    """Rows [q, r, overlap, yaw_bin] drawn from the seed: ``check_pairs``
    among pairs closer than ``check_near_m`` (where overlaps are not
    nought), a quarter as many among the rest."""
    all_rows = np.concatenate(tables)
    poses = route(run)
    d = np.linalg.norm(poses[all_rows[:, 0].astype(int), :2, 3]
                       - poses[all_rows[:, 1].astype(int), :2, 3], axis=1)
    r = synth.rng(run.seed, 8)
    near, far = np.flatnonzero(d < run.mix["check_near_m"]), np.flatnonzero(
        d >= run.mix["check_near_m"])
    k = run.mix["check_pairs"]
    pick = np.concatenate([r.choice(near, min(k, len(near)), replace=False),
                           r.choice(far, min(k // 4, len(far)), replace=False)])
    return all_rows[np.sort(pick)]


def readings(run, rows: np.ndarray, points: np.ndarray, prog_overlap: np.ndarray | None,
             prec: str = ref_gt.REFERENCE) -> dict:
    """Largest overlap gap and count of yaw-bin mismatches of ``rows``
    against the reference; ``prog_overlap`` None puts the reference at
    ``prec`` in the program's place."""
    poses = route(run)
    q, r = rows[:, 0].astype(int), rows[:, 1].astype(int)
    width = ref.geometry(run.config)["out_width"]
    want, other = [], []
    step = run.mix["check_batch"]
    for s in range(0, len(rows), step):
        qs, rs = q[s : s + step], r[s : s + step]
        pq = torch.from_numpy(points[qs]).to(run.device)
        pr = torch.from_numpy(points[rs]).to(run.device)
        want.append(ref_gt.overlaps(pq, pr, poses[qs], poses[rs]).cpu().numpy())
        if prog_overlap is None:
            other.append(ref_gt.overlaps(pq, pr, poses[qs], poses[rs], prec).cpu().numpy())
    want = np.concatenate(want)
    got = np.concatenate(other) if prog_overlap is None else prog_overlap
    bins = ref_gt.yaw_bins(poses[q], poses[r], width)
    return {"overlap_err": float(np.abs(got - want).max()),
            "yaw_bin_mismatches": float(np.count_nonzero(rows[:, 3] != bins))}


def check(run, state) -> dict[str, tuple[float, float]]:
    lim = run.mix["limits"]
    rows = sample_pairs(run, state["tables"])
    points = state["points"]
    state.clear()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    got = readings(run, rows, points, rows[:, 2])
    return {k: (got[k], lim[k]) for k in lim}
