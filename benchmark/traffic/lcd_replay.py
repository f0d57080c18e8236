"""Closed-loop replay of online loop closing over a KITTI-00-length route:
``OnlineLoopCloser.run`` over the route's frames after the map, as fast as
they resolve, for the window's seconds.

The route is a loop driven lap after lap (``synth.loop_route``). Set-up
embeds the map's frames (the first ``map_frames``) from seeded images with
the program's legs and adds them through ``Infer.add_embedding``; the window
continues the route from there, reading each frame's image from disk in the
layout ``Infer`` reads. Window images are links into a seeded pool of
``pool`` images, so a run writes little.

End-to-end: ``lcd_frames_per_s``, the frames whose answer came back over
the time they took (whole calls of ``frames_per_call`` frames).

Every frame the window dispatches is recorded (its candidates and its
answer), and one head call of a seeded early window frame keeps K1's output
for a seeded few of its pairs, with the pairs' inputs (``K1Tap``). After
the window the program's answers are judged against the plain reference
(``benchmark/reference``), stage by stage:

- the gating: each judged frame's candidates against the reference's
  gating of the same poses (``candidate_mismatches``, exact);
- the legs: the program's stored embedding of each judged frame and of
  every candidate of each, against the reference's legs on the same images
  (``legs_err``);
- K1: the kept output against the reference's float32 delta layer and
  c_conv1 on the same inputs (``k1_err``);
- the heads and the choice: the reference's heads score every candidate
  the reference gates for a judged frame, from the program's own embeddings
  (the map the program holds); the program's overlap must lie near the
  reference's at its match, and its match near the reference's best
  (``overlap_err``, the larger of the two gaps).

The yaw and its confidence are not compared: given the embeddings they are
a float32 FFT correlation, and the TF32 control reads them as closely as
the program does (their sums are of non-negative products, which TF32's
rounding does not lift above float32's), so no limit separates the two
(PERF.md, section 2).
"""

from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import synth
from benchmark.reference import lcd as ref_lcd
from benchmark.reference import model as ref

MAP_BLOCK = 64
PAIRS_PER_CALL = 256  # the program's chunk of pairs per head call
K1_PAIRS = 16  # pairs of the tapped head call whose K1 output is kept


@dataclass
class Answer:
    frame: int
    cands: np.ndarray
    match: int | None
    overlap: float = -1.0


def map_images(run, first: int, count: int) -> torch.Tensor:
    """(count, H, W, C) images of map frames first.. (inside one block of
    MAP_BLOCK frames, which is made whole from its own stream)."""
    g = ref.geometry(run.config)
    block = first // MAP_BLOCK
    gen = synth.generator(run.seed, run.device, 1000 + block)
    n = min(MAP_BLOCK, run.mix["map_frames"] - block * MAP_BLOCK)
    kinds = synth.range_images(n, run.config, g["height"], g["width"], gen, run.device)
    at = first - block * MAP_BLOCK
    return synth.stack_channels(kinds)[at : at + count]


def route(run) -> np.ndarray:
    mix = run.mix
    return synth.loop_route(mix["frames"], mix["lap_frames"], mix["spacing_m"],
                            mix["lateral_m"])


def candidates(run, poses: np.ndarray, frame: int) -> np.ndarray:
    """The reference's gating: the frames ``frame`` is scored against (no
    covariance: every frame the inactive-map gates let through)."""
    return ref_lcd.candidates(frame, poses[:, :2, 3], run.mix["inactive_time"],
                              run.mix["inactive_dist_m"])


def write_window_images(run, root: str) -> None:
    """The pool's images as per-kind .npy files, and each window frame's
    files as links to a pool entry chosen from the seed."""
    mix, g = run.mix, ref.geometry(run.config)
    pool = mix["pool"]
    kinds = synth.range_images(pool, run.config, g["height"], g["width"],
                               synth.generator(run.seed, run.device, 2000), run.device)
    for kind, x in kinds.items():
        os.makedirs(os.path.join(root, "pool", kind), exist_ok=True)
        os.makedirs(os.path.join(root, "00", kind), exist_ok=True)
        host = x.cpu().numpy()
        for k in range(pool):
            np.save(os.path.join(root, "pool", kind, f"{k}.npy"), host[k])
    perm = synth.rng(run.seed, 4).permutation(pool)
    first = mix["map_frames"]
    for f in range(first, mix["frames"]):
        k = int(perm[(f - first) % pool])
        for kind in kinds:
            os.symlink(os.path.join(root, "pool", kind, f"{k}.npy"),
                       os.path.join(root, "00", kind, f"{f:06d}.npy"))


def window_images(run, frames) -> torch.Tensor:
    """The window frames' images as the reference reads them from disk."""
    out = []
    for f in frames:
        parts = []
        for kind, _ in synth.CHANNEL_ORDER:
            p = os.path.join(run.workdir, "00", kind, f"{int(f):06d}.npy")
            if os.path.exists(p):
                x = np.load(p)
                parts.append(x[..., None] if x.ndim == 2 else x)
        out.append(np.concatenate(parts, axis=-1))
    return torch.from_numpy(np.stack(out)).to(run.device)


def images(run, frames) -> torch.Tensor:
    """(k, H, W, C) images of any frames, map or window, in order."""
    frames = [int(f) for f in frames]
    m = run.mix["map_frames"]
    out = [None] * len(frames)
    by_block: dict[int, list[int]] = {}
    for i, f in enumerate(frames):
        if f < m:
            by_block.setdefault(f // MAP_BLOCK, []).append(i)
    for block, at in by_block.items():
        imgs = map_images(run, block * MAP_BLOCK, MAP_BLOCK)
        for i in at:
            out[i] = imgs[frames[i] - block * MAP_BLOCK]
    win = [i for i, f in enumerate(frames) if f >= m]
    if win:
        for i, x in zip(win, window_images(run, [frames[i] for i in win])):
            out[i] = x
    return torch.stack(out)


def chunk_sizes(counts) -> set[int]:
    """The head's batch sizes for frames with these candidate counts."""
    sizes = set()
    for n in counts:
        if n >= PAIRS_PER_CALL:
            sizes.add(PAIRS_PER_CALL)
        if n % PAIRS_PER_CALL:
            sizes.add(n % PAIRS_PER_CALL)
    return sizes


def k1_target(run, poses: np.ndarray) -> tuple[int, np.ndarray]:
    """The tapped head call, from the seed: the first head call of a frame
    of the window's first call that the reference gates candidates for,
    and the order in which its pairs are taken (the first K1_PAIRS that
    the call holds are kept)."""
    r = synth.rng(run.seed, 8)
    m = run.mix["map_frames"]
    reach = range(m, min(run.mix["frames"], m + run.mix["frames_per_call"]))
    frames = [f for f in reach if len(candidates(run, poses, f))] or [m]
    frame = int(frames[r.integers(len(frames))])
    return frame, r.permutation(PAIRS_PER_CALL)


def k1_rows(order: np.ndarray, size: int) -> np.ndarray:
    """The kept pairs of a head call of ``size`` pairs, ascending."""
    return np.sort(order[order < size][:K1_PAIRS])


class K1Tap:
    """Keeps K1's output of one head call of the timed path: the overlap
    head's inputs (a forward pre-hook on the head) and the input of c_conv2,
    which is K1's output (B, 64, W', J) (a forward pre-hook on c_conv2), at
    the kept pairs. Armed for the target frame's first head call only."""

    def __init__(self, head, frame: int, order: np.ndarray):
        self.frame, self.order = frame, order
        self.armed, self.rows, self.inputs, self.got = False, None, None, None
        self.handles = [head.register_forward_pre_hook(self._head),
                        head.c_conv2.register_forward_pre_hook(self._c_conv2)]

    def arm(self, frame: int) -> None:
        self.armed = frame == self.frame and self.inputs is None

    def _head(self, module, args):
        if self.armed and self.inputs is None:
            fa, fb = args[0], args[1]
            self.rows = torch.as_tensor(k1_rows(self.order, fa.shape[0]), device=fa.device)
            self.inputs = (fa.index_select(0, self.rows).clone(),
                           fb.index_select(0, self.rows).clone())

    def _c_conv2(self, module, args):
        if self.armed and self.inputs is not None and self.got is None:
            self.got = args[0].index_select(0, self.rows).clone()
            self.armed = False

    def warm(self, score, fa, fb) -> None:
        """One armed head call at set-up: CUDA loads the kernels that keep
        the pairs here rather than in the window."""
        self.armed = True
        score(fa, fb)
        self.armed, self.rows, self.inputs, self.got = False, None, None, None

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def kept(self):
        """(fa, fb, K1 output (k, W', J, 64)) on the host, or None."""
        if self.got is None:
            return None
        fa, fb = self.inputs
        return fa.float().cpu(), fb.float().cpu(), self.got.permute(0, 2, 3, 1).float().cpu()


def setup(run) -> dict:
    from overlapnet_torch.core.config import config_from_dict
    from overlapnet_torch.lcd.infer import Infer
    from overlapnet_torch.lcd.online import OnlineLoopCloser

    mix, dev = run.mix, run.device
    g = ref.geometry(run.config)
    cfg = config_from_dict(run.config)
    cfg.data.data_root_folder, cfg.data.infer_seqs = run.workdir, "00"
    n, m = mix["frames"], mix["map_frames"]
    poses = route(run)
    weights = synth.init_weights(run.config, run.seed, dev)
    infer = Infer(cfg, params=weights, db_capacity=n, device=dev)
    with torch.no_grad():  # the store grows here: its tensors stay normal ones
        for b0 in range(0, m, MAP_BLOCK):
            fv = infer.model.encode(map_images(run, b0, min(MAP_BLOCK, m - b0)))
            for k in range(fv.shape[0]):
                infer.add_embedding(b0 + k, fv[k])
    write_window_images(run, run.workdir)
    closer = OnlineLoopCloser(infer, poses, covariances=None,
                              inactive_time=mix["inactive_time"],
                              inactive_dist=mix["inactive_dist_m"],
                              overlap_threshold=mix["overlap_threshold"])
    # The map's frames went in through add_embedding: the loop starts past
    # them, where resume() of a saved session would put it.
    closer._next_frame = m

    # Warm-up: the legs on one frame, and the heads at every batch size the
    # window's frames can give (full chunks and each remainder); the largest
    # candidate gather once, so the allocator holds a block for it.
    reach = range(m, min(n, m + mix["warm_frames"]))
    counts = [len(candidates(run, poses, f)) for f in reach]
    w_out = g["out_width"]
    c_out = infer.model.legs.out_channels
    with torch.no_grad():
        infer.model.encode(torch.zeros((1, g["height"], g["width"], g["channels"]), device=dev))
        q = torch.zeros((1, w_out, c_out), device=dev)
        for b in sorted(chunk_sizes(counts)):
            infer.model.score(torch.zeros((b, w_out, c_out), device=dev), q.expand(b, -1, -1))
        big = torch.empty((max(counts, default=1), w_out, c_out), device=dev)
        del big
    # One frame through a throwaway Infer on the first window frame's files,
    # with a full chunk of candidates and a partial one: CUDA loads a
    # kernel's module at its first launch, and every kernel of the frame
    # path (image load, legs, insert, gather, heads, yaw readout) is launched
    # here rather than in the window.
    k = PAIRS_PER_CALL + 8
    spare = Infer(cfg, params=weights, db_capacity=k + 1, device=dev)
    for i in range(k):
        spare.add_embedding(i, torch.zeros((w_out, c_out), device=dev))
    spare.dispatch_frame(m, list(range(k))).result
    del spare
    tap = K1Tap(infer.model.overlap_head, *k1_target(run, poses))
    with torch.no_grad():
        fa = torch.zeros((PAIRS_PER_CALL, w_out, c_out), device=dev)
        tap.warm(infer.model.score, fa, q.expand(PAIRS_PER_CALL, -1, -1))
        del fa
    run.sync()

    state = {"infer": infer, "closer": closer, "log": [], "tracer": None, "tap": tap}
    dispatch = infer.dispatch_frame

    def recording(frame_id, candidate_frame_ids, *args, **kw):
        tap.arm(int(frame_id))
        tracer = state["tracer"]
        if tracer is None:
            pending = dispatch(frame_id, candidate_frame_ids, *args, **kw)
        else:
            with tracer.span("dispatch"):
                pending = dispatch(frame_id, candidate_frame_ids, *args, **kw)
        tap.armed = False
        state["log"].append((frame_id, candidate_frame_ids, pending))
        return pending

    infer.dispatch_frame = recording
    return state


def window(run, state, seconds: float, tracer) -> dict:
    closer, mix = state["closer"], run.mix
    state["tracer"] = tracer
    cursor = first = mix["map_frames"]
    t0 = time.perf_counter()
    while cursor < mix["frames"]:
        cursor = min(mix["frames"], cursor + mix["frames_per_call"])
        closer.run(cursor, pipeline_depth=mix["pipeline_depth"])
        if time.perf_counter() - t0 >= seconds:
            break
    dt = time.perf_counter() - t0
    # the window's frames, candidate pairs and head batch sizes, for the
    # per-layer readers
    cands = [len(c) for _, c, _ in state["log"]]
    chunks = [min(PAIRS_PER_CALL, n - s) for n in cands for s in range(0, n, PAIRS_PER_CALL)]
    run.counts.update(frames=len(cands), pairs=int(sum(cands)), chunks=chunks)
    return {"lcd_frames_per_s": (cursor - first) / dt}


def count_answers(run, state) -> list[Answer]:
    answers, failed = [], 0
    for frame, cands, pending in state["log"]:
        res = pending.result
        cands = np.asarray(cands, np.int64)
        if res is None:
            failed += int(len(cands) > 0)
            answers.append(Answer(int(frame), cands, None))
        else:
            answers.append(Answer(int(frame), cands, int(res[0]), float(res[1])))
    run.counts.update(attempted=len(answers), failed=failed, frames=len(answers),
                      pairs=int(sum(len(a.cands) for a in answers)))
    return answers


def sample(run, answers: list[Answer]) -> list[Answer]:
    """The judged frames: the one with the most candidates and a seeded
    draw of the rest, ``check_frames`` in all."""
    if not answers:
        return []
    longest = max(range(len(answers)), key=lambda i: len(answers[i].cands))
    rest = [i for i in range(len(answers)) if i != longest]
    k = min(len(rest), run.mix["check_frames"] - 1)
    pick = synth.rng(run.seed, 5).choice(rest, size=k, replace=False) if k else []
    return [answers[longest]] + [answers[int(i)] for i in sorted(pick)]


def scores(params, emb, cands, q, prec=ref.REFERENCE):
    """The reference overlap head's overlap of every candidate (left)
    against the query volume ``q`` (right), in the program's chunks."""
    over = []
    for s in range(0, len(cands), PAIRS_PER_CALL):
        left = emb(cands[s : s + PAIRS_PER_CALL])
        over.append(ref.overlap(params, left, q.expand(left.shape[0], -1, -1), prec))
    return torch.cat(over)


def k1_of(params, fa, fb, prec=ref.REFERENCE) -> torch.Tensor:
    """The reference's delta layer and c_conv1, (k, W', J, 64)."""
    p = "overlap_head.c_conv1."
    with ref.tf32(prec.heads_tf32):
        return ref.delta_conv1(fa, fb, params[p + "weight"], params[p + "bias"])


def judge(run, judged: list[Answer], emb, k1) -> dict[str, tuple[float, float]]:
    """The compared numbers of the judged answers: ``emb(frames)`` gives the
    judged side's embeddings (k, W', C) on the device, ``k1`` its kept
    (fa, fb, K1 output) or None."""
    lim = run.mix["limits"]
    params = synth.init_weights(run.config, run.seed, run.device)
    poses = route(run)
    want_cands = {a.frame: candidates(run, poses, a.frame) for a in judged}
    mismatches = sum(len(np.setxor1d(a.cands, want_cands[a.frame])) for a in judged)
    legs_frames = {a.frame for a in judged} | {a.match for a in judged if a.match is not None}
    for c in want_cands.values():
        legs_frames |= {int(x) for x in c}
    legs_frames = sorted(legs_frames)
    legs_err = overlap_err = 0.0
    k1_err = float("inf")
    with torch.no_grad():
        for at in range(0, len(legs_frames), MAP_BLOCK):
            fr = legs_frames[at : at + MAP_BLOCK]
            want = ref.legs(params, images(run, fr))
            got = emb(fr)
            err = (got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
            legs_err = max(legs_err, float(err.max()))
        if k1 is not None:
            fa, fb, got = (x.to(run.device) for x in k1)
            want = k1_of(params, fa, fb)
            k1_err = float(((got - want).flatten(1).norm(dim=1)
                            / want.flatten(1).norm(dim=1)).max())
        for a in judged:
            c = want_cands[a.frame]
            if len(c) == 0:
                continue
            if a.match is None or a.match not in set(c.tolist()):
                overlap_err = float("inf")
                continue
            over = scores(params, emb, c, emb([a.frame]))
            o_j = float(over[int(np.flatnonzero(c == a.match)[0])])
            overlap_err = max(overlap_err, abs(a.overlap - o_j), float(over.max()) - o_j)
    return {"candidate_mismatches": (float(mismatches), lim["candidate_mismatches"]),
            "legs_err": (legs_err, lim["legs_err"]),
            "k1_err": (k1_err, lim["k1_err"]),
            "overlap_err": (overlap_err, lim["overlap_err"])}


def check(run, state) -> dict[str, tuple[float, float]]:
    """Judge the program's answers: frees the program first, keeping its
    map (the embeddings it holds, on the host), its answers and the kept K1
    output."""
    answers = count_answers(run, state)
    judged = sample(run, answers)
    tap, infer = state["tap"], state["infer"]
    tap.remove()
    k1 = tap.kept()
    rows = dict(infer._frame_rows)
    held = torch.from_numpy(infer.feature_volumes)
    state.clear()
    del infer, tap
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()

    def emb(frames):
        idx = torch.as_tensor([rows[int(f)] for f in frames])
        return held[idx].to(run.device)

    return judge(run, judged, emb, k1)


def control(run, judged_frames: list[int], prec: ref.Precision) -> dict[str, float]:
    """The reference in the program's place at ``prec``, judged as the
    program is: its own embeddings of every frame the judged frames need,
    its own best candidate and its overlap, and its own delta layer and
    c_conv1 for the K1 number."""
    params = synth.init_weights(run.config, run.seed, run.device)
    poses = route(run)
    frame, order = k1_target(run, poses)
    first = candidates(run, poses, frame)[:PAIRS_PER_CALL]
    k1_cands = first[k1_rows(order, len(first))]
    need, cands_of = set(judged_frames) | {frame} | {int(x) for x in k1_cands}, {}
    for f in judged_frames:
        c = candidates(run, poses, f)
        cands_of[f] = c
        need |= set(int(x) for x in c)
    need = sorted(need)
    table = {}
    with torch.no_grad():
        for at in range(0, len(need), MAP_BLOCK):
            fr = need[at : at + MAP_BLOCK]
            for f, e in zip(fr, ref.legs(params, images(run, fr), prec)):
                table[f] = e

        def emb(frames):
            return torch.stack([table[int(f)] for f in frames])

        answers = []
        for f in judged_frames:
            c = cands_of[f]
            if len(c) == 0:
                answers.append(Answer(f, c, None))
                continue
            over = scores(params, emb, c, emb([f]), prec)
            j = int(torch.argmax(over))
            answers.append(Answer(f, c, int(c[j]), float(over[j])))
        left = emb(k1_cands)
        right = emb([frame]).expand(left.shape[0], -1, -1)
        k1 = (left, right, k1_of(params, left, right, prec))
    return {k: v for k, (v, _) in judge(run, answers, emb, k1).items()}
