"""Each cell's driver runs at a tiny size on the CPU and comes out correct;
with the timed path broken underneath (each fault the cell can have) the
same run comes out not correct. These skip the harness's look for a chip
and drive the rest of a run. The training cell is not in BENCHMARK.json
yet; ``bench_root`` adds it (conftest.py)."""

import numpy as np
import pytest
import torch

from benchmark import harness

TINY_MODEL = {"model": {"inputShape": [64, 360], "leg_output_width": 90}}
LCD = dict(frames=250, map_frames=200, lap_frames=200, pool=6, inactive_time=20,
           inactive_dist_m=5.0, warm_frames=8, check_frames=3)
TINY = {
    "geo.lcd-dense": (LCD, TINY_MODEL),
    # float32 legs: PyTorch's CPU bfloat16 conv weight gradient returns NaN now and then
    "semantic.train": (dict(scans=20, probability_pool=6, pairs=48),
                       {"batch_size": 8, "model": dict(TINY_MODEL["model"], leg_dtype="float32")}),
    "geo.gt-prep": (dict(frames=30, valid_points=2500, max_points=3000, block=6, chunk=64,
                         check_pairs=24, spacing_m=2.0), TINY_MODEL),
}
SEED = 2**31 + 4242


def run(cell, root, seconds=0.6, trace=False):
    mix, model = TINY[cell]
    torch.manual_seed(0)
    spec = harness.find_cell(cell, root=root, overrides=mix, config_overrides=model)
    return harness.run_cell(spec, SEED, seconds, trace, device="cpu")


@pytest.mark.parametrize("cell", list(TINY))
def test_a_tiny_run_is_correct(cell, bench_root):
    out = run(cell, bench_root, trace=cell == "geo.lcd-dense")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def offset_overlap(monkeypatch):
    from overlapnet_torch.models.siamese import OverlapNet
    score = OverlapNet.score
    monkeypatch.setattr(OverlapNet, "score",
                        lambda self, fa, fb, *a: (lambda o, l: (o + 0.05, l))(*score(self, fa, fb, *a)))


def half_candidates(monkeypatch):
    from overlapnet_torch.lcd.descriptor_db import DescriptorDB
    query = DescriptorDB.query
    monkeypatch.setattr(DescriptorDB, "query", lambda self, fv, idx: tuple(
        np.concatenate([x, np.full(len(idx) - len(x), -1.0, x.dtype)])
        for x in query(self, fv, list(idx)[: max(1, len(idx) // 2)])))


def trimmed_gating(monkeypatch):
    """The online loop's gating lets every second candidate go before the
    frame is dispatched."""
    from overlapnet_torch.lcd import online
    mask_of = online.candidate_mask

    def trimmed(*a, **k):
        mask = mask_of(*a, **k).copy()
        mask[np.flatnonzero(mask)[1::2]] = False
        return mask
    monkeypatch.setattr(online, "candidate_mask", trimmed)


def k1_one_tf32_pass(monkeypatch):
    """K1 in one TF32 pass: its operands rounded to TF32 (10 mantissa bits)."""
    from overlapnet_torch.models import heads
    k1 = heads.delta_conv1

    def tf32(x):
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    monkeypatch.setattr(heads, "delta_conv1", lambda a, b, w, bias, **k: k1(
        tf32(a.float()), tf32(b.float()), tf32(w.float()), bias, **k))


def frame_not_stored(monkeypatch):
    """The frame step leaves the map as it was: a window frame's embedding
    is never written (its row keeps zeros)."""
    from overlapnet_torch.lcd.infer import Infer
    add = Infer.add_embedding
    monkeypatch.setattr(Infer, "add_embedding", lambda self, frame_id, fv: add(
        self, frame_id, fv if frame_id < LCD["map_frames"] else fv * 0))


def params_unchanged(monkeypatch):
    from overlapnet_torch.train.trainer import Optimizer
    monkeypatch.setattr(Optimizer, "update", lambda self, *a, **k: None)


def half_batch(monkeypatch):
    from overlapnet_torch.train import trainer
    loss = trainer._loss

    def half(cfg, model, x1, x2, overlap, orientation, mesh=None):
        k = x1.shape[0] // 2
        return loss(cfg, model, x1[:k], x2[:k], overlap[:k], orientation[:k], mesh)
    monkeypatch.setattr(trainer, "_loss", half)


def gt_offset(monkeypatch):
    from overlapnet_torch.geometry import overlap
    chunk = overlap.pair_chunk
    monkeypatch.setattr(overlap, "pair_chunk", lambda *a: chunk(*a) + 0.05)


def gt_half_chunk(monkeypatch):
    from overlapnet_torch.geometry import overlap
    chunk = overlap.pair_chunk

    def half(*a):
        out = chunk(*a)
        return torch.cat([out[: len(out) // 2], torch.zeros_like(out[len(out) // 2:])])
    monkeypatch.setattr(overlap, "pair_chunk", half)


FAULTS = [
    ("geo.lcd-dense", offset_overlap), ("geo.lcd-dense", half_candidates),
    ("geo.lcd-dense", frame_not_stored), ("geo.lcd-dense", trimmed_gating),
    ("geo.lcd-dense", k1_one_tf32_pass),
    ("semantic.train", params_unchanged), ("semantic.train", half_batch),
    ("geo.gt-prep", gt_offset), ("geo.gt-prep", gt_half_chunk),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch, bench_root):
    fault(monkeypatch)
    out = run(cell, bench_root)
    assert not out["correct"], out["checks"]
