"""The fused frame step of ``Infer()`` (one shard): ``dispatch_frame``
against an independent answer, the argmax of ``infer_multiple`` over
ascending candidates, and against ``Infer(shards=1)``, frame by frame;
``OnlineLoopCloser.run`` against its ``step`` loop; on a card, the step
comes back unresolved and waits for nothing. The 360-column geometry (W' = 90),
seeded weights, float32 legs, the port alone (no JAX: the card's case runs
where JAX does not)."""

import os

import numpy as np
import pytest
import torch

from overlapnet_torch.core import config as tconfig
from overlapnet_torch.lcd.descriptor_db import DescriptorDB, ShardedDescriptorDB
from overlapnet_torch.lcd.infer import Infer
from overlapnet_torch.lcd.online import OnlineLoopCloser
from overlapnet_torch.models import init_params

H, W = 64, 360
OUT = 8  # frames driven out; as many again come back over them, rolled
GATES = dict(inactive_time=3, inactive_dist=1.5)


@pytest.fixture(scope="module")
def route(tmp_path_factory):
    """An out-and-back route of 2 * OUT frames on disk (depth and normals)
    with its poses and one seeded weight set: frame OUT + j stands beside
    frame j and sees its image column-rolled, plus depth noise."""
    root = tmp_path_factory.mktemp("route")
    rng = np.random.default_rng(8)
    for kind in ("depth", "normal"):
        os.makedirs(root / "00" / kind)
    for j in range(OUT):
        depth = np.abs(rng.normal(size=(H, W))).astype(np.float32) * 10.0
        normal = rng.normal(size=(H, W, 3)).astype(np.float32)
        shift = int(rng.integers(-40, 40))
        noise = 0.05 * rng.normal(size=(H, W)).astype(np.float32)
        for f, d, n in ((j, depth, normal),
                        (OUT + j, np.roll(depth, shift, axis=1) + noise, np.roll(normal, shift, axis=1))):
            np.save(root / "00" / "depth" / f"{f:06d}.npy", d)
            np.save(root / "00" / "normal" / f"{f:06d}.npy", n)
    cfg = tconfig.OverlapNetConfig(
        model=tconfig.ModelConfig(input_width=W, leg_dtype="float32"),
        data=tconfig.DataConfig(data_root_folder=str(root), infer_seqs="00"))
    poses = np.tile(np.eye(4), (2 * OUT, 1, 1))
    poses[:, 0, 3] = np.arange(2 * OUT) % OUT
    poses[OUT:, 1, 3] = 0.3
    return cfg, init_params(cfg.model, cfg.num_input_channels, seed=2), poses


def _infer(route, **kw):
    cfg, params, _ = route
    return Infer(cfg, params=params, db_capacity=4 * OUT, device=kw.pop("device", "cpu"), **kw)


def _candidates(i):
    return list(range(max(0, i - 7), max(0, i - 2)))


def _best(infer, frame_id, cands, fv=None):
    """The argmax of ``infer_multiple`` over ascending candidates (of equal
    overlaps the first), as (match, overlap, yaw_deg, confidence), or None
    without candidates: the frame step's answer, reached another way."""
    out = infer.infer_multiple(frame_id, cands, fv=fv)
    if out is None:
        return None
    b = int(np.argmax(out[0]))
    return cands[b], float(out[0][b]), float(out[1][b]), float(out[2][b])


def _same(got, want):
    if want is None:
        assert got is None
        return
    assert got[0] == want[0], (got, want)
    for a, b in zip(got[1:], want[1:]):
        assert a == pytest.approx(b, abs=1e-6)


def test_plain_frame_step_matches_query_best_and_the_sharded_store(route, tmp_path):
    plain, sync, sharded = _infer(route), _infer(route), _infer(route, shards=1)
    pending = []
    for i in range(2 * OUT):
        cands = _candidates(i)
        pending.append((plain.dispatch_frame(i, cands), _best(sync, i, cands),
                        sharded.dispatch_frame(i, cands)))
    assert sum(want is not None for _, want, _ in pending) == 2 * OUT - 3
    for got, want, other in pending:
        _same(got.result, want)
        _same(other.result, want)
    np.testing.assert_array_equal(plain.feature_volumes, sync.feature_volumes)
    # the store grew inside the steps: it still takes rows from outside them
    plain.save_cache(str(tmp_path / "cache.npz"))
    assert plain.restore_cache(str(tmp_path / "cache.npz")) == 2 * OUT
    fv = sync.feature_volumes[3]
    _same(plain.query_best(2 * OUT, [1, 2], fv=fv), _best(sync, 2 * OUT, [1, 2], fv=fv))


def test_equal_overlaps_go_to_the_lower_row_and_no_candidates_to_none(route):
    """Both stores' step on a head whose overlap is a stored value (equal
    inputs at two batch positions need not score equal bits on every CPU):
    of equal overlaps the lower row wins, as np.argmax over ascending
    candidates picks it; with no candidate the step offers overlap -1 and
    ``dispatch_frame`` resolves to None; a precomputed embedding runs the
    step without the legs and gives the argmax of ``infer_multiple``."""
    def head(fa, fb):
        return fa[:, 0, :1], torch.einsum("bwc,bvc->bw", fa, fb)

    fv = np.random.default_rng(1).normal(size=(5, 6, 2)).astype(np.float32)
    fv[:, 0, 0] = [0.7, 0.2, 0.7, 0.7, 0.1]  # the overlaps
    plain = DescriptorDB(head, capacity=8, width=6, channels=2, device="cpu")
    sharded = ShardedDescriptorDB(head, capacity=8, width=6, channels=2, shards=1, device="cpu")
    for db in (plain, sharded):
        db.add(fv)
        row, (packed, event) = db.frame_step(None, np.arange(8) >= 2, fv=fv[1])
        assert row == 5 and event is None and len(db) == 6
        assert packed.tolist()[:2] == [pytest.approx(0.7), 2.0]
        assert db.frame_step(None, np.zeros(8, bool), fv=fv[1])[1][0].tolist()[:2] == [-1.0, 0.0]
    assert int(np.argmax(plain.query(fv[1], [2, 3, 4])[0])) == 0

    stored = np.random.default_rng(2).random((3, W // 4, 128)).astype(np.float32)
    for infer in (_infer(route), _infer(route, shards=1)):
        for f in range(3):
            infer.add_embedding(10 + f, stored[f])
        _same(infer.dispatch_frame(13, [12, 10], fv=stored[1]).result,
              _best(infer, 14, [10, 12], fv=stored[1]))
        assert infer.dispatch_frame(15, [], fv=stored[1]).result is None
        assert len(infer.feature_volumes) == 6
    with pytest.raises(ValueError, match="2\\*\\*24"):
        DescriptorDB(lambda fa, fb: None, capacity=2**24, width=1, channels=1, device="cpu")


def test_pipelined_run_on_the_plain_store_equals_the_step_loop(route):
    _, _, poses = route

    def closer():
        return OnlineLoopCloser(_infer(route), poses, overlap_threshold=-1.0, **GATES)

    piped, stepped = closer(), closer()
    piped.run(pipeline_depth=3)
    for i in range(len(poses)):
        stepped.step(i)
    assert len(stepped.closures) > OUT
    assert [(c.frame, c.match) for c in piped.closures] == [(c.frame, c.match) for c in stepped.closures]
    for a, b in zip(piped.closures, stepped.closures):
        assert (a.overlap, a.yaw_deg, a.confidence) == pytest.approx(
            (b.overlap, b.yaw_deg, b.confidence), abs=1e-6)


@pytest.mark.card
def test_plain_frame_step_waits_for_nothing_on_the_card(route):
    """On a card the plain store's step returns before the device is done
    (an event, no value), with no copy to the host or wait on the way
    (``set_sync_debug_mode("error")`` raises at any), and resolves to what
    the argmax of the synchronous ``infer_multiple`` gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step waits for nothing only there")
    plain, sync = _infer(route, device="cuda"), _infer(route, device="cuda")
    images = [plain._load_image(f"{i:06d}") for i in range(2 * OUT)]
    for i in range(2 * OUT - 1):  # the map, and the plans of the step's kernels
        plain.dispatch_frame(i, _candidates(i), image=images[i]).result
        sync.infer_multiple(i, _candidates(i))
    last = 2 * OUT - 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = plain.dispatch_frame(last, _candidates(last), image=images[last])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pending._event is not None and not pending._done
    _same(pending.result, _best(sync, last, _candidates(last)))
