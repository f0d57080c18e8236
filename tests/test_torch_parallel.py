"""The port's multi-device layer against the JAX package's, on the CPU.

The JAX package runs on a mesh of 2 of the 8 virtual CPU devices that
``tests/conftest.py`` provides. The port runs as 2 gloo ranks: OS processes
started through the variables ``core.distributed.maybe_initialize_distributed``
reads, as ``tests/test_multiprocess.py`` starts the JAX package's. One set of
ranks runs every case once for the whole file (``tests/torch_dist_worker.py``,
the ``ranks`` fixture, with a deadline) and writes its results; each test
below holds one case of them. Inputs are made from seeds with numpy, at the
small input_width=360 geometry (W' = 90) with fp32 legs; on the CPU the port
takes K1's and K2's plain versions.

Tolerances: bit equality where the arithmetic is the same (the two ranks'
parameters and results; a mesh of one rank against no mesh; what moves
through the collectives unchanged); rtol 1e-5 on losses and 1e-4 / atol
1e-6 on parameters after one step where only the order of a sum differs (the
data-parallel step against one process), as the JAX package's own test
holds its mesh step (tests/test_train.py); rtol 1e-4 against the JAX package
for one step (tests/test_torch_train.py's port-vs-JAX tolerance); 1e-5 on
overlaps, 1e-4 on yaw peaks against the JAX sharded store
(tests/test_torch_lcd.py's); 1e-2 m and chi2 rtol 1e-2 for the edge-sharded
solve (tests/test_backend.py:170-200), 1e-8 m in float64 over a short one;
1e-4 / 1e-3 for the channel-sharded head (tests/test_parallel.py's).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from overlapnet_tpu.backend import PoseGraph as JaxPoseGraph
from overlapnet_tpu.backend import optimize_pose_graph as jax_optimize
from overlapnet_tpu.core.config import ModelConfig as JaxModelConfig
from overlapnet_tpu.core.config import OverlapNetConfig as JaxConfig
from overlapnet_tpu.lcd.descriptor_db import ShardedDescriptorDB as JaxShardedDB
from overlapnet_tpu.models import init_params as jax_init_params
from overlapnet_tpu.models import leg_output_width, make_head_apply, make_leg_apply
from overlapnet_tpu.ops.correlation import circular_correlation as jax_correlation
from overlapnet_tpu.ops.delta import delta_conv1 as jax_delta_conv1
from overlapnet_tpu.parallel import mesh as jmesh
from overlapnet_tpu.train import trainer as jtrainer
from overlapnet_tpu.train.checkpoint import save_params_npz
from overlapnet_torch import weights
from overlapnet_torch.backend import pose_graph as tpg
from overlapnet_torch.cli.__main__ import main as cli_main
from overlapnet_torch.data.dataset import ResidentPairs
from overlapnet_torch.kernels.delta_conv1 import delta_conv1
from overlapnet_torch.lcd.descriptor_db import ShardedDescriptorDB
from overlapnet_torch.lcd.infer import Infer
from overlapnet_torch.models import build_model
from overlapnet_torch.ops.correlation import circular_correlation
from overlapnet_torch.parallel.mesh import make_mesh
from overlapnet_torch.train import checkpoint as tckpt
from overlapnet_torch.train import trainer as tt
from overlapnet_torch.weights import load_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
SPAWN_DEADLINE_S = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results ({key: array} each) and the data directory."""
    root = tmp_path_factory.mktemp("dist")
    data, out = str(root / "data"), str(root / "out")
    os.makedirs(out)
    W.write_data(data)
    save_params_npz(os.path.join(data, "params.npz"),
                    jax_init_params(JaxModelConfig(input_width=W.W_IN), 4, rng=3))
    W.write_cli_data(data)
    env = {k: v for k, v in os.environ.items() if not k.startswith("OVERLAPNET_")}
    env.update(OVERLAPNET_COORDINATOR=f"127.0.0.1:{_free_port()}",
               OVERLAPNET_NUM_PROCESSES=str(RANKS))
    # each rank salts str hashes its own way: the epoch shuffle must agree anyway
    procs = [
        subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_dist_worker.py"),
                          out, data], cwd=REPO,
                         env={**env, "OVERLAPNET_PROCESS_ID": str(r), "PYTHONHASHSEED": str(r)},
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_DEADLINE_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-6000:]}"
    results = []
    for r in range(RANKS):
        with np.load(os.path.join(out, f"rank{r}.npz")) as f:
            results.append(dict(f))
    return results, data, out


def _jax_mesh():
    return jmesh.make_mesh(RANKS, devices=jax.devices("cpu")[:RANKS])


def _jax_cfg(**train_kw) -> JaxConfig:
    cfg = JaxConfig()
    cfg.model.input_width, cfg.model.leg_dtype = W.W_IN, "float32"
    cfg.train.batch_size = 4
    for k, v in train_kw.items():
        setattr(cfg.train, k, v)
    return cfg


def _jax_params(state_dict, jcfg):
    """A JAX parameter tree holding the port's ``state_dict``."""
    flat = weights.params_to_jax(state_dict)
    target = jax_init_params(jcfg.model, 4, rng=0)
    leaves = [jnp.asarray(flat["/".join(str(getattr(k, "key", k)) for k in path)])
              for path, _ in jax.tree_util.tree_flatten_with_path(target)[0]]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(target), leaves)


def _port_params(jparams) -> dict:
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    return {k: v.numpy() for k, v in weights.params_from_jax(flat).items()}


def _params_of(res: dict, prefix: str) -> dict:
    head = f"{prefix}/p/"
    return {k[len(head):]: v for k, v in res.items() if k.startswith(head)}


def _assert_params_close(got: dict, want: dict, rtol, atol, outliers=0.0, bound=0.0):
    """Every parameter within rtol/atol. With ``outliers``, that share of a
    tensor may miss (within ``bound``): Adagrad moves an element whose
    gradient is near zero by up to a whole step whichever way its sign falls,
    and the order of a sum can flip that sign."""
    assert got.keys() == want.keys()
    for name in want:
        if not outliers:
            np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)
            continue
        err = np.abs(got[name] - want[name])
        missed = err > atol + rtol * np.abs(want[name])
        assert missed.sum() <= max(outliers * missed.size, 10), (name, missed.sum())
        assert err.max() <= bound, (name, err.max())


def _one_process_step(cfg, batch):
    state, tx = tt.create_train_state(cfg, 100, 0, device="cpu")
    return tt.make_train_step(cfg, tx)(state, batch)


# -- the mesh --------------------------------------------------------------------


def test_rank_blocks_and_padding_match_the_jax_layout(ranks):
    """pad_to_multiple as the JAX package's; rank r holds block r of the
    leading dim (and of dim 1), as NamedSharding lays P('data') out."""
    results, _, _ = ranks
    x = np.arange(15).reshape(5, 3)
    padded, n = jmesh.pad_to_multiple(x, RANKS)
    assert n == 5 and padded.shape == (6, 3)
    stacked = np.arange(24).reshape(3, 4, 2)
    for r, res in enumerate(results):
        assert int(res["mesh/n"]) == n
        np.testing.assert_array_equal(res["mesh/block"], padded[3 * r : 3 * r + 3])
        np.testing.assert_array_equal(res["mesh/replicated"], padded)
        np.testing.assert_array_equal(res["mesh/block_dim1"], stacked[:, 2 * r : 2 * r + 2])
    jax_blocks = jax.device_put(padded, jmesh.batch_sharding(_jax_mesh())).addressable_shards
    for res, shard in zip(results, sorted(jax_blocks, key=lambda s: s.index[0].start)):
        np.testing.assert_array_equal(res["mesh/block"], np.asarray(shard.data))
    with pytest.raises(ValueError, match="world of 1"):
        make_mesh(2, device="cpu")


@pytest.mark.parametrize("case", ["one/train_equal", "one/pg_equal", "frames"])
def test_a_mesh_of_one_rank_gives_the_bits_of_no_mesh(ranks, case):
    """On a gloo group of one rank: the train step (masked orientation
    loss), the pose-graph solve and the fused frame steps equal no mesh."""
    res = ranks[0][0]
    if case == "frames":
        np.testing.assert_array_equal(res["db/frames_one"], res["db/frames_nomesh"])
    else:
        assert bool(res[case])


# -- data-parallel training --------------------------------------------------------


@pytest.mark.parametrize("case", ["dp", "masked"])
def test_data_parallel_step_matches_the_jax_mesh_step(ranks, case):
    """One Adagrad step of batch 4 on 2 ranks (2 pairs each) against the JAX
    ``make_train_step(cfg, tx, mesh)`` on 2 devices and the port's step in
    one process. ``masked``: mask_zero_orientation with every unmasked pair
    on rank 0 — the orientation mean divides by the global count, which the
    mean of the ranks' own means misses by a factor of 2. Parameters: rtol
    1e-4 / atol 1e-6 against one process; against JAX also, but for up to 1%
    of a tensor's elements within a tenth of an Adagrad step."""
    results, _, _ = ranks
    masked = case == "masked"
    tcfg = W.small_cfg(mask_zero_orientation=masked)
    jcfg = _jax_cfg(mask_zero_orientation=masked)
    batch = W.masked_batch() if masked else W.make_batch(4)
    got = results[0]
    for k in (*_params_of(got, case), *(k for k in got if k.startswith(f"{case}/m/"))):
        key = k if "/m/" in k else f"{case}/p/{k}"
        np.testing.assert_array_equal(results[1][key], got[key], err_msg=key)

    state_t, m_t = _one_process_step(tcfg, batch)
    for k, v in m_t.items():
        np.testing.assert_allclose(got[f"{case}/m/{k}"], float(v), rtol=1e-5, err_msg=k)
    _assert_params_close(_params_of(got, case), {k: v.numpy() for k, v in state_t.params.items()},
                         rtol=1e-4, atol=1e-6)

    mesh = _jax_mesh()
    init, _ = tt.create_train_state(tcfg, 100, 0, device="cpu")
    params = _jax_params(init.params, jcfg)
    tx = jtrainer.make_optimizer(jcfg, 100)
    state_j = jtrainer.TrainState(params=params, opt_state=tx.init(params),
                                  step=jnp.zeros((), jnp.int32))
    state_j, m_j = jtrainer.make_train_step(jcfg, tx, mesh)(state_j, jmesh.shard_batch(mesh, batch))
    for k in m_j:
        np.testing.assert_allclose(got[f"{case}/m/{k}"], float(m_j[k]), rtol=1e-4, err_msg=k)
    # a few elements whose gradient is near zero move by a part of the step
    # (Adagrad's first step is lr * g / sqrt(g^2 + eps)) as JAX's convs round
    _assert_params_close(_params_of(got, case), _port_params(state_j.params), rtol=1e-4,
                         atol=1e-6, outliers=0.01, bound=0.1 * tcfg.train.learning_rate)

    if masked:  # the ranks' own orientation means, averaged: what naive DP gives
        model = build_model(tcfg.model, 4, device="cpu")
        halves = []
        for block in (slice(0, 2), slice(2, 4)):
            b = {k: torch.from_numpy(v[block]) for k, v in batch.items()}
            halves.append(float(tt.loss_and_grads(tcfg, model, b["x1"], b["x2"], b["overlap"],
                                                  b["orientation"])[0]["orientation_loss"]))
        want = float(m_j["orientation_loss"])
        assert halves[1] == 0.0 and abs(np.mean(halves) - want) > 0.3 * want


def test_resident_and_stacked_steps_match_one_process(ranks):
    """An epoch of the resident store on 2 ranks, K = 2 steps per call (one
    stacked call sharded on dim 1, one single step), against the same epoch
    in one process: the same epoch loss (rtol 1e-5) and parameters after 3
    steps (rtol 1e-4 / atol 1e-6, a few near-zero-gradient elements within
    a step of lr)."""
    results, data, _ = ranks
    got = results[0]
    np.testing.assert_array_equal(_params_of(results[1], "resident")["legs.s_conv1.weight"],
                                  _params_of(got, "resident")["legs.s_conv1.weight"])
    assert int(got["resident/steps"]) == 3
    cfg = W.small_cfg(steps_per_dispatch=2, rotate_training_data=1)
    trainer = tt.Trainer(cfg, steps_per_epoch=3, device="cpu")
    m = trainer.run_epoch_resident(ResidentPairs(W.pair_dataset(data), device="cpu"), 4,
                                   epoch=0, shuffle=False)
    np.testing.assert_allclose(got["resident/epoch_loss"], m["epoch_loss"], rtol=1e-5)
    lr = cfg.train.learning_rate
    _assert_params_close(_params_of(got, "resident"),
                         {k: v.numpy() for k, v in trainer.state.params.items()},
                         rtol=1e-4, atol=1e-6, outliers=0.02, bound=3 * 2 * lr)


def test_mesh_evaluate_with_a_ragged_batch_matches_jax(ranks):
    """Trainer(mesh=).evaluate over a batch of 3 and one of 1 (each padded
    to a multiple of 2 and trimmed) against the JAX Trainer on a 2-device
    mesh (overlap metrics 1e-4, yaw RMS 1e-3) and the port in one process
    (1e-5)."""
    results, _, _ = ranks
    got = {k[len("eval/"):]: float(v) for k, v in results[0].items() if k.startswith("eval/")}
    assert got == {k[len("eval/"):]: float(v) for k, v in results[1].items()
                   if k.startswith("eval/")}
    one = tt.Trainer(W.small_cfg(), steps_per_epoch=1, device="cpu")
    want = one.evaluate(W.eval_batches())
    assert got.keys() == want.keys() and "yaw_rms@0.3" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    jt = jtrainer.Trainer(_jax_cfg(), steps_per_epoch=1, mesh=_jax_mesh())
    jt.state = jt.state.replace(params=_jax_params(one.state.params, _jax_cfg()))
    want_j = jt.evaluate(W.eval_batches())
    assert got.keys() == want_j.keys()
    for k in want_j:
        np.testing.assert_allclose(got[k], want_j[k], rtol=1e-3, atol=1e-4, err_msg=k)


# -- the rank-sharded map -----------------------------------------------------------


def _jax_db(capacity):
    """The JAX store on the weights of data/params.npz (the same seed)."""
    jcfg = JaxModelConfig(input_width=W.W_IN, leg_dtype="float32")
    params = jax_init_params(jcfg, 4, rng=3)
    db = JaxShardedDB(make_head_apply(jcfg), params, _jax_mesh(), capacity=capacity,
                      width=leg_output_width(jcfg))
    db.set_embedder(make_leg_apply(jcfg))
    return db


def _port_db(data, capacity):
    model = build_model(W.small_cfg().model, 4, device="cpu")
    model.load_state_dict(load_npz(os.path.join(data, "params.npz")))
    db = ShardedDescriptorDB(model.eval().score, capacity=capacity, width=W.W_OUT,
                             shards=RANKS, device="cpu")
    db.set_embedder(model.encode)
    return db


def _assert_topk_equal(got, want, one_device=False):
    """The same rows (ids equal wherever a row scored); overlaps within 1e-5
    of the JAX store's (1e-6 of the port's one-device store), yaw peaks
    1e-4, confidences 1e-5."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    live = want[0] > -1.0
    np.testing.assert_array_equal(got[0] > -1.0, live)
    np.testing.assert_array_equal(got[1][live], want[1][live])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6 if one_device else 1e-5)
    np.testing.assert_allclose(got[2][live], want[2][live], atol=1e-4)
    np.testing.assert_allclose(got[3][live], want[3][live], atol=1e-5)


QUERIES = {
    "top3": dict(k=3), "top3_mask": dict(k=3, candidate_mask="mask"),
    "top3_odd": dict(k=3, candidate_mask="odd"), "top3_few": dict(k=3, candidate_mask="few"),
    "top64": dict(k=64),
}


@pytest.fixture(scope="module")
def stores(ranks):
    """The JAX store on a 2-device mesh and the port's one-device store with
    2 shards, both holding the 11 rows the ranks' store holds."""
    fvs = W.db_inputs()["fvs"]
    out = []
    for db in (_jax_db(W.DB_CAP), _port_db(ranks[1], W.DB_CAP)):
        db.add(fvs[0])
        db.add(fvs[1:])
        out.append(db)
    return out


@pytest.mark.parametrize("query", [*QUERIES, "all", "batch"])
def test_rank_sharded_map_matches_the_jax_sharded_store(ranks, stores, query):
    """ShardedDescriptorDB over 2 ranks (rank r holds rows r, r+2, ...)
    against the JAX store on a 2-device mesh and the port's one-device store
    with 2 shards: query_topk (``top3_odd``: every candidate on rank 1),
    query_all and query_topk_batch; both ranks give the same answers."""
    results = ranks[0]
    x = W.db_inputs()
    fvs = x["fvs"]
    got = results[0][f"db/{query}"]
    np.testing.assert_array_equal(results[1][f"db/{query}"], got)
    assert int(results[0]["db/local_rows"]) == 6 and int(results[1]["db/local_rows"]) == 5
    np.testing.assert_array_equal(results[0]["db/feature_volumes"], fvs)
    for one_device, db in zip((False, True), stores):
        if query == "all":
            want = np.stack(db.query_all(fvs[5], x["mask"]))
            scored = want[0] > -1.0
            np.testing.assert_array_equal(np.flatnonzero(scored), [0, 1, 3, 6, 10])
            np.testing.assert_allclose(got[0], want[0], atol=1e-6 if one_device else 1e-5)
            np.testing.assert_allclose(got[1:, scored], want[1:, scored], atol=1e-4)
            assert not got[1:, ~scored].any()
        elif query == "batch":
            want = db.query_topk_batch(fvs[[3, 7]], k=3, candidate_mask=x["masks"])
            for qi in range(2):
                _assert_topk_equal(got[:, qi], [w[qi] for w in want], one_device)
            assert np.all(got[0, 1] == -1.0)
        else:
            kw = dict(QUERIES[query])
            if "candidate_mask" in kw:
                kw["candidate_mask"] = x[kw["candidate_mask"]]
            want = db.query_topk(fvs[4], **kw)
            assert got.shape[1] == len(want[0])
            _assert_topk_equal(got, want, one_device)


def test_rank_sharded_frame_steps_match_the_jax_sharded_store(ranks):
    """The fused frame step on 2 ranks over 6 frames: no candidate at all,
    candidates only on rank 0, only on rank 1, and all; against the JAX
    store's frame_step on a 2-device mesh and the port's one-device store.
    Every rank joins every frame's gather and gets the same answer."""
    results, data, _ = ranks
    got = results[0]["db/frames"]
    np.testing.assert_array_equal(results[1]["db/frames"], got)
    images, candidates = W.frame_inputs()
    for one_device, db in ((False, _jax_db(16)), (True, _port_db(data, 16))):
        want = []
        for img, rows in zip(images, candidates):
            packed = db.frame_step(img, W.frame_mask(rows, db.capacity))[1]
            want.append(np.asarray(packed[0] if one_device else packed))
        want = np.stack(want)
        assert want[0, 0] == -1.0
        _assert_topk_equal(got.T, want.T, one_device)


def test_infer_on_the_mesh_matches_the_one_device_store(ranks):
    """Infer(mesh=) on 2 ranks: fused frames, query_best, infer_multiple,
    infer_one and infer_multiple_vs_multiple give what Infer(shards=2) gives
    on one device (matches equal; overlaps and confidences 1e-6, yaw 1e-3
    degrees)."""
    results, data, _ = ranks
    got = results[0]["infer/frames"]
    np.testing.assert_array_equal(results[1]["infer/frames"], got)
    want = W.infer_results(Infer(W.infer_cfg(data), db_capacity=16, device="cpu", shards=2))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:2]).all() and not np.isnan(got[2:]).any()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, [1, 3]], want[:, [1, 3]], atol=1e-6)
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=1e-3)


def test_rank_sharded_map_saves_and_restores_in_global_row_order(ranks):
    """save gathers the ranks' rows into global order and rank 0 writes
    once; restore on both ranks gives back the map and its answers."""
    results, _, out = ranks
    fvs = W.db_inputs()["fvs"]
    with np.load(os.path.join(out, "db.npz")) as f:
        np.testing.assert_array_equal(f["feature_volumes"], fvs)
    for res in results:
        assert int(res["db/restored_rows"]) == len(fvs)
        np.testing.assert_array_equal(res["db/restored_top3"], res["db/top3"])


# -- the edge-sharded pose graph and the channel-sharded head -------------------------


def test_edge_sharded_solve_matches_the_jax_mesh_solve(ranks):
    """The drifted square loop (105 edges: one zero-information pad edge on
    rank 1) solved with its edges split over 2 ranks. The JAX package's test
    holds its mesh solve to its one-device solve at 1e-2 m and chi2 rtol
    1e-2 (100 CG steps do not converge here, so the order of the sums shows
    at that level); the port's is held to both packages' one-device solves
    at that tolerance, and to the JAX mesh solve on 2 devices at 1e-2 m (two
    sharded solves, each within that noise of the one-device answer). Both
    ranks get the same poses."""
    results, _, _ = ranks
    got, chi2 = results[0]["pg/poses"], results[0]["pg/chi2"]
    np.testing.assert_array_equal(results[1]["pg/poses"], got)
    graph, est = W.loop_graph()
    assert graph.n_edges % RANKS
    jgraph = JaxPoseGraph(graph.n_poses, graph.edges_i, graph.edges_j,
                          graph.measurements, graph.informations)
    want_m, _ = jax_optimize(jgraph, est, iterations=10, cg_iters=100, mesh=_jax_mesh())
    np.testing.assert_allclose(got, np.asarray(want_m), atol=1e-2)
    want_j, chi_j = jax_optimize(jgraph, est, iterations=10, cg_iters=100)
    want_t, chi_t = tpg.optimize_pose_graph(graph, est, iterations=10, cg_iters=100,
                                            device="cpu")
    for want, chi in ((np.asarray(want_j), np.asarray(chi_j)), (want_t, chi_t)):
        np.testing.assert_allclose(got, want, atol=1e-2)
        np.testing.assert_allclose(chi2, chi, rtol=1e-2)
    # the sharded sums themselves: in float64, over a solve too short to
    # amplify rounding, within 1e-8 m
    want64, _ = tpg.optimize_pose_graph(graph, est, device="cpu", dtype=torch.float64,
                                        **W.PG_SHORT)
    np.testing.assert_allclose(results[0]["pg/poses64"], want64, atol=1e-8)


def test_channel_sharded_head_matches_replicated(ranks):
    """Each rank holds 64 of the 128 channels of both volumes and of
    c_conv1's kernel; K1's entry and the correlation on the slices, summed
    over the ranks, equal the replicated computation of both packages."""
    results, _, _ = ranks
    fa, fb, kernel, bias = W.head_inputs()
    np.testing.assert_array_equal(results[1]["head/delta"], results[0]["head/delta"])
    got_delta = results[0]["head/delta"] + bias
    full = delta_conv1(*(torch.from_numpy(a) for a in (fa, fb, kernel, bias))).numpy()
    np.testing.assert_allclose(got_delta, full, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_delta, np.asarray(jax_delta_conv1(fa, fb, kernel, bias, stride=15)),
                               rtol=1e-4, atol=1e-4)
    corr = circular_correlation(torch.from_numpy(fa), torch.from_numpy(fb)).numpy()
    np.testing.assert_allclose(results[0]["head/corr"], corr, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(results[0]["head/corr"],
                               np.asarray(jax_correlation(jnp.asarray(fa), jnp.asarray(fb))),
                               rtol=1e-4, atol=1e-3)


# -- the CLI over ranks ----------------------------------------------------------


def test_cli_train_over_two_ranks(ranks):
    """``cli train`` on 2 ranks (batch 2: one pair a rank; 4 steps, a ragged
    validation set of 3), then ``--resume`` with the epochs done, against
    the one-process CLI with rank 0's hash salt (so the same epoch shuffle):
    rank 0's checkpoint holds 4 steps and its logs the same losses and
    validation metrics (first epoch rtol 1e-6, second 1e-4). Parameters
    after several steps are not compared: a rounding-level difference flips
    ReLU units and grows through Adagrad's normalised steps (one step is
    held above)."""
    import json

    results, data, _ = ranks
    for res in results:
        assert int(res["cli/train"]) == 0 and int(res["cli/resume"]) == 0
    env = {k: v for k, v in os.environ.items() if not k.startswith("OVERLAPNET_")}
    subprocess.run([sys.executable, "-m", "overlapnet_torch.cli", "train",
                    os.path.join(data, "net_one.yml"), "--device", "cpu"],
                   env={**env, "PYTHONHASHSEED": "0"}, cwd=REPO, check=True, timeout=300,
                   capture_output=True)
    logs = []
    for name in ("exp_dist", "exp_one"):
        exp = os.path.join(data, name, "mini")
        assert tckpt.latest_step(os.path.join(exp, "checkpoints")) == 4
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            logs.append([json.loads(line) for line in f])
    got, want = logs
    assert [r["phase"] for r in got] == [r["phase"] for r in want] == ["train", "validation"] * 2
    for epoch, rtol in ((0, 1e-6), (1, 1e-4)):
        for k in ("epoch_loss", "overlap_rms_error"):
            rows = [r for r in got if r["epoch"] == epoch and k in r]
            np.testing.assert_allclose(rows[0][k], [r for r in want if r["epoch"] == epoch
                                                    and k in r][0][k], rtol=rtol, err_msg=k)


def test_cli_lcd_over_two_ranks_and_a_rank_that_sits_out(ranks, capsys):
    """``cli lcd --mesh 2`` (the map on both ranks) and ``--mesh 1`` in a
    world of 2 (rank 1 sits out) give the closures of one process; the
    session rank 0 wrote resumes in one process at the end."""
    results, data, out = ranks
    for res in results:
        assert int(res["cli/lcd2"]) == 0 and int(res["cli/lcd1"]) == 0
    want_path = os.path.join(out, "lcd_one.npz")
    assert cli_main(W.lcd_args(data, want_path)) == 0
    with np.load(want_path) as f:
        want = dict(f)
    assert len(want["frame"]) > 0
    for name, atol in (("lcd2.npz", {"overlap": 1e-6, "yaw_deg": 1e-3}),
                       ("lcd1.npz", {"overlap": 0.0, "yaw_deg": 0.0})):
        with np.load(os.path.join(out, name)) as f:
            for k in ("frame", "match"):
                np.testing.assert_array_equal(f[k], want[k], err_msg=f"{name} {k}")
            for k, tol in atol.items():
                np.testing.assert_allclose(f[k], want[k], atol=tol, err_msg=f"{name} {k}")
    capsys.readouterr()
    session = os.path.join(out, "session2.npz")
    assert cli_main(W.lcd_args(data, os.path.join(out, "resumed.npz"), "--session", session)) == 0
    assert f"resumed session at frame {W.CLI_OUT + W.CLI_BACK} ({len(want['frame'])} closures)" \
        in capsys.readouterr().out


def test_run_e2e_over_two_ranks(ranks):
    """``run_e2e(mesh=)`` on 2 ranks (8 sim frames, one epoch at batch 4,
    the harness's masked soft-band loss): both ranks return the same
    metrics, rank 0 wrote the trained weights, and the untrained metrics
    (the data-parallel evaluation before any step) equal one process's
    ``Trainer.evaluate`` on the validation set rank 0 made (rtol 1e-5)."""
    from overlapnet_torch.data.dataset import PairImageDataset
    from overlapnet_torch.data.gt_files import load_gt_pairs
    from overlapnet_torch.sim import e2e as te2e

    results, _, out = ranks
    got = [{k[len("e2e/"):]: float(v) for k, v in r.items() if k.startswith("e2e/")}
           for r in results]
    assert got[0] == got[1] and all(np.isfinite(v) for v in got[0].values())
    assert {"ate_before_m", "ate_after_m", "lcd_f1", "train_epoch0_loss"} <= got[0].keys()
    work = os.path.join(out, "e2e")
    assert os.path.exists(os.path.join(work, "trained_params.npz"))
    cfg = te2e.make_config(work, dict(W.E2E["model_overrides"]), device="cpu",
                           batch_size=W.E2E["batch_size"], no_epochs=W.E2E["epochs"], seed=0)
    val = load_gt_pairs([os.path.join(work, te2e.SEQ, "ground_truth", "validation_set.npz")],
                        shuffle=False)
    assert got[0]["train_n_val_pairs"] == len(val)
    ds = PairImageDataset(cfg.data.image_root, val, channels=cfg.channels,
                          height=cfg.model.input_height, width=cfg.model.input_width)
    want = tt.Trainer(cfg, steps_per_epoch=1, device="cpu").evaluate(
        ds.batches(cfg.train.batch_size))
    assert want
    for k, v in want.items():
        np.testing.assert_allclose(got[0][f"untrained_{k}"], v, rtol=1e-5, err_msg=k)
