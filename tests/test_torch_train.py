"""The port's training slice vs the JAX package on the CPU: losses, schedule,
the hand-written optimizer against optax, train steps on shared weights,
the resident store, checkpoints and the weight bridges, at the small
input_width=360 geometry (W'=90), batch 2-4.

Inputs are made from a seed with numpy and go through both packages; weights
and optimizer state cross through ``overlapnet_torch.weights``. On the CPU
the port takes the plain versions of K1 and K2. Tolerances: 1e-6 where both
sides do the same fp32 arithmetic (losses, optimizer rules), rtol 1e-4 for
one train step (sums in another order through eleven convs), 1e-3 after
three steps (Adagrad's first steps have size lr whatever the gradient, so a
sign flip of a near-zero gradient would show: there is none at this
tolerance; elements with near-zero gradients get an absolute allowance of
a fraction of one step), and a stated loose gate for bf16 legs.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from overlapnet_tpu.core.config import OverlapNetConfig as JaxConfig
from overlapnet_tpu.data import dataset as jdata
from overlapnet_tpu.data.gt_files import PairList as JaxPairList
from overlapnet_tpu.models import build_model as jax_build_model
from overlapnet_tpu.models import init_params as jax_init_params
from overlapnet_tpu.train import checkpoint as jckpt
from overlapnet_tpu.train import losses as jlosses
from overlapnet_tpu.train import trainer as jtrainer
from overlapnet_tpu.train.schedule import reference_lr_schedule as jax_schedule
from overlapnet_torch import weights
from overlapnet_torch.cli.__main__ import main as cli_main
from overlapnet_torch.core.config import ChannelConfig, OverlapNetConfig
from overlapnet_torch.data import dataset as tdata
from overlapnet_torch.data.gt_files import PairList, load_gt_pairs, save_gt_files
from overlapnet_torch.lcd.infer import Infer
from overlapnet_torch.models import init_params
from overlapnet_torch.train import checkpoint as tckpt
from overlapnet_torch.train import losses as tlosses
from overlapnet_torch.train import trainer as ttrainer
from overlapnet_torch.train.schedule import reference_lr_schedule

W_IN, W_OUT = 360, 90


def _t(x):
    return torch.from_numpy(np.asarray(x))


def small_cfgs(batch_size=2, model_kw=None, train_kw=None):
    """(port config, JAX config) with the same small geometry and settings."""
    out = []
    for cls in (OverlapNetConfig, JaxConfig):
        cfg = cls()
        cfg.model = dataclasses.replace(
            cfg.model, input_width=W_IN, **{"leg_dtype": "float32", **(model_kw or {})})
        cfg.train = dataclasses.replace(cfg.train, batch_size=batch_size, **(train_kw or {}))
        out.append(cfg)
    return out


def make_batch(b, seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=(b, 64, W_IN, 4)).astype(np.float32)
    x2 = np.roll(x1, 30, axis=2) + 0.3 * rng.normal(size=x1.shape).astype(np.float32)
    return {
        "x1": x1,
        "x2": x2.astype(np.float32),
        "overlap": rng.uniform(0.2, 1.0, size=(b,)).astype(np.float32),
        "orientation": rng.integers(0, W_OUT, size=(b,)).astype(np.int32),
    }


def flat_jax_params(jparams) -> dict[str, np.ndarray]:
    """The JAX package's flat-key form of a parameter tree (as its
    save_params_npz keys it)."""
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]
    }


def jax_params_from(state_dict, jcfg):
    """A JAX parameter tree holding the port's ``state_dict``."""
    flat = weights.params_to_jax(state_dict)
    target = jax_init_params(jcfg.model, 4, rng=0)
    leaves = [jnp.asarray(flat["/".join(str(getattr(k, "key", k)) for k in path)])
              for path, _ in jax.tree_util.tree_flatten_with_path(target)[0]]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(target), leaves)


def optax_state_from(template, flat, step):
    """``template`` (an optax state of the JAX trainer) with its slots
    filled from the port's flat optimizer state and every count at ``step``."""
    def fill(path, leaf):
        names = [getattr(k, "name", None) for k in path]
        slot = next((n for n in names if n in weights.OPT_SLOTS), None)
        if slot is None:
            return jnp.asarray(step, leaf.dtype) if "count" in names else leaf
        keys = [str(k.key) for k in path if hasattr(k, "key")]
        key = f"{slot}/" + "/".join(keys[keys.index("params"):])
        return jnp.asarray(flat[key])
    return jax.tree_util.tree_map_with_path(fill, template)


def assert_params_close(state_dict, jparams, rtol, atol=0.0, outliers=0.0, bound=0.0):
    """Every parameter within rtol/atol of the JAX one. With ``outliers``,
    that share of a tensor's elements may miss the tolerance as long as they
    stay within ``bound``: an optimizer that normalises each element by its
    own gradient history moves an element whose gradient is near zero by up
    to a whole step whichever way its sign falls."""
    ref = weights.params_from_jax(flat_jax_params(jparams))
    assert ref.keys() == state_dict.keys()
    for name, t in state_dict.items():
        got, want = t.detach().numpy(), ref[name].numpy()
        if not outliers:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
            continue
        err = np.abs(got - want)
        missed = err > atol + rtol * np.abs(want)
        # a share of the tensor, or ten elements of a small one (a bias)
        assert missed.sum() <= max(outliers * missed.size, 10), (name, missed.sum())
        assert err.max() <= bound, (name, err.max())


# -- losses and schedule ---------------------------------------------------------


def test_sigmoid_overlap_loss_and_target_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(size=(6, 1)).astype(np.float32)
    true = rng.uniform(size=(6,)).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.sigmoid_overlap_loss(_t(pred), _t(true)).numpy(),
        np.asarray(jlosses.sigmoid_overlap_loss(jnp.asarray(pred), jnp.asarray(true))),
        rtol=1e-6)
    bins = np.array([2, 0, 89, 45, 7, 7], np.int32)
    np.testing.assert_array_equal(
        tlosses.orientation_target(_t(bins), _t(true), W_OUT).numpy(),
        np.asarray(jlosses.orientation_target(jnp.asarray(bins), jnp.asarray(true), W_OUT)))


@pytest.mark.parametrize("soft", [-1.0, 0.3], ids=["hard", "soft-band"])
@pytest.mark.parametrize("masked", [False, True], ids=["all-pairs", "pair-mask"])
def test_orientation_entropy_and_combined_loss_match_jax(soft, masked):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(6, W_OUT)) * 3).astype(np.float32)
    overlap = np.array([0.1, 0.35, 0.5, 0.69, 0.71, 0.95], np.float32)
    bins = rng.integers(0, W_OUT, size=6).astype(np.int32)
    pred = rng.uniform(size=(6, 1)).astype(np.float32)
    target_t = tlosses.orientation_target(_t(bins), _t(overlap), W_OUT)
    target_j = jlosses.orientation_target(jnp.asarray(bins), jnp.asarray(overlap), W_OUT)
    mask = overlap > 0.4 if masked else None
    np.testing.assert_allclose(
        tlosses.weighted_orientation_entropy(
            _t(logits), target_t, float(W_OUT), 0.7,
            pair_mask=None if mask is None else _t(mask), soft_overlap_min=soft).numpy(),
        np.asarray(jlosses.weighted_orientation_entropy(
            jnp.asarray(logits), target_j, float(W_OUT), 0.7,
            pair_mask=None if mask is None else jnp.asarray(mask), soft_overlap_min=soft)),
        rtol=1e-6)
    kw = dict(pos_weight=float(W_OUT), mask_zero_orientation=masked, soft_overlap_min=soft)
    total_t, parts_t = tlosses.combined_loss(_t(pred), _t(logits), _t(overlap), target_t, **kw)
    total_j, parts_j = jlosses.combined_loss(
        jnp.asarray(pred), jnp.asarray(logits), jnp.asarray(overlap), target_j, **kw)
    assert parts_t.keys() == parts_j.keys()
    for k in parts_j:
        np.testing.assert_allclose(parts_t[k].numpy(), np.asarray(parts_j[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(total_t.numpy(), np.asarray(total_j), rtol=1e-6)


def test_an_all_masked_batch_gives_zero_orientation_loss():
    logits = torch.zeros(2, W_OUT)
    target = tlosses.orientation_target(_t(np.array([1, 2])), _t(np.array([0.1, 0.2], np.float32)), W_OUT)
    got = tlosses.weighted_orientation_entropy(
        logits, target, float(W_OUT), pair_mask=torch.zeros(2, dtype=torch.bool))
    assert float(got) == 0.0


def test_lr_schedule_matches_jax():
    ours = reference_lr_schedule(0.001, 0.99, steps_per_epoch=10)
    theirs = jax_schedule(0.001, 0.99, steps_per_epoch=10)
    for step in (0, 9, 10, 19, 25, 105, 1000):
        np.testing.assert_allclose(ours(step), float(theirs(jnp.asarray(step))), rtol=1e-6)
    assert ours(0) == pytest.approx(0.0001) and ours(10) == pytest.approx(0.001)


# -- the optimizer against optax -------------------------------------------------


def _toy_params(rng):
    return {
        # no '.weight' names: those change layout between the packages
        "legs.s_conv1.gain": rng.normal(size=(4, 3, 2, 2)).astype(np.float32),
        "legs.s_conv1.bias": rng.normal(size=(4,)).astype(np.float32),
        "overlap_head.c_conv1.gain": rng.normal(size=(5, 4, 1, 3)).astype(np.float32),
        "overlap_head.never_touched": rng.normal(size=(3,)).astype(np.float32),
        "orientation_head.logit_scale": np.float32(10.0),
    }


def _toy_grads(rng, params, scale):
    grads = {k: (rng.normal(size=np.shape(v)) * scale).astype(np.float32)
             for k, v in params.items()}
    grads["overlap_head.never_touched"][:] = 0.0
    grads["orientation_head.logit_scale"] = np.float32(rng.normal() * 50 * scale)
    return grads


def _nest(flat):
    """'a.b.c' keys -> the nested dict the JAX trainer's label functions
    walk ({'params': {'a': {'b': {'c': ...}}}})."""
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, last = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = jnp.asarray(v)
    return {"params": tree}


@pytest.mark.parametrize("kind,clip,frozen", [
    ("adagrad", 0.0, False),
    ("adam", 0.0, False),
    ("adagrad", 1.0, False),
    ("adagrad", 1.0, True),
    ("adam", 0.5, True),
], ids=["adagrad", "adam", "adagrad-clip", "adagrad-clip-frozen", "adam-clip-frozen"])
def test_optimizer_trajectory_matches_optax(kind, clip, frozen):
    """Five steps on seeded gradients across an epoch boundary of the
    schedule (steps_per_epoch=2): parameters and state equal the JAX
    trainer's optax chain at 1e-6 (relative, and absolute: a weight of
    order 1 that an update brings near 0 keeps the ulp of where it was). One
    parameter never gets a gradient
    (update 0, no NaN); the clip is per group; frozen legs keep their values
    and have no state."""
    tcfg, jcfg = small_cfgs(train_kw=dict(optimizer=kind, grad_clip_norm=clip, learning_rate=0.01),
                            model_kw=dict(legs_trainable=not frozen))
    rng = np.random.default_rng(3)
    start = _toy_params(rng)
    tx_t = ttrainer.make_optimizer(tcfg, steps_per_epoch=2)
    tx_j = jtrainer.make_optimizer(jcfg, steps_per_epoch=2)
    params_t = {k: _t(np.array(v)) for k, v in start.items()}
    state_t = tx_t.init(params_t)
    params_j = _nest(start)
    state_j = tx_j.init(params_j)
    assert ("legs.s_conv1.gain" in next(iter(
        v for v in state_t.values() if isinstance(v, dict)))) == (not frozen)
    for step in range(5):
        grads = _toy_grads(rng, start, scale=10.0 if step % 2 else 0.05)
        tx_t.update(params_t, {k: _t(np.array(v)) for k, v in grads.items()}, state_t, step)
        updates, state_j = tx_j.update(_nest(grads), state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        for k, v in params_t.items():
            node = params_j["params"]
            for part in k.split("."):
                node = node[part]
            assert torch.isfinite(v).all()
            np.testing.assert_allclose(v.numpy(), np.asarray(node), rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step} {k}")
    np.testing.assert_array_equal(
        params_t["overlap_head.never_touched"].numpy(), start["overlap_head.never_touched"])
    if frozen:
        np.testing.assert_array_equal(
            params_t["legs.s_conv1.gain"].numpy(), start["legs.s_conv1.gain"])
    # the state crosses through weights.py and equals optax's slots
    flat = weights.opt_state_to_jax(state_t)
    crossed = optax_state_from(state_j, flat, 5)
    for a, b in zip(jax.tree.leaves(crossed), jax.tree.leaves(state_j)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-9)


def test_unknown_optimizer_raises():
    tcfg, _ = small_cfgs(train_kw=dict(optimizer="sgd"))
    with pytest.raises(ValueError, match="adagrad"):
        ttrainer.make_optimizer(tcfg, 1)


def test_opt_state_round_trips_through_flat_arrays():
    rng = np.random.default_rng(0)
    params = {"legs.s_conv1.weight": _t(rng.normal(size=(4, 3, 2, 2)).astype(np.float32)),
              "legs.s_conv1.bias": _t(rng.normal(size=(4,)).astype(np.float32))}
    state = {"mu": {k: torch.rand_like(v) for k, v in params.items() if v.dim()},
             "nu": {k: torch.rand_like(v) for k, v in params.items() if v.dim()}, "count": 7}
    flat = weights.opt_state_to_jax(state)
    assert flat["mu/params/legs/s_conv1/kernel"].shape == (2, 2, 3, 4)  # HWIO
    back = weights.opt_state_from_jax(flat)
    assert back["count"] == 7 and back.keys() == state.keys()
    for slot in ("mu", "nu"):
        for k, v in state[slot].items():
            np.testing.assert_array_equal(back[slot][k].numpy(), v.numpy())
    with pytest.raises(KeyError):
        weights.opt_state_from_jax({"momentum/params/x/kernel": np.zeros(1)})


# -- train steps on shared weights ------------------------------------------------

_JAX_STEPS = {}


def jax_step_for(jcfg, steps_per_epoch, key):
    """The JAX package's jitted train step for a config variant, compiled
    once per test process."""
    if key not in _JAX_STEPS:
        tx = jtrainer.make_optimizer(jcfg, steps_per_epoch)
        _JAX_STEPS[key] = (tx, jtrainer.make_train_step(jcfg, tx))
    return _JAX_STEPS[key]


def both_states(tcfg, jcfg, steps_per_epoch, key, seed=0):
    """(port state, port tx, JAX state, JAX step) on the same weights."""
    state_t, tx_t = ttrainer.create_train_state(tcfg, steps_per_epoch, seed, device="cpu")
    tx_j, step_j = jax_step_for(jcfg, steps_per_epoch, key)
    params_j = jax_params_from(state_t.params, jcfg)
    state_j = jtrainer.TrainState(params=params_j, opt_state=tx_j.init(params_j),
                                  step=jnp.zeros((), jnp.int32))
    return state_t, tx_t, state_j, step_j


def run_both(tcfg, jcfg, key, n_steps, batch_size=2, rtol=1e-4, atol=1e-6, **outliers):
    state_t, tx_t, state_j, step_j = both_states(tcfg, jcfg, 100, key)
    step_t = ttrainer.make_train_step(tcfg, tx_t)
    for i in range(n_steps):
        batch = make_batch(batch_size, seed=i)
        state_t, m_t = step_t(state_t, batch)
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()})
        assert m_t.keys() == m_j.keys()
        for k in m_j:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=rtol, err_msg=f"step {i} {k}")
    assert state_t.step == int(state_j.step) == n_steps
    assert_params_close(state_t.params, state_j.params, rtol=rtol, atol=atol, **outliers)
    return state_t, state_j


def test_one_train_step_matches_jax():
    """Loss, metrics (grad_norm included) and every updated parameter after
    one Adagrad step equal ``make_train_step`` of the JAX package at rtol
    1e-4 (atol 1e-6: the first Adagrad step moves every weight by lr = 1e-4
    times the gradient's sign, so absolute agreement is far below a step)."""
    tcfg, jcfg = small_cfgs()
    run_both(tcfg, jcfg, "default", 1)


def test_three_train_steps_match_jax():
    """Losses and metrics of every step at rtol 1e-3. Parameters at rtol
    1e-3 / atol 3e-5 (a third of one step: lr = 1e-4 in the warm-up epoch)
    for all but at most 2% of a tensor's elements, which stay within the
    three steps' total size: Adagrad divides each element's gradient by its
    own history, so where the gradient is at its rounding noise the move
    follows its sign (26 of 147456 elements of one leg kernel were such; the
    share moves with the order in which the convs sum, hence the margin. A
    wrong rule moves every element)."""
    tcfg, jcfg = small_cfgs()
    run_both(tcfg, jcfg, "default", 3, rtol=1e-3, atol=3e-5, outliers=0.02, bound=3.03e-4)


def test_train_step_with_cosine_head_clip_soft_band_and_adam_matches_jax():
    """The options the flagship recipe turns on: cosine correlation with its
    learnable scale (the 'orient' clip group), stop-gradient, the soft yaw
    band with the pair mask, group clip, Adam."""
    kw = dict(
        model_kw=dict(correlation_normalize="cosine", correlation_stop_gradient=True),
        train_kw=dict(optimizer="adam", grad_clip_norm=0.5, yaw_soft_overlap_min=0.3,
                      mask_zero_orientation=True),
    )
    tcfg, jcfg = small_cfgs(**kw)
    # as the three-step test; with the stop-gradient the legs learn from the
    # overlap loss alone, and up to a seventh of a leg bias's gradients were
    # seen at their rounding noise, where Adam too moves by the sign
    state_t, _ = run_both(tcfg, jcfg, "flagship", 2, rtol=1e-3, atol=3e-5,
                          outliers=0.2, bound=2.02e-4)
    assert float(state_t.params["orientation_head.logit_scale"]) != 10.0


def test_train_step_with_bf16_legs_is_close_to_jax():
    """bf16 legs round at other places in the two frameworks (oneDNN vs
    XLA:CPU convs and their gradients): the loss is held to 2% and the
    gradient norm to 10%; parameters are not compared."""
    tcfg, jcfg = small_cfgs(model_kw=dict(leg_dtype="bfloat16"))
    state_t, tx_t, state_j, step_j = both_states(tcfg, jcfg, 100, "bf16")
    batch = make_batch(2)
    _, m_t = ttrainer.make_train_step(tcfg, tx_t)(state_t, batch)
    _, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=0.02)
    np.testing.assert_allclose(float(m_t["grad_norm"]), float(m_j["grad_norm"]), rtol=0.1)
    assert all(torch.isfinite(p).all() for p in state_t.params.values())


def test_frozen_legs_do_not_update_but_count_in_grad_norm():
    tcfg, _ = small_cfgs(model_kw=dict(legs_trainable=False))
    state, tx = ttrainer.create_train_state(tcfg, 10, 0, device="cpu")
    before = {k: v.clone() for k, v in state.params.items()}
    assert not any(k.startswith("legs.") for k in state.opt_state["sum_of_squares"])
    state, metrics = ttrainer.make_train_step(tcfg, tx)(state, make_batch(2))
    for k, v in state.params.items():
        if k.startswith("legs."):
            np.testing.assert_array_equal(v.numpy(), before[k].numpy(), err_msg=k)
    assert not torch.equal(state.params["overlap_head.c_conv2.weight"],
                           before["overlap_head.c_conv2.weight"])
    # the metric is the norm of the raw gradients, legs included
    cfg_all, _ = small_cfgs()
    state2, tx2 = ttrainer.create_train_state(cfg_all, 10, 0, device="cpu")
    _, metrics2 = ttrainer.make_train_step(cfg_all, tx2)(state2, make_batch(2))
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(metrics2["grad_norm"]), rtol=1e-6)


def test_roll_columns_is_np_roll():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 3, 12, 2)).astype(np.float32)
    shift = np.array([0, 5, 12, 11], np.int32)
    want = np.stack([np.roll(x[i], int(shift[i]), axis=1) for i in range(4)])
    np.testing.assert_array_equal(ttrainer.roll_columns(_t(x), _t(shift)).numpy(), want)


def _resident_batch(rng, n_scans, bs):
    return {
        "i1": rng.integers(0, n_scans, bs).astype(np.int32),
        "i2": rng.integers(0, n_scans, bs).astype(np.int32),
        "shift": rng.integers(0, W_IN + 1, bs).astype(np.int32),
        "overlap": rng.uniform(size=bs).astype(np.float32),
        "orientation": rng.integers(0, W_OUT, bs).astype(np.int32),
    }


def test_resident_step_equals_host_step():
    """Device-side gather + roll step == the step on the host-assembled
    batch: bit-equal parameters (the same arithmetic on the same values)."""
    tcfg, _ = small_cfgs()
    rng = np.random.default_rng(0)
    images = rng.normal(size=(5, 64, W_IN, 4)).astype(np.float32)
    rb = _resident_batch(rng, 5, 2)
    host = {
        "x1": images[rb["i1"]],
        "x2": np.stack([np.roll(images[i], int(s), axis=1) for i, s in zip(rb["i2"], rb["shift"])]),
        "overlap": rb["overlap"], "orientation": rb["orientation"],
    }
    state_h, tx_h = ttrainer.create_train_state(tcfg, 4, 0, device="cpu")
    state_r, tx_r = ttrainer.create_train_state(tcfg, 4, 0, device="cpu")
    state_h, m_h = ttrainer.make_train_step(tcfg, tx_h)(state_h, host)
    state_r, m_r = ttrainer.make_resident_train_step(tcfg, tx_r)(state_r, _t(images), rb)
    assert float(m_h["loss"]) == float(m_r["loss"])
    for k, v in state_h.params.items():
        np.testing.assert_array_equal(v.numpy(), state_r.params[k].numpy(), err_msg=k)


class FakeResident:
    """Minimal ResidentPairs stand-in: fixed images + index stream."""

    def __init__(self, images, batches):
        self.images = _t(images)
        self._batches = batches

    def batches(self, batch_size, epoch=0, shuffle=True, drop_remainder=True):
        return iter(self._batches)


def test_k_steps_per_call_equal_k_single_steps():
    """steps_per_dispatch = 3 over 5 batches (one group of 3 + 2 tail
    singles) leaves exactly the parameters of 5 single steps."""
    rng = np.random.default_rng(1)
    images = rng.normal(size=(4, 64, W_IN, 4)).astype(np.float32)
    batches = [_resident_batch(np.random.default_rng(i), 4, 2) for i in range(5)]
    out = []
    for k in (1, 3):
        tcfg, _ = small_cfgs(train_kw=dict(steps_per_dispatch=k))
        trainer = ttrainer.Trainer(tcfg, steps_per_epoch=5, device="cpu")
        metrics = trainer.run_epoch_resident(FakeResident(images, batches), 2)
        assert trainer.state.step == 5
        out.append((metrics, trainer.state.params))
    assert out[0][0]["epoch_loss"] == out[1][0]["epoch_loss"]
    assert out[0][0]["loss"] == out[1][0]["loss"]
    for k, v in out[0][1].items():
        np.testing.assert_array_equal(v.numpy(), out[1][1][k].numpy(), err_msg=k)


def test_run_epoch_reports_the_epoch():
    tcfg, _ = small_cfgs()
    trainer = ttrainer.Trainer(tcfg, steps_per_epoch=3, device="cpu", pipeline_depth=2)
    metrics = trainer.run_epoch([make_batch(2, seed=i) for i in range(3)])
    assert trainer.state.step == 3
    for key in ("loss", "overlap_loss", "orientation_loss", "grad_norm", "epoch_loss",
                "train_pairs_per_sec", "sec_per_dispatch"):
        assert np.isfinite(metrics[key]), key
    assert trainer.run_epoch([]) == {}


def test_correlation_release_epoch_gates_leg_gradient():
    """With correlation_stop_gradient on and only the orientation loss, the
    legs move only from correlation_release_epoch on."""
    tcfg, _ = small_cfgs(
        model_kw=dict(correlation_stop_gradient=True, correlation_normalize="cosine"),
        train_kw=dict(overlap_loss_weight=0.0, orientation_loss_weight=1.0,
                      correlation_release_epoch=1, optimizer="adam"))
    trainer = ttrainer.Trainer(tcfg, steps_per_epoch=1, device="cpu")
    batch = make_batch(2)
    k0 = trainer.state.params["legs.s_conv1.weight"].clone()
    trainer.run_epoch([batch], epoch=0)
    k1 = trainer.state.params["legs.s_conv1.weight"].clone()
    assert torch.equal(k0, k1)  # stop-gradient active
    trainer.run_epoch([batch], epoch=1)
    assert not torch.equal(k1, trainer.state.params["legs.s_conv1.weight"])


def test_rotate_adjust_in_reference_yaw_space_raises():
    tcfg, _ = small_cfgs(model_kw=dict(yaw_space="reference"),
                         train_kw=dict(rotate_adjust_yaw_labels=True, rotate_training_data=1))
    with pytest.raises(ValueError, match="calibrated"):
        ttrainer.Trainer(tcfg, steps_per_epoch=1, device="cpu")


def test_evaluate_matches_the_jax_trainer():
    """The same weights and batches through both trainers' ``evaluate``:
    the same metric names; overlap metrics at 1e-4, yaw RMS at 1e-3 of a
    degree scale (sub-bin peaks of fp32 logits)."""
    tcfg, jcfg = small_cfgs(batch_size=3)
    trainer_t = ttrainer.Trainer(tcfg, steps_per_epoch=1, device="cpu")
    trainer_j = jtrainer.Trainer(jcfg, steps_per_epoch=1)
    trainer_j.state = trainer_j.state.replace(
        params=jax_params_from(trainer_t.state.params, jcfg))
    batches = [make_batch(3, seed=5), make_batch(2, seed=6)]
    for b in batches:
        b["overlap"] = np.clip(b["overlap"] + 0.3, 0, 1)
    m_t, m_j = trainer_t.evaluate(batches), trainer_j.evaluate(batches)
    assert m_t.keys() == m_j.keys() and "yaw_rms@0.3" in m_t
    for k in m_j:
        np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-3, atol=1e-4, err_msg=k)


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default would run")
    tcfg, _ = small_cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.Trainer(tcfg, steps_per_epoch=1)
    ds = _disk_dataset(tmp_path, n_scans=2, n_pairs=2)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        tdata.ResidentPairs(ds)
    yml = _network_yml(tmp_path, _disk_dataset(tmp_path / "cli", 3, 4, write_gt=True)[2])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["train", yml])


# -- data -------------------------------------------------------------------------


def _disk_dataset(root, n_scans, n_pairs, write_gt=False, h=64, w=W_IN, **ds_kw):
    """Seeded scans and a pair list on disk; returns (port dataset, JAX
    dataset, root)."""
    rng = np.random.default_rng(3)
    root = str(root)
    for kind, ch in (("depth", None), ("normal", 3)):
        os.makedirs(os.path.join(root, "07", kind), exist_ok=True)
        for i in range(n_scans):
            shape = (h, w) if ch is None else (h, w, ch)
            np.save(os.path.join(root, "07", kind, f"{i:06d}.npy"),
                    rng.normal(size=shape).astype(np.float32))
    i1, i2 = rng.integers(0, n_scans, n_pairs), rng.integers(0, n_scans, n_pairs)
    overlap = rng.uniform(0, 1, n_pairs)
    yaw = rng.integers(0, 360, n_pairs).astype(float)
    if write_gt:
        table = np.stack([i1, i2, overlap, yaw], axis=1)
        save_gt_files(os.path.join(root, "07", "ground_truth"), "07", table, table, table[:3])
    names = (["%06d" % i for i in i1], ["%06d" % i for i in i2])
    dirs = (["07"] * n_pairs, ["07"] * n_pairs)
    ds_t = tdata.PairImageDataset(root, PairList(*names, *dirs, overlap, yaw), ChannelConfig(),
                                  height=h, width=w, **ds_kw)
    ds_j = jdata.PairImageDataset(root, JaxPairList(*names, *dirs, overlap, yaw),
                                  ChannelConfig(), height=h, width=w, **ds_kw)
    return ds_t, ds_j, root


@pytest.mark.parametrize("rotate", [0, 1, 2])
def test_pair_batches_equal_the_jax_dataset(tmp_path, rotate):
    """Same shuffle stream, same shift draws, same label adjustment: host
    batches of two epochs are bit-equal to the JAX package's."""
    ds_t, ds_j, _ = _disk_dataset(tmp_path, 5, 9, h=8, w=12, rotate_data=rotate, seed=7,
                                  adjust_yaw_labels=True, leg_output_width=6)
    for epoch in (0, 1):
        kw = dict(epoch=epoch, shuffle=True, drop_remainder=True)
        got, want = list(ds_t.batches(4, **kw)), list(ds_j.batches(4, **kw))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in b:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(list(ds_t.batches(4, max_batches=1))) == 1
    assert [len(b["overlap"]) for b in ds_t.batches(4)] == [4, 4, 1]


def test_resident_pairs_reconstruct_host_batches(tmp_path):
    ds, _, _ = _disk_dataset(tmp_path, 6, 10, h=8, w=12, rotate_data=1, seed=7)
    resident = tdata.ResidentPairs(ds, device="cpu")
    assert resident.images.shape == (resident.n_scans, 8, 12, 4) and len(resident) == 10
    host = list(ds.batches(4, epoch=0, shuffle=True, drop_remainder=True))
    res = list(resident.batches(4, epoch=0, shuffle=True, drop_remainder=True))
    assert len(host) == len(res) == 2
    for hb, rb in zip(host, res):
        np.testing.assert_array_equal(hb["x1"], resident.images[_t(rb["i1"]).long()].numpy())
        x2 = ttrainer.roll_columns(resident.images[_t(rb["i2"]).long()], _t(rb["shift"]))
        np.testing.assert_array_equal(hb["x2"], x2.numpy())
        np.testing.assert_array_equal(hb["overlap"], rb["overlap"])
        np.testing.assert_array_equal(hb["orientation"], rb["orientation"])
    bf16 = tdata.ResidentPairs(ds, device="cpu", input_dtype="bfloat16")
    assert bf16.images.dtype == torch.bfloat16


def test_dataset_bfloat16_batches_and_rejected_arguments(tmp_path):
    ds, _, root = _disk_dataset(tmp_path, 2, 1, h=8, w=12)
    (b,) = list(ds.batches(1, input_dtype="bfloat16"))
    assert b["x1"].dtype == torch.bfloat16 and b["overlap"].dtype == np.float32
    (b32,) = list(ds.batches(1))
    np.testing.assert_allclose(b["x1"].float().numpy(), b32["x1"], rtol=0.01, atol=0.01)
    with pytest.raises(ValueError, match="input_dtype"):
        list(ds.batches(1, input_dtype="float16"))
    with pytest.raises(ValueError, match="input_dtype"):
        tdata.ResidentPairs(ds, device="cpu", input_dtype="float16")


def test_a_missing_scan_raises_in_the_consumer(tmp_path):
    ds, _, root = _disk_dataset(tmp_path, 2, 2, h=8, w=12)
    os.unlink(os.path.join(root, "07", "depth", "000000.npy"))
    os.unlink(os.path.join(root, "07", "depth", "000001.npy"))
    with pytest.raises(FileNotFoundError):
        list(ds.batches(2))


def test_gt_files_cross_read(tmp_path):
    """GT pair files written by the port's copy load in both packages."""
    from overlapnet_tpu.data.gt_files import load_gt_pairs as jax_load

    table = np.array([[0, 1, 0.5, 10], [2, 3, 0.9, 200], [4, 4, 1.0, 180]], float)
    paths = save_gt_files(str(tmp_path), "07", table, table[:2], table[2:])
    ours = load_gt_pairs([paths["train_set"]], shuffle=False)
    theirs = jax_load([paths["train_set"]], shuffle=False)
    assert ours.imgf1 == theirs.imgf1 == ["000000", "000002"] and ours.dir2 == ["07", "07"]
    np.testing.assert_array_equal(ours.overlap, theirs.overlap)
    assert len(ours[np.array([1])]) == 1


# -- checkpoints and weight bridges ----------------------------------------------


def test_checkpoint_round_trip_and_retention(tmp_path):
    """State survives save -> a fresh trainer -> restore (params, optimizer
    state, step), training continues identically, and only the last
    max_to_keep steps stay on disk."""
    tcfg, _ = small_cfgs()
    trainer = ttrainer.Trainer(tcfg, steps_per_epoch=2, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    assert tckpt.latest_step(ckpt) is None
    for i in range(4):
        trainer.run_epoch([make_batch(2, seed=i)])
        assert tckpt.save_checkpoint(ckpt, trainer.state, max_to_keep=2) == i + 1
    assert sorted(os.listdir(ckpt)) == ["step_00000003.pt", "step_00000004.pt"]
    assert tckpt.latest_step(ckpt) == 4

    fresh = ttrainer.Trainer(dataclasses.replace(
        tcfg, train=dataclasses.replace(tcfg.train, seed=99)), steps_per_epoch=2, device="cpu")
    assert not torch.equal(fresh.state.params["legs.s_conv1.weight"],
                           trainer.state.params["legs.s_conv1.weight"])
    tckpt.restore_checkpoint(ckpt, fresh.state)
    assert fresh.state.step == 4
    for k, v in trainer.state.params.items():
        np.testing.assert_array_equal(fresh.state.params[k].numpy(), v.numpy(), err_msg=k)
    for k, v in trainer.state.opt_state["sum_of_squares"].items():
        np.testing.assert_array_equal(fresh.state.opt_state["sum_of_squares"][k].numpy(), v.numpy())
    batch = make_batch(2, seed=9)
    m1 = trainer.run_epoch([batch])
    m2 = fresh.run_epoch([batch])
    assert m1["loss"] == m2["loss"] and m1["grad_norm"] == m2["grad_norm"]
    for k, v in trainer.state.params.items():
        np.testing.assert_array_equal(fresh.state.params[k].numpy(), v.numpy(), err_msg=k)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), fresh.state)
    adam_cfg, _ = small_cfgs(train_kw=dict(optimizer="adam"))
    other = ttrainer.Trainer(adam_cfg, steps_per_epoch=2, device="cpu")
    with pytest.raises(ValueError, match="optimizer state"):
        tckpt.restore_checkpoint(ckpt, other.state)


def test_params_npz_crosses_between_the_packages(tmp_path):
    """A params.npz written by the port's trainer loads with the JAX
    package's load_params_npz and gives the same forward there; one written
    by the JAX package loads in the port."""
    tcfg, jcfg = small_cfgs()
    trainer = ttrainer.Trainer(tcfg, steps_per_epoch=1, device="cpu")
    trainer.run_epoch([make_batch(2)])
    path = str(tmp_path / "params.npz")
    tckpt.save_params_npz(path, trainer.state.params)
    jparams = jckpt.load_params_npz(path, jax_init_params(jcfg.model, 4, rng=5))
    batch = make_batch(2, seed=3)
    ov_j, lg_j = jax_build_model(jcfg.model).apply(jparams, batch["x1"], batch["x2"])
    with torch.inference_mode():
        ov_t, lg_t = trainer.state.model(_t(batch["x1"]), _t(batch["x2"]))
    np.testing.assert_allclose(ov_t.numpy(), np.asarray(ov_j), atol=1e-4)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=1e-3,
                               atol=1e-4 * float(np.abs(lg_j).max()))

    back = str(tmp_path / "from_jax.npz")
    jckpt.save_params_npz(back, jparams)
    loaded = tckpt.load_params_npz(back, trainer.state.params)
    for k, v in trainer.state.params.items():
        np.testing.assert_array_equal(loaded[k].numpy(), v.numpy(), err_msg=k)
    cosine, _ = small_cfgs(model_kw=dict(correlation_normalize="cosine"))
    with pytest.raises(ValueError, match="do not fit"):
        tckpt.load_params_npz(back, init_params(cosine.model, 4))


def test_infer_loads_the_trainers_outputs_and_rejects_other_directories(tmp_path):
    tcfg, _ = small_cfgs()
    trainer = ttrainer.Trainer(tcfg, steps_per_epoch=1, device="cpu")
    trainer.run_epoch([make_batch(2)])
    ckpt = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(ckpt, trainer.state)
    tcfg.experiment.pretrained_weightsfilename = ckpt
    served = Infer(tcfg, device="cpu")
    for k, v in trainer.state.params.items():
        np.testing.assert_array_equal(served.model.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    orbax_like = tmp_path / "orbax" / "3"
    orbax_like.mkdir(parents=True)
    (orbax_like / "_METADATA").write_text("{}")
    tcfg.experiment.pretrained_weightsfilename = str(tmp_path / "orbax")
    with pytest.raises(NotImplementedError, match="save_params_npz"):
        Infer(tcfg, device="cpu")


def test_keras_import_matches_the_jax_import(tmp_path):
    """A Keras-format HDF5 file written here loads through both packages'
    importers to the same weights, and ``Infer`` takes a .weight file."""
    h5py = pytest.importorskip("h5py")
    from overlapnet_tpu.train.import_keras import import_keras_weights as jax_import
    from overlapnet_torch.train.import_keras import import_keras_weights, read_keras_weights

    tcfg, jcfg = small_cfgs()
    jparams = jax_init_params(jcfg.model, 4, rng=0)
    rng = np.random.default_rng(0)
    path = str(tmp_path / "model_geo.weight")
    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        layers = {**{n: jparams["params"]["legs"][n] for n in jparams["params"]["legs"]},
                  **{n: jparams["params"]["overlap_head"][n]
                     for n in jparams["params"]["overlap_head"]}}
        g.attrs["layer_names"] = [b"leg_input_l"] + [n.encode() for n in layers]
        g.create_group("leg_input_l").attrs["weight_names"] = []
        for layer, leaves in layers.items():
            lg = g.create_group(layer)
            names = []
            for var in ("kernel", "bias"):
                wn = f"{layer}/{var}:0"
                lg.create_dataset(wn, data=rng.normal(size=leaves[var].shape).astype(np.float32))
                names.append(wn.encode())
            lg.attrs["weight_names"] = names
        f.create_group("optimizer_weights").create_dataset(
            "training/Adagrad/accumulator_0:0", data=np.zeros(3, np.float32))

    assert "s_conv1/kernel" in read_keras_weights(path)
    want = weights.params_from_jax(flat_jax_params(jax_import(path, jparams)))
    start = init_params(tcfg.model, 4, seed=1)
    got = import_keras_weights(path, start)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    tcfg.experiment.pretrained_weightsfilename = path
    served = Infer(tcfg, device="cpu").model.state_dict()
    np.testing.assert_array_equal(served["overlap_head.overlap_output.weight"].numpy(),
                                  want["overlap_head.overlap_output.weight"].numpy())

    bad = str(tmp_path / "bad.weight")
    with h5py.File(bad, "w") as f:
        g = f.create_group("model_weights")
        g.attrs["layer_names"] = [b"s_conv1"]
        lg = g.create_group("s_conv1")
        lg.create_dataset("s_conv1/kernel:0", data=np.zeros((3, 3, 1, 1), np.float32))
        lg.attrs["weight_names"] = [b"s_conv1/kernel:0"]
    with pytest.raises(ValueError, match="Shape mismatch"):
        import_keras_weights(bad, start)
    assert import_keras_weights(bad, start, strict=False).keys() == start.keys()
    with h5py.File(bad, "w") as f:
        f.create_group("model_weights").attrs["layer_names"] = []
    with pytest.raises(ValueError, match="No layers"):
        import_keras_weights(bad, start)


# -- cli train --------------------------------------------------------------------


def _network_yml(tmp_path, data_root, **extra):
    import yaml

    exp = os.path.join(str(tmp_path), "exp")
    os.makedirs(exp, exist_ok=True)
    cfg = {
        "data_root_folder": data_root, "experiments_path": exp, "testname": "mini",
        "training_seqs": "07", "batch_size": 2, "no_epochs": 2, "no_batches_in_epoch": 2,
        "no_test_pairs": 3, "learning_rate": 0.001,
        "model": {"inputShape": [64, W_IN, 4], "leg_dtype": "float32"},
        "use_depth": True, "use_normals": True, "infer_seqs": "07", **extra,
    }
    path = os.path.join(exp, "network.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "host-batches"])
def test_cli_train_runs_resumes_and_exports(tmp_path, resident):
    """Two epochs of two steps on the CPU; the outputs exist; --resume with
    the epochs done takes no further step; the exported params.npz serves."""
    root = _disk_dataset(tmp_path / "data", 4, 6, write_gt=True)[2]
    yml = _network_yml(tmp_path, root)
    extra = [] if resident else ["--no-resident"]
    assert cli_main(["train", yml, "--device", "cpu", *extra]) == 0
    exp = os.path.join(str(tmp_path), "exp", "mini")
    ckpts = os.path.join(exp, "checkpoints")
    assert tckpt.latest_step(ckpts) == 4
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        phases = [__import__("json").loads(line)["phase"] for line in f]
    assert phases == ["train", "validation"] * 2
    before = tckpt.load_checkpoint(ckpts)
    assert cli_main(["train", yml, "--device", "cpu", "--resume", *extra]) == 0
    after = tckpt.load_checkpoint(ckpts)
    assert after["step"] == before["step"] == 4
    tcfg, _ = small_cfgs()
    tcfg.experiment.pretrained_weightsfilename = os.path.join(exp, "params.npz")
    served = Infer(tcfg, device="cpu").model.state_dict()
    for k, v in after["params"].items():
        np.testing.assert_array_equal(served[k].numpy(), v.numpy(), err_msg=k)


def test_cli_train_rejects_pack_dir(tmp_path, capsys):
    """--pack-dir whose pack holds images of another shape than the config's
    input is an argument error (packs that fit: tests/test_torch_data.py)."""
    from overlapnet_torch.data.pack import SequencePack

    root = _disk_dataset(tmp_path / "data", 3, 4, write_gt=True)[2]
    yml = _network_yml(tmp_path, root)
    packs = str(tmp_path / "packs")
    SequencePack.build(root, "07", ChannelConfig(), packs, height=64, width=W_IN // 2)
    with pytest.raises(SystemExit) as e:
        cli_main(["train", yml, "--device", "cpu", "--pack-dir", packs])
    assert e.value.code == 2 and "the config's input is" in capsys.readouterr().err
