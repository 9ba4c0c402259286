"""Port parity: one pacing train step and one eval step of
``pacingpseudo_torch.train.step`` against ``pacingpseudo_tpu.train.step``
(CPU, float32, 64x64, init_ch 8, batch 2, the Experiment session's loss
set).

Both sides start from the same state: the port's seeded init, carried to
JAX by the JAX package's importer, a warm memory bank with one cold row,
step 0.  The batch is one the JAX ``augment_batch`` made (weak and strong
streams).  The JAX side's gradients are read from an identity stage in
front of its optimizer.  To keep this file's compile time down, the JAX
programs draw from an ``rbg`` key instead of threefry and are compiled at
XLA backend optimization level 0 (the same float32 operations).  The port runs twice: with the loss library
(``use_pallas_loss="auto"`` on the CPU) and with the fused loss's plain
version (``"on"``).  ``test_train_step_matches_jax`` also holds the step's
other config flags (``CASES``), each with the JAX step built from the same
overrides: the consistency variants ``l1_loss``, ``l2_loss`` and
``kl_loss``, ``detach_weak_cr``, ``memory_update_mode="all"``,
``aux_on_strong=False`` and ``ensemble_mode="mean"`` at the bounds below,
and the single-stream steps (the Control session, ``fuse_streams=False``)
with every ConvLayer's LeakyReLU at slope 1 on both sides (the port's
``models.unet.NEGATIVE_SLOPE``, the JAX ``ConvLayer.negative_slope`` field,
set in a subclass that the JAX UNet builds while the step is traced).  At
slope 0.01 one pixel of ``dec_block1.conv_layer2`` of the weak stream lies
at |x| = 7.2e-7 and takes the other branch on one side, which puts most
leaves 1-2.3% of their norm off; at slope 1 no branch exists and the same
bounds hold.

Tolerances: weighted metrics rtol 1e-4; BN statistics and the bank within
1e-4 x max.  Gradients: see ``_assert_grads_close``; new parameters follow
from them through Adam's first step (``_assert_new_params_close``).
``_nchw`` is the one place that permutes NHWC into NCHW.

Why the gradients are not all held at 1e-3 x max: the two float32 forwards
differ by up to ~5e-5 in a BatchNorm output, and a pixel whose
pre-activation lies closer to 0 than that takes the other LeakyReLU branch
(slope 1 against 0.01) on one side.  At these inputs that happens to one
pixel of ``dec_block2.conv_layer1`` and one of ``dec_block4.conv_layer2``.
Every leaf the backward reaches after such a pixel moves by up to ~1e-2 of
its max, on 32x32 and 8x8 maps where one pixel is a large share of a
channel; the JAX step's own float32 gradient differs from a float64
evaluation of the same step by as much.  The leaves before the first such
pixel (``dec_block1``, ``final_conv``, the aux path) are held at 1e-3 x max.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pacingpseudo_tpu.aug.engine import augment_batch
from pacingpseudo_tpu.aug.params import BaseAugParams, StrongAugParams
from pacingpseudo_tpu.config import ExperimentConfig as JaxConfig
from pacingpseudo_tpu.evals.dice import dice_per_class_jax
from pacingpseudo_tpu.models import PacingPseudoModel as JaxPacing
from pacingpseudo_tpu.models import unet as jax_unet
from pacingpseudo_tpu.tools.torch_import import convert_state_dict
from pacingpseudo_tpu.train import optim as jax_optim
from pacingpseudo_tpu.train import schedules as jax_sched
from pacingpseudo_tpu.train.state import TrainState as JaxState
from pacingpseudo_tpu.train.step import make_pacing_eval_step as jax_eval_step
from pacingpseudo_tpu.train.step import make_pacing_train_step as jax_train_step
from pacingpseudo_torch.config import ExperimentConfig
from pacingpseudo_torch.evals.dice import dice_per_class, dice_per_class_hard
from pacingpseudo_torch.models import unet
from pacingpseudo_torch.models.unet import torch_default_init_
from pacingpseudo_torch.tools.weights import from_jax_variables
from pacingpseudo_torch.train import optim, schedules
from pacingpseudo_torch.train.state import build_model, create_train_state
from pacingpseudo_torch.train.step import make_pacing_eval_step, make_pacing_train_step

N, S, C, INIT_CH, HID = 2, 64, 4, 8, 16
STEPS_PER_EPOCH = 4
FLAGS = dict(num_classes=C, ignored_index=C, init_ch=INIT_CH, hid_ch=HID,
             batch_size=N, do_loss_ent=True, do_decoder_consistency=True,
             do_aux_path=True, do_memory=True, compute_dtype="float32")
CONTROL = dict(session="Control", do_loss_ent=False, do_decoder_consistency=False,
               do_aux_path=False, do_memory=False)
# A case of test_train_step_matches_jax: (config overrides of both sides,
# the port's own overrides, the ConvLayers' LeakyReLU slope or None for the
# model's own).
CASES = {
    "auto": ({}, {"use_pallas_loss": "auto"}, None),
    "on": ({}, {"use_pallas_loss": "on"}, None),
    "l1_loss": ({"loss_cr_variants": "l1_loss"}, {}, None),
    "l2_loss": ({"loss_cr_variants": "l2_loss"}, {}, None),
    "kl_loss": ({"loss_cr_variants": "kl_loss"}, {}, None),
    "detach_weak_cr": ({"detach_weak_cr": True}, {}, None),
    "memory_update_all": ({"memory_update_mode": "all"}, {}, None),
    "aux_on_weak": ({"aux_on_strong": False}, {}, None),
    "ensemble_mean": ({"ensemble_mode": "mean"}, {}, None),
    "control_slope1": (CONTROL, {}, 1.0),
    "unfused_streams_slope1": ({"fuse_streams": False}, {}, 1.0),
}


def _nchw(x):
    """NHWC numpy -> NCHW torch: the one place the layouts meet."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def _np(tree):
    return jax.tree.map(np.array, tree)


def _grad_stash():
    """Identity optimizer stage whose state is the last gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _compiled(jitted, *args):
    """``jitted(*args)``, compiled at XLA backend optimization level 0."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _batch():
    rs = np.random.RandomState(0)
    scribble = np.full((N, S, S), C, np.float32)              # C = ignore
    pick = rs.rand(N, S, S) < 0.1
    scribble[pick] = rs.randint(0, C, pick.sum())
    raw = {"image": jnp.asarray(rs.randn(N, S, S), jnp.float32),
           "label": jnp.asarray(rs.randint(0, C, (N, S, S)), jnp.float32),
           "scribble": jnp.asarray(scribble),
           "size": jnp.asarray(np.tile([S, S], (N, 1)), jnp.int32)}
    base = BaseAugParams(crop_size=(S, S), num_classes=C, ignored_index=C)
    augment = jax.jit(lambda r, k: augment_batch(
        r, k, base, StrongAugParams.color(1.0), True))
    return _np(_compiled(augment, raw, jax.random.key(3, impl="rbg")))


def _initial_state_dict(flags=FLAGS):
    model = build_model(ExperimentConfig(**flags).validate(), device="cpu")
    torch_default_init_(model, torch.Generator().manual_seed(5))
    if model.do_aux_path:
        bank = np.random.RandomState(6).randn(C, HID).astype(np.float32)
        bank[2] = 0.0                                          # a cold row
        model.aux_path.memory_bank.copy_(torch.from_numpy(bank)[:, :, None, None])
    return {k: v.clone() for k, v in model.state_dict().items()}


class _SlopeOneConvLayer(jax_unet.ConvLayer):
    """The JAX ConvLayer with its LeakyReLU at slope 1 (an identity)."""

    negative_slope: float = 1.0


@contextlib.contextmanager
def _slope(slope):
    """Every ConvLayer's LeakyReLU at ``slope`` on both sides, or the
    model's own for ``None``."""
    with pytest.MonkeyPatch.context() as mp:
        if slope is not None:
            assert slope == 1.0
            mp.setattr(jax_unet, "ConvLayer", _SlopeOneConvLayer)
            mp.setattr(unet, "NEGATIVE_SLOPE", slope)
        yield


def _batch_for(batch, flags):
    """The batch a session trains on: the Control session's has no strong
    stream."""
    if flags.get("do_decoder_consistency"):
        return batch
    return {k: v for k, v in batch.items() if k != "image_strong"}


def _jax_step(batch, overrides, slope, with_eval=False):
    """The JAX step (and eval step) of ``FLAGS`` + ``overrides`` from the
    port's seeded state, on ``batch``."""
    flags = {**FLAGS, **overrides}
    sd0 = _initial_state_dict(flags)
    batch = _batch_for(batch, flags)
    params, stats, bank = convert_state_dict({k: v.numpy() for k, v in sd0.items()})
    config = JaxConfig(**flags).validate()
    model = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=config.do_aux_path,
                      hid_ch=HID, aux_on_strong=config.aux_on_strong,
                      fuse_streams=config.fuse_streams, s2d_hires=False,
                      dtype=jnp.float32)
    tx = optax.chain(_grad_stash(), jax_optim.make_optimizer(config, STEPS_PER_EPOCH))
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=stats, opt_state=tx.init(params),
                     memory_bank=None if bank is None else jnp.asarray(bank))
    with _slope(slope):
        step = jax_train_step(config, model, tx, STEPS_PER_EPOCH, donate=False)
        new_state, metrics = _compiled(step, state, batch, jax.random.key(0, impl="rbg"))
        out = dict(sd0=sd0, batch=batch, metrics=_np(metrics),
                   grads=_np(new_state.opt_state[0]),
                   new_sd=from_jax_variables(
                       _np(new_state.params), _np(new_state.batch_stats),
                       None if bank is None else np.array(new_state.memory_bank)))
        if with_eval:
            loss, dice, logits = _compiled(jax_eval_step(config, model), new_state, batch)
            out["eval"] = (float(loss), np.array(dice), _nchw(logits))
    return out


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def run(batch):
    """The JAX step and eval step from the shared state and batch."""
    return _jax_step(batch, {}, None, with_eval=True)


@pytest.fixture(scope="module")
def jax_runs(batch, run):
    """The JAX step of a case of ``CASES``, built once a case."""
    cache = {}

    def get(case):
        overrides, _, slope = CASES[case]
        key = (tuple(sorted(overrides.items())), slope)
        if key not in cache:
            cache[key] = run if key == ((), None) else _jax_step(batch, overrides, slope)
        return cache[key]

    return get


def _port_state(sd0, **overrides):
    config = ExperimentConfig(**{**FLAGS, **overrides}).validate()
    model = build_model(config, device="cpu")
    model.load_state_dict(sd0, strict=True)
    return config, create_train_state(config, device="cpu", model=model)


def _port_batch(batch):
    return {k: _nchw(v) for k, v in batch.items()}


def _bn_fed_conv_bias(name):
    return name.endswith(".conv.bias") or name == "aux_path.layer_bottleneck.1.bias"


def _before_branch_flips(name):
    return name.startswith(("backbone.dec_block1.", "backbone.final_conv.",
                            "aux_path."))


def _assert_grads_close(params, want_grads):
    """Per leaf: a conv bias that feeds a BatchNorm cancels out of the output,
    so its true gradient is 0 and both sides must give roundoff, under 1e-4 x
    the max gradient of the same conv's weight.  Every other leaf: L2 error
    under 1e-2 x its L2 norm (worst measured 4.5e-3, see the module
    docstring), and the leaves before any branch flip 1e-3 x max."""
    for name, p in params.items():
        want = want_grads[name]
        if _bn_fed_conv_bias(name):
            bound = 1e-4 * float(want_grads[name[:-4] + "weight"].abs().max())
            assert float(p.grad.abs().max()) <= bound, name
            assert float(want.abs().max()) <= bound, name
            continue
        err = float((p.grad - want).norm())
        assert err <= 1e-2 * float(want.norm()), (name, err)
        if _before_branch_flips(name):
            err = float((p.grad - want).abs().max())
            assert err <= 1e-3 * float(want.abs().max()), (name, err)


def _assert_new_params_close(params, old_sd, want_grads, new_sd, lr, wd):
    """Adam's first step moves each element by ``lr·g/(|g|+1e-8)`` with
    ``g = grad + wd·p``: ±lr whatever the size of ``g``.  The new values
    agree within 1e-6 where the two sides' ``g`` share a sign; they may
    differ by 2·lr only where the JAX ``g`` lies within the gradient
    tolerance of 0 (and anywhere in a BN-fed conv bias, whose gradient is
    roundoff on both sides)."""
    for name, p in params.items():
        err = (p.detach() - new_sd[name]).abs()
        if _bn_fed_conv_bias(name):
            assert float(err.max()) <= 2 * lr + 1e-7, name
            continue
        g_want = want_grads[name] + wd * old_sd[name]
        near_zero = g_want.abs() <= 1e-2 * float(want_grads[name].abs().max())
        assert float(torch.where(near_zero, 0.0, err).max()) <= 1e-6, name
        assert float(err.max()) <= 2 * lr + 1e-6, name


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(jax_runs, case):
    run = jax_runs(case)
    overrides, port_overrides, slope = CASES[case]
    config, state = _port_state(run["sd0"], **overrides, **port_overrides)
    with _slope(slope):
        metrics = make_pacing_train_step(config, STEPS_PER_EPOCH)(
            state, _port_batch(run["batch"]))
    assert state.step == 1

    assert sorted(metrics) == sorted(run["metrics"])
    for k, want in run["metrics"].items():
        assert np.isclose(float(metrics[k]), float(want), rtol=1e-4, atol=0), k

    params = dict(state.model.named_parameters())
    want_grads = from_jax_variables(run["grads"], {})
    _assert_grads_close(params, want_grads)
    _assert_new_params_close(params, run["sd0"], want_grads, run["new_sd"],
                             float(run["metrics"]["lr"]), config.wd)

    got_sd = state.model.state_dict()
    for name, want in run["new_sd"].items():
        if name.endswith(("running_mean", "running_var", "memory_bank")):
            err = float((got_sd[name] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (name, err)


def test_eval_step_matches_jax(run):
    config, state = _port_state(run["sd0"])
    batch = _port_batch(run["batch"])
    make_pacing_train_step(config, STEPS_PER_EPOCH)(state, batch)
    loss, dice, logits = make_pacing_eval_step(config)(state, batch)
    want_loss, want_dice, want_logits = run["eval"]
    assert state.model.training
    assert np.isclose(float(loss), want_loss, rtol=1e-4)
    err = float((logits - want_logits).abs().max())
    assert err <= 1e-4 * float(want_logits.abs().max())
    # Dice of the argmax: a pixel whose top two logits lie within the
    # logits' error may flip, so Dice is compared on identical inputs below
    # and here only for its NaN pattern and a loose value bound.
    assert np.array_equal(np.isnan(dice.numpy()), np.isnan(want_dice))
    np.testing.assert_allclose(dice.numpy(), want_dice, atol=2e-2)


def test_dice_conventions_match_jax():
    from pacingpseudo_tpu.evals.dice import compute_dice_hard

    rs = np.random.RandomState(9)
    logits = rs.randn(N, 16, 16, C).astype(np.float32)
    logits[0, ..., 3] -= 50.0                 # class 3 never predicted in sample 0
    label = rs.randint(0, C - 1, (N, 16, 16))  # and never labelled anywhere
    one_hot = np.eye(C, dtype=np.float32)[label]
    region = (rs.rand(N, 16, 16, 1) > 0.2).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    want = np.asarray(dice_per_class_jax(probs, one_hot, region_mask=region))
    got = dice_per_class(_nchw(probs), _nchw(one_hot), region_mask=_nchw(region))
    assert np.isnan(want[0, 3])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, equal_nan=True)

    pred = probs.argmax(-1)
    got_hard = dice_per_class_hard(torch.from_numpy(pred), torch.from_numpy(label), C)
    want_hard = np.array([compute_dice_hard(pred[i], label[i], C) for i in range(N)])
    np.testing.assert_allclose(got_hard.numpy(), want_hard, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("policy", ["poly", "linear", "cosine"])
def test_schedules_match_jax(policy):
    config = dataclasses.replace(ExperimentConfig(**FLAGS), lr_decay=policy, epoch=400)
    tx_sched = jax_sched.make_lr_schedule(policy, 400, config.lr)
    for step in (0, 7, 4 * 37, 4 * 399):
        want = float(tx_sched(step // STEPS_PER_EPOCH))
        assert np.isclose(optim.lr_at(config, step, STEPS_PER_EPOCH), want, rtol=1e-6)
    for t in (0.0, 37.0, 80.0, 120.0):
        assert np.isclose(schedules.gaussian_ramp_up(t, 1.0, scale=8.0),
                          float(jax_sched.gaussian_ramp_up(t, 1.0, scale=8.0)), rtol=1e-6)
        assert np.isclose(schedules.memory_momentum(t, 400),
                          float(jax_sched.memory_momentum(t, 400)), rtol=1e-6)


def test_frozen_bn_step_keeps_running_stats(run):
    config, state = _port_state(run["sd0"])
    stats0 = {k: v.clone() for k, v in state.model.state_dict().items()
              if "running" in k}
    metrics = make_pacing_train_step(config, STEPS_PER_EPOCH, module_train=False)(
        state, _port_batch(run["batch"]))
    assert all(torch.isfinite(v).all() for k, v in metrics.items() if k != "lr")
    for k, v in state.model.state_dict().items():
        if k in stats0:
            assert torch.equal(v, stats0[k]), k
    assert state.step == 1
