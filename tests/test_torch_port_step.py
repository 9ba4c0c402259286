"""Port parity: one pacing train step and one eval step of
``pacingpseudo_torch.train.step`` against ``pacingpseudo_tpu.train.step``
(CPU, float32 and bfloat16, 64x64, init_ch 8, batch 2, the Experiment
session's loss set).

Both sides start from the same state: the port's seeded init, carried to
JAX by the JAX package's importer, a warm memory bank with one cold row,
at step 0 or, for the cases with a start epoch, at the first update of
that epoch (``state.step`` on both sides; JAX's learning-rate schedule
reads the optimizer's own count, set to the same step, while Adam's
moments stay fresh on both).  At epoch 0 both loss ramps weigh e^-8 =
3.4e-4, so the entropy and soft-CE gradients enter far under the bounds
below; the cases ``late_395`` (whole weight, bank momentum 0.0175),
``mid_200`` (whole weight, 0.48) and ``ramp_40`` (0.018, 0.82) hold
them where they weigh, on the library and the fused-loss paths, and the
routing variants again at epoch 395.  One compiled JAX step serves every
start epoch of a config.  The batch is one the JAX ``augment_batch`` made (weak and strong
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

bfloat16 (``bf16_late_395``, ``control_bf16_late_395``: both sides at
``compute_dtype="bfloat16"``, epoch 395).  The yardstick is JAX's own: on
the same state and batch, per leaf the L2 distance of the port's bfloat16
gradient from JAX's bfloat16 gradient is at most ``BF16_SPREAD`` (4) x
the distance between JAX's bfloat16 and float32 gradients (measured worst
ratio 1.69, Experiment; 1.66, Control); the same rule holds the BN
statistics and the bank, and the elements whose first Adam step takes the
other sign than JAX's bfloat16 step, counted over all leaves.  A metric's relative error is at
most 4 x the largest relative bfloat16-to-float32 distance among the
step's loss metrics on JAX's side (one scalar's own distance is a single
draw of rounding: JAX's ``loss_aux_cls`` moved 3e-5 relative where its
``loss_pce`` moved 9.4e-4).  Where each side casts:

- input: JAX ``x.astype(dt)`` (``unet.py:418``), port ``x.to(dtype)``
  (``unet.py:274``);
- convs: both cast input, kernel and bias to bf16 and return bf16 (JAX
  ``nn.Conv(dtype=bf16)``, the bias added in bf16 after the product; port
  ``Conv2d``, ``unet.py:60-67``, the bias inside ``F.conv2d``);
- BatchNorm: statistics and normalisation in float32 on both sides, running
  statistics float32; JAX casts the output back to bf16 inside the norm
  (``ops/fused_bn.py``), the port after it (``unet.py:139``);
- LeakyReLU in bf16 on both (JAX ``unet.py:164``, its slope rounded to
  bf16, 0.010009765625; port ``unet.py:139``, slope 0.01 in float32
  arithmetic, rounded once);
- max-pool in bf16; the decoder's 2x bilinear upsample in bf16 (JAX with
  interpolation weights rounded to bf16, ``ops/resize.py:47-49``; port
  ``F.interpolate``, float32 weights);
- skip concat: the skip cast to the upsampled tensor's dtype (JAX
  ``unet.py:258``, port ``unet.py:223``);
- logits: the final 1x1 conv in bf16, cast to float32 (JAX
  ``unet.py:510``, port ``unet.py:288``); every loss, the weak stream's
  softmax target included, in float32 on both;
- aux path: the concat of stages 6 and 5 cast to bf16, its conv in bf16,
  its BatchNorm, LeakyReLU, classifier and resize in float32 (JAX
  ``aux_path.py:82-91``, port ``aux_path.py:98-101``);
- the bank: float32 features (resized in float32) and float32 EMA on both.

JAX's bfloat16 step runs the space-to-depth stage-1 blocks
(``s2d_hires=True``), as the sweep's config did; the port has no S2D. In
bfloat16 too that is a layout: ``_S2DConv`` (``unet.py:304-310``) returns
bf16 as ``nn.Conv`` does, and on this batch JAX's bf16 forward with S2D and
without it differ in 0.2% of the logits, by one bf16 rounding (max 1.2e-2,
RMS 1.5e-4, against an RMS of 4.9e-2 between JAX's bf16 and float32
logits); the aux features are equal bit for bit.

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
# Start epochs of a case (``STEPS_PER_EPOCH`` updates an epoch, FLAGS'
# 400-epoch schedule).  Both loss ramps are ``gaussian_ramp_up(epoch, w,
# max_t=80, scale=8)``: e^-8 = 3.4e-4 of their weight at epoch 0, e^-4 =
# 0.018 at epoch 40, the whole weight from epoch 80 on; the bank's momentum
# ``0.9 (1 - epoch/400)^0.9``: 0.9, 0.82, 0.48 and 0.0175 at epochs 0, 40,
# 200 and 395.
LATE, MID, RAMP = 395, 200, 40
BF16_SPREAD = 4.0
# A case of test_train_step_matches_jax: (config overrides of both sides,
# the port's own overrides, the ConvLayers' LeakyReLU slope or None for the
# model's own, the start epoch).
CASES = {
    "auto": ({}, {"use_pallas_loss": "auto"}, None, 0),
    "on": ({}, {"use_pallas_loss": "on"}, None, 0),
    "l1_loss": ({"loss_cr_variants": "l1_loss"}, {}, None, 0),
    "l2_loss": ({"loss_cr_variants": "l2_loss"}, {}, None, 0),
    "kl_loss": ({"loss_cr_variants": "kl_loss"}, {}, None, 0),
    "detach_weak_cr": ({"detach_weak_cr": True}, {}, None, 0),
    "memory_update_all": ({"memory_update_mode": "all"}, {}, None, 0),
    "aux_on_weak": ({"aux_on_strong": False}, {}, None, 0),
    "ensemble_mean": ({"ensemble_mode": "mean"}, {}, None, 0),
    "control_slope1": (CONTROL, {}, 1.0, 0),
    "unfused_streams_slope1": ({"fuse_streams": False}, {}, 1.0, 0),
    "late_395": ({}, {"use_pallas_loss": "auto"}, None, LATE),
    "late_395_on": ({}, {"use_pallas_loss": "on"}, None, LATE),
    "mid_200": ({}, {"use_pallas_loss": "on"}, None, MID),
    "ramp_40": ({}, {"use_pallas_loss": "on"}, None, RAMP),
    "detach_weak_cr_late_395": ({"detach_weak_cr": True}, {}, None, LATE),
    "memory_update_all_late_395": ({"memory_update_mode": "all"}, {}, None, LATE),
    "aux_on_weak_late_395": ({"aux_on_strong": False}, {}, None, LATE),
    "ensemble_mean_late_395": ({"ensemble_mode": "mean"}, {}, None, LATE),
    "bf16_late_395": ({"compute_dtype": "bfloat16"}, {"use_pallas_loss": "on"}, None, LATE),
    "control_bf16_late_395": ({**CONTROL, "compute_dtype": "bfloat16"}, {}, None, LATE),
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


def _opt_state_at(tx, params, step):
    """``tx.init(params)`` with the learning-rate schedule's count at
    ``step``: the JAX optimizer reads its rate from that count, the port
    from ``state.step``.  Adam's moments and count stay fresh on both
    sides (the first Adam step, which ``_assert_new_params_close`` reads)."""
    def at(s):
        if isinstance(s, optax.ScaleByScheduleState):
            return s._replace(count=jnp.asarray(step, jnp.int32))
        return s
    return jax.tree.map(at, tx.init(params),
                        is_leaf=lambda s: isinstance(s, optax.ScaleByScheduleState))


def _jax_step(batch, overrides, slope, epoch=0, programs=None, with_eval=False):
    """The JAX step (and eval step) of ``FLAGS`` + ``overrides`` from the
    port's seeded state at update ``epoch * STEPS_PER_EPOCH``, on ``batch``.
    ``programs`` caches the compiled step by config: the start step is a
    value of the state, so every epoch of one config runs one program."""
    flags = {**FLAGS, **overrides}
    sd0 = _initial_state_dict(flags)
    batch = _batch_for(batch, flags)
    params, stats, bank = convert_state_dict({k: v.numpy() for k, v in sd0.items()})
    config = JaxConfig(**flags).validate()
    bf16 = config.compute_dtype == "bfloat16"
    # bfloat16 runs the S2D stage-1 blocks, as the JAX loop builds the
    # model from the config (s2d_hires True); float32 the plain blocks.
    model = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=config.do_aux_path,
                      hid_ch=HID, aux_on_strong=config.aux_on_strong,
                      fuse_streams=config.fuse_streams, s2d_hires=bf16,
                      dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tx = optax.chain(_grad_stash(), jax_optim.make_optimizer(config, STEPS_PER_EPOCH))
    start = epoch * STEPS_PER_EPOCH
    state = JaxState(step=jnp.asarray(start, jnp.int32), params=params,
                     batch_stats=stats, opt_state=_opt_state_at(tx, params, start),
                     memory_bank=None if bank is None else jnp.asarray(bank))
    key = jax.random.key(0, impl="rbg")
    programs = {} if programs is None else programs
    name = (tuple(sorted(overrides.items())), slope)
    with _slope(slope):
        if name not in programs:
            step = jax_train_step(config, model, tx, STEPS_PER_EPOCH, donate=False)
            programs[name] = step.lower(state, batch, key).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        new_state, metrics = programs[name](state, batch, key)
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
def programs():
    """The compiled JAX steps of this module, one a config."""
    return {}


@pytest.fixture(scope="module")
def run(batch, programs):
    """The JAX step and eval step from the shared state and batch."""
    return _jax_step(batch, {}, None, programs=programs, with_eval=True)


@pytest.fixture(scope="module")
def jax_runs(batch, run, programs):
    """The JAX step of a config, slope and start epoch, run once each."""
    cache = {((), None, 0): run}

    def get(overrides, slope, epoch):
        key = (tuple(sorted(overrides.items())), slope, epoch)
        if key not in cache:
            cache[key] = _jax_step(batch, overrides, slope, epoch, programs)
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


def _l2(a, b):
    return float((a.float() - b.float()).norm())


def _assert_within_bf16_spread(metrics, params, got_sd, run, run_f32):
    """The bfloat16 yardstick (module docstring): leaf by leaf, the port's
    bfloat16 value within ``BF16_SPREAD`` x the L2 distance between JAX's
    bfloat16 and float32 values on the same state and batch; a metric's
    relative error within ``BF16_SPREAD`` x the largest relative distance
    among the step's loss metrics."""
    losses = [k for k in run["metrics"] if k != "lr"]
    yard = max(abs(float(run["metrics"][k]) / float(run_f32["metrics"][k]) - 1)
               for k in losses)
    for k in losses:
        err = abs(float(metrics[k]) / float(run["metrics"][k]) - 1)
        assert err <= BF16_SPREAD * yard, (k, err, yard)
    want_grads = from_jax_variables(run["grads"], {})
    ref_grads = from_jax_variables(run_f32["grads"], {})
    for name, p in params.items():
        yard = _l2(want_grads[name], ref_grads[name])
        err = _l2(p.grad, want_grads[name])
        assert err <= BF16_SPREAD * yard, ("grad", name, err, yard)
    for name, want in run["new_sd"].items():
        if name.endswith(("running_mean", "running_var", "memory_bank")):
            yard = _l2(want, run_f32["new_sd"][name])
            err = _l2(got_sd[name], want)
            assert err <= BF16_SPREAD * yard, (name, err, yard)
    # Adam's first step moves an element by +-lr: the new parameters differ
    # by 2 lr where the two sides' steps took opposite signs, and by
    # roundoff elsewhere.  Over all leaves, the port's opposite steps number
    # at most BF16_SPREAD x those between JAX's bfloat16 and float32 steps.
    lr = float(run["metrics"]["lr"])
    flips = yard = 0
    for name, p in params.items():
        want = run["new_sd"][name]
        err = (p.detach() - want).abs()
        assert float(err.max()) <= 2 * lr + 1e-6, name
        flips += int((err > lr).sum())
        yard += int(((want - run_f32["new_sd"][name]).abs() > lr).sum())
    assert flips <= BF16_SPREAD * yard, (flips, yard)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(jax_runs, case):
    overrides, port_overrides, slope, epoch = CASES[case]
    run = jax_runs(overrides, slope, epoch)
    config, state = _port_state(run["sd0"], **overrides, **port_overrides)
    state.step = epoch * STEPS_PER_EPOCH
    with _slope(slope):
        metrics = make_pacing_train_step(config, STEPS_PER_EPOCH)(
            state, _port_batch(run["batch"]))
    assert state.step == epoch * STEPS_PER_EPOCH + 1
    assert sorted(metrics) == sorted(run["metrics"])
    # JAX's poly decay runs in float32: (1 - 395/400) carries ~4e-6 of it.
    assert np.isclose(float(metrics["lr"]), float(run["metrics"]["lr"]), rtol=1e-5, atol=0)
    params = dict(state.model.named_parameters())
    got_sd = state.model.state_dict()

    if config.compute_dtype == "bfloat16":
        as_f32 = {k: v for k, v in overrides.items() if k != "compute_dtype"}
        _assert_within_bf16_spread(metrics, params, got_sd, run,
                                   jax_runs(as_f32, slope, epoch))
        return

    for k, want in run["metrics"].items():
        assert np.isclose(float(metrics[k]), float(want), rtol=1e-4, atol=0), k

    want_grads = from_jax_variables(run["grads"], {})
    _assert_grads_close(params, want_grads)
    _assert_new_params_close(params, run["sd0"], want_grads, run["new_sd"],
                             float(run["metrics"]["lr"]), config.wd)

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
