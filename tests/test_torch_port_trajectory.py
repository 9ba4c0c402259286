"""Port parity over a trajectory: five pacing train steps of
``pacingpseudo_torch.train.step`` against ``pacingpseudo_tpu.train.step``
across two epoch boundaries (CPU, float32, 64x64, init_ch 8, batch 2, the
Experiment session's loss set, ``aux_drop_prob=0``).

``STEPS_PER_EPOCH = 2``: steps 1-2 are epoch 0 with the train-mode step,
steps 3-5 epochs 1-2 with the frozen-BN step (``module_train=False``), as
the loop runs them under ``ref_quirk_bn_eval_after_first_epoch``.  So the
per-epoch learning rate, the loss ramps and the bank's momentum change
twice inside the trajectory, and Adam's moments build up over five
updates.  Both sides start from the state of ``test_torch_port_step.py``
(the port's seeded init carried to JAX by the JAX package's importer, a
warm bank with one cold row) and take the same five batches, made by the
JAX ``augment_batch`` from numpy rasters (one key a step).  The JAX
programs use that file's ``rbg``-key and optimization-level-0 trick to
keep the compile time down.

Tolerances.  The one-step test's account: the two float32 forwards differ
by ~5e-5 in a BatchNorm output, which flips the LeakyReLU branch of single
pixels and moves that step's gradient leaves by up to ~1e-2 of their L2
norm.  Over k steps the errors do not just add: every later forward starts
from slightly other parameters and flips other pixels, and Adam moves an
element by about lr whatever its gradient's size, so an element whose
gradient lies near 0 may go either way.  Measured here: a relative 1e-7
perturbation of the initial weights (float32 roundoff) moves the port's
own five-step trajectory by up to ~47% of a leaf's update in L2, ~16% of
its first and second Adam moments.  So the trajectory is held against
that yardstick, taken in the same run (``PERTURB_SEEDS``: three port runs
from perturbed weights):

* weighted metrics: step 1 rtol 1e-4 as in the one-step test; steps 2-5
  rtol 1e-3 (the losses are smooth in the parameters);
* per leaf, the parameters (error in L2 over the L2 norm of the JAX
  update) and Adam's two moments (over their L2 norms): the port-JAX
  error within 4x the largest perturbed error + 1e-3 (measured worst
  ratio 3.0), and over all leaves, the root of the summed squares of the
  port-JAX errors within that of the perturbed errors (measured 0.55-0.58);
  the leaves no flip reaches on the way back from the losses
  (``final_conv``, the aux classifier and its BatchNorm) within 2e-2
  (measured worst 1.3e-2).  Conv biases that feed a BatchNorm are left
  out: their gradient is roundoff on both sides;
* every parameter element within 2 lr a step of JAX's (Adam's step);
* BatchNorm statistics (updated in steps 1-2 only) and the bank within
  1e-3 x max (measured worst 4.3e-4; perturbed 6.8e-4).

The ``last_epoch`` tests run the same five steps on the sweep's schedule
(``epoch=80``) from update ``2 x 77 + 1``: one step of epoch 77, two of
78, two of 79, the schedule's last.  There the loss ramps weigh 0.74 /
0.82 / 0.90 of their weight (at epochs 0-2 of the first trajectory, under
5e-4), the bank's momentum is 0.047 / 0.033 / 0.0175 and the learning
rate changes twice; Adam starts fresh on both sides and JAX's schedule
count starts at the same update.  Same yardsticks, from three perturbed
port runs of the same steps (worst leaf 0.15 of its bound).  All five are
frozen-BN steps, as a run under ``ref_quirk_bn_eval_after_first_epoch``
takes them this late.  With train-mode BatchNorm (the sweep's) the two
forwards' batch statistics differ by float32 rounding and single
pre-activations within that of 0 take the other LeakyReLU branch: comparing
the two forwards' signs at JAX's parameters before each update finds, before
update 4 (index 3), ``dec_block1.conv_block.conv_layer1``, sample 0,
channel 4, pixel (34, 31) at +1.4e-5 in JAX and -2.1e-8 in the port, which
leaves that channel's BN weight's Adam moments 1.2% of their norm apart
against 0.08% for the perturbed runs (the losses still agree within
3.1e-6), and others in ``dec_block1.conv_layer2``, ``dec_block2.
conv_layer2`` and ``enc_block6``; at slope 1 a max-pool's choice between
near-equal values then splits the runs into two groups.  The train-mode
step at these epochs is held one update at a time in
``test_torch_port_step.py`` (``late_395``, ``mid_200``, ``ramp_40``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacingpseudo_tpu.aug.engine import augment_batch
from pacingpseudo_tpu.aug.params import BaseAugParams, StrongAugParams
from pacingpseudo_tpu.config import ExperimentConfig as JaxConfig
from pacingpseudo_tpu.models import PacingPseudoModel as JaxPacing
from pacingpseudo_tpu.tools.torch_import import convert_state_dict
from pacingpseudo_tpu.train import optim as jax_optim
from pacingpseudo_tpu.train.state import TrainState as JaxState
from pacingpseudo_tpu.train.step import make_pacing_train_step as jax_train_step
from pacingpseudo_torch.config import ExperimentConfig
from pacingpseudo_torch.tools.weights import from_jax_variables
from pacingpseudo_torch.train.state import build_model, create_train_state
from pacingpseudo_torch.train.step import make_pacing_train_step
from test_torch_port_step import (C, FLAGS, HID, INIT_CH, N, S, _initial_state_dict,
                                  _nchw, _np, _opt_state_at)

STEPS_PER_EPOCH = 2
STEPS = 5
FROZEN_FROM = STEPS_PER_EPOCH           # the first step of epoch 1
TRAJ_FLAGS = dict(FLAGS, epoch=20, aux_drop_prob=0.0,
                  ref_quirk_bn_eval_after_first_epoch=True)
# A trajectory: (config flags, first update, first frozen-BN update or None).
FIRST_EPOCHS = (TRAJ_FLAGS, 0, FROZEN_FROM)
LAST_EPOCH = (dict(FLAGS, epoch=80, aux_drop_prob=0.0,
                   ref_quirk_bn_eval_after_first_epoch=True), 2 * 77 + 1, 0)
PERTURB_SEEDS = (1, 2, 3)
PERTURB = 1e-7
TIGHT = ("backbone.final_conv.", "aux_path.fc_cls.", "aux_path.layer_bottleneck.2.")


def _batches():
    """STEPS batches from the JAX augmenter, one raster and key a step."""
    base = BaseAugParams(crop_size=(S, S), num_classes=C, ignored_index=C)
    augment = jax.jit(lambda r, k: augment_batch(
        r, k, base, StrongAugParams.color(1.0), True))
    out, compiled = [], None
    for i in range(STEPS):
        rs = np.random.RandomState(100 + i)
        scribble = np.full((N, S, S), C, np.float32)
        pick = rs.rand(N, S, S) < 0.1
        scribble[pick] = rs.randint(0, C, pick.sum())
        raw = {"image": jnp.asarray(rs.randn(N, S, S), jnp.float32),
               "label": jnp.asarray(rs.randint(0, C, (N, S, S)), jnp.float32),
               "scribble": jnp.asarray(scribble),
               "size": jnp.asarray(np.tile([S, S], (N, 1)), jnp.int32)}
        key = jax.random.key(30 + i, impl="rbg")
        if compiled is None:
            compiled = augment.lower(raw, key).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        out.append(_np(compiled(raw, key)))
    return out


def _frozen(i, frozen_from):
    return frozen_from is not None and i >= frozen_from


def _jax_trajectory(trajectory, batches):
    """The JAX trajectory: per-step metrics and the final state."""
    flags, start, frozen_from = trajectory
    sd0 = _initial_state_dict()
    params, stats, bank = convert_state_dict({k: v.numpy() for k, v in sd0.items()})
    config = JaxConfig(**flags).validate()
    model = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=True,
                      hid_ch=HID, s2d_hires=False, dtype=jnp.float32)
    tx = jax_optim.make_optimizer(config, STEPS_PER_EPOCH)
    state = JaxState(step=jnp.asarray(start, jnp.int32), params=params,
                     batch_stats=stats, opt_state=_opt_state_at(tx, params, start),
                     memory_bank=jnp.asarray(bank))
    key = jax.random.key(0, impl="rbg")
    steps = {}
    for module_train in {not _frozen(i, frozen_from) for i in range(STEPS)}:
        jitted = jax_train_step(config, model, tx, STEPS_PER_EPOCH,
                                module_train=module_train, donate=False)
        steps[module_train] = jitted.lower(state, batches[0], key).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    metrics = []
    for i, batch in enumerate(batches):
        state, m = steps[not _frozen(i, frozen_from)](state, batch, key)
        metrics.append({k: float(v) for k, v in m.items()})
    adam = state.opt_state[1]
    return dict(sd0=sd0, batches=batches, metrics=metrics, trajectory=trajectory,
                sd=from_jax_variables(_np(state.params), _np(state.batch_stats),
                                      np.array(state.memory_bank)),
                mu=from_jax_variables(_np(adam.mu), {}),
                nu=from_jax_variables(_np(adam.nu), {}),
                step=int(state.step))


@pytest.fixture(scope="module")
def batches():
    return _batches()


@pytest.fixture(scope="module")
def run(batches):
    return _jax_trajectory(FIRST_EPOCHS, batches)


@pytest.fixture(scope="module")
def run_last(batches):
    return _jax_trajectory(LAST_EPOCH, batches)


def _port_trajectory(run, perturb_seed=None):
    """The port's five steps from the JAX run's initial state (its weights
    perturbed by ``PERTURB`` relative noise of ``perturb_seed``), on the
    same batches: ``(state, metrics, BN statistics before the first frozen
    step)``."""
    flags, start, frozen_from = run["trajectory"]
    config = ExperimentConfig(**flags).validate()
    sd = {k: v.clone() for k, v in run["sd0"].items()}
    if perturb_seed is not None:
        gen = torch.Generator().manual_seed(perturb_seed)
        for k, v in sd.items():
            if k.endswith("weight"):
                v.mul_(1 + PERTURB * torch.randn(v.shape, generator=gen))
    model = build_model(config, device="cpu")
    model.load_state_dict(sd, strict=True)
    state = create_train_state(config, device="cpu", model=model)
    state.step = start
    steps = {mt: make_pacing_train_step(config, STEPS_PER_EPOCH, module_train=mt)
             for mt in (True, False)}
    metrics, stats = [], None
    for i, batch in enumerate(run["batches"]):
        if i == frozen_from:
            stats = {k: v.clone() for k, v in state.model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
        m = steps[not _frozen(i, frozen_from)](state, {k: _nchw(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, stats


def _port_runs(run):
    """The port's trajectory and the perturbed ones."""
    state, metrics, stats = _port_trajectory(run)
    return dict(state=state, metrics=metrics, stats_epoch0=stats,
                perturbed=[_port_trajectory(run, s)[0] for s in PERTURB_SEEDS])


@pytest.fixture(scope="module")
def port(run):
    return _port_runs(run)


@pytest.fixture(scope="module")
def port_last(run_last):
    return _port_runs(run_last)


def _bn_fed_conv_bias(name):
    return name.endswith(".conv.bias") or name == "aux_path.layer_bottleneck.1.bias"


def _check_step_count_and_schedule(run, port):
    assert port["state"].step == run["step"] == run["trajectory"][1] + STEPS
    lrs = [m["lr"] for m in port["metrics"]]
    assert len(set(lrs)) == 3                  # three epochs, three rates
    for got, want in zip(port["metrics"], run["metrics"]):
        assert np.isclose(got["lr"], want["lr"], rtol=1e-6)


def _check_metrics(run, port, step):
    got, want = port["metrics"][step], run["metrics"][step]
    assert sorted(got) == sorted(want)
    rtol = 1e-4 if step == 0 else 1e-3
    for k in want:
        assert np.isclose(got[k], want[k], rtol=rtol, atol=0), (k, got[k], want[k])


def _distances(state, other, run, name):
    """Relative L2 distances of one leaf between ``state`` and ``other``
    (JAX's final state when ``other`` is None), on JAX's scales:
    (parameter over the JAX update, first moment, second moment)."""
    p = dict(state.model.named_parameters())[name]
    want, start, mu, nu = run["sd"][name], run["sd0"][name], run["mu"][name], run["nu"][name]
    if other is None:
        q, m, v = want, mu, nu
    else:
        q = dict(other.model.named_parameters())[name].detach()
        m, v = (other.optimizer.state[dict(other.model.named_parameters())[name]][k]
                for k in ("exp_avg", "exp_avg_sq"))
    st = state.optimizer.state[p]
    return np.array([float((p.detach() - q).norm() / (want - start).norm()),
                     float((st["exp_avg"] - m).norm() / mu.norm()),
                     float((st["exp_avg_sq"] - v).norm() / nu.norm())])


def _check_parameters_and_adam_moments(run, port):
    state = port["state"]
    for n, p in state.model.named_parameters():
        assert int(state.optimizer.state[p]["step"]) == STEPS, n
    got, yard = [], []
    for name, _ in state.model.named_parameters():
        if _bn_fed_conv_bias(name):
            continue
        err = _distances(state, None, run, name)
        ref = np.max([_distances(state, o, run, name) for o in port["perturbed"]], axis=0)
        assert (err <= 4 * ref + 1e-3).all(), (name, err, ref)
        if name.startswith(TIGHT):
            assert (err <= 2e-2).all(), (name, err)
        got.append(err)
        yard.append(ref)
    total, total_ref = np.sqrt(np.square(got).sum(0)), np.sqrt(np.square(yard).sum(0))
    assert (total <= total_ref).all(), (total, total_ref)

    lr_max = max(m["lr"] for m in run["metrics"])
    for name, p in state.model.named_parameters():
        diff = float((p.detach() - run["sd"][name]).abs().max())
        assert diff <= 2 * lr_max * STEPS + 1e-6, name


def _check_bn_statistics_and_bank(run, port):
    got = port["state"].model.state_dict()
    for name, want in run["sd"].items():
        if name.endswith(("running_mean", "running_var", "memory_bank")):
            err = float((got[name] - want).abs().max())
            assert err <= 1e-3 * float(want.abs().max()), (name, err)


def test_step_count_and_schedule(run, port):
    _check_step_count_and_schedule(run, port)


@pytest.mark.parametrize("step", range(STEPS))
def test_metrics_match_jax(run, port, step):
    _check_metrics(run, port, step)


def test_parameters_and_adam_moments_match_jax(run, port):
    _check_parameters_and_adam_moments(run, port)


def test_bn_statistics_and_bank_match_jax(run, port):
    _check_bn_statistics_and_bank(run, port)


def test_last_epoch_step_count_and_schedule(run_last, port_last):
    _check_step_count_and_schedule(run_last, port_last)
    epochs = [(LAST_EPOCH[1] + i) // STEPS_PER_EPOCH for i in range(STEPS)]
    assert epochs[-1] == LAST_EPOCH[0]["epoch"] - 1           # the schedule's last


@pytest.mark.parametrize("step", range(STEPS))
def test_last_epoch_metrics_match_jax(run_last, port_last, step):
    _check_metrics(run_last, port_last, step)


def test_last_epoch_parameters_and_adam_moments_match_jax(run_last, port_last):
    _check_parameters_and_adam_moments(run_last, port_last)


def test_last_epoch_bn_statistics_and_bank_match_jax(run_last, port_last):
    _check_bn_statistics_and_bank(run_last, port_last)


def test_frozen_steps_keep_the_statistics_of_epoch_0(port):
    """Steps 3-5 (module_train=False) leave the running statistics where
    step 2 put them: the frozen step's parity with JAX's frozen step is in
    the metrics of steps 3-5 and the final state above."""
    final = port["state"].model.state_dict()
    assert port["stats_epoch0"]
    for name, want in port["stats_epoch0"].items():
        assert torch.equal(final[name], want), name
