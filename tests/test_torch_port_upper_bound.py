"""Port parity: the Upperbound session of ``pacingpseudo_torch`` against
``pacingpseudo_tpu`` (CPU, float32, 64x64, init_ch 8, batch 2, 4 classes,
``loss_dice`` on).

Both sides start from the same state: the port's seeded init of the bare
model that an Upperbound config builds (no aux path, no bank), with
BatchNorm statistics and affine parameters drawn from a seed, carried to
JAX by the JAX package's importer.  The BatchNorm shift is drawn away
from its init of 0 because of the crop padding: there the first layer's
input is 0, so its
pre-activation is ``(bias - mean)·scale + shift`` with ``bias - mean`` at
roundoff, and with a shift of 0 the LeakyReLU branch of the whole padding
is decided by roundoff (at the init, the first BatchNorm's shift gradient
of the port's float32 step is 34% and JAX's 132% of its norm off a float64
evaluation; every other leaf agrees with it to 1e-5).  The batch
is one the JAX ``augment_batch`` made without the strong stream from raw
slices smaller than the crop, so that the crop leaves padding: label rows
that are all zero, which both sides train as background.  The JAX side's
gradients are read from an identity stage in front of its optimizer; its
programs are compiled at XLA backend optimization level 0 and draw from an
``rbg`` key, as in ``tests/test_torch_port_step.py``.

Tolerances: ``loss_ce``, ``loss_dice`` and ``loss_total`` rtol 1e-4; BN
statistics within 1e-4 x max.  Gradients and new parameters: under the
conventions of ``tests/test_torch_port_step.py``'s docstring and for its
reasons (two float32 forwards differ by up to ~5e-5 in a BatchNorm output,
which flips the LeakyReLU branch of single pixels whose pre-activation lies
nearer 0): each leaf within 2e-2 of its L2 norm, the leaves before any
branch (``dec_block1``, ``final_conv``) within 1e-3 x max.  The L2 bound is
the float32 error of either side here: against a float64 evaluation of the
same step, JAX's gradient is off by up to 1.6e-2 of a leaf's norm
(``enc_block1``) and the port's by up to 1.0e-2; the two sides differ by up
to 1.4e-2.  The eval step:
the losses rtol 1e-4, the logits within 1e-4 x max, the per-class Dice
within 1e-6.  The resident
validation: the loss sum rtol 1e-4, the Dice sums within 1e-2 (a pixel whose
top two logits lie within the logits' error may take the other class).

Also: the frozen-BN step keeps the running statistics, ``torch.argmax`` of
an all-zero row is 0, and a two-epoch ``--session Upperbound`` CLI run on
the CPU logs ``loss_ce`` and ``loss_dice``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pacingpseudo_tpu.aug.engine import augment_batch
from pacingpseudo_tpu.aug.params import BaseAugParams
from pacingpseudo_tpu.config import ExperimentConfig as JaxConfig
from pacingpseudo_tpu.models import PacingPseudoModel as JaxPacing
from pacingpseudo_tpu.tools.torch_import import convert_state_dict
from pacingpseudo_tpu.train import optim as jax_optim
from pacingpseudo_tpu.train.state import TrainState as JaxState
from pacingpseudo_tpu.train.step import make_resident_eval_fn as jax_resident_eval
from pacingpseudo_tpu.train.step import make_upper_bound_eval_step as jax_eval_step
from pacingpseudo_tpu.train.step import make_upper_bound_train_step as jax_train_step
from pacingpseudo_torch.cli import train as train_cli
from pacingpseudo_torch.config import ExperimentConfig
from pacingpseudo_torch.data.npz_dataset import SliceDataset
from pacingpseudo_torch.data.splits import read_fold_split
from pacingpseudo_torch.data.synthetic import write_synthetic_dataset
from pacingpseudo_torch.models.unet import torch_default_init_
from pacingpseudo_torch.tools.weights import from_jax_variables
from pacingpseudo_torch.train import loop
from pacingpseudo_torch.train.state import build_model, create_train_state
from pacingpseudo_torch.train.step import (make_upper_bound_eval_step,
                                           make_upper_bound_train_step)

N, S, C, INIT_CH = 2, 64, 4, 8
STEPS_PER_EPOCH = 4
FLAGS = dict(session="Upperbound", num_classes=C, ignored_index=C, init_ch=INIT_CH,
             batch_size=N, loss_dice=True, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread in this module: the tier-1 run's six workers
    share the machine's cores, and a worker's own pool of a thread a core
    only oversubscribes them (this file's fixture took 17x as long under
    six workers as alone with the default pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


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
    """A JAX-augmented batch of raw 40x48 and 52x64 slices on 64x64 canvases:
    the 64x64 crop leaves padding."""
    rs = np.random.RandomState(0)
    label = np.full((N, S, S), C, np.float32)         # canvas padding: ignored
    label[0, :40, :48] = rs.randint(0, C, (40, 48))
    label[1, :52, :] = rs.randint(0, C, (52, S))
    raw = {"image": jnp.asarray(rs.randn(N, S, S), jnp.float32),
           "label": jnp.asarray(label),
           "scribble": jnp.asarray(label),
           "size": jnp.asarray([[40, 48], [52, 64]], jnp.int32)}
    base = BaseAugParams(crop_size=(S, S), num_classes=C, ignored_index=C)
    augment = jax.jit(lambda r, k: augment_batch(r, k, base, None, False))
    return _np(_compiled(augment, raw, jax.random.key(3, impl="rbg")))


def _initial_state_dict():
    model = build_model(ExperimentConfig(**FLAGS).validate(), device="cpu")
    torch_default_init_(model, torch.Generator().manual_seed(5))
    rs = np.random.RandomState(6)
    draws = {"running_mean": lambda shape: 0.1 * rs.randn(*shape),
             "running_var": lambda shape: rs.uniform(0.5, 1.5, shape),
             "norm_op.weight": lambda shape: rs.uniform(0.8, 1.2, shape),
             "norm_op.bias": lambda shape: 0.1 * rs.randn(*shape)}
    with torch.no_grad():
        for name, t in model.state_dict(keep_vars=True).items():
            for suffix, draw in draws.items():
                if name.endswith(suffix):
                    t.copy_(torch.from_numpy(draw(t.shape).astype(np.float32)))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _jax_model():
    return JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=False, s2d_hires=False,
                     dtype=jnp.float32)


@pytest.fixture(scope="module")
def run():
    """The JAX upper-bound step and eval step from the shared state and batch."""
    sd0 = _initial_state_dict()
    assert not any(k.startswith("aux_path.") for k in sd0)
    batch = _batch()
    params, stats, bank = convert_state_dict({k: v.numpy() for k, v in sd0.items()})
    assert bank is None and list(params) == ["backbone"]
    config = JaxConfig(**FLAGS).validate()
    model = _jax_model()
    tx = optax.chain(_grad_stash(), jax_optim.make_optimizer(config, STEPS_PER_EPOCH))
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                     opt_state=tx.init(params), memory_bank=None)
    step = jax_train_step(config, model, tx, STEPS_PER_EPOCH, donate=False)
    new_state, metrics = _compiled(step, state, batch, jax.random.key(0, impl="rbg"))
    loss_ce, loss_dice, dice, logits = _compiled(jax_eval_step(config, model), state, batch)
    return dict(sd0=sd0, batch=batch, metrics=_np(metrics), jax_state=state,
                grads=_np(new_state.opt_state[0]),
                new_sd=from_jax_variables(_np(new_state.params),
                                          _np(new_state.batch_stats)),
                eval=(float(loss_ce), float(loss_dice), np.array(dice), _nchw(logits)))


def _port_state(sd0, **overrides):
    config = ExperimentConfig(**{**FLAGS, **overrides}).validate()
    model = build_model(config, device="cpu")
    model.load_state_dict(sd0, strict=True)
    return config, create_train_state(config, device="cpu", model=model)


def _port_batch(batch):
    return {k: _nchw(v) for k, v in batch.items()}


def test_the_batch_has_crop_padding(run):
    label = run["batch"]["label"]
    assert label.shape == (N, S, S, C)
    padded = label.sum(-1) == 0
    assert 0 < padded.mean() < 0.5
    assert "image_strong" not in run["batch"]


def test_argmax_of_an_all_zero_row_is_the_first_class():
    rows = torch.zeros(3, C, 2, 2)
    rows[1, 2] = 1.0
    assert rows.argmax(dim=1).tolist() == [[[0, 0], [0, 0]], [[2, 2], [2, 2]], [[0, 0], [0, 0]]]
    assert np.asarray(jnp.argmax(jnp.zeros((2, C)), axis=-1)).tolist() == [0, 0]


@pytest.mark.parametrize("session", ["Upperbound", "Experiment"])
def test_the_session_decides_the_aux_path(session):
    """An Upperbound config builds the bare model whatever ``do_aux_path``
    says, as JAX's loop does; another session keeps the aux path."""
    config = ExperimentConfig(**{**FLAGS, "session": session, "do_aux_path": True,
                                 "do_memory": True}).validate()
    model = build_model(config, device="meta")
    assert model.do_aux_path == (session != "Upperbound")
    assert any(k.startswith("aux_path.") for k in model.state_dict()) == model.do_aux_path


def test_train_step_matches_jax(run):
    config, state = _port_state(run["sd0"])
    assert not state.model.do_aux_path and state.memory_bank is None
    metrics = make_upper_bound_train_step(config, STEPS_PER_EPOCH)(
        state, _port_batch(run["batch"]))
    assert state.step == 1
    assert sorted(metrics) == sorted(run["metrics"]) == ["loss_ce", "loss_dice",
                                                         "loss_total", "lr"]
    for k, want in run["metrics"].items():
        assert np.isclose(float(metrics[k]), float(want), rtol=1e-4, atol=0), k

    params = dict(state.model.named_parameters())
    want_grads = from_jax_variables(run["grads"], {})
    lr, wd = float(run["metrics"]["lr"]), config.wd
    for name, p in params.items():
        want = want_grads[name]
        if name.endswith(".conv.bias"):
            # feeds a BatchNorm: the true gradient is 0, both sides roundoff
            bound = 1e-4 * float(want_grads[name[:-4] + "weight"].abs().max())
            assert float(p.grad.abs().max()) <= bound and float(want.abs().max()) <= bound
            assert float((p.detach() - run["new_sd"][name]).abs().max()) <= 2 * lr + 1e-7
            continue
        assert float((p.grad - want).norm()) <= 2e-2 * float(want.norm()), name
        if name.startswith(("backbone.dec_block1.", "backbone.final_conv.")):
            assert float((p.grad - want).abs().max()) <= 1e-3 * float(want.abs().max()), name
        # Adam's first step moves each element by lr·g/(|g|+1e-8), g = grad
        # + wd·p: ±lr where |g| >> 1e-8.  So the new values agree within
        # 1e-6 where the two sides' g share a sign and exceed 1e-6, and are
        # 2·lr apart at most anywhere.
        err = (p.detach() - run["new_sd"][name]).abs()
        g_got, g_want = (g + wd * run["sd0"][name] for g in (p.grad, want))
        same = (torch.sign(g_got) == torch.sign(g_want)) & (g_got.abs().minimum(
            g_want.abs()) > 1e-6)
        assert float(torch.where(same, err, 0.0).max()) <= 1e-6, name
        assert float(err.max()) <= 2 * lr + 1e-6, name

    got_sd = state.model.state_dict()
    for name, want in run["new_sd"].items():
        if name.endswith(("running_mean", "running_var")):
            err = float((got_sd[name] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (name, err)


def test_frozen_bn_step_keeps_the_running_statistics(run):
    config, state = _port_state(run["sd0"])
    metrics = make_upper_bound_train_step(config, STEPS_PER_EPOCH, module_train=False)(
        state, _port_batch(run["batch"]))
    assert state.model.training is False and np.isfinite(float(metrics["loss_total"]))
    got = state.model.state_dict()
    for name, want in run["sd0"].items():
        if name.endswith(("running_mean", "running_var")):
            assert torch.equal(got[name], want), name
    assert not torch.equal(got["backbone.final_conv.weight"],
                           run["sd0"]["backbone.final_conv.weight"])


def test_eval_step_matches_jax(run):
    config, state = _port_state(run["sd0"])
    loss_ce, loss_dice, dice, logits = make_upper_bound_eval_step(config)(
        state, _port_batch(run["batch"]))
    want_ce, want_dice_loss, want_dice, want_logits = run["eval"]
    assert state.model.training
    assert np.isclose(float(loss_ce), want_ce, rtol=1e-4)
    assert np.isclose(float(loss_dice), want_dice_loss, rtol=1e-4)
    assert float((logits - want_logits).abs().max()) <= 1e-4 * float(want_logits.abs().max())
    # the per-class Dice is of the softmax (no argmax): its values on every
    # slice and class to 1e-6, its NaNs (a class absent from the slice) equal
    np.testing.assert_allclose(dice.numpy(), want_dice, rtol=0, atol=1e-6, equal_nan=True)


def test_resident_validation_matches_jax(run, tmp_path):
    """Six validation slices of 56x56 to 60x60 on 64x64 canvases in blocks
    of 4 (the last padded by duplicates), through both packages' resident
    validation with the upper-bound target."""
    write_synthetic_dataset(str(tmp_path), "chaos", 30, (58, 58), 5, 5, seed=2,
                            size_jitter=2)
    _, val_files = read_fold_split(str(tmp_path), "chaos", 1, "t1")
    val_ds = SliceDataset(val_files, 5, 5, canvas_size=S)
    flags = {**FLAGS, "num_classes": 5, "ignored_index": 5, "batch_size": 4}
    assert len(val_ds) == 6
    config = ExperimentConfig(**flags).validate()
    state = create_train_state(config, device="cpu", seed=4)
    pool = loop.stage_val_pool(val_ds, 4, "cpu")
    assert not pool.valid_blocks.all()
    got = loop.make_resident_eval_fn(config)(state, pool)

    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    params, stats, _ = convert_state_dict(sd)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                      opt_state=(), memory_bank=None)
    model = JaxPacing(num_classes=5, init_ch=INIT_CH, do_aux_path=False, s2d_hires=False,
                      dtype=jnp.float32)
    jax_pool = {k: v.numpy() for k, v in pool.raw.items()}
    want = _compiled(jax_resident_eval(JaxConfig(**flags).validate(), model,
                                       upper_bound=True),
                     jstate, jax_pool, pool.idx_blocks.numpy().astype(np.int32),
                     pool.valid_blocks.numpy())
    assert float(got["n_sum"]) == float(want["n_sum"]) == len(val_ds)
    assert np.isclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-4)
    np.testing.assert_array_equal(got["dice_cnt"].numpy(), np.asarray(want["dice_cnt"]))
    np.testing.assert_allclose(got["dice_sum"].numpy(), np.asarray(want["dice_sum"]),
                               atol=1e-2)


def test_cli_trains_the_upper_bound_on_the_cpu(tmp_path):
    """``python -m pacingpseudo_torch.cli.train --gpu cpu --session
    Upperbound ...``, called in this process."""
    run_dir = train_cli.main([
        "--gpu", "cpu", "--session", "Upperbound", "--tag", "ub", "--input_size", str(S),
        str(S), "--init_ch", str(INIT_CH), "--batch_size", "2", "--compute_dtype", "float32",
        "--epoch", "2", "--max_steps_per_epoch", "2", "--ckp_interval", "1",
        "--ref_quirk_bn_eval_after_first_epoch", "--synthetic_data", "24",
        "--data_root", str(tmp_path / "data"), "--root", str(tmp_path / "out")])
    runs = list((tmp_path / "out" / "t1" / "Upperbound").iterdir())
    assert [str(r) for r in runs] == [run_dir]
    assert len(runs) == 1 and runs[0].name.endswith("-fold1-ub")
    run = runs[0]
    for rel in ("log.txt", "config.json", "valdice.npz", "ckps/ckp_0/model.pth",
                "ckps/ckp_1/train.pth"):
        assert (run / rel).is_file(), rel
    log = (run / "log.txt").read_text()
    for line in ("loss_ce", "loss_dice", "loss_total", "epoch: 001, lr: ", "val: 001, loss: ",
                 "epoch 001 on: frozen-BN step"):
        assert line in log, line
    sd = torch.load(run / "ckps" / "ckp_1" / "model.pth")
    assert sd and all(k.startswith("backbone.") for k in sd)
