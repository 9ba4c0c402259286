"""Port parity at the LVSC configuration, and the LVSC rehearsal's scripts.

* ``test_lvsc_train_step_matches_jax``: the Experiment step at LVSC's two
  classes (a two-row memory bank, one row cold) on a heterogeneous raw batch
  (extents jittered around the 64x64 crop, padded to a canvas rounded up to
  32, as ``SliceDataset`` pads them) that JAX's ``augment_batch`` cropped and
  embedded, against the JAX step from the same state, at
  ``tests/test_torch_port_step.py``'s bounds for its default case (CPU,
  float32, init_ch 8).
* The port's writer with ``scripts/gen_lvsc_data.py``'s arguments, at a
  small size, equals the JAX package's writer file for file, fold lists
  included.
* ``scripts/lvsc_rehearsal_torch.py``: its identity check on such a pool
  passes on the pool's counts and exits non-zero on a wrong one; its train
  and inference argv carry every flag that ``scripts/lvsc_rehearsal_r5.sh``
  gives ``train_chaos.py`` and ``inference.py``, read from that file.
* ``scripts/lvsc_compare.py``: JAX's kept run read as a port run passes
  rules (a)-(c); a flat trajectory at 0.96 fails (b) in epochs 12-17 only
  (a flat 0.97 would also fail window 0-5, whose band tops at 0.9690); a
  run without ``eval.log`` leaves (c) not evaluated.
"""
import os
import re
import shlex
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pacingpseudo_tpu.aug.engine import augment_batch
from pacingpseudo_tpu.aug.params import BaseAugParams, StrongAugParams
from pacingpseudo_tpu.config import ExperimentConfig as JaxConfig
from pacingpseudo_tpu.data.synthetic import write_synthetic_dataset as jax_write
from pacingpseudo_tpu.models import PacingPseudoModel as JaxPacing
from pacingpseudo_tpu.tools.torch_import import convert_state_dict
from pacingpseudo_tpu.train import optim as jax_optim
from pacingpseudo_tpu.train.state import TrainState as JaxState
from pacingpseudo_tpu.train.step import make_pacing_train_step as jax_train_step
from pacingpseudo_torch.config import ExperimentConfig
from pacingpseudo_torch.data.synthetic import write_synthetic_dataset as port_write
from pacingpseudo_torch.models.unet import torch_default_init_
from pacingpseudo_torch.tools.weights import from_jax_variables
from pacingpseudo_torch.train.state import build_model, create_train_state
from pacingpseudo_torch.train.step import make_pacing_train_step
from scripts import lvsc_compare
from scripts import lvsc_rehearsal_torch as rehearsal
from test_torch_port_step import (FLAGS, HID, INIT_CH, N, S, STEPS_PER_EPOCH,
                                  _assert_grads_close, _assert_new_params_close, _compiled,
                                  _grad_stash, _np, _port_batch, _slope)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 2                                   # LVSC: background and myocardium
LVSC_FLAGS = {**FLAGS, "dataset": "lvsc", "num_classes": C, "ignored_index": C}
EXTENTS = ((70, 58), (60, 72))          # live extents around the 64x64 crop
CANVAS = 96                             # the largest extent rounded up to 32
POOL_SLICES, POOL_SIZE, POOL_JITTER = 240, (64, 64), 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread in this module: the tier-1 run's six workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _raw_batch():
    """Two slices of the extents ``EXTENTS`` on a ``CANVAS`` canvas, padded
    as ``SliceDataset.load`` pads them: image 0, label and scribble the
    ignore index outside the live region."""
    rs = np.random.RandomState(0)
    image = np.zeros((N, CANVAS, CANVAS), np.float32)
    label = np.full((N, CANVAS, CANVAS), C, np.float32)
    scribble = np.full((N, CANVAS, CANVAS), C, np.float32)
    for i, (h, w) in enumerate(EXTENTS):
        image[i, :h, :w] = rs.randn(h, w)
        label[i, :h, :w] = rs.randint(0, C, (h, w))
        pick = rs.rand(h, w) < 0.1
        scb = np.full((h, w), C, np.float32)
        scb[pick] = rs.randint(0, C, pick.sum())
        scribble[i, :h, :w] = scb
    return {"image": jnp.asarray(image), "label": jnp.asarray(label),
            "scribble": jnp.asarray(scribble),
            "size": jnp.asarray(np.array(EXTENTS, np.int32))}


def _augmented():
    base = BaseAugParams(crop_size=(S, S), num_classes=C, ignored_index=C)
    augment = jax.jit(lambda r, k: augment_batch(r, k, base, StrongAugParams.color(1.0),
                                                 True))
    return _np(_compiled(augment, _raw_batch(), jax.random.key(3, impl="rbg")))


def _initial_state_dict():
    """The port's seeded init with a two-row bank: background warm, the
    myocardium's row cold."""
    model = build_model(ExperimentConfig(**LVSC_FLAGS).validate(), device="cpu")
    torch_default_init_(model, torch.Generator().manual_seed(5))
    bank = np.random.RandomState(6).randn(C, HID).astype(np.float32)
    bank[1] = 0.0
    model.aux_path.memory_bank.copy_(torch.from_numpy(bank)[:, :, None, None])
    return {k: v.clone() for k, v in model.state_dict().items()}


def _jax_run(slope=None):
    """The JAX step from ``_initial_state_dict`` on ``_augmented``'s batch,
    every ConvLayer's LeakyReLU at ``slope`` (None: the model's own)."""
    batch = _augmented()
    sd0 = _initial_state_dict()
    params, stats, bank = convert_state_dict({k: v.numpy() for k, v in sd0.items()})
    config = JaxConfig(**LVSC_FLAGS).validate()
    model = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=True, hid_ch=HID,
                      aux_on_strong=config.aux_on_strong, fuse_streams=config.fuse_streams,
                      s2d_hires=False, dtype=jnp.float32)
    tx = optax.chain(_grad_stash(), jax_optim.make_optimizer(config, STEPS_PER_EPOCH))
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                     opt_state=tx.init(params), memory_bank=jnp.asarray(bank))
    with _slope(slope):
        step = jax_train_step(config, model, tx, STEPS_PER_EPOCH, donate=False)
        new_state, metrics = _compiled(step, state, batch, jax.random.key(0, impl="rbg"))
    return dict(sd0=sd0, batch=batch, metrics=_np(metrics), grads=_np(new_state.opt_state[0]),
                new_sd=from_jax_variables(_np(new_state.params), _np(new_state.batch_stats),
                                          np.array(new_state.memory_bank)))


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(slope):
        if slope not in cache:
            cache[slope] = _jax_run(slope)
        return cache[slope]

    return get


def test_lvsc_batch_is_cropped_from_heterogeneous_extents(jax_runs):
    """The batch is the crop and embed of slices larger and smaller than the
    crop: each sample's valid region is neither empty nor the whole crop."""
    batch = jax_runs(None)["batch"]
    assert batch["image"].shape == (N, S, S, 1) and batch["label"].shape == (N, S, S, C)
    valid = batch["valid_mask"][..., 0]
    assert all(0 < valid[i].sum() < S * S for i in range(N))


@pytest.mark.parametrize("slope", [None, 1.0], ids=["model_slope", "slope1"])
def test_lvsc_train_step_matches_jax(jax_runs, slope):
    """At the model's LeakyReLU slope: the metrics, BatchNorm statistics and
    the bank.  At slope 1 (no branch): those, every gradient leaf and Adam's
    first step too.  At the model's slope a pre-activation of this batch
    lies nearer 0 than the two float32 forwards' difference and takes the
    other branch on one side, which puts every leaf upstream 0.5-2.1% of its
    norm off (``enc_block1`` the most); at slope 1 every leaf but the
    BN-fed conv biases agrees within 1e-4 of its norm (both measured on the
    CPU).  ``test_torch_port_step.py``'s single-stream cases take slope 1
    for the same reason."""
    run = jax_runs(slope)
    config = ExperimentConfig(**LVSC_FLAGS).validate()
    model = build_model(config, device="cpu")
    model.load_state_dict(run["sd0"], strict=True)
    state = create_train_state(config, device="cpu", model=model)
    with _slope(slope):
        metrics = make_pacing_train_step(config, STEPS_PER_EPOCH)(
            state, _port_batch(run["batch"]))
    assert state.step == 1

    assert sorted(metrics) == sorted(run["metrics"])
    for k, want in run["metrics"].items():
        assert np.isclose(float(metrics[k]), float(want), rtol=1e-4, atol=0), k

    if slope is not None:
        params = dict(state.model.named_parameters())
        want_grads = from_jax_variables(run["grads"], {})
        _assert_grads_close(params, want_grads)
        _assert_new_params_close(params, run["sd0"], want_grads, run["new_sd"],
                                 float(run["metrics"]["lr"]), config.wd)

    got_sd = state.model.state_dict()
    assert tuple(got_sd["aux_path.memory_bank"].shape[:2]) == (C, HID)
    for name, want in run["new_sd"].items():
        if name.endswith(("running_mean", "running_var", "memory_bank")):
            err = float((got_sd[name] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (name, err)


def _pool_args():
    return dict(num_classes=C, ignored_index=C, modality="t1", seed=1,
                size_jitter=POOL_JITTER, difficulty="easy")


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    root = tmp_path_factory.mktemp("lvsc_pools")
    out = {}
    for name, write in (("jax", jax_write), ("port", port_write)):
        out[name] = str(root / name)
        write(out[name], "lvsc", POOL_SLICES, POOL_SIZE, **_pool_args())
    return out


def test_port_writer_equals_jax_writer_at_lvsc_arguments(pools):
    base = {k: os.path.join(v, "lvsc") for k, v in pools.items()}
    files = {k: sorted(os.listdir(os.path.join(v, "slices"))) for k, v in base.items()}
    assert files["port"] == files["jax"]
    assert len([f for f in files["port"] if f.endswith(".npz")]) == POOL_SLICES
    shapes = set()
    for name in files["port"]:
        if not name.endswith(".npz"):
            continue
        got, want = (np.load(os.path.join(base[k], "slices", name)) for k in ("port", "jax"))
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert np.array_equal(got[key], want[key]), (name, key)
        shapes.add(want["img"].shape)
    assert len(shapes) > 1                          # the extents are jittered
    split = os.path.join("train_test_split", "five_fold_split")
    lists = {k: sorted(os.listdir(os.path.join(v, split))) for k, v in base.items()}
    assert lists["port"] == lists["jax"] and len(lists["port"]) == 10
    for name in lists["port"]:
        texts = [open(os.path.join(base[k], split, name)).read() for k in ("port", "jax")]
        assert texts[0] == texts[1], name


def test_rehearsal_identity_check(pools):
    got = rehearsal.identity(pools["port"])
    # 240 slices in 10 pseudo-patients of 24, fold 0 testing patients 0 and 5
    assert got == {"train": 192, "val": 48, "patients": 2, "canvas": 96, "steps": 16}
    assert rehearsal.check_identity(pools["port"], got) == got
    for key in got:
        with pytest.raises(SystemExit):
            rehearsal.check_identity(pools["port"], {**got, key: got[key] + 1})


def _shell_flags(path, start, end):
    """``flag -> value`` (None for a switch) of the command in lines
    ``start``-``end`` (1-based, both included) of a shell script."""
    with open(path) as f:
        lines = f.read().splitlines()[start - 1:end]
    words = shlex.split(" ".join(line.rstrip("\\").strip() for line in lines))
    flags = {}
    for i, w in enumerate(words):
        if w.startswith("--"):
            nxt = words[i + 1] if i + 1 < len(words) else None
            flags[w] = None if nxt is None or nxt.startswith("--") else nxt
    return flags


def _argv_flags(argv):
    return {w: (argv[i + 1] if i + 1 < len(argv) and not argv[i + 1].startswith("--")
                else None) for i, w in enumerate(argv) if w.startswith("--")}


def test_rehearsal_argv_carries_the_jax_scripts_flags():
    script = os.path.join(ROOT, "scripts", "lvsc_rehearsal_r5.sh")
    text = open(script).read().splitlines()
    assert "python train_chaos.py --dataset lvsc" in text[71]
    assert "python inference.py --dataset lvsc" in text[91]
    # "$EPOCHS" is 36 in the kept run (chain_r5.log), "$SLICES" the default
    values = {"$EPOCHS": str(rehearsal.EPOCHS), "$SLICES": str(rehearsal.SLICES)}
    paths = ("--data_root", "--run_dir", "--checkpoint_file", "--root")
    for (a, b), argv in (((72, 76), rehearsal.train_argv("lvsc_torch", rehearsal.SLICES, "0",
                                                          0)),
                         ((92, 94), rehearsal.inference_argv("lvsc_torch", "0"))):
        want = _shell_flags(script, a, b)
        got = _argv_flags(argv)
        assert want and set(want) <= set(got), sorted(set(want) - set(got))
        for flag, value in want.items():
            if flag in paths:
                continue
            assert got[flag] == values.get(value, value), flag
    with open(os.path.join(ROOT, "lvsc_rehearsal", "chain_r5.log")) as f:
        assert re.search(r"LVSC rehearsal at (\d+) epochs", f.read())[1] == str(rehearsal.EPOCHS)


def _port_layout(tmp_path, valdice=None, with_eval=True):
    """JAX's kept run laid out as ``lvsc_rehearsal_torch.py`` leaves a port
    run; ``valdice`` replaces its validation Dice."""
    jax_root = os.path.join(ROOT, "lvsc_rehearsal")
    port = tmp_path / "port"
    shutil.copytree(os.path.join(jax_root, "run-fold0"), port / "run-fold0")
    if valdice is not None:
        np.savez(port / "run-fold0" / "valdice", valdice=valdice)
    if with_eval:
        shutil.copyfile(os.path.join(jax_root, "eval_r5.log"), port / "eval.log")
    out = lvsc_compare.main(["--jax", jax_root, "--port", str(port)])
    assert os.path.isfile(port / "compare.json")
    return out


def test_compare_passes_jax_read_as_a_port_run(tmp_path):
    out = _port_layout(tmp_path)
    assert out["identity"]["pass"]
    assert {k: r["verdict"] for k, r in out["rules"].items()} == dict.fromkeys("abc", "pass")
    assert out["verdict"] == "pass"


def test_compare_flat_trajectory_fails_the_fall_only(tmp_path):
    valdice = np.zeros(36)
    valdice[:18] = 0.96
    out = _port_layout(tmp_path, valdice)
    checks = {c["window"]: c["pass"] for c in out["rules"]["b"]["checks"]}
    assert checks == {"0-5": True, "6-11": True, "12-17": False}
    assert out["rules"]["a"]["verdict"] == "pass" and out["verdict"] == "fail"


def test_compare_without_eval_log(tmp_path):
    valdice = np.load(os.path.join(ROOT, "lvsc_rehearsal", "run-fold0", "valdice.npz"))
    cut = valdice["valdice"].copy()
    cut[12:] = 0.0                                  # stopped after epoch 11
    out = _port_layout(tmp_path, cut, with_eval=False)
    assert out["rules"]["c"]["verdict"] == "not evaluated"
    checks = {c["window"] for c in out["rules"]["b"]["checks"]}
    assert checks == {"0-5", "6-11"}                # 12-17 not reached
    assert out["verdict"] == "incomplete"
