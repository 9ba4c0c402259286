"""The port's epoch loop, checkpoints and train CLI on the CPU
(``pacingpseudo_torch/train/loop.py``, ``cli/train.py``), at 64x64,
init_ch 8, batch 2, on a seeded synthetic CHAOS pool of 24 slices (fold 1:
18 training, 6 validation).

* ``python -m pacingpseudo_torch.cli.train --gpu cpu --synthetic_data``
  runs two epochs and writes the run's artifacts and log lines.
* A run stopped after epoch 0 (``stop_after_epoch=0``) and resumed equals
  the uninterrupted run bit for bit: parameters, BatchNorm statistics, the
  bank, Adam's state, ``step`` and ``valdice``.  The shuffle order is a
  function of (seed, epoch) and the step's draws of (seed, step), so
  nothing else is needed; the runs go single-threaded, because MKL picks
  its thread count by the machine's load and with it the order of a
  reduction, which would differ between two runs of one process.
* The validation on the device (``make_resident_eval_fn`` over a staged
  ``ValPool``) equals ``ValState`` batch by batch: the loss exactly (the
  same float64 products added in the same order), the per-class Dice to
  float64 roundoff (rtol 1e-12: the device adds a block's samples in its
  own order).
* Every flag of the JAX package's ``build_parser`` parses in the port's to
  the same ``ExperimentConfig`` fields, its default and a value other than
  its default (parametrised over the flags).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pacingpseudo_tpu.cli import train as jax_cli
from pacingpseudo_torch.aug.engine import eval_preprocess_batch
from pacingpseudo_torch.cli import train as cli
from pacingpseudo_torch.config import ExperimentConfig
from pacingpseudo_torch.data.npz_dataset import BatchLoader, SliceDataset, raw_batch_to_device
from pacingpseudo_torch.data.splits import read_fold_split
from pacingpseudo_torch.data.synthetic import write_synthetic_dataset
from pacingpseudo_torch.train import loop
from pacingpseudo_torch.train.state import create_train_state
from pacingpseudo_torch.train.step import make_pacing_eval_step

ROOT = pathlib.Path(__file__).resolve().parent.parent
S, SLICES = 64, 24
SMALL = ["--input_size", str(S), str(S), "--init_ch", "8", "--hid_ch", "16",
         "--batch_size", "2", "--compute_dtype", "float32"]
EXPERIMENT = ["--session", "Experiment", "--do_loss_ent", "--do_decoder_consistency",
              "--do_aux_path", "--do_memory"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pool"))
    write_synthetic_dataset(root, "chaos", SLICES, (S, S), 5, 5, seed=1)
    return root


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _config(**kw):
    args = cli.build_parser().parse_args(["--tag", "t", *SMALL, *EXPERIMENT, "--epoch", "2"])
    return dataclasses.replace(cli.config_from_args(args), **kw).validate()


def test_cli_trains_two_epochs_on_the_cpu(tmp_path):
    argv = [sys.executable, "-m", "pacingpseudo_torch.cli.train", "--gpu", "cpu",
            "--tag", "smoke", *SMALL, *EXPERIMENT, "--epoch", "2",
            "--max_steps_per_epoch", "2", "--ckp_interval", "1",
            "--ref_quirk_bn_eval_after_first_epoch", "--no-tb_figures",
            "--synthetic_data", str(SLICES), "--data_root", str(tmp_path / "data"),
            "--run_dir", str(tmp_path / "run")]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(argv, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = tmp_path / "run"
    for rel in ("log.txt", "config.json", "valdice.npz", "ckps/ckp_0/model.pth",
                "ckps/ckp_1/train.pth"):
        assert (run / rel).is_file(), rel
    log = (run / "log.txt").read_text()
    for line in ("epoch: 000, lr: ", "epoch: 001, lr: ", "val: 000, loss: ", "val: 001, loss: ",
                 "first epoch took", "epoch 001 on: frozen-BN step", "slices/s",
                 "The best at epoch"):
        assert line in log, line
    valdice = np.load(run / "valdice.npz")["valdice"]
    assert valdice.shape == (2,) and np.isfinite(valdice).all()


def _state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        for k, v in state.optimizer.state[p].items():
            out[f"adam.{name}.{k}"] = v
    return out


def test_stop_and_resume_equals_the_uninterrupted_run(data_root, tmp_path, one_thread):
    config = _config(ref_quirk_bn_eval_after_first_epoch=True)
    full_dir, full = loop._train_driver(config, data_root, str(tmp_path / "full"),
                                        max_steps_per_epoch=2, device="cpu")
    part_dir = str(tmp_path / "part")
    loop._train_driver(config, data_root, part_dir, max_steps_per_epoch=2,
                       stop_after_epoch=0, device="cpu")
    assert sorted(os.listdir(os.path.join(part_dir, "ckps"))) == ["ckp_0"]
    _, resumed = loop._train_driver(dataclasses.replace(config, resume=True), data_root,
                                    part_dir, max_steps_per_epoch=2, device="cpu")
    assert "resumed from" in open(os.path.join(part_dir, "log.txt")).read()

    assert full.step == resumed.step == 4
    want, got = _state_tensors(full), _state_tensors(resumed)
    assert sorted(want) == sorted(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    np.testing.assert_array_equal(np.load(os.path.join(part_dir, "valdice.npz"))["valdice"],
                                  np.load(os.path.join(full_dir, "valdice.npz"))["valdice"])


def test_device_validation_equals_valstate(data_root, one_thread):
    config = _config(batch_size=4)        # 6 validation slices: a partial last batch
    state = create_train_state(config, device="cpu", seed=3)
    train_files, val_files = read_fold_split(data_root, "chaos", config.fold, config.modality)
    train_ds = SliceDataset(train_files, 5, 5)
    val_ds = SliceDataset(val_files, 5, 5, canvas_size=train_ds.canvas_size)
    assert len(val_ds) % config.batch_size != 0

    pool = loop.stage_val_pool(val_ds, config.batch_size, "cpu")
    per_class, avg_all, loss = loop.summarize_validation(
        loop.make_resident_eval_fn(config)(state, pool))

    vs = loop.ValState(config.num_classes)
    eval_step = make_pacing_eval_step(config)
    for raw in BatchLoader(val_ds, config.batch_size):
        raw.pop("uid")
        raw, n_real = loop._pad_batch(raw, config.batch_size)
        batch = eval_preprocess_batch(raw_batch_to_device(raw, "cpu"), config.num_classes)
        batch["sample_valid"] = torch.arange(config.batch_size) < n_real
        loss_b, dice, _ = eval_step(state, batch)
        vs.update(loss_b, dice.numpy(), n_real, n_real)
    want_class, want_all = vs.summary()
    assert loss == vs.loss.avg
    np.testing.assert_allclose(per_class, want_class, rtol=1e-12)
    assert np.isclose(avg_all, want_all, rtol=1e-12)
    assert all(np.isfinite(per_class)) and max(per_class) > 0


def test_empty_epoch_raises(data_root, tmp_path):
    with pytest.raises(RuntimeError, match="empty train epoch"):
        loop._train_driver(_config(batch_size=64), data_root, str(tmp_path / "run"),
                           device="cpu")


def test_step_seed_is_a_pure_function():
    seeds = {loop.step_seed(1, k, s) for k in range(50) for s in (0, 1)}
    assert len(seeds) == 100 and all(0 <= x < 2**63 for x in seeds)
    assert loop.step_seed(1, 7) == loop.step_seed(1, 7) != loop.step_seed(2, 7)


def test_gpu_flag_names_the_device():
    assert cli.devices_from_gpu("cpu") == [torch.device("cpu")]
    assert cli.devices_from_gpu("0") == [torch.device("cuda", 0)]
    with pytest.raises(SystemExit):
        cli.devices_from_gpu("cuda0")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop._train_driver(_config(), "unused", "unused", device="cuda")


def _flag_values(action: argparse.Action):
    """argv for ``action``: its default (no argv) and a value other than
    its default."""
    flag = action.option_strings[0]
    if isinstance(action, argparse.BooleanOptionalAction):
        return [[], [f"--no-{flag[2:]}" if action.default else flag]]
    if isinstance(action, argparse._StoreTrueAction):
        return [[], [flag]]
    if action.choices:
        other = next(c for c in action.choices if c != action.default)
        return [[], [flag, str(other)]]
    if action.nargs == "?":                       # the reference's type=bool flags
        return [[], [flag, "False"]]
    if action.nargs == "+":
        return [[], [flag, "encoder/stage4", "encoder/stage3"]]
    if action.nargs == 2:
        return [[], [flag, "32", "48"]]
    if action.type is int:
        return [[], [flag, str((action.default or 0) + 3)]]
    if action.type is float:
        return [[], [flag, str((action.default or 0.0) + 0.25)]]
    return [[], [flag, "somewhere"]]


JAX_FLAGS = [a for a in jax_cli.build_parser()._actions if a.option_strings and a.dest != "help"]


def test_the_parsers_have_the_same_flags():
    port = {a.dest: (a.option_strings, a.default)
            for a in cli.build_parser()._actions if a.option_strings and a.dest != "help"}
    assert len(JAX_FLAGS) == len(port) == 73
    for a in JAX_FLAGS:
        assert port[a.dest] == (a.option_strings, a.default), a.dest
    assert ([f.name for f in dataclasses.fields(ExperimentConfig)]
            == [f.name for f in dataclasses.fields(jax_cli.ExperimentConfig)])


@pytest.mark.parametrize("action", JAX_FLAGS, ids=lambda a: a.dest)
def test_flag_parses_to_the_same_config(action):
    for extra in _flag_values(action):
        argv = (["--tag", "t"] if action.dest != "tag" else []) + extra
        if action.dest == "tag" and not extra:
            argv = ["--tag", "t"]
        want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
        got = cli.config_from_args(cli.build_parser().parse_args(argv))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), argv
