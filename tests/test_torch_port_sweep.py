"""The port's sweep CLI and ``--profile_dir`` on the CPU
(``pacingpseudo_torch/cli/sweep.py``, ``train/loop.py``).

* ``_config_hash`` equals JAX's ``pacingpseudo_tpu.cli.sweep._config_hash``
  for several argv: the same result-affecting fields, the run-placement
  ones excluded on both sides, so a fold cache means the same in both
  packages.
* ``python -m pacingpseudo_torch.cli.sweep --gpu cpu`` on a synthetic
  pool, 2 folds of 2 epochs (9 steps each) at 64x64 (the Upperbound
  session at lr 0.003: by its second epoch a fold predicts some foreground,
  Dice ~0.05, so it writes the ``best_ckp`` that inference reads, as in
  JAX only when an epoch's Dice beats 0), writes ``fold{N}.json``,
  ``sweep_summary.json`` and ``sweep_table.md``; the summary's averages
  are JAX's formula (``cli/sweep.py:134-150``) over the fold results; a
  rerun reads the cache, and a changed hyperparameter regenerates the fold.
* A 3-epoch CPU training run with ``--profile_dir`` writes one trace, of
  epoch 1, and logs it.

Torch runs on one thread (module fixture), as in the other port test
files that train.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest
import torch

from pacingpseudo_tpu.cli import sweep as jax_sweep
from pacingpseudo_tpu.cli import train as jax_train
from pacingpseudo_torch.cli import sweep
from pacingpseudo_torch.cli import train as cli

SMALL = ["--input_size", "64", "64", "--init_ch", "8", "--batch_size", "2",
         "--compute_dtype", "float32", "--no-tb_figures"]
SWEEP = ["--gpu", "cpu", "--session", "Upperbound", "--tag", "sw", "--folds", "0", "1",
         "--synthetic_data", "24", "--epoch", "2", "--lr", "0.003", *SMALL]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _jax_args(argv):
    p = jax_train.build_parser()
    p.add_argument("--folds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--sweep_out", type=str, default="")
    p.add_argument("--patient_regex", type=str, default="")
    return p.parse_args(argv)


@pytest.mark.parametrize("argv", [
    ["--tag", "t"],
    ["--tag", "other", "--root", "/elsewhere", "--fold", "3", "--resume",
     "--steps_per_dispatch", "1", "--device_resident_data", "off", "--profile_dir", "p"],
    ["--tag", "t", "--session", "Experiment", "--do_loss_ent", "--do_decoder_consistency",
     "--do_aux_path", "--do_memory", "--epoch", "7"],
    ["--tag", "t", "--dataset", "acdc", "--lr", "0.01", "--input_size", "64", "64",
     "--compute_dtype", "float32", "--optimizer", "momentum"],
    ["--tag", "t", "--synthetic_data", "24", "--synthetic_difficulty", "hard",
     "--max_steps_per_epoch", "3", "--patient_regex", "(pat\\d+)_"],
    ["--tag", "t", "--reference_parity", "--feat_stage", "encoder/stage5"],
])
def test_config_hash_equals_jax(argv):
    got = sweep._config_hash(sweep.build_parser().parse_args(argv), cli.config_from_args)
    want = jax_sweep._config_hash(_jax_args(argv), jax_train.config_from_args)
    assert got == want


def test_placement_fields_keep_the_hash_and_hyperparameters_change_it():
    base = ["--tag", "t"]
    h = sweep._config_hash(sweep.build_parser().parse_args(base), cli.config_from_args)
    moved = sweep.build_parser().parse_args(
        ["--tag", "x", "--root", "/r", "--fold", "2", "--steps_per_dispatch", "1",
         "--gpu", "cpu"])
    assert sweep._config_hash(moved, cli.config_from_args) == h
    for extra in (["--epoch", "7"], ["--lr", "0.01"], ["--init_ch", "16"]):
        args = sweep.build_parser().parse_args(base + extra)
        assert sweep._config_hash(args, cli.config_from_args) != h, extra


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    argv = [*SWEEP, "--data_root", str(root / "data"), "--root", str(root / "out")]
    return root, argv, sweep.main(argv)


def test_the_sweep_writes_folds_summary_and_table(swept):
    root, _, summary = swept
    out = root / "out" / "sweep-sw"
    folds = {f: json.load(open(out / f"fold{f}.json")) for f in (0, 1)}
    for f, res in folds.items():
        assert set(res) == {"_config_hash", "dice", "hd95", "dice_per_patient",
                            "hd95_per_patient", "num_patients", "run_dir"}
        assert 0.0 <= res["dice"] <= 1.0 and res["num_patients"] >= 1
        assert os.path.isfile(os.path.join(res["run_dir"], "inference", "eval_data.npz"))
        assert f"-fold{f}-sw" in res["run_dir"]
    assert json.load(open(out / "sweep_summary.json")) == summary
    dices = [folds[f]["dice"] for f in (0, 1)]
    hd95s = [folds[f]["hd95"] for f in (0, 1)]
    # JAX's formula (pacingpseudo_tpu/cli/sweep.py:134-150)
    assert summary["dataset"] == "chaost1" and summary["session"] == "Upperbound"
    assert summary["overall_dice"] == float(np.mean(dices))
    assert summary["overall_hd95"] == pytest.approx(float(np.nanmean(hd95s)), nan_ok=True)
    assert summary["overall_dice_per_patient"] == float(np.mean(
        [folds[f]["dice_per_patient"] for f in (0, 1)]))
    table = open(out / "sweep_table.md").read()
    assert table.splitlines()[0] == "| Metric | Fold 0 | Fold 1 | Overall |"
    assert f"| DSC | {dices[0]:.4f} | {dices[1]:.4f} | {summary['overall_dice']:.4f} |" in table
    assert "| HD95 (mm) |" in table


def test_a_rerun_reads_the_cache_and_a_new_setting_regenerates(swept, capsys):
    root, argv, summary = swept
    capsys.readouterr()
    again = sweep.main(argv)
    out = capsys.readouterr().out
    assert "fold 0: cached" in out and "fold 1: cached" in out
    assert again == summary
    changed = sweep.main([*argv[:argv.index("--folds")], "--folds", "0",
                          *argv[argv.index("--folds") + 3:], "--loss_dice", "False"])
    out = capsys.readouterr().out
    assert "fold 0: cached result has config hash" in out and "regenerating" in out
    new = json.load(open(root / "out" / "sweep-sw" / "fold0.json"))
    assert new["_config_hash"] != summary["folds"]["0"]["_config_hash"]
    assert changed["folds"]["0"]["run_dir"] != summary["folds"]["0"]["run_dir"]


def test_profile_dir_writes_one_trace(tmp_path):
    profile = tmp_path / "profile"
    run_dir = cli.main(["--gpu", "cpu", "--tag", "prof", "--session", "Upperbound",
                        *SMALL, "--epoch", "3", "--max_steps_per_epoch", "1",
                        "--synthetic_data", "24", "--data_root", str(tmp_path / "data"),
                        "--root", str(tmp_path / "out"), "--profile_dir", str(profile)])
    traces = glob.glob(str(profile / "*"))
    assert [os.path.basename(t) for t in traces] == ["trace_epoch001.json"]
    trace = json.load(open(traces[0]))
    assert trace["traceEvents"]
    log = open(os.path.join(run_dir, "log.txt")).read()
    assert f"profiler trace written to {traces[0]}" in log
