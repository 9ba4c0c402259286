"""The three-arm quality study of the port: ``scripts/quality_study_torch.py``
and ``scripts/quality_study_compare.py`` (CPU).

- Each arm's ``ExperimentConfig``, as the runner builds it, equals the JAX
  package's ``config_from_args`` for the same argv, field by field; no
  field exists on one side only (``ONLY_PORT`` and ``ONLY_JAX`` are empty).
- The ``hard`` pool writer equals JAX's file for file and array for array,
  with the port's scribbles written by host processes.
- The runner on the CPU (12 slices of 64x64, init_ch 8, batch 2, 2 epochs,
  every arm): ``--stop_after_epoch 0`` leaves one epoch and no ``DONE``
  marker; a second call carries each arm on to the end, keeps the first
  epoch in ``valdice.npz``, evaluates it and marks it; the summary has
  three rows.  Without CUDA the runner exits unless ``--device cpu``.
- The compare script: ``study_r3`` against copies of its own files passes
  every rule; Upperbound's curve swapped for Control's fails rule (a); the
  window means and the best epoch of hand-made curves.
"""
import dataclasses
import importlib.util
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from pacingpseudo_tpu.cli import train as jax_train_cli
from pacingpseudo_tpu.data import synthetic as jax_synthetic
from pacingpseudo_torch.data import synthetic
from pacingpseudo_torch.train import loop
from test_torch_port_data import POOL

ROOT = pathlib.Path(__file__).resolve().parent.parent
STUDY_R3 = ROOT / "study_r3"
ARMS = ("Control", "Experiment", "Upperbound")
# Config fields of one package only: none (the port keeps the JAX package's
# TPU knobs, parsed and ignored, and JAX has the dispatch knobs too).
ONLY_PORT = set()
ONLY_JAX = set()
SMALL = ["--input_size", "64", "64", "--init_ch", "8", "--batch_size", "2", "--lr", "5e-3",
         "--no-tb_figures"]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


runner = _load("quality_study_torch")
compare = _load("quality_study_compare")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread in this module (the tier-1 run's six workers share
    the machine's cores; see ``tests/test_torch_port_infer.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("seed", [1, 2])
def test_arm_config_matches_jax(arm, seed, tmp_path):
    argv = runner.train_argv(arm, str(tmp_path), 400, 1916, "hard", seed, "0")
    got = dataclasses.asdict(runner.arm_config(argv))
    want = dataclasses.asdict(jax_train_cli.config_from_args(
        jax_train_cli.build_parser().parse_args(argv)))
    assert set(got) - set(want) == ONLY_PORT and set(want) - set(got) == ONLY_JAX
    for name in set(got) & set(want):
        assert got[name] == want[name], name
    assert got["session"] == arm and got["seed"] == seed and got["epoch"] == 400
    assert got["fold"] == 0 and got["modality"] == "t1"
    assert got["do_memory"] == (arm == "Experiment")
    run_dir = argv[argv.index("--run_dir") + 1]
    assert run_dir == str(tmp_path / (arm + ("" if seed == 1 else f"-s{seed}")) / "run-fold0")


def test_arm_config_matches_the_jax_study(tmp_path):
    """The Experiment arm's config equals ``study_r3``'s on every field that
    both record, but the tag and the git revision."""
    argv = runner.train_argv("Experiment", str(tmp_path), 400, 1916, "hard", 1, "0")
    got = dataclasses.asdict(runner.arm_config(argv))
    want = json.loads((STUDY_R3 / "Experiment" / "run-fold0" / "config.json").read_text())
    differ = {k for k in set(got) & set(want) if got[k] != want[k]
              and not (isinstance(want[k], list) and tuple(want[k]) == got[k])}
    assert differ == {"tag"}
    assert got["tag"] == "study_torch" and want["tag"] == "study_r3"


def test_hard_pool_matches_jax(tmp_path, monkeypatch):
    """JAX's serial writer against the port's with its scribbles in three
    host processes."""
    pool = {**POOL, "num_slices": 12, "difficulty": "hard"}
    want = jax_synthetic.write_synthetic_dataset(str(tmp_path / "jax"), **pool)
    monkeypatch.setattr(synthetic, "SLICES_A_WORKER", 4)
    got = synthetic.write_synthetic_dataset(str(tmp_path / "port"), **pool)
    assert got == want and len(got) == 12
    for sub in ("jax", "port"):
        assert (tmp_path / sub / "chaos" / "slices" / ".generated").is_file()
    trees = [sorted(str(p.relative_to(tmp_path / sub))
                    for p in (tmp_path / sub).rglob("*") if p.is_file())
             for sub in ("jax", "port")]
    assert trees[0] == trees[1]
    for rel in trees[0]:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.endswith(".npz"):
            x, y = np.load(a), np.load(b)
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                assert x[k].dtype == y[k].dtype, (rel, k)
                np.testing.assert_array_equal(x[k], y[k])
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def test_runner_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match="no CUDA device"):
        runner.main(["--root", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def _epochs_logged(run_dir):
    log = (run_dir / "log.txt").read_text()
    return sum(f"val: {e:03d}," in log for e in range(10))


def test_runner_stops_and_resumes_on_the_cpu(tmp_path, monkeypatch):
    """Every arm stopped after epoch 0, then carried on to epoch 1.  The
    loop's TensorBoard writer is left out: where TensorFlow is installed,
    importing it takes ~15 s, and the test holds no TensorBoard output."""
    monkeypatch.setattr(loop, "_tb_writer", lambda run_dir: None)
    root = tmp_path / "study"
    args = ["--root", str(root), "--device", "cpu", "--epochs", "2", "--slices", "12"]
    runner.main(args + ["--stop_after_epoch", "0", "--", *SMALL])
    for arm in ARMS:
        run_dir = root / arm / "run-fold0"
        assert _epochs_logged(run_dir) == 1, arm
        assert (run_dir / "ckps" / "ckp_0").is_dir(), arm
        assert not (root / arm / "DONE").exists(), arm
        assert np.load(run_dir / "valdice.npz")["valdice"].shape == (2,)
    first = {arm: float(np.load(root / arm / "run-fold0" / "valdice.npz")["valdice"][0])
             for arm in ARMS}

    rows = runner.main(args + ["--", *SMALL])
    assert [r["arm"] for r in rows] == list(ARMS)
    assert json.loads((root / "summary.json").read_text()) == rows
    for arm, row in zip(ARMS, rows):
        run_dir = root / arm / "run-fold0"
        assert (root / arm / "DONE").exists(), arm
        assert "resumed from" in (run_dir / "log.txt").read_text()
        assert (run_dir / "ckps" / "ckp_1").is_dir(), arm
        valdice = np.load(run_dir / "valdice.npz")["valdice"]
        assert valdice[0] == first[arm] and valdice[1] > 0, arm
        assert row["epochs"] == 2 and row["best_epoch"] == int(np.argmax(valdice))
        for key in ("test_dice_slice", "test_dice_patient", "test_hd95_slice"):
            assert np.isfinite(row[key]), (arm, key)
        assert "Per-patient" in (root / arm / "eval.log").read_text()

    # a marked arm is skipped
    rows_again = runner.main(args + ["--arms", "Upperbound", "--", *SMALL])
    assert rows_again == rows


def _copy_study(src, dst, swap=None):
    """The files the compare script reads, from ``src`` to ``dst``; ``swap``
    maps an arm to the arm whose curve it takes."""
    shutil.copy(src / "summary.json", dst / "summary.json")
    for arm in ARMS:
        (dst / arm / "run-fold0").mkdir(parents=True)
        source = (swap or {}).get(arm, arm)
        shutil.copy(src / source / "run-fold0" / "valdice.npz",
                    dst / arm / "run-fold0" / "valdice.npz")


def test_compare_passes_the_jax_study_against_itself(tmp_path):
    _copy_study(STUDY_R3, tmp_path)
    out = compare.main(["--jax", str(STUDY_R3), "--port", str(tmp_path)])
    assert {r: v["verdict"] for r, v in out["rules"].items()} == {
        "a": "pass", "b": "pass", "c": "pass", "d": "pass"}
    assert out["verdict"] == "pass"
    assert json.loads((tmp_path / "compare.json").read_text()) == json.loads(json.dumps(out))
    rec = out["records"]["port"]["1"]["Upperbound"]
    assert rec["best_epoch"] == 26 and rec["epochs_completed"] == 400
    assert np.isclose(rec["test_dice_slice"], 0.6268541216850281)


def test_compare_fails_the_ordering_when_upperbound_learns_like_control(tmp_path):
    _copy_study(STUDY_R3, tmp_path, swap={"Upperbound": "Control"})
    out = compare.main(["--jax", str(STUDY_R3), "--port", str(tmp_path)])
    assert out["rules"]["a"]["verdict"] == "fail"
    assert out["rules"]["a"]["checks"] == [{"seed": 1, "gap": 0.0, "pass": False}]
    assert out["verdict"] == "fail"


def test_window_means_of_hand_made_curves():
    curve = np.arange(1, 401) / 1000.0          # epoch e has (e + 1) / 1000
    want = {"0-10": 0.0055, "10-25": 0.018, "25-50": 0.038, "50-100": 0.0755,
            "100-200": 0.1505, "200-400": 0.3005}
    got = compare.window_means(curve)
    assert got.keys() == want.keys()
    for key in want:
        assert np.isclose(got[key], want[key], rtol=0, atol=1e-12), key
    assert compare.best(curve) == (0.4, 399)
    assert compare.best(curve, 100) == (0.1, 99)

    stopped = np.zeros(400)
    stopped[:100] = 0.5
    stopped[30] = 0.9
    assert compare.completed_epochs(stopped) == 100
    got = compare.window_means(stopped)
    assert got["25-50"] == pytest.approx((24 * 0.5 + 0.9) / 25)
    assert got["50-100"] == 0.5
    assert got["100-200"] is None and got["200-400"] is None
    assert compare.best(stopped) == (0.9, 30)


def test_compare_spreads_the_band_over_the_seeds(tmp_path):
    """Three seeds whose 0-10 window means are 0.1, 0.2 and 0.3: rule (b)'s
    band there is 3 x their sample deviation (0.1), about their mean."""
    records = {"jax": {}, "port": {}}
    curve = np.full(400, 0.2)
    base = compare.window_means(curve)
    for arm in ARMS:
        records["jax"][arm] = {"windows": dict(base), "best_val_dice": 0.2,
                               "test_dice_slice": 0.2}
    for seed, level in zip((1, 2, 3), (0.1, 0.2, 0.3)):
        records["port"][seed] = {}
        for arm in ARMS:
            w = dict(base)
            w["0-10"] = level
            records["port"][seed][arm] = {
                "windows": w, "best_val_dice": 0.6 if arm == "Upperbound" else 0.2,
                "best_val_dice_0_99": 0.2, "test_dice_slice": 0.2}
    rules = compare.verdict(records)
    first = [c for c in rules["b"]["checks"] if c["window"] == "0-10"]
    assert len(first) == 3
    for check in first:
        assert check["seeds"] == 3 and check["pass"]
        assert check["band"] == pytest.approx(0.3) and check["port"] == pytest.approx(0.2)
    assert rules["a"]["verdict"] == "pass" and rules["d"]["verdict"] == "pass"
