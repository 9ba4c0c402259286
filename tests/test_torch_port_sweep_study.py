"""The five-fold jagged sweep of ``study_r5/sweep/`` on the port: its pool,
its runner's checks and its comparison, on the CPU.

* the ``jagged`` pool that ``cli.sweep`` writes from the runner's argv
  (``scripts/sweep_torch.py``) equals the JAX package's
  ``write_synthetic_dataset`` file for file (arrays, split lists, marker),
  at 130 slices of 48x48: the patient-level split of 10 pseudo-patients,
  and two of the writer's worker processes;
* ``scripts/sweep_compare.py``'s parser on JAX's committed arm logs: each
  fold's last attempt (interleaved and repeated lines folded, Experiment
  fold 0 after four ``config:`` lines) reads 80 epochs, Experiment fold 0
  epoch 0 ``All: 0.1789``, and the 10-79 means the rules quote;
* the rules on made-up fold results: JAX's own pass every rule, and each
  of four edits fails its rule alone (inside the other rules' bands);
* the runner's checks before and after training at a tiny size: a pool's
  fold figures against a header and a patient count, JAX's headers from
  its logs, a run log's headers, and the config hash beside JAX's;
* the draw-against-defect rule of ``scripts/control_from_jax_init.py``'s
  sweep-fold mode, at and beside its thresholds.
"""
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest

from pacingpseudo_tpu.data import synthetic as jax_synthetic

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_SWEEP = ROOT / "study_r5" / "sweep"
TINY = dict(slices=130, size=48)
WINDOWS = {"Control": [0.1805, 0.2186, 0.1976, 0.1741, 0.1918],
           "Experiment": [0.2200, 0.2128, 0.2253, 0.2226, 0.2099]}


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def runner():
    return _script("sweep_torch")


@pytest.fixture(scope="module")
def compare():
    return _script("sweep_compare")


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.fixture(scope="module")
def tiny_pool(tmp_path_factory, runner):
    """The runner's pool at ``TINY`` (as ``cli.sweep`` writes it) and JAX's."""
    from pacingpseudo_torch.cli import sweep
    root = tmp_path_factory.mktemp("sweep")
    argv = runner.sweep_argv("Control", str(root / "port"), 0, slices=TINY["slices"],
                             gpu="cpu", extra=["--input_size", str(TINY["size"]),
                                               str(TINY["size"])])
    args = sweep.build_parser().parse_args(argv)
    sweep.write_pool(args)
    jax_synthetic.write_synthetic_dataset(
        str(root / "jax"), "chaos", TINY["slices"], (TINY["size"],) * 2, 5, 5,
        modality="t1", seed=1, difficulty="jagged")
    return {"port": args.data_root, "jax": str(root / "jax"), "batch": args.batch_size}


def test_jagged_pool_matches_the_jax_writer(tiny_pool):
    jroot, proot = tiny_pool["jax"], tiny_pool["port"]
    files = _tree(proot)
    assert files == _tree(jroot)
    assert sum(f.endswith(".npz") for f in files) == TINY["slices"]
    marker = os.path.join("chaos", "slices", ".generated")
    assert marker in files and "jagged" in open(os.path.join(proot, marker)).read()
    for rel in files:
        a, b = os.path.join(jroot, rel), os.path.join(proot, rel)
        if rel.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f"{rel}:{k}")
        else:
            assert open(a).read() == open(b).read(), rel


def test_jax_log_parser_takes_each_folds_last_attempt(compare):
    for arm, means in WINDOWS.items():
        folds = compare.parse_jax_log(str(JAX_SWEEP / f"{arm}80.log"))
        assert sorted(folds) == [0, 1, 2, 3, 4]
        for fold, rec in folds.items():
            assert rec["valdice"].shape == (80,) and rec["config"]["fold"] == fold
            assert round(float(rec["valdice"][10:].mean()), 4) == means[fold], (arm, fold)
    exp = compare.parse_jax_log(str(JAX_SWEEP / "Experiment80.log"))
    assert exp[0]["valdice"][0] == 0.1789 and len(exp[0]["headers"]) == 4
    seed2 = compare.parse_jax_log(str(JAX_SWEEP / "Control80_s2.log"))
    assert round(float(seed2[0]["valdice"][10:].mean()), 4) == 0.2409


def _write_port(compare, root, edit=None):
    """A port sweep directory holding JAX's own results, ``edit(arm, fold,
    result, curve)`` applied to each fold; returns its path."""
    jax = compare.read_side(str(JAX_SWEEP), True)
    for arm in compare.ARMS:
        curves = compare.parse_jax_log(str(JAX_SWEEP / f"{arm}80.log"))
        for fold in compare.FOLDS:
            res = dict(jax[arm][fold])
            curve = curves[fold]["valdice"].copy()
            if edit:
                edit(arm, fold, res, curve)
            out = root / f"{arm}80" / f"fold{fold}"
            out.mkdir(parents=True, exist_ok=True)
            (root / f"{arm}80" / f"fold{fold}.json").write_text(
                json.dumps({"dice": res["dice"], "hd95": res["hd95"]}))
            np.savez(out / "valdice.npz", valdice=curve)
            (out / "pool.json").write_text(json.dumps({"fold0_sha256": "same"}))
    return str(root)


def _shift_gap(arm, fold, res, curve):
    res["dice"] += 0.035 if arm == "Control" else -0.035


def _fold_dice(arm, fold, res, curve):
    if (arm, fold) == ("Control", 2):
        res["dice"] += 0.09


def _fold_hd95(arm, fold, res, curve):
    if (arm, fold) == ("Experiment", 1):
        res["hd95"] += 31.0


def _curve(arm, fold, res, curve):
    if (arm, fold) == ("Control", 3):
        curve[10:] += 0.08


@pytest.mark.parametrize("edit, failing", [(None, ""), (_shift_gap, "a"), (_fold_dice, "b"),
                                           (_fold_hd95, "c"), (_curve, "d")],
                         ids=["jax", "gap", "fold_dice", "fold_hd95", "curve"])
def test_rules(tmp_path, compare, edit, failing):
    port = _write_port(compare, tmp_path, edit)
    out = compare.main(["--jax", str(JAX_SWEEP), "--port", port])
    want = {k: "fail" if k == failing else "pass" for k in "abcd"}
    assert {k: r["verdict"] for k, r in out["rules"].items()} == want
    assert out["verdict"] == ("fail" if failing else "pass")
    assert json.load(open(os.path.join(port, "compare.json")))["verdict"] == out["verdict"]
    assert out["pool"]["agree"]


def test_rules_wait_for_missing_folds_and_hold_the_pool(tmp_path, compare):
    port = _write_port(compare, tmp_path)
    os.remove(os.path.join(port, "Experiment80", "fold4.json"))
    out = compare.main(["--jax", str(JAX_SWEEP), "--port", port])
    assert out["rules"]["a"]["verdict"] == "not evaluated" and out["verdict"] == "incomplete"
    (tmp_path / "Control80" / "fold1" / "pool.json").write_text(
        json.dumps({"fold0_sha256": "other"}))
    assert compare.main(["--jax", str(JAX_SWEEP), "--port", port])["verdict"] == "fail"


def test_runner_checks_the_pool_before_training(tiny_pool, runner):
    data, batch = tiny_pool["port"], tiny_pool["batch"]
    assert runner.jax_headers(str(JAX_SWEEP), [0, 4]) == {0: (1532, 384, 127, 256),
                                                         4: (1536, 380, 128, 256)}
    # 130 slices of 13 a patient: fold 0 tests patients 0 and 5
    header = {0: (104, 26, 104 // batch, 64), 1: (104, 26, 104 // batch, 64)}
    got = runner.check_pool(data, [0, 1], batch, header, patients=2)
    assert got[0] == {"slices": 130, "train": 104, "test": 26, "steps": 104 // batch,
                      "canvas": 64, "patients": 2}
    with pytest.raises(SystemExit, match="JAX's log"):
        runner.check_pool(data, [0], batch, {0: (1532, 384, 127, 256)}, patients=2)
    with pytest.raises(SystemExit, match="pseudo-patients"):
        runner.check_pool(data, [0], batch, header, patients=runner.TEST_PATIENTS)
    assert runner.fold0_checksum(data) == runner.fold0_checksum(data)


def test_runner_checks_each_log_and_reports_the_hash(tmp_path, tiny_pool, runner):
    ident = runner.fold_identity(tiny_pool["port"], tiny_pool["batch"], 0)
    log = tmp_path / "log.txt"
    log.write_text("train slices=104 val slices=26 steps/epoch=8 canvas=64 device=cpu\n")
    runner.check_log(str(tmp_path), ident)
    log.write_text("train slices=104 val slices=26 steps/epoch=9 canvas=64 device=cpu\n")
    with pytest.raises(SystemExit, match="log headers"):
        runner.check_log(str(tmp_path), ident)
    report = runner.config_hash_report(runner.sweep_argv("Experiment", str(tmp_path), 0),
                                       str(JAX_SWEEP), "Experiment")
    assert "JAX's 88de1df7c0dc" in report


@pytest.mark.parametrize("gap_i,gaps_ii,verdict", [
    (0.060, [], "explained by the draw"),
    (0.050, [-0.02, 0.01], "explained by the draw"),
    (0.030, [0.00, 0.01], "still open"),
    (0.020, [0.00, 0.029], "not the draw"),
    (-0.015, [0.00, 0.030], "still open"),
    (0.010, [0.00], "incomplete"),
    (None, [0.00, 0.01], "incomplete"),
])
def test_fault3_rule(gap_i, gaps_ii, verdict):
    """``scripts/control_from_jax_init.py``'s rule for a sweep fold, at
    and beside its thresholds (+0.05, +0.02, +0.03), two seeds in (ii)."""
    assert _script("control_from_jax_init").sweep_verdict(gap_i, gaps_ii, 2) == verdict
