"""The dilated study of the port (``study_r3_dilated``'s regime), on the CPU:
``scripts/study_r3_pool_torch.py --scribble_style dilated``, the runner's
refusals and identity checks (``scripts/quality_study_torch.py``), and
``scripts/quality_study_compare.py --protocol dilated``.

- The pool: 48 hard phantoms of 64x64, seed 1, dilated scribbles, through
  the script's ``write_pool`` and through the JAX package's writer with
  ``scribble_style="dilated"``: in draw order, every ``img``, ``lab`` and
  ``scb`` array equal; the fold lists every fifth slice; the marker names
  the style (a marker without one, as the skeleton pools were marked, reads
  as skeleton, and the skeleton marker's text is unchanged).
- The runner refuses a skeleton pool when asked for a dilated one, and a
  pool of another size; fold 0's figures at 1,916 slices and batch 12 are
  those of JAX's ``train.log`` headers; a log without the frozen-BN step
  under the quirk is refused.
- The compare script: the default protocol reproduces the committed
  ``study_torch/compare.json`` and ``study_torch_r3split/compare.json``
  byte for byte; the dilated protocol on hand-built ``valdice`` curves (seed
  1's Control complete, its Experiment stopped after epoch 156, seed 2
  stopped after epoch 49) gives the windows, bands and "not evaluated" of
  its rules (a)-(d); an arm without the quirk stops it.
"""
import importlib.util
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from pacingpseudo_tpu.data import synthetic as jax_synthetic

ROOT = pathlib.Path(__file__).resolve().parent.parent
STUDY_R3_DILATED = ROOT / "study_r3_dilated"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


pool = _load("study_r3_pool_torch")
runner = _load("quality_study_torch")
compare = _load("quality_study_compare")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread in this module (see ``test_torch_port_infer.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_dilated_r3_pool_matches_the_jax_writer(tmp_path):
    got = pool.write_pool(str(tmp_path / "port"), 48, seed=1, size=(64, 64),
                          scribble_style="dilated")
    want = jax_synthetic.write_synthetic_dataset(
        str(tmp_path / "jax"), "chaost1", 48, (64, 64), 5, 5, folds=5, modality="t1", seed=1,
        difficulty="hard", scribble_style="dilated")
    assert got == want and len(got) == 48
    skeleton = jax_synthetic.write_synthetic_dataset(
        str(tmp_path / "skeleton"), "chaost1", 2, (64, 64), 5, 5, folds=5, modality="t1",
        seed=1, difficulty="hard")
    for rel in got:
        a, b = np.load(tmp_path / "port" / "chaos" / rel), np.load(tmp_path / "jax" / "chaos" / rel)
        for k in ("img", "lab", "scb"):
            assert a[k].dtype == b[k].dtype, (rel, k)
            np.testing.assert_array_equal(a[k], b[k])
    first = np.load(tmp_path / "port" / "chaos" / got[0])["scb"]
    thin = np.load(tmp_path / "skeleton" / "chaos" / skeleton[0])["scb"]
    assert (first < 5).sum() > (thin < 5).sum()     # the strokes are wider
    base = pathlib.Path(pool.split_dir(str(tmp_path / "port")))
    for fold in range(5):
        test = (base / f"test_fold{fold}.txt").read_text().split()
        train = (base / f"train_fold{fold}.txt").read_text().split()
        assert test == got[fold::5] and train == [p for p in got if p not in test]
    assert pool.read_marker(str(tmp_path / "port")) == {
        "slices": 48, "size": (64, 64), "seed": 1, "scribble_style": "dilated"}
    assert pool.fold0_identity(str(tmp_path / "port"), 12) == {
        **pool.expected_fold0(48, 12), "canvas": 64}


def test_a_marker_without_a_style_reads_as_skeleton(tmp_path):
    line = "1916 (256, 256) seed 1: test = rel_paths[fold::5]\n"
    assert pool.marker_text(1916, (256, 256), 1) == line
    base = pathlib.Path(pool.split_dir(str(tmp_path)))
    base.mkdir(parents=True)
    (base / "r3_split").write_text(line)
    assert pool.read_marker(str(tmp_path)) == {
        "slices": 1916, "size": (256, 256), "seed": 1, "scribble_style": "skeleton"}
    assert pool.read_marker(str(tmp_path / "none")) is None


def test_fold0_at_study_scale_reads_the_jax_headers():
    """``train slices=1532 val slices=384 steps/epoch=127 canvas=256`` in
    both JAX ``train.log`` headers, 80 patients in its summary."""
    want = pool.expected_fold0(1916, 12)
    assert compare.expected_fold0(1916, 12) == {k: v for k, v in want.items()
                                                if k != "patients"}
    assert {k: v for k, v in want.items() if k != "patients"} == compare.JAX_FOLD0
    for arm in ("Control", "Experiment"):
        log = (STUDY_R3_DILATED / arm / "train.log").read_text()
        header = tuple(int(x) for x in compare.HEADER.findall(log)[0])
        assert header == (want["train"], want["test"], want["steps"], want["canvas"])
    rows = json.loads((STUDY_R3_DILATED / "summary.json").read_text())
    assert {r["n_patients"] for r in rows} == {want["patients"]} == {80}


def _argv(root, slices=10):
    return runner.train_argv("Control", str(root), 200, slices, "hard", 1, "cpu",
                             r3_split=True, scribble_style="dilated",
                             tag="study_torch_dilated")


def test_runner_refuses_a_pool_of_another_style_or_size(tmp_path):
    data = runner.data_root(str(tmp_path), 1, r3_split=True)
    pool.write_pool(data, 10, seed=1, size=(32, 32))
    before = sorted(p.name for p in pathlib.Path(data, "chaos", "slices").iterdir())
    with pytest.raises(SystemExit, match="scribble_style.*skeleton"):
        runner.write_pool(_argv(tmp_path), 10, "dilated")
    with pytest.raises(SystemExit, match="'slices': 10"):
        runner.write_pool(_argv(tmp_path, 12), 12, "skeleton")
    assert sorted(p.name for p in pathlib.Path(data, "chaos", "slices").iterdir()) == before
    argv = _argv(tmp_path)
    assert argv[argv.index("--tag") + 1] == "study_torch_dilated"
    assert "--synthetic_scribble_style" not in argv
    plain = runner.train_argv("Control", str(tmp_path), 200, 10, "hard", 2, "cpu",
                              scribble_style="dilated")
    assert plain[plain.index("--synthetic_scribble_style") + 1] == "dilated"
    assert runner.arm_config(plain).seed == 2


def test_runner_refuses_a_log_without_the_frozen_step(tmp_path):
    config = runner.arm_config(_argv(tmp_path) + ["--ref_quirk_bn_eval_after_first_epoch"])
    fold = pool.expected_fold0(1916, 12)
    head = "train slices=1532 val slices=384 steps/epoch=127 canvas=256 device=cuda:0\n"
    epochs = "".join(f"epoch: {e:03d}, lr: 0.0001, loss_pce: 0.1, 4.4 s/epoch\n"
                     for e in range(3))
    (tmp_path / "log.txt").write_text(head + epochs)
    with pytest.raises(SystemExit, match="frozen-BN"):
        runner.check_log(str(tmp_path), config, fold)
    frozen = epochs.replace("epoch: 001", "epoch 001 on: frozen-BN step (...)\nepoch: 001")
    (tmp_path / "log.txt").write_text(head + frozen)
    runner.check_log(str(tmp_path), config, fold)
    (tmp_path / "log.txt").write_text(head.replace("1532", "1533") + frozen)
    with pytest.raises(SystemExit, match="log headers"):
        runner.check_log(str(tmp_path), config, fold)


@pytest.mark.parametrize("study", ["study_torch", "study_torch_r3split"])
def test_default_protocol_reproduces_the_committed_compare(study, tmp_path):
    out = tmp_path / "compare.json"
    compare.main(["--jax", str(ROOT / "study_r3"), "--port", str(ROOT / study),
                  "--json", str(out)])
    committed = json.loads((ROOT / study / "compare.json").read_text())
    ran = json.loads(out.read_text())
    for d in (committed, ran):
        d.pop("jax_root"), d.pop("port_root")
    assert ran == committed
    # the committed file was written from the repository's root
    again = json.dumps({"jax_root": "study_r3", "port_root": study, **ran}, indent=2)
    assert again == (ROOT / study / "compare.json").read_text()


def _arm(root, arm, valdice, epochs_run, quirk=True, slices=1916):
    """An arm's directory: JAX's config.json for ``arm`` (the quirk as
    given), a log header of fold 0 of ``slices``, ``valdice`` with zeros
    after ``epochs_run`` epochs."""
    run = root / arm / "run-fold0"
    run.mkdir(parents=True)
    config = json.loads((STUDY_R3_DILATED / arm.split("-")[0] / "run-fold0"
                         / "config.json").read_text())
    config["ref_quirk_bn_eval_after_first_epoch"] = quirk
    (run / "config.json").write_text(json.dumps(config))
    f = compare.expected_fold0(slices, 12)
    (run / "log.txt").write_text(f"train slices={f['train']} val slices={f['test']} "
                                 f"steps/epoch={f['steps']} canvas={f['canvas']} device=cpu\n")
    vd = np.zeros(200)
    vd[:epochs_run] = valdice[:epochs_run]
    np.savez(run / "valdice.npz", valdice=vd)


def _port(tmp_path, quirk=True):
    """Seed 1: Control complete at 0.30, Experiment stopped after epoch 156
    at 0.34 in epochs 0-49 and 0.20 after; seed 2 stopped after epoch 49 at
    0.26 and 0.33; the test rows of seed 1 only."""
    port = tmp_path / "port"
    _arm(port, "Control", np.full(200, 0.30), 200, quirk)
    _arm(port, "Experiment", np.where(np.arange(200) < 50, 0.34, 0.20), 157)
    _arm(port, "Control-s2", np.full(200, 0.26), 50)
    _arm(port, "Experiment-s2", np.full(200, 0.33), 50)
    rows = [{"arm": "Control", "test_dice_slice": 0.40, "test_dice_patient": 0.41,
             "test_hd95_slice": 150.0},
            {"arm": "Experiment", "test_dice_slice": 0.30, "test_dice_patient": 0.31,
             "test_hd95_slice": 160.0}]
    (port / "summary.json").write_text(json.dumps(rows))
    return port


def test_dilated_protocol_on_hand_made_curves(tmp_path):
    port = _port(tmp_path)
    out = compare.main(["--protocol", "dilated", "--jax", str(STUDY_R3_DILATED),
                        "--port", str(port)])
    assert out["protocol"] == "dilated" and sorted(out["records"]["port"]) == ["1", "2"]
    rec = out["records"]["port"]["1"]["Experiment"]
    assert rec["epochs_completed"] == 157 and rec["windows"]["150-200"] is None
    assert rec["windows"]["100-150"] == pytest.approx(0.20)
    assert out["records"]["port"]["2"]["Control"]["windows"]["50-100"] is None
    jax_exp = out["records"]["jax"]["Experiment"]
    assert jax_exp["epochs_completed"] == 157 and jax_exp["best_epoch"] == 13
    rules = out["rules"]

    (a,) = rules["a"]["checks"]
    assert a["gap"] == pytest.approx(0.10) and a["pass"]
    assert a["jax_gap"] == pytest.approx(0.2771 - 0.1441, abs=1e-4)

    b = {(c["arm"], c["window"]): c for c in rules["b"]["checks"]}
    assert sorted(b) == sorted((arm, w) for arm in ("Control", "Experiment")
                               for w in ("0-10", "10-25", "25-50"))
    s = float(np.std([0.30, 0.26], ddof=1))
    assert 3 * s > 0.05
    assert b[("Control", "0-10")]["band"] == pytest.approx(3 * s)
    assert b[("Control", "0-10")]["port"] == pytest.approx(0.28)
    assert b[("Control", "0-10")]["seeds"] == 2
    assert b[("Control", "0-10")]["pass"]                # 0.2796 within 0.28 +- 0.0849
    assert b[("Experiment", "25-50")]["band"] == pytest.approx(0.05)
    assert not b[("Experiment", "25-50")]["pass"]        # 0.2270 outside 0.335 +- 0.05
    assert b[("Experiment", "10-25")]["pass"]            # 0.2876 within 0.335 +- 0.05
    assert rules["b"]["verdict"] == "fail" and rules["b"]["not_evaluated"] == []

    c = {(x["arm"], x["window"]): x for x in rules["c"]["checks"]}
    assert sorted(c) == [("Control", "100-150"), ("Control", "150-200"), ("Control", "50-100"),
                         ("Experiment", "100-150"), ("Experiment", "50-100")]
    assert c[("Control", "150-200")]["band"] == pytest.approx(3 * s)
    assert c[("Experiment", "50-100")]["band"] == pytest.approx(0.05)
    assert c[("Control", "50-100")]["port"] == pytest.approx(0.30)
    assert c[("Experiment", "50-100")]["pass"]           # 0.1504 within 0.20 +- 0.05
    assert not c[("Experiment", "100-150")]["pass"]      # 0.1378 outside 0.20 +- 0.05
    assert rules["c"]["not_evaluated"] == []

    d = {x["arm"]: x for x in rules["d"]["checks"]}
    assert d["Control"]["port"] == 0.40 and d["Control"]["jax"] == pytest.approx(0.3774, abs=1e-4)
    assert d["Control"]["band"] == pytest.approx(3 * s) and d["Control"]["pass"]
    assert d["Experiment"]["band"] == pytest.approx(0.05) and not d["Experiment"]["pass"]
    assert out["verdict"] == "fail"
    assert json.loads((port / "compare.json").read_text()) == json.loads(json.dumps(out))


def test_dilated_protocol_leaves_unreached_windows_not_evaluated(tmp_path):
    """Seed 1 cut after epoch 49 as seed 2 is: (a) and (c) have no inputs;
    no test rows: (d) has none."""
    port = _port(tmp_path)
    for arm in ("Control", "Experiment"):
        path = port / arm / "run-fold0" / "valdice.npz"
        vd = np.load(path)["valdice"]
        vd[50:] = 0
        np.savez(path, valdice=vd)
    (port / "summary.json").unlink()
    out = compare.main(["--protocol", "dilated", "--jax", str(STUDY_R3_DILATED),
                        "--port", str(port)])
    rules = out["rules"]
    assert rules["a"] == {"checks": [], "not_evaluated": [{"seed": 1, "epochs": "50-149"}],
                          "verdict": "not evaluated"}
    assert rules["c"]["verdict"] == "not evaluated"
    assert [(x["arm"], x["window"]) for x in rules["c"]["not_evaluated"]] == [
        ("Control", "50-100"), ("Control", "100-150"), ("Control", "150-200"),
        ("Experiment", "50-100"), ("Experiment", "100-150")]
    assert rules["d"]["not_evaluated"] == [{"arm": "Control"}, {"arm": "Experiment"}]
    assert rules["b"]["verdict"] in ("pass", "fail") and len(rules["b"]["checks"]) == 6
    assert out["verdict"] in ("fail", "incomplete")


def test_dilated_protocol_stops_on_an_arm_of_another_study(tmp_path):
    port = _port(tmp_path, quirk=False)
    with pytest.raises(SystemExit, match="quirk is not on"):
        compare.main(["--protocol", "dilated", "--jax", str(STUDY_R3_DILATED),
                      "--port", str(port)])
    assert not (port / "compare.json").exists()
    shutil.rmtree(port)
    port = _port(tmp_path)
    with pytest.raises(SystemExit, match="log headers"):
        compare.main(["--protocol", "dilated", "--jax", str(STUDY_R3_DILATED),
                      "--port", str(port), "--slices", "48"])
