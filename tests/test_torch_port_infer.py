"""Port parity: inference (``pacingpseudo_torch/evals``, ``cli/inference.py``)
against ``pacingpseudo_tpu`` on the CPU, float32, 64x64 canvases, init_ch 8.

* The host metrics: ``hd95``, ``hd``, ``compute_95hd``, ``compute_hd``,
  ``compute_dice`` and ``compute_dice_hard`` equal JAX's (to 1e-12) on
  random masks, with empty and full classes.
* ``run_inference`` on one weight set (a backbone trained for 20
  upper-bound steps, so that it predicts several classes), both packages
  on the CPU, batch 4 over the 8 test slices (56x56 to 60x60, so every slice is cropped from
  its canvas): the JAX side reads an orbax checkpoint of the weights, the
  port a siamese checkpoint of its own (the backbone is taken) and the
  reference's layout (a bare ``UNet`` state_dict file, at batch 3: a
  partial last batch), which must give the same output.  The per-slice predictions are equal, or differ only at
  pixels whose top two logits lie within 1e-4 x the largest logit (the
  two float32 forwards add in another order); ``dicearr`` and ``hd95arr``
  are then equal to 1e-6 on the slices whose predictions are equal, and
  the ``uids`` and the per-patient aggregation equal.
* The port's ``tools/study_summary.py`` and JAX's read the port's
  ``eval_data.npz``; on a study root of three arms (a seeded
  ``valdice.npz`` with a NaN and trailing zeros, the port's
  ``eval_data.npz``, the same without ``uids``) the two give the same
  rows (to float rounding), the same table and the same ``--json`` file.
* The checkpoint layouts: the JAX importer reads an upper-bound
  checkpoint of the port into the tree of JAX's upper-bound state.
* ``python -m pacingpseudo_torch.cli.inference`` resolves a run
  directory's final checkpoint and writes the same ``eval_data.npz``; it
  refuses a path without the fold, and hands ``--spatial_shards`` and the
  devices to ``run_inference``.  Its parser has every flag of JAX's, with
  the same default, choices and parsed value, ``--gpu``'s default (``0``,
  not ``1``) the one difference, and ``--num_devices`` besides.
"""
import argparse
import dataclasses
import importlib
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from pacingpseudo_tpu.cli import inference as jax_cli
from pacingpseudo_tpu.evals import dice as jax_dice
from pacingpseudo_tpu.evals import infer as jax_infer
from pacingpseudo_tpu.models import PacingPseudoModel as JaxPacing
from pacingpseudo_tpu.tools import study_summary as jax_summary
from pacingpseudo_tpu.tools.torch_import import convert_state_dict, load_torch_checkpoint
from pacingpseudo_torch.aug.engine import eval_preprocess_batch, eval_preprocess_image
from pacingpseudo_torch.cli import inference as cli
from pacingpseudo_torch.config import ExperimentConfig
from pacingpseudo_torch.data.npz_dataset import BatchLoader, SliceDataset, raw_batch_to_device
from pacingpseudo_torch.data.splits import read_fold_split, read_test_split
from pacingpseudo_torch.data.synthetic import write_synthetic_dataset
from pacingpseudo_torch.evals import dice, hd, infer
from pacingpseudo_torch.train import checkpoint as ckpt
from pacingpseudo_torch.train.state import create_train_state
from pacingpseudo_torch.tools import study_summary
from pacingpseudo_torch.train.step import make_upper_bound_train_step

jax_hd = importlib.import_module("pacingpseudo_tpu.evals.hd")   # the package exports a function hd

C, INIT_CH, BATCH = 5, 8, 4
MODEL_KWARGS = dict(init_ch=INIT_CH, output_stride=8)


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


def _masks(seed):
    """Pairs of (prediction, label) integer maps over C classes: random
    blobs, a class absent from one side, from both, and one covering a map."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:40, :36]
    pairs = []
    for k in range(6):
        pred = np.zeros((40, 36), np.int64)
        lab = np.zeros((40, 36), np.int64)
        for c in range(1, C):
            for m in (pred, lab):
                cy, cx, r = rs.uniform(8, 30), rs.uniform(8, 28), rs.uniform(3, 9)
                m[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = c
        if k == 1:
            pred[pred == 3] = 0                  # class 3 only in the label
        if k == 2:
            pred[pred == 4] = 0
            lab[lab == 4] = 0                    # class 4 in neither
        if k == 3:
            pred[:] = 2                          # class 2 covers the prediction
        pairs.append((pred, lab))
    return pairs


@pytest.mark.parametrize("k", range(6))
def test_host_metrics_equal_jax(k):
    pred, lab = _masks(11)[k]
    spacing = (1.62, 1.62)
    np.testing.assert_allclose(hd.compute_95hd(pred, lab, C, spacing),
                               jax_hd.compute_95hd(pred, lab, C, spacing),
                               rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(hd.compute_hd(pred, lab, C, spacing),
                               jax_hd.compute_hd(pred, lab, C, spacing),
                               rtol=1e-12, equal_nan=True)
    for c in range(1, C):
        p, t = pred == c, lab == c
        if p.any() and t.any():
            assert hd.hd95(p, t, spacing) == jax_hd.hd95(p, t, spacing)
            assert hd.hd(p, t, 1.5) == jax_hd.hd(p, t, 1.5)
    np.testing.assert_allclose(dice.compute_dice_hard(pred, lab, C),
                               jax_dice.compute_dice_hard(pred, lab, C),
                               rtol=1e-12, equal_nan=True)
    probs = np.random.RandomState(k).rand(40, 36, C)
    probs[..., 0] += 2.0 * (pred == 0)
    one_hot = np.eye(C)[lab]
    np.testing.assert_allclose(dice.compute_dice(np.moveaxis(probs, -1, 0),
                                                 np.moveaxis(one_hot, -1, 0)),
                               jax_dice.compute_dice(probs, one_hot),
                               rtol=1e-12, equal_nan=True)


def test_host_metrics_nan_gating():
    full = np.ones((8, 8), np.int64)
    empty = np.zeros((8, 8), np.int64)
    assert np.isnan(hd.compute_95hd(full, empty, 2, (1.0, 1.0))).all()
    with pytest.raises(RuntimeError):
        hd.hd95(empty.astype(bool), full.astype(bool))
    assert np.isnan(dice.compute_dice_hard(empty, empty, 2)[1])


def test_per_patient_aggregation_equals_jax():
    rs = np.random.RandomState(4)
    uids = [f"pat{i % 4}_slice{i:03d}" for i in range(13)] + ["loner"]
    arr = rs.rand(len(uids), C)
    arr[rs.rand(*arr.shape) < 0.3] = np.nan
    arr[2] = np.nan
    for regex in ("", r"pat(\d)_"):
        assert (infer.aggregate_per_patient(uids, arr, C, regex)
                == jax_infer.aggregate_per_patient(uids, arr, C, regex))
    assert [infer.patient_key(u) for u in uids] == [jax_infer.patient_key(u) for u in uids]


def _weights(data):
    """A siamese state whose backbone took 20 upper-bound steps on 8
    training slices (so that it predicts several classes)."""
    train_files, _ = read_fold_split(data, "chaos", 1, "t1")
    ds = SliceDataset(train_files, C, C, canvas_size=64)
    batch = eval_preprocess_batch(
        raw_batch_to_device(next(iter(BatchLoader(ds, 8))), "cpu"), C)
    config = ExperimentConfig(session="Upperbound", init_ch=INIT_CH, lr=3e-3,
                              batch_size=8, compute_dtype="float32").validate()
    bare = create_train_state(config, device="cpu", seed=21)
    step = make_upper_bound_train_step(config, steps_per_epoch=100)
    for _ in range(20):
        step(bare, batch)
    siamese = create_train_state(dataclasses.replace(config, session="Experiment", hid_ch=16,
                                                     do_aux_path=True, do_memory=True),
                                 device="cpu", seed=22)
    siamese.model.backbone.load_state_dict(bare.model.backbone.state_dict())
    return siamese


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer")
    data = str(root / "data")
    write_synthetic_dataset(data, "chaos", 40, (56, 56), C, C, seed=3, size_jitter=4)
    state = _weights(data)
    siamese = str(root / "fold1" / "siamese")
    ckpt.save_checkpoint(siamese, state)
    bare = {k[len("backbone."):]: v for k, v in state.model.state_dict().items()
            if k.startswith("backbone.")}
    bare_file = str(root / "fold1" / "reference_unet.pth")
    torch.save(bare, bare_file)
    params, stats, _ = convert_state_dict({k: v.numpy() for k, v in bare.items()})
    jax_ckpt = str(root / "fold1" / "jax")
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(jax_ckpt, {"step": np.int32(0), "params": params, "batch_stats": stats})
    checkpointer.wait_until_finished()

    out = {}
    for name, path, fn, kw in (
            ("jax", jax_ckpt, jax_infer.run_inference, {"batch_size": BATCH}),
            ("port", siamese, infer.run_inference, {"batch_size": BATCH, "device": "cpu"}),
            ("bare", bare_file, infer.run_inference, {"batch_size": 3, "device": "cpu"})):
        run_dir = root / "runs" / name
        run_dir.mkdir(parents=True)
        # XLA compiles JAX's forward at its lowest optimization level (the
        # same float32 operations), to keep this file's time down.
        jax.config.update("jax_disable_most_optimizations", True)
        try:
            res = fn("chaost1", 1, path, data, str(run_dir), model_kwargs=MODEL_KWARGS,
                     compute_dtype="float32", num_workers=2,
                     save_pred=str(run_dir / "preds"), **kw)
        finally:
            jax.config.update("jax_disable_most_optimizations", False)
        out[name] = (res, run_dir)
    return dict(root=root, data=data, siamese=siamese, out=out)


def _preds(run_dir, uids):
    return [np.load(run_dir / "preds" / f"{u}.npz")["pred"] for u in uids]


def _port_logits(siamese, data, uid):
    """The port's float32 logits of one test slice, cropped to its extent."""
    ds = SliceDataset(read_test_split(data, "chaost1", 1), C, C)
    idx = [i for i, f in enumerate(ds.file_ls) if os.path.basename(f) == f"{uid}.npz"][0]
    s = ds.load(idx)
    model = infer.load_inference_model(siamese, C, MODEL_KWARGS, "float32", "cpu")
    image = torch.from_numpy(s["image"].astype(np.float16))[None]
    with torch.no_grad():
        logits = model(eval_preprocess_image(image, torch.from_numpy(s["size"])[None]))
    h, w = s["size"]
    return logits["segmentation/logits"][0, :, :h, :w].numpy()


def _same_predictions(runs, a, b):
    """Per slice, whether runs ``a`` and ``b`` predicted the same; where they
    did not, the pixels that differ have top two logits within 1e-4 x the
    largest logit."""
    (res_a, dir_a), (res_b, dir_b) = runs["out"][a], runs["out"][b]
    uids = list(res_b["uids"])
    assert list(res_a["uids"]) == uids
    same = []
    for uid, p, q in zip(uids, _preds(dir_a, uids), _preds(dir_b, uids)):
        assert p.shape == q.shape and p.shape != (64, 64)
        diff = p != q
        same.append(not diff.any())
        if diff.any():
            logits = np.sort(_port_logits(runs["siamese"], runs["data"], uid), axis=0)
            margin = logits[-1] - logits[-2]
            assert (margin[diff] <= 1e-4 * np.abs(logits).max()).all(), uid
    return np.array(same)


def test_run_inference_equals_jax(runs):
    want, got = runs["out"]["jax"][0], runs["out"]["port"][0]
    assert got["uids"] == list(want["uids"]) and len(got["uids"]) == 8
    assert got["dicearr"].shape == got["hd95arr"].shape == (8, C)
    same = _same_predictions(runs, "port", "jax")
    assert same.mean() >= 0.5
    for key in ("dicearr", "hd95arr"):
        np.testing.assert_allclose(got[key][same], want[key][same], atol=1e-6,
                                   equal_nan=True)
    assert np.isfinite(got["hd95arr"]).any() and np.isfinite(got["dicearr"][:, 1:]).any()
    if same.all():
        for key in ("dice", "hd95", "dice_per_patient", "hd95_per_patient", "num_patients"):
            assert np.isclose(got[key], want[key], rtol=1e-6), key
    saved = np.load(runs["out"]["port"][1] / "eval_data.npz")
    np.testing.assert_array_equal(saved["dicearr"], got["dicearr"])
    np.testing.assert_array_equal(saved["hd95arr"], got["hd95arr"])
    assert list(saved["uids"]) == got["uids"]


def test_reference_layout_gives_the_same_output(runs):
    """The bare state_dict file, at batch 3 (a partial last batch)."""
    a, b = runs["out"]["port"][0], runs["out"]["bare"][0]
    same = _same_predictions(runs, "bare", "port")
    for key in ("dicearr", "hd95arr"):
        np.testing.assert_array_equal(b[key][same], a[key][same])


@pytest.mark.parametrize("summary", [study_summary, jax_summary], ids=["port", "jax"])
def test_study_summary_reads_the_port_artifact(runs, tmp_path, summary):
    got, run_dir = runs["out"]["port"]
    dest = tmp_path / "Upperbound" / "outputs" / "Inference" / "chaost1" / "run-fold1"
    dest.mkdir(parents=True)
    shutil.copy(run_dir / "eval_data.npz", dest / "eval_data.npz")
    row = summary.summarise_arm(str(tmp_path), "Upperbound", "chaost1")
    assert np.isclose(row["test_dice_slice"], summary.per_slice_dice(got["dicearr"]))
    assert row["n_patients"] == got["num_patients"] and row["n_slices"] == 8
    assert np.isclose(row["test_dice_patient"], got["dice_per_patient"])


def _study_root(root, run_dir):
    """Three arms: a seeded ``valdice.npz`` of 12 epochs (a NaN, the last
    three never run), the port's ``eval_data.npz`` with a ``valdice.npz``,
    and the same ``eval_data.npz`` without its ``uids`` alone."""
    rs = np.random.RandomState(8)
    for arm in ("Control", "Experiment"):
        vd = np.concatenate([rs.rand(9), np.zeros(3)])
        vd[2] = np.nan
        os.makedirs(root / arm / "run-fold0")
        np.savez(root / arm / "run-fold0" / "valdice", valdice=vd)
    saved = dict(np.load(run_dir / "eval_data.npz"))
    for arm, keys in (("Experiment", sorted(saved)),
                      ("Upperbound", [k for k in saved if k != "uids"])):
        dest = root / arm / "outputs" / "Inference" / "chaost1" / "run-fold0"
        dest.mkdir(parents=True)
        np.savez(dest / "eval_data", **{k: saved[k] for k in keys})


def test_study_summary_equals_jax(runs, tmp_path, capsys, monkeypatch):
    """The port's summary of a study root against JAX's: each row's values
    to float rounding, the table and the ``--json`` file (read back) the
    same."""
    _study_root(tmp_path, runs["out"]["port"][1])
    arms = ["Control", "Experiment", "Upperbound", "Missing"]
    rows = [study_summary.summarise_arm(str(tmp_path), a, "chaost1") for a in arms]
    want = [jax_summary.summarise_arm(str(tmp_path), a, "chaost1") for a in arms]
    for got, ref in zip(rows, want):
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            assert got[k] == v if not isinstance(v, float) else np.isclose(got[k], v), k
    assert rows[0]["epochs_completed"] == 9 and rows[0]["best_epoch"] != 2
    assert rows[2]["test_dice_patient"] is None and rows[3] == {"arm": "Missing"}
    assert study_summary.render_table(rows) == jax_summary.render_table(want)

    argv = ["--root", str(tmp_path), "--arms", *arms]
    study_summary.main([*argv, "--json", str(tmp_path / "port.json")])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["study_summary", *argv, "--json",
                                      str(tmp_path / "jax.json")])
    jax_summary.main()
    assert port_out == capsys.readouterr().out and "Experiment - Control" not in port_out
    got_json, want_json = (json.load(open(tmp_path / f)) for f in ("port.json", "jax.json"))
    assert [sorted(r) for r in got_json] == [sorted(r) for r in want_json]
    for got, ref in zip(got_json, want_json):
        for k, v in ref.items():
            assert got[k] == v if not isinstance(v, float) else np.isclose(got[k], v), k


def test_upper_bound_checkpoint_opens_in_the_jax_importer(tmp_path):
    """The port's upper-bound checkpoint holds ``backbone.*`` only; the JAX
    importer reads it into the tree of JAX's upper-bound state (a
    ``PacingPseudoModel`` without aux path), and the port's inference
    opens it as a siamese checkpoint's backbone."""
    config = ExperimentConfig(session="Upperbound", init_ch=INIT_CH,
                              compute_dtype="float32").validate()
    state = create_train_state(config, device="cpu", seed=5)
    path = str(tmp_path / "ckp_0")
    ckpt.save_checkpoint(path, state)
    params, stats, bank = load_torch_checkpoint(os.path.join(path, ckpt.MODEL_FILE))
    assert bank is None
    model = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=False, s2d_hires=False,
                      dtype=jnp.float32)
    image = jnp.zeros((1, 64, 64, 1))
    want = model.init(jax.random.PRNGKey(0), image, train=False)
    for got, tmpl in ((params, want["params"]), (stats, want["batch_stats"])):
        assert jax.tree.structure(got) == jax.tree.structure(tmpl)
        assert all(np.shape(a) == np.shape(b) for a, b in zip(jax.tree.leaves(got),
                                                              jax.tree.leaves(tmpl)))
    assert ckpt.saved_is_siamese(path)
    unet = infer.load_inference_model(path, C, MODEL_KWARGS, "float32", "cpu")
    for name, p in unet.state_dict().items():
        assert torch.equal(p, state.model.state_dict()["backbone." + name]), name


def test_cli_resolves_the_final_checkpoint(runs, tmp_path, monkeypatch):
    run = tmp_path / "Upperbound-fold1-x"
    shutil.copytree(runs["siamese"], run / "ckps" / "ckp_399")
    argv = ["--gpu", "cpu", "--dataset", "chaost1", "--fold", "1", "--checkpoint_file",
            str(run), "--data_root", runs["data"], "--root", str(tmp_path / "out"),
            "--init_ch", str(INIT_CH), "--compute_dtype", "float32", "--batch_size",
            str(BATCH), "--save_pred"]
    res = cli.main(argv)
    out_dir = tmp_path / "out" / "Inference" / "chaost1" / run.name
    saved = np.load(out_dir / "eval_data.npz")
    want = runs["out"]["port"][0]
    np.testing.assert_array_equal(saved["dicearr"], want["dicearr"])
    np.testing.assert_array_equal(res["hd95arr"], want["hd95arr"])
    assert len(list((out_dir / "preds").glob("*.npz"))) == 8
    log = (out_dir / "log.txt").read_text()
    assert "ckps/ckp_399" in log and "Fold 1, overall Dice" in log and "slices/s" in log
    with pytest.raises(SystemExit, match="fold2"):
        cli.main([*argv[:5], "2", *argv[6:]])
    # --spatial_shards and the devices reach run_inference (the sharded run
    # itself: tests/test_torch_port_spatial.py).
    seen = {}
    monkeypatch.setattr(infer, "run_inference", lambda **kw: seen.update(kw))
    cli.main([*argv, "--spatial_shards", "2", "--num_devices", "3"])
    assert (seen["spatial_shards"], seen["num_devices"]) == (2, 3)
    assert seen["device"] == [torch.device("cpu")]


JAX_FLAGS = [a for a in jax_cli.build_parser()._actions if a.option_strings and a.dest != "help"]
REQUIRED = ["--fold", "1", "--checkpoint_file", "run-fold1"]


def test_the_parsers_have_the_same_flags():
    port = {a.dest: a for a in cli.build_parser()._actions
            if a.option_strings and a.dest != "help"}
    # --num_devices, the first k devices of --gpu, is the port's one flag more
    assert sorted(port) == sorted([a.dest for a in JAX_FLAGS] + ["num_devices"])
    assert len(port) == 22
    for a in JAX_FLAGS:
        b = port[a.dest]
        assert (b.option_strings, b.choices, b.type, b.required, type(b)) == (
            a.option_strings, a.choices, a.type, a.required, type(a)), a.dest
        assert b.default == a.default or (a.dest, a.default, b.default) == ("gpu", "1", "0")


@pytest.mark.parametrize("action", JAX_FLAGS, ids=lambda a: a.dest)
def test_flag_parses_to_the_same_value(action):
    flag = action.option_strings[0]
    if isinstance(action, argparse._StoreTrueAction):
        extra = [flag]
    elif action.choices:
        extra = [flag, str(next(c for c in action.choices if c != action.default))]
    elif action.required:
        extra = []
    elif action.type is int:
        extra = [flag, str(action.default + 3)]
    else:
        extra = [flag, "somewhere"]
    for argv in (REQUIRED, REQUIRED + extra):
        want = vars(jax_cli.build_parser().parse_args(argv))
        got = vars(cli.build_parser().parse_args(argv))
        if "--gpu" not in argv:
            assert (want.pop("gpu"), got.pop("gpu")) == ("1", "0")
        assert got.pop("num_devices") == 0
        assert got == want, argv
