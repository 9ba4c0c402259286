"""Port parity: the Control session's epoch loop and its validation, against
the JAX package's loop (``pacingpseudo_tpu.train.loop.train_driver``), on
the CPU; and ``scripts/study_r3_pool_torch.py``, the pool and fold split
that ``study_r3`` read.

The pool script: fold 0 of 1,916 slices named as the old writer named them
holds 1,532 training and 384 test slices from 80 pseudo-patients, the test
list every fifth slice from the first, both lists in the pool's order; a
small pool's slices equal the JAX package's writer's file for file and its
fold lists are the old split (the old drawing equals today's: the hard
phantoms and skeleton scribbles of revisions ``e76e14f`` and ``5168465``
were checked equal to today's byte for byte).  ``quality_study_torch.py
--r3_split`` trains every seed on that one pool, without
``--synthetic_data``.

Both loops run two epochs of the Control session (pCE only; float32, 64x64,
init_ch 8, batch 2, one device) on one pool: 30 ``hard`` phantoms, folds cut
as ``study_r3``'s writer cut them (every fifth slice, through
``scripts/study_r3_pool_torch.py``): 24 training and 6 validation slices.
The loops differ in what cannot be matched draw for draw, the augmentation
(JAX's keys, the port's ``torch.Generator``), so both take the same
deterministic one instead: ``eval_preprocess_batch`` of the raw batch (the
live region's MeanStdNorm, the scribble and label one-hot, the region as
the valid mask).  The port starts from JAX's initial weights and BatchNorm
statistics (``create_train_state`` wrapped on both sides; carried across by
``pacingpseudo_torch.tools.weights``; JAX's ``model.init`` compiled at
XLA's lowest backend optimisation, which only shortens the compile); the
shuffle order is the same function of ``(seed, epoch)`` on both sides.
JAX's model takes ``s2d_hires=False``: its space-to-depth execution of the
high-resolution convs computes the same convs, and only lengthens the
trace.  Everything else is each
loop's own: the resident pool, the chunked updates, Adam with the per-epoch
learning rate, the BatchNorm EMA, the validation pass, its Dice
accounting and its log line.

Tolerances.  The two float32 forwards differ by ~5e-5 in a BatchNorm
output (``tests/test_torch_port_step.py``), which flips single LeakyReLU
branches; Adam moves an element by about lr whatever its gradient's size,
so over 24 updates the two runs part as a port run from weights nudged by
1e-7 (relative) parts from the port's own (measured here: BatchNorm
statistics 1.7% of a buffer's largest value apart after epoch 0, 1.8% of
the validation pixels predicted otherwise after epoch 1).  So the port's
third run, from JAX's weights nudged by ``NUDGE``, is the yardstick:

* the BatchNorm running statistics after epoch 0 (each buffer's largest
  error over its largest value, the worst buffer) within 4x the nudged
  run's + 1e-4 (measured 2.4% against 1.7%);
* the share of validation pixels (in the live region) whose argmax differs
  between the two final models within 4x the nudged run's + 1e-3
  (measured 2.0% against 1.8%);
* the validation loss within 4x the nudged run's distance + 1e-4 relative;
* each epoch's ``valdice`` and the ``All`` of the ``val:`` line within
  5e-3 (measured 4.1e-4), and each class's Dice within 2e-2 (measured
  3.1e-3; a class of 6 slices of 64x64 counts few pixels): a fourteenth
  and under a third of the 0.07 by which the port's Control arm read
  above ``study_r3``'s in epochs 0-9 (``PERF.md`` §6).

A Dice is a count of argmax pixels: at the study's learning rate (1e-4)
two epochs leave the model near its initialisation, where many pixels lie
near a tie; the flipped share bounds that directly.

``test_frozen_bn_loop_matches_jax`` holds the same checks, with the same
bounds, on both loops under ``ref_quirk_bn_eval_after_first_epoch`` (the
regime of ``study_r3_dilated``) for three epochs, so epochs 1-2 take the
frozen-BN step (BatchNorm on its running statistics, which then stay as
epoch 0 left them, on both sides); the port's log says the frozen step took
over at epoch 1.
"""
import importlib.util
import json
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from pacingpseudo_tpu.aug.engine import eval_preprocess_batch as jax_eval_preprocess
from pacingpseudo_tpu.config import ExperimentConfig as JaxConfig
from pacingpseudo_tpu.data import synthetic as jax_synthetic
from pacingpseudo_tpu.train import checkpoint as jax_ckpt
from pacingpseudo_tpu.train import loop as jax_loop
from pacingpseudo_torch.aug.engine import eval_preprocess_batch
from pacingpseudo_torch.config import ExperimentConfig
from pacingpseudo_torch.models.unet import UNet
from pacingpseudo_torch.tools.weights import from_jax_variables
from pacingpseudo_torch.train import checkpoint as ckpt
from pacingpseudo_torch.train import loop

ROOT = pathlib.Path(__file__).resolve().parent.parent
S, SLICES, EPOCHS = 64, 30, 2
CONFIG = dict(seed=1, dataset="chaost1", session="Control", num_classes=5, ignored_index=5,
              init_ch=8, batch_size=2, epoch=EPOCHS, input_size=(S, S), num_devices=1,
              compute_dtype="float32", tb_figures=False, ckp_interval=1,
              steps_per_dispatch=12, s2d_hires=False)
FLIP_SPREADS, FLIP_FLOOR = 4, 1e-3
DICE_ATOL = 5e-3
CLASS_ATOL = 2e-2
LOSS_SPREADS, LOSS_RTOL = 4, 1e-4
NUDGE = 1e-7
STATS_SPREADS = 4
STATS_FLOOR = 1e-4


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pool_script():
    return _script("study_r3_pool_torch")


def test_r3_split_of_the_study_pool():
    names = [f"slices/pat{i // 24:03d}_slice{i % 24:03d}.npz" for i in range(1916)]
    folds = _pool_script().r3_folds(names)
    train, test = folds[0]
    assert (len(train), len(test)) == (1532, 384)
    assert test == names[0::5] and train == [p for i, p in enumerate(names) if i % 5]
    assert len({p.split("/")[1].split("_")[0] for p in test}) == 80
    for fold, (tr, te) in enumerate(folds):
        assert te == names[fold::5] and sorted(tr + te) == sorted(names)


def test_r3_pool_matches_the_jax_writer(tmp_path):
    """Ten 32x32 phantoms: the slices equal the JAX package's writer's, the
    fold lists are the old split, the split directory marked."""
    got = _pool_script().write_pool(str(tmp_path / "port"), 10, seed=1, size=(32, 32))
    want = jax_synthetic.write_synthetic_dataset(
        str(tmp_path / "jax"), "chaost1", 10, (32, 32), 5, 5, folds=5, modality="t1", seed=1,
        difficulty="hard")
    assert got == want
    for rel in got:
        a, b = np.load(tmp_path / "port" / "chaos" / rel), np.load(tmp_path / "jax" / "chaos" / rel)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    base = tmp_path / "port" / "chaos" / "train_test_split" / "five_fold_split" / "t1"
    for fold in range(5):
        test = (base / f"test_fold{fold}.txt").read_text().split()
        train = (base / f"train_fold{fold}.txt").read_text().split()
        assert test == got[fold::5] and train == [p for p in got if p not in test]
    assert (base / "r3_split").is_file()


def test_study_runner_trains_every_seed_on_the_r3_pool(tmp_path):
    runner = _script("quality_study_torch")
    for seed in (1, 2):
        argv = runner.train_argv("Control", str(tmp_path), 400, 1916, "hard", seed, "0",
                                 r3_split=True)
        assert "--synthetic_data" not in argv and "--synthetic_difficulty" not in argv
        assert argv[argv.index("--data_root") + 1] == str(tmp_path / "data")
        assert argv[argv.index("--seed") + 1] == str(seed)
    assert "--synthetic_data" in runner.train_argv("Control", str(tmp_path), 400, 1916, "hard",
                                                   2, "0")


_CACHE_OPTIONS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
                  "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module", autouse=True)
def shared_jax_compiles(tmp_path_factory):
    """JAX's compiled executables shared by the module's two JAX loops
    through a persistent compilation cache in a directory of the module's
    own: the frozen-BN case's loop reads the first loop's ``model.init`` and
    validation step from it (~3.5 s of its ~27 s on an idle core).  The
    cache is reset on the way in and out (JAX checks for a cache directory
    once, at its first compile), and the options restored."""
    from jax._src import compilation_cache

    saved = {k: getattr(jax.config, k) for k in _CACHE_OPTIONS}
    jax.config.update("jax_compilation_cache_dir", str(tmp_path_factory.mktemp("jax_cache")))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread in this module (see ``test_torch_port_infer.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _jax_aug(base, strong, do_strong):
    def fn(raw, rng):
        p = jax_eval_preprocess(raw, CONFIG["num_classes"])
        return {"image": p["image"], "label": p["label"], "scribble": p["scribble"],
                "valid_mask": p["region_mask"]}
    return fn


def _port_aug(base, strong, do_strong):
    def fn(raw, generator):
        p = eval_preprocess_batch(raw, CONFIG["num_classes"])
        return {"image": p["image"], "label": p["label"], "scribble": p["scribble"],
                "valid_mask": p["region_mask"]}
    return fn


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both loops' run dirs, JAX's saved states, the port's final state."""
    return _run_loops(tmp_path_factory.mktemp("control_loop"), CONFIG)


QUIRK_EPOCHS = 3
QUIRK = {**CONFIG, "epoch": QUIRK_EPOCHS, "ref_quirk_bn_eval_after_first_epoch": True}


@pytest.fixture(scope="module")
def quirk_runs(tmp_path_factory):
    """The same under the BatchNorm quirk, three epochs."""
    return _run_loops(tmp_path_factory.mktemp("control_loop_quirk"), QUIRK)


def _run_loops(root, config):
    """Run JAX's loop, the port's and the port's from nudged weights on one
    pool under ``config``; their run dirs and saved states."""
    data = str(root / "data")
    _pool_script().write_pool(data, SLICES, seed=1, size=(S, S))
    for side in ("jax", "port", "nudged"):
        (root / side).mkdir()
    mp = pytest.MonkeyPatch()
    saved, init = {}, {}
    try:
        mp.setattr(jax_loop, "make_train_augment_fn", _jax_aug)
        mp.setattr(jax_loop, "_tb_writer", lambda run_dir: None)
        make_state = jax_loop.create_train_state

        class _JitInit:          # model.init compiled: ~26 s less than op by op
            def __init__(self, model):
                self.model = model

            def init(self, *args, **kw):
                lowered = jax.jit(self.model.init, static_argnames=("train",)).lower(*args, **kw)
                return lowered.compile(
                    compiler_options={"xla_backend_optimization_level": 0})(*args)

        def jax_state(rng, model, *args, **kw):
            state = make_state(rng, _JitInit(model), *args, **kw)
            init["state"] = jax.tree.map(np.asarray, state)
            return state

        mp.setattr(jax_loop, "create_train_state", jax_state)
        mp.setattr(jax_ckpt, "save_checkpoint",
                   lambda path, state: saved.__setitem__(pathlib.Path(path).name, state))
        jax_run = jax_loop.train_driver(JaxConfig(**config).validate(), data,
                                        run_dir=str(root / "jax"))

        mp.setattr(loop, "make_train_augment_fn", _port_aug)
        mp.setattr(loop, "_tb_writer", lambda run_dir: None)
        make_port_state = loop.create_train_state
        nudge = {}

        def port_state(config, **kw):
            state = make_port_state(config, **kw)
            j = init["state"]
            sd = {k: torch.as_tensor(np.asarray(v))
                  for k, v in from_jax_variables(j.params, j.batch_stats).items()}
            if nudge:
                gen = torch.Generator().manual_seed(nudge["seed"])
                sd = {k: v * (1 + NUDGE * torch.randn(v.shape, generator=gen))
                      if k.endswith((".weight", ".bias")) else v for k, v in sd.items()}
            missing, unexpected = state.model.load_state_dict(sd, strict=False)
            assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
            return state

        mp.setattr(loop, "create_train_state", port_state)
        port_saved = {"port": {}, "nudged": {}}
        save = ckpt.save_checkpoint
        for side in ("port", "nudged"):
            def port_save(path, state, side=side):
                port_saved[side][pathlib.Path(path).name] = {
                    k: v.detach().clone() for k, v in state.model.state_dict().items()}
                save(path, state)

            mp.setattr(ckpt, "save_checkpoint", port_save)
            nudge.update({"seed": 1} if side == "nudged" else {})
            loop._train_driver(ExperimentConfig(**config).validate(), data, str(root / side),
                               device="cpu")
    finally:
        mp.undo()
    return {"data": data, "jax": jax_run, "port": str(root / "port"), "epochs": config["epoch"],
            "nudged": str(root / "nudged"), "jax_saved": saved,
            "port_saved": port_saved["port"], "nudged_saved": port_saved["nudged"]}


def _val_lines(run_dir):
    """``(loss, {class: Dice}, All)`` of each ``val:`` line of ``log.txt``."""
    out = []
    for line in (pathlib.Path(run_dir) / "log.txt").read_text().splitlines():
        m = re.search(r"val: \d+, loss: ([0-9.]+), \[(.*), All: ([0-9.]+)\]", line)
        if m:
            classes = dict(kv.rsplit(": ", 1) for kv in m.group(2).split(", "))
            out.append((float(m.group(1)), {k: float(v) for k, v in classes.items()},
                        float(m.group(3))))
    return out


def test_both_loops_ran_two_epochs_on_the_r3_split(runs):
    for side in ("jax", "port"):
        log = (pathlib.Path(runs[side]) / "log.txt").read_text()
        assert "train slices=24 val slices=6" in log, side
        assert len(_val_lines(runs[side])) == EPOCHS, side
    assert {"ckp_0", "ckp_1"} <= set(runs["jax_saved"]) & set(runs["port_saved"])


def test_valdice_per_epoch_matches_jax(runs):
    _check_valdice(runs)


def _check_valdice(runs):
    want = np.load(pathlib.Path(runs["jax"]) / "valdice.npz")["valdice"]
    got = np.load(pathlib.Path(runs["port"]) / "valdice.npz")["valdice"]
    assert got.shape == want.shape == (runs["epochs"],) and np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=DICE_ATOL)


def test_validation_line_per_class_matches_jax(runs):
    _check_validation_lines(runs)


def _check_validation_lines(runs):
    lines = {side: _val_lines(runs[side]) for side in ("jax", "port", "nudged")}
    for (loss_j, cls_j, all_j), (loss_p, cls_p, all_p), (loss_n, _, _) in zip(
            lines["jax"], lines["port"], lines["nudged"]):
        assert list(cls_p) == list(cls_j)
        for k in cls_j:
            assert abs(cls_p[k] - cls_j[k]) <= CLASS_ATOL, (k, cls_p[k], cls_j[k])
        assert abs(all_p - all_j) <= DICE_ATOL
        bound = LOSS_SPREADS * abs(loss_p - loss_n) + LOSS_RTOL * loss_j
        assert abs(loss_p - loss_j) <= bound, (loss_p, loss_j, loss_n)


def _stats_error(got, want):
    """The largest error of a BatchNorm running statistic over the largest
    value of its buffer, over the model's buffers."""
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 22
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
               / float(np.abs(np.asarray(want[k])).max()) for k in keys)


def test_batch_norm_statistics_after_epoch_0_match_jax(runs):
    _check_stats(runs)


def _check_stats(runs):
    j = runs["jax_saved"]["ckp_0"]
    want = from_jax_variables(jax.tree.map(np.asarray, j.params),
                              jax.tree.map(np.asarray, j.batch_stats))
    got = _stats_error(runs["port_saved"]["ckp_0"], want)
    spread = _stats_error(runs["nudged_saved"]["ckp_0"], runs["port_saved"]["ckp_0"])
    print(json.dumps({"bn_stats_error": got, "bn_stats_spread": spread}))
    assert got <= STATS_SPREADS * spread + STATS_FLOOR, (got, spread)


def test_final_models_flip_few_validation_pixels(runs):
    """The final models' argmax over the validation slices' live regions
    (the port's eval forward, each with its own weights): the share of
    pixels where JAX's and the port's differ, against the share where the
    port's and the nudged run's differ."""
    _check_flips(runs)


def _check_flips(runs):
    from pacingpseudo_torch.data.npz_dataset import SliceDataset
    from pacingpseudo_torch.data.splits import read_fold_split

    last = runs["epochs"] - 1
    j = runs["jax_saved"][f"ckp_{last}"]
    _, val = read_fold_split(runs["data"], "chaost1", 0, "t1")
    ds = SliceDataset(val, 5, 5)
    raw = [ds.load(i) for i in range(len(ds))]
    proc = eval_preprocess_batch({k: torch.as_tensor(np.stack([r[k] for r in raw]))
                                  for k in ("image", "label", "scribble", "size")}, 5)
    pred = {}
    for side, sd in (("jax", from_jax_variables(jax.tree.map(np.asarray, j.params),
                                                jax.tree.map(np.asarray, j.batch_stats))),
                     ("port", runs["port_saved"][f"ckp_{last}"]),
                     ("nudged", runs["nudged_saved"][f"ckp_{last}"])):
        model = UNet(num_classes=5, init_ch=8, output_stride=8)
        model.load_state_dict({k[len("backbone."):]: torch.as_tensor(np.asarray(v))
                               for k, v in sd.items() if k.startswith("backbone.")})
        with torch.no_grad():
            pred[side] = model.eval()(proc["image"])["segmentation/logits"].argmax(1)
    region = proc["region_mask"][:, 0] > 0

    def share(a, b):
        return float(((pred[a] != pred[b]) & region).sum()) / float(region.sum())

    got, spread = share("jax", "port"), share("nudged", "port")
    print(json.dumps({"flipped_share": got, "flipped_share_nudged": spread}))
    assert got <= FLIP_SPREADS * spread + FLIP_FLOOR, (got, spread)


def _check_frozen(runs):
    """Both loops validated every epoch; the port's log says the frozen-BN
    step took over at epoch 1 (JAX's loop logs nothing there); the running
    statistics after the last epoch are epoch 0's, bit for bit, on both
    sides."""
    for side in ("jax", "port"):
        assert len(_val_lines(runs[side])) == QUIRK_EPOCHS, side
    log = (pathlib.Path(runs["port"]) / "log.txt").read_text()
    assert "epoch 001 on: frozen-BN step" in log.split("epoch: 001")[0].split("val: 000")[1]
    last = f"ckp_{QUIRK_EPOCHS - 1}"
    for key, value in runs["port_saved"]["ckp_0"].items():
        if key.endswith(("running_mean", "running_var")):
            assert torch.equal(runs["port_saved"][last][key], value), key
    for a, b in zip(jax.tree.leaves(runs["jax_saved"]["ckp_0"].batch_stats),
                    jax.tree.leaves(runs["jax_saved"][last].batch_stats)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("check", [_check_frozen, _check_valdice, _check_validation_lines,
                                   _check_stats, _check_flips],
                         ids=["frozen", "valdice", "val_line", "bn_stats", "flips"])
def test_frozen_bn_loop_matches_jax(quirk_runs, check):
    check(quirk_runs)
