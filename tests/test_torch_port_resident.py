"""The resident training pool, chunked dispatch and the training dtypes of
the port (``data/resident.py``, ``train/step.py``'s chunked steps,
``train/loop.py``'s ``steps_per_dispatch`` / ``device_resident_data``) on
the CPU, against the JAX package.  64x64 canvases, init_ch 8, float32, a
seeded synthetic CHAOS pool of 24 slices (fold 1: 18 training, 6
validation).

* The training dtypes: the pool, its gathered batches and the streamed
  batches equal JAX's ``_shrink_raw`` of the same loader batches (float16
  image, uint8 label/scribble) bit for bit, and JAX's single-device
  ``make_resident_gather`` on the same index blocks.  The batches the
  loop's step receives are held on both paths: before the repair the port
  trained on float32 canvases.
* Resident validation: the rounded validation pool equals JAX's; its sums
  equal the port's batch-by-batch ``ValState`` over the same rounded
  batches at ``test_torch_port_loop.py``'s tolerances (loss exactly, Dice
  rtol 1e-12), and JAX's ``make_resident_eval_fn`` on JAX's pool at
  ``test_torch_port_upper_bound.py``'s (loss rtol 1e-4, counts equal, Dice
  sums atol 1e-2).
* The chunked step at K = 2 on a pre-augmented pool, from JAX's weights:
  the trajectory test's five steps as three dispatches across two epoch
  boundaries (2 + 2 + a remainder of 1; frozen BN from step 3) against
  JAX's ``make_resident_chunked_train_step(body, 2)`` (``(body, 1)`` for
  the remainder, as JAX's loop builds it), with Adam, at
  ``test_torch_port_trajectory.py``'s tolerances: each dispatch's summed
  metrics rtol 1e-3; per leaf, the parameters and Adam's moments within 4x
  the port's own spread + 1e-3 (the leaves no LeakyReLU flip reaches
  within 2e-2), and the root-sum-square over the leaves within the
  spread's; every element within 2 lr a step; BN statistics and the bank
  within 1e-3 x max.  The pool holds the trajectory test's batches in the
  layout that test hands them over (``_nchw``), which ``gather`` keeps, so
  the chunked run equals the trajectory test's eager run bit for bit; the
  port's spread is the chunked runs from weights perturbed by 1e-7
  relative, as there.
* The loop: the final state and the log's metric lines are equal bit for
  bit across ``steps_per_dispatch`` 1, 3 (not a divisor of the 4 steps an
  epoch) and 5 (> the epoch) x ``device_resident_data`` on / off, and
  across a stop after epoch 0 and a resume; ``auto`` follows the 6 GiB
  rule.  The step's scalars (epoch and learning rate, the key of a
  captured CUDA graph) are those the eager update uses.
* One momentum (SGD) step against JAX's, at ``test_torch_port_step.py``'s
  tolerances.

Torch runs on one thread (module fixture): under six workers the default
pool oversubscribes the machine, and bit-equal comparisons of two CPU runs
need one reduction order.
"""
from __future__ import annotations

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacingpseudo_tpu.config import ExperimentConfig as JaxConfig
from pacingpseudo_tpu.data import BatchLoader as JaxLoader
from pacingpseudo_tpu.data import SliceDataset as JaxDataset
from pacingpseudo_tpu.models import PacingPseudoModel as JaxPacing
from pacingpseudo_tpu.parallel import make_resident_gather
from pacingpseudo_tpu.tools.torch_import import convert_state_dict
from pacingpseudo_tpu.train import optim as jax_optim
from pacingpseudo_tpu.train.loop import _shrink_raw
from pacingpseudo_tpu.train.state import TrainState as JaxState
from pacingpseudo_tpu.train.step import make_pacing_train_step as jax_train_step
from pacingpseudo_tpu.train.step import make_resident_chunked_train_step as jax_chunked
from pacingpseudo_tpu.train.step import make_resident_eval_fn as jax_resident_eval
from pacingpseudo_torch.aug.engine import eval_preprocess_batch
from pacingpseudo_torch.cli import train as cli
from pacingpseudo_torch.data import npz_dataset, resident
from pacingpseudo_torch.data.npz_dataset import BatchLoader, SliceDataset
from pacingpseudo_torch.data.splits import read_fold_split
from pacingpseudo_torch.data.synthetic import write_synthetic_dataset
from pacingpseudo_torch.train import checkpoint as ckpt_lib
from pacingpseudo_torch.train import loop
from pacingpseudo_torch.train import step as step_mod
from pacingpseudo_torch.train.optim import lr_at, make_capturable
from pacingpseudo_torch.train.state import build_model, create_train_state
from pacingpseudo_torch.train.step import (make_pacing_eval_step, make_pacing_train_step,
                                           make_resident_chunked_train_step)
from test_torch_port_step import (C, FLAGS, HID, INIT_CH, N, S, _assert_grads_close,
                                  _batch, _bn_fed_conv_bias, _compiled, _grad_stash,
                                  _initial_state_dict, _nchw, _np)
from test_torch_port_trajectory import PERTURB, PERTURB_SEEDS, TIGHT, _batches

SLICES = 24
SMALL = ["--input_size", str(S), str(S), "--init_ch", str(INIT_CH), "--hid_ch", str(HID),
         "--batch_size", "2", "--compute_dtype", "float32", "--no-tb_figures"]
EXPERIMENT = ["--session", "Experiment", "--do_loss_ent", "--do_decoder_consistency",
              "--do_aux_path", "--do_memory"]
STEPS = 4          # per epoch in the loop runs


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pool"))
    write_synthetic_dataset(root, "chaos", SLICES, (S, S), 5, 5, seed=1)
    return root


@pytest.fixture(scope="module")
def splits(data_root):
    train_files, val_files = read_fold_split(data_root, "chaos", 1, "t1")
    train_ds = SliceDataset(train_files, 5, 5)
    val_ds = SliceDataset(val_files, 5, 5, canvas_size=train_ds.canvas_size)
    return train_ds, val_ds


def _config(**kw):
    args = cli.build_parser().parse_args(["--tag", "t", *SMALL, *EXPERIMENT, "--epoch", "2"])
    return dataclasses.replace(cli.config_from_args(args), **kw).validate()


def _jax_stage(files, canvas_size=None):
    """JAX's staging of a split (loop.py:425-445): the loader's batches
    through ``_shrink_raw``, concatenated."""
    ds = JaxDataset(files, 5, 5, canvas_size=canvas_size)
    parts = [_shrink_raw({k: v for k, v in b.items() if k != "uid"})
             for b in JaxLoader(ds, batch_size=256, shuffle=False, drop_last=False)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == v.dtype and g.shape == v.shape, (k, g.dtype, v.dtype)
        np.testing.assert_array_equal(g, v, err_msg=k)


def test_shrink_raw_equals_jax(splits):
    train_ds, _ = splits
    for batch in BatchLoader(train_ds, 4):
        batch.pop("uid")
        want = _shrink_raw(batch)
        _assert_same(npz_dataset.shrink_raw(batch), want)
        _assert_same(npz_dataset.raw_batch_to_device(batch, "cpu", shrink=True), want)
        assert np.abs(batch["image"] - want["image"].astype(np.float32)).max() > 0


def test_pool_and_gather_equal_jax(splits):
    train_ds, _ = splits
    pool = resident.stage_train_pool(train_ds, "cpu")
    want = _jax_stage(train_ds.file_ls)
    _assert_same(pool, want)
    jax_gather = make_resident_gather(None)
    order = np.arange(len(train_ds))
    np.random.RandomState([3, 0]).shuffle(order)
    for idx in order[:16].reshape(4, 4).astype(np.int32):
        got = resident.gather(pool, torch.from_numpy(idx))
        _assert_same(got, {k: np.asarray(v) for k, v in jax_gather(want, idx).items()})


def _recorded_raws(monkeypatch, data_root, tmp_path, **kw):
    """The raw batches the loop's train step receives (its augmentation's
    input), epoch 0, on the host."""
    seen = []
    make = loop.make_train_augment_fn

    def recording(*args, **kwargs):
        fn = make(*args, **kwargs)

        def wrapped(raw, generator):
            seen.append({k: v.numpy().copy() for k, v in raw.items()})
            return fn(raw, generator)
        return wrapped

    monkeypatch.setattr(loop, "make_train_augment_fn", recording)
    loop._train_driver(_config(epoch=1, **kw), data_root, str(tmp_path / "run"),
                       max_steps_per_epoch=3, device="cpu")
    return seen


@pytest.mark.parametrize("mode", ["on", "off"])
def test_the_loop_trains_on_jax_rounded_batches(monkeypatch, data_root, splits, tmp_path,
                                                mode):
    """The repair: streamed and resident, the step's raw batches are JAX's
    ``_shrink_raw`` of the loader's batches in the loop's order."""
    train_ds, _ = splits
    seen = _recorded_raws(monkeypatch, data_root, tmp_path, device_resident_data=mode,
                          steps_per_dispatch=2)
    order = np.arange(len(train_ds))
    np.random.RandomState([1 + 2, 0]).shuffle(order)      # seed 1, epoch 0
    blocks = order[:3 * 2].reshape(3, 2)
    loader = JaxLoader(JaxDataset(train_ds.file_ls, 5, 5), 2)
    want = [_shrink_raw({k: v for k, v in loader._collate(b).items() if k != "uid"})
            for b in blocks]
    assert len(seen) == len(want) == 3
    for got, w in zip(seen, want):
        _assert_same(got, w)


def test_resident_validation_equals_valstate_and_jax(splits):
    train_ds, val_ds = splits
    config = _config(batch_size=4)        # 6 validation slices: a partial last batch
    pool = loop.stage_val_pool(val_ds, config.batch_size, "cpu", shrink=True)
    jax_pool = _jax_stage(val_ds.file_ls, canvas_size=train_ds.canvas_size)
    _assert_same(pool.raw, jax_pool)
    assert loop.stage_val_pool(val_ds, 4, "cpu").raw["image"].dtype == torch.float32

    state = create_train_state(config, device="cpu", seed=3)
    acc = loop.make_resident_eval_fn(config)(state, pool)
    per_class, avg_all, loss = loop.summarize_validation(acc)
    vs = loop.ValState(config.num_classes)
    eval_step = make_pacing_eval_step(config)
    for raw in BatchLoader(val_ds, config.batch_size):
        raw.pop("uid")
        raw, n_real = loop._pad_batch(raw, config.batch_size)
        batch = eval_preprocess_batch(npz_dataset.raw_batch_to_device(raw, "cpu", shrink=True),
                                      config.num_classes)
        batch["sample_valid"] = torch.arange(config.batch_size) < n_real
        loss_b, dice, _ = eval_step(state, batch)
        vs.update(loss_b, dice.numpy(), n_real, n_real)
    want_class, want_all = vs.summary()
    assert loss == vs.loss.avg
    np.testing.assert_allclose(per_class, want_class, rtol=1e-12)
    assert np.isclose(avg_all, want_all, rtol=1e-12)

    flags = dict(FLAGS, num_classes=5, ignored_index=5, batch_size=4)
    params, stats, bank = convert_state_dict(
        {k: v.numpy() for k, v in state.model.state_dict().items()})
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                      opt_state=(), memory_bank=jnp.asarray(bank))
    model = JaxPacing(num_classes=5, init_ch=INIT_CH, do_aux_path=True, hid_ch=HID,
                      s2d_hires=False, dtype=jnp.float32)
    want = _compiled(jax_resident_eval(JaxConfig(**flags).validate(), model,
                                       upper_bound=False),
                     jstate, jax_pool, pool.idx_blocks.numpy().astype(np.int32),
                     pool.valid_blocks.numpy())
    assert float(acc["n_sum"]) == float(want["n_sum"]) == len(val_ds)
    assert np.isclose(float(acc["loss_sum"]), float(want["loss_sum"]), rtol=1e-4)
    np.testing.assert_array_equal(acc["dice_cnt"].numpy(), np.asarray(want["dice_cnt"]))
    np.testing.assert_allclose(acc["dice_sum"].numpy(), np.asarray(want["dice_sum"]),
                               atol=1e-2)


# ---------------------------------------------------------------------------
# The chunked step against JAX's, K = 2
# ---------------------------------------------------------------------------

K = 2
CHUNK_SPE = 2           # steps an epoch, as in the trajectory test
# The trajectory test's five steps as three dispatches: epoch 0 (train-mode
# BN), epoch 1 and the one step of epoch 2 (frozen BN; the remainder).
DISPATCHES = ((True, 0, 2), (False, 2, 4), (False, 4, 5))


def _chunk_flags(optimizer):
    return dict(FLAGS, epoch=20, aux_drop_prob=0.0, optimizer=optimizer,
                ref_quirk_bn_eval_after_first_epoch=True)


@pytest.fixture(scope="module")
def chunk_data():
    """A pre-augmented pool of the trajectory test's five batches (10
    samples, in order) and the (5, N) index blocks of its steps."""
    batches = _batches()
    pool = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    return pool, np.arange(len(pool["image"]), dtype=np.int32).reshape(len(batches), N)


@pytest.fixture(scope="module")
def chunk_run(chunk_data):
    """JAX's three chunked dispatches: final state and summed metrics."""
    from pacingpseudo_torch.tools.weights import from_jax_variables

    pool, blocks = chunk_data
    sd0 = _initial_state_dict()
    params, stats, bank = convert_state_dict({k: v.numpy() for k, v in sd0.items()})
    config = JaxConfig(**_chunk_flags("adam")).validate()
    model = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=True,
                      hid_ch=HID, s2d_hires=False, dtype=jnp.float32)
    tx = jax_optim.make_optimizer(config, CHUNK_SPE)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=stats, opt_state=tx.init(params),
                     memory_bank=jnp.asarray(bank))
    key = jax.random.key(0, impl="rbg")
    sums, compiled = [], {}
    for module_train, a, b in DISPATCHES:
        idx = blocks[a:b]
        if (module_train, b - a) not in compiled:
            body = jax_train_step(config, model, tx, CHUNK_SPE, module_train=module_train,
                                  jit=False)
            compiled[module_train, b - a] = jax_chunked(body, b - a).lower(
                state, pool, idx, key).compile(
                    compiler_options={"xla_backend_optimization_level": 0})
        state, m = compiled[module_train, b - a](state, pool, idx, key)
        sums.append({k: float(v) for k, v in m.items()})
    adam = state.opt_state[1]
    buffers = {k: from_jax_variables(_np(v), {})
               for k, v in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu))}
    return dict(optimizer="adam", sd0=sd0, sums=sums, buffers=buffers,
                sd=from_jax_variables(_np(state.params), _np(state.batch_stats),
                                      np.array(state.memory_bank)),
                step=int(state.step))


def _port_state(run, perturb_seed=None):
    """A port state from the JAX run's initial weights, perturbed by
    ``PERTURB`` relative noise of ``perturb_seed`` (as the trajectory test
    perturbs them)."""
    config = _port_config(run["optimizer"])
    sd = {k: v.clone() for k, v in run["sd0"].items()}
    if perturb_seed is not None:
        gen = torch.Generator().manual_seed(perturb_seed)
        for k, v in sd.items():
            if k.endswith("weight"):
                v.mul_(1 + PERTURB * torch.randn(v.shape, generator=gen))
    model = build_model(config, device="cpu")
    model.load_state_dict(sd, strict=True)
    return config, create_train_state(config, device="cpu", model=model)


def _port_chunks(run, chunk_data, perturb_seed=None):
    """The port's three chunked dispatches from the JAX run's initial state."""
    pool, blocks = chunk_data
    config, state = _port_state(run, perturb_seed)
    port_pool = {k: _nchw(v) for k, v in pool.items()}
    generator = torch.Generator()
    chunked = {mt: make_resident_chunked_train_step(
        make_pacing_train_step(config, CHUNK_SPE, module_train=mt), K, port_pool)
        for mt in (True, False)}
    sums = []
    for module_train, a, b in DISPATCHES:
        acc = chunked[module_train](state, torch.from_numpy(blocks[a:b]), generator,
                                    config.seed)
        sums.append({k: float(v) for k, v in acc.items()})
    return state, sums


def _port_eager(run, chunk_data):
    """The same five updates as eager steps on the batches as the trajectory
    test hands them over (``_nchw`` of each batch): that test's own run."""
    pool, blocks = chunk_data
    config, state = _port_state(run)
    steps = {mt: make_pacing_train_step(config, CHUNK_SPE, module_train=mt)
             for mt in (True, False)}
    for module_train, a, b in DISPATCHES:
        for idx in blocks[a:b]:
            steps[module_train](state, {k: _nchw(v[idx]) for k, v in pool.items()})
    return state


def _port_config(optimizer):
    from pacingpseudo_torch.config import ExperimentConfig
    return ExperimentConfig(**_chunk_flags(optimizer)).validate()


def _distances(state, other, run, name):
    """Relative L2 distances of one leaf between ``state`` and ``other``
    (JAX's final state when None): the parameter over the JAX update, each
    optimizer buffer over its norm."""
    params = dict(state.model.named_parameters())
    want, start = run["sd"][name], run["sd0"][name]
    if other is None:
        q, bufs = want, {k: v[name] for k, v in run["buffers"].items()}
    else:
        o = dict(other.model.named_parameters())[name]
        q, bufs = o.detach(), {k: other.optimizer.state[o][k] for k in run["buffers"]}
    st = state.optimizer.state[params[name]]
    return np.array([float((params[name].detach() - q).norm() / (want - start).norm())]
                    + [float((st[k] - bufs[k]).norm() / run["buffers"][k][name].norm())
                       for k in sorted(run["buffers"])])


def test_chunked_step_matches_jax(chunk_run, chunk_data):
    """The port's chunked step against JAX's, with the chunked runs from the
    three perturbed weight sets as the port's spread.  The unperturbed run
    is the trajectory test's eager run bit for bit."""
    state, sums = _port_chunks(chunk_run, chunk_data)
    perturbed = [_port_chunks(chunk_run, chunk_data, s)[0] for s in PERTURB_SEEDS]
    assert state.step == chunk_run["step"] == DISPATCHES[-1][2]
    _assert_states_equal(state, _port_eager(chunk_run, chunk_data))

    for got, want in zip(sums, chunk_run["sums"]):
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.isclose(got[k], want[k], rtol=1e-3, atol=0), (k, got[k], want[k])

    errs, yard = [], []
    for name, _ in state.model.named_parameters():
        if _bn_fed_conv_bias(name):
            continue
        err = _distances(state, None, chunk_run, name)
        ref = np.max([_distances(state, o, chunk_run, name) for o in perturbed], axis=0)
        assert (err <= 4 * ref + 1e-3).all(), (name, err, ref)
        if name.startswith(TIGHT):
            assert (err <= 2e-2).all(), (name, err)
        errs.append(err)
        yard.append(ref)
    total, total_ref = np.sqrt(np.square(errs).sum(0)), np.sqrt(np.square(yard).sum(0))
    assert (total <= total_ref).all(), (total, total_ref)

    lr_max = max(m["lr"] for m in chunk_run["sums"])     # a sum >= each step's rate
    for name, p in state.model.named_parameters():   # Adam: about lr an element a step
        diff = float((p.detach() - chunk_run["sd"][name]).abs().max())
        assert diff <= 2 * lr_max * state.step + 1e-6, name

    sd = state.model.state_dict()
    for name, want in chunk_run["sd"].items():
        if name.endswith(("running_mean", "running_var", "memory_bank")):
            err = float((sd[name] - want).abs().max())
            assert err <= 1e-3 * float(want.abs().max()), (name, err)


def _assert_states_equal(a, b):
    """Model state and Adam's moments bit for bit."""
    sd_a, sd_b = a.model.state_dict(), b.model.state_dict()
    assert sorted(sd_a) == sorted(sd_b)
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_b)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        st_a, st_b = a.optimizer.state[p], b.optimizer.state[q]
        assert all(torch.equal(st_a[k], st_b[k]) for k in ("exp_avg", "exp_avg_sq"))


def test_chunked_step_equals_the_eager_steps(chunk_data):
    """On the CPU the chunked step is the eager step K times: the same
    state and the per-step metrics summed in order, bit for bit (K = 2
    batches of pool samples in a shuffled order)."""
    pool, _ = chunk_data
    blocks = np.random.RandomState(0).permutation(len(pool["image"]))[:K * N].reshape(K, N)
    blocks = torch.from_numpy(blocks.astype(np.int32))
    config = _port_config("adam")
    port_pool = {k: _nchw(v) for k, v in pool.items()}
    states = []
    for chunked in (True, False):
        state = create_train_state(config, device="cpu", seed=4)
        step = make_pacing_train_step(config, CHUNK_SPE)
        if chunked:
            acc = make_resident_chunked_train_step(step, K, port_pool)(
                state, blocks, torch.Generator(), 1)
        else:
            acc = None
            for idx in blocks:
                m = step(state, resident.gather(port_pool, idx))
                acc = m if acc is None else {k: acc[k] + v for k, v in m.items()}
        states.append((state, acc))
    (a, acc_a), (b, acc_b) = states
    assert a.step == b.step == K
    for k in acc_b:
        assert acc_a[k] == acc_b[k] if k == "lr" else torch.equal(acc_a[k], acc_b[k]), k
    sd_a, sd_b = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_b)


def test_a_chunk_takes_at_most_chunk_steps(chunk_data):
    pool, _ = chunk_data
    config = _port_config("adam")
    state = create_train_state(config, device="cpu", seed=4)
    chunked = make_resident_chunked_train_step(make_pacing_train_step(config, CHUNK_SPE), K,
                                               {k: _nchw(v) for k, v in pool.items()})
    with pytest.raises(ValueError, match="1 to 2"):
        chunked(state, torch.zeros((K + 1, N), dtype=torch.int32), torch.Generator(), 1)


# ---------------------------------------------------------------------------
# The loop across dispatch settings
# ---------------------------------------------------------------------------

def _state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        for k, v in state.optimizer.state[p].items():
            out[f"opt.{name}.{k}"] = v
    return out


def _metric_lines(run_dir):
    """The log's epoch and validation lines without their times."""
    lines = []
    for line in open(os.path.join(run_dir, "log.txt")):
        line = line.split("] ", 1)[1]
        if line.startswith(("epoch: ", "val: ")):
            lines.append(re.sub(r", [\d.]+ s/epoch, [\d.]+ slices/s", "", line))
    return lines


@pytest.fixture(scope="module")
def eager_run(data_root, tmp_path_factory):
    """Today's loop: eager steps on streamed batches."""
    config = _config(steps_per_dispatch=1, device_resident_data="off",
                     ref_quirk_bn_eval_after_first_epoch=True)
    run_dir, state = loop._train_driver(config, data_root,
                                        str(tmp_path_factory.mktemp("eager")),
                                        max_steps_per_epoch=STEPS, device="cpu")
    return state, _metric_lines(run_dir)


@pytest.mark.parametrize("spd,mode", [(1, "on"), (3, "on"), (3, "off"), (5, "on"),
                                      (5, "off")])
def test_the_loop_is_the_same_for_every_dispatch(data_root, tmp_path, eager_run, spd, mode):
    config = _config(steps_per_dispatch=spd, device_resident_data=mode,
                     ref_quirk_bn_eval_after_first_epoch=True)
    run_dir, state = loop._train_driver(config, data_root, str(tmp_path / "run"),
                                        max_steps_per_epoch=STEPS, device="cpu")
    want_state, want_lines = eager_run
    got_lines = _metric_lines(run_dir)
    # the validation pool is rounded only when the run is resident
    train_lines = [line for line in got_lines if line.startswith("epoch")]
    assert train_lines == [line for line in want_lines if line.startswith("epoch")]
    assert len(got_lines) == len(want_lines) == 4
    if mode == "off":
        assert got_lines == want_lines
    log = open(os.path.join(run_dir, "log.txt")).read()
    assert f"steps per dispatch {min(spd, STEPS)} (eager steps)" in log
    assert ("resident on the device" in log) == (mode == "on")
    got, want = _state_tensors(state), _state_tensors(want_state)
    assert state.step == want_state.step == 2 * STEPS and sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_stop_and_resume_inside_chunked_epochs(data_root, tmp_path, eager_run):
    config = _config(steps_per_dispatch=3, device_resident_data="on",
                     ref_quirk_bn_eval_after_first_epoch=True)
    part = str(tmp_path / "part")
    loop._train_driver(config, data_root, part, max_steps_per_epoch=STEPS,
                       stop_after_epoch=0, device="cpu")
    _, resumed = loop._train_driver(dataclasses.replace(config, resume=True), data_root,
                                    part, max_steps_per_epoch=STEPS, device="cpu")
    assert "resumed from" in open(os.path.join(part, "log.txt")).read()
    got, want = _state_tensors(resumed), _state_tensors(eager_run[0])
    assert resumed.step == 2 * STEPS
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("mode,slices,canvas,want", [
    ("on", 10, 64, True), ("off", 10, 64, False), ("auto", 1533, 256, True),
    ("auto", 24_575, 256, True), ("auto", 24_576, 256, False), ("auto", 30_000, 256, False)])
def test_auto_follows_the_6_gib_rule(mode, slices, canvas, want):
    assert resident.use_resident(mode, slices, canvas) is want
    if mode == "auto":
        # JAX's pool_bytes < n_dev * 6 GiB at one device (loop.py:414-419)
        assert want == (slices * canvas ** 2 * 4 < 6 * 2 ** 30)


def test_the_step_scalars_are_the_eager_updates(monkeypatch):
    """``step.scalars(n)`` -- the epoch and the learning rate a captured
    step bakes in -- equals what the eager update ``n`` uses: the epoch its
    losses see and the rate it sets; constant inside an epoch, new at each
    epoch boundary."""
    config = _port_config("adam")
    seen = []
    losses = step_mod._pacing_losses

    def recording(cfg, model, batch, epoch):
        seen.append(epoch)
        return losses(cfg, model, batch, epoch)

    monkeypatch.setattr(step_mod, "_pacing_losses", recording)
    step = make_pacing_train_step(config, 3)
    state = create_train_state(config, device="cpu", seed=4)
    batch = {k: _nchw(v) for k, v in _batch().items()}
    keys = []
    for n in range(7):
        want = step.scalars(n)
        m = step(state, batch)
        assert seen[-1] == want.epoch == float(n // 3)
        assert m["lr"] == want.lr == lr_at(config, n, 3)
        assert state.optimizer.param_groups[0]["lr"] == want.lr
        keys.append(want)
    assert keys[0] == keys[1] == keys[2] != keys[3] == keys[4] == keys[5] != keys[6]


def test_a_capturable_state_saves_in_the_eager_layout(tmp_path):
    """A checkpoint of an optimizer made capturable (the CUDA-graph path)
    holds Adam's step counts as CPU scalars and ``capturable`` False, and
    restores into a fresh eager state bit for bit; the live optimizer is
    left as it was."""
    config = _port_config("adam")
    state = create_train_state(config, device="cpu", seed=4)
    make_pacing_train_step(config, CHUNK_SPE)(state, {k: _nchw(v) for k, v in
                                                      _batch().items()})
    make_capturable(state.optimizer)
    assert state.optimizer.param_groups[0]["capturable"]
    ckpt_lib.save_checkpoint(str(tmp_path / "ckp"), state)
    saved = torch.load(str(tmp_path / "ckp" / ckpt_lib.TRAIN_FILE))["optimizer"]
    assert not any(g["capturable"] for g in saved["param_groups"])
    assert all(s["step"].device.type == "cpu" and s["step"].dtype == torch.float32
               and s["step"].dim() == 0 for s in saved["state"].values())
    assert state.optimizer.param_groups[0]["capturable"]
    fresh = ckpt_lib.restore_checkpoint(str(tmp_path / "ckp"),
                                        create_train_state(config, device="cpu", seed=9))
    assert not fresh.optimizer.param_groups[0]["capturable"]
    got, want = _state_tensors(fresh), _state_tensors(state)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# One momentum step against JAX's
# ---------------------------------------------------------------------------

def test_momentum_step_matches_jax():
    """SGD with momentum 0.9: the metrics at rtol 1e-4 and the gradients as
    ``test_torch_port_step.py`` holds them; the first update is ``-lr (g +
    wd p)`` on both sides, so each new parameter is held within lr x the
    gradient tolerance of JAX's, and the momentum buffer within the
    gradient tolerance (L2 1e-2 of its norm)."""
    import optax

    from pacingpseudo_torch.config import ExperimentConfig
    from pacingpseudo_torch.tools.weights import from_jax_variables

    flags = dict(FLAGS, optimizer="momentum")
    sd0, batch = _initial_state_dict(), _batch()
    params, stats, bank = convert_state_dict({k: v.numpy() for k, v in sd0.items()})
    config = JaxConfig(**flags).validate()
    model = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=True,
                      hid_ch=HID, s2d_hires=False, dtype=jnp.float32)
    tx = optax.chain(_grad_stash(), jax_optim.make_optimizer(config, 4))
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                      opt_state=tx.init(params), memory_bank=jnp.asarray(bank))
    new, metrics = _compiled(jax_train_step(config, model, tx, 4, donate=False), jstate,
                             batch, jax.random.key(0, impl="rbg"))
    want_grads = from_jax_variables(_np(new.opt_state[0]), {})
    want_sd = from_jax_variables(_np(new.params), _np(new.batch_stats),
                                 np.array(new.memory_bank))
    want_buf = from_jax_variables(_np(new.opt_state[1][1].trace), {})

    pconfig = ExperimentConfig(**flags).validate()
    pmodel = build_model(pconfig, device="cpu")
    pmodel.load_state_dict(sd0, strict=True)
    state = create_train_state(pconfig, device="cpu", model=pmodel)
    assert isinstance(state.optimizer, torch.optim.SGD)
    got = make_pacing_train_step(pconfig, 4)(state, {k: _nchw(v) for k, v in batch.items()})
    for k, want in metrics.items():
        assert np.isclose(float(got[k]), float(want), rtol=1e-4, atol=0), k
    params = dict(state.model.named_parameters())
    _assert_grads_close(params, want_grads)
    lr = float(metrics["lr"])
    for name, p in params.items():
        buf = state.optimizer.state[p]["momentum_buffer"]
        if _bn_fed_conv_bias(name):
            continue
        assert float((buf - want_buf[name]).norm()) <= 1e-2 * float(want_buf[name].norm()), name
        err = float((p.detach() - want_sd[name]).norm())
        assert err <= lr * 1e-2 * float(want_grads[name].norm()) + 1e-7, name
