"""Port parity: data-parallel training over ranks (``pacingpseudo_torch/
parallel/mesh.py`` and the loop's multi-device branch) against one process
and against the JAX package's sharded step.

Two gloo ranks on the CPU (one torch thread a rank; a ``FileStore`` under
``tmp_path``, so test workers never share a port), 64x64, init_ch 8,
float32, a global batch of 4 (2 rows a rank).  One spawn of
``tests/torch_parallel_ranks.py::units`` computes every unit on both ranks:

* ``factor_devices`` equals JAX's for 1-16 devices and batches 1-16;
* the synchronised BatchNorm, forward and backward, equals one process on
  the concatenated batch (rtol 1e-5, atol 1e-6: the sums are split in two
  and added in another order);
* every loss with a global normaliser (the library's plain versions and
  the fused loss's plain version): the ranks' losses add up to the
  one-process loss and each rank's gradient is its rows of the
  one-process gradient (the same bound);
* ``memory_update`` of the gathered global batch (both ensemble modes,
  ``update_mode`` ``all`` and ``first``) equals one process bit for bit, and
  the sharded pool's gather equals ``data.resident.gather`` of the whole
  pool bit for bit, with a pool of 7 slices over 2 ranks;
* each rank's augmented rows are the one-process augmentation's bit for
  bit;
* one pacing and one upper-bound step on 2 ranks agree with JAX's step on
  a 2-device ``data_mesh(2)`` of the 8 virtual CPU devices within JAX's own
  bounds (``tests/test_sharding.py:66-96``: metrics rtol 2e-4 atol 1e-5,
  parameters within 2·lr, BN statistics rtol 1e-4 atol 1e-6) and with the
  port's one-process step within the same bounds; the summed gradients
  agree with JAX's (read from Adam's first moment) within the one-device
  parity tests' bounds (1e-2 and 2e-2 of a leaf's norm) and with the
  one-process step's within 1e-2; BN statistics, the bank and the
  parameters are equal on both ranks;
* a chunk of K = 2 updates on the 2 ranks (``steps_per_dispatch``),
  resident (the sharded pool's gather) and streamed (the augmentation
  inside), equals the same updates one at a time bit for bit: summed
  metrics, state, Adam's moments, the bank; the resident chunk on a
  pre-augmented pool is held against JAX's
  ``make_resident_chunked_train_step(body, 2, mesh=data_mesh(2))``;
* ``train.step.uses_graph``, the rule of which dispatch a chunk takes, on
  a table of device x chunk x ranks' backend.

Then the loop: 2 ranks against one process, ``device_resident_data`` on
and off, within JAX's bound for its multi-device driver
(``tests/test_driver_multidevice.py:74-75``: val loss rtol 1e-3, val Dice
atol 5e-3); on 2 ranks ``--steps_per_dispatch`` 2 against 1, bit for bit
(checkpoints and metric lines); a 2-rank checkpoint resumed in one process, and a one-process
checkpoint resumed by the CLI on 2 ranks (``--gpu cpu --num_devices 2
--resume``); the splits with a space axis that the CLI runs (an explicit
``--spatial_shards 2``, the AUTO split of 4 devices at batch 6, a space
axis clamped to one device); and the refusals: more devices than listed,
a card that does not exist.
"""
import dataclasses
import glob
import os
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as workers
from pacingpseudo_tpu.config import ExperimentConfig as JaxConfig
from pacingpseudo_tpu.models import PacingPseudoModel as JaxPacing
from pacingpseudo_tpu.parallel import data_mesh, replicate, shard_batch
from pacingpseudo_tpu.parallel import factor_devices as jax_factor_devices
from pacingpseudo_tpu.tools.torch_import import convert_state_dict
from pacingpseudo_tpu.train import optim as jax_optim
from pacingpseudo_tpu.train.state import TrainState as JaxState
from pacingpseudo_tpu.train.step import make_pacing_train_step as jax_pacing_step
from pacingpseudo_tpu.train.step import make_upper_bound_train_step as jax_ub_step
from pacingpseudo_torch.cli import train as train_cli
from pacingpseudo_torch.config import DATASETS, ExperimentConfig
from pacingpseudo_torch.data.resident import gather, stage_train_pool
from pacingpseudo_torch.data.npz_dataset import SliceDataset
from pacingpseudo_torch.data.synthetic import write_synthetic_dataset
from pacingpseudo_torch.models.unet import ConvLayer, torch_default_init_
from pacingpseudo_torch.ops.fused_convbn import get_conv_impl, set_conv_impl
from pacingpseudo_torch.parallel import mesh
from pacingpseudo_torch.tools.weights import from_jax_variables
from pacingpseudo_torch.train import loop
from pacingpseudo_torch.train.state import build_model
from pacingpseudo_torch.train.step import uses_graph

W, N, S, C, INIT_CH, HID = 2, 4, 64, 3, 8, 16
STEPS_PER_EPOCH = 4
CONFIGS = {
    "pacing": dict(num_classes=C, ignored_index=C, init_ch=INIT_CH, hid_ch=HID, batch_size=N,
                   do_loss_ent=True, do_decoder_consistency=True, do_aux_path=True,
                   do_memory=True, compute_dtype="float32"),
    "upper_bound": dict(session="Upperbound", num_classes=C, ignored_index=C,
                        init_ch=INIT_CH, batch_size=N, loss_dice=True,
                        compute_dtype="float32"),
}
LOSSES = ("pce", "ent", "ent_nomask", "sce", "l1", "l2", "kl", "kl_nomask", "dice", "fused")
BANK_MODES = [(e, m) for e in ("cosine_similarity", "mean") for m in ("all", "first")]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread in this module (the ranks take one each): the
    tier-1 run's six workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def _np(tree):
    return jax.tree.map(np.array, tree)


def _state_dict0(name):
    """The seeded initial state of a session (a warm bank with a cold row)."""
    model = build_model(ExperimentConfig(**CONFIGS[name]).validate(), device="cpu")
    torch_default_init_(model, torch.Generator().manual_seed(5))
    if name == "pacing":
        bank = np.random.RandomState(6).randn(C, HID).astype(np.float32)
        bank[1] = 0.0
        model.aux_path.memory_bank.copy_(torch.from_numpy(bank)[:, :, None, None])
    return {k: v.clone() for k, v in model.state_dict().items()}


def _nhwc_batch(name):
    """A pre-augmented global batch (NHWC numpy, JAX's layout)."""
    rs = np.random.RandomState(1 if name == "pacing" else 2)
    image = rs.randn(N, S, S, 1).astype(np.float32)
    if name == "upper_bound":
        return {"image": image,
                "label": np.eye(C, dtype=np.float32)[rs.randint(0, C, (N, S, S))]}
    return {"image": image, "image_strong": rs.randn(N, S, S, 1).astype(np.float32),
            "scribble": np.eye(C + 1, dtype=np.float32)[rs.randint(0, C + 1, (N, S, S))],
            "valid_mask": (rs.rand(N, S, S, 1) > 0.2).astype(np.float32)}


K = 2                 # updates a chunk


def _chunk_pool():
    """A pre-augmented pool of 8 samples (NHWC numpy) and the (K, N) index
    blocks of a chunk, in a shuffled order."""
    rs = np.random.RandomState(7)
    n = 2 * N
    pool = {"image": rs.randn(n, S, S, 1).astype(np.float32),
            "image_strong": rs.randn(n, S, S, 1).astype(np.float32),
            "scribble": np.eye(C + 1, dtype=np.float32)[rs.randint(0, C + 1, (n, S, S))],
            "valid_mask": (rs.rand(n, S, S, 1) > 0.2).astype(np.float32)}
    return pool, rs.permutation(n)[:K * N].reshape(K, N).astype(np.int32)


def _raw_batch(rs):
    """A raw canvas batch of N 32x32 slices of several live sizes."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    label = rs.randint(0, C, (N, 32, 32)).astype(np.float32)
    return {"image": t(rs.randn(N, 32, 32).astype(np.float32)), "label": t(label),
            "scribble": t(np.where(rs.rand(N, 32, 32) < 0.2, label, C).astype(np.float32)),
            "size": t(np.array([[32, 32], [30, 28], [32, 20], [25, 32]], np.int32))}


def chunk_inputs():
    """The inputs of ``workers.chunk_runs``: the pacing session from its
    seeded state, the pool and its blocks, and K raw batches."""
    pool, blocks = _chunk_pool()
    raws = [_raw_batch(np.random.RandomState(20 + k)) for k in range(K)]
    return {"chunk_config": CONFIGS["pacing"], "chunk_sd0": _state_dict0("pacing"),
            "chunk_spe": STEPS_PER_EPOCH, "chunk_pool": {k: _nchw(v) for k, v in pool.items()},
            "chunk_blocks": torch.from_numpy(blocks),
            "chunk_raw": {k: torch.stack([r[k] for r in raws]) for k in raws[0]}}


def _unit_inputs(pool_files):
    rs = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    raw_sizes = np.array([[32, 32], [30, 28], [32, 20], [25, 32]], np.int32)
    label = rs.randint(0, C, (N, 32, 32)).astype(np.float32)
    inp = {
        "logits": t(rs.randn(N, C, 16, 16).astype(np.float32)),
        "logits_strong": t(rs.randn(N, C, 16, 16).astype(np.float32)),
        "target": t(rs.randint(0, C + 1, (N, 16, 16))),
        "mask": t((rs.rand(N, 1, 16, 16) > 0.3).astype(np.float32)),
        "one_hot": t(np.eye(C, dtype=np.float32)[rs.randint(0, C, (N, 16, 16))]
                     .transpose(0, 3, 1, 2)),
        "bn_x": t(rs.randn(N, 5, 6, 6).astype(np.float32) * 2 + 1),
        "bn_w": t(rs.randn(N, 5, 6, 6).astype(np.float32)),
        "aux_features": t(rs.randn(N, HID, 8, 8).astype(np.float32)),
        "scribble": t(np.eye(C + 1, dtype=np.float32)[rs.randint(0, C + 1, (N, 32, 32))]
                      .transpose(0, 3, 1, 2)),
        "bank": t(np.where(np.arange(C)[:, None] == 1, 0.0,
                           rs.randn(C, HID)).astype(np.float32)),
        "raw": {"image": t(rs.randn(N, 32, 32).astype(np.float32)), "label": t(label),
                "scribble": t(np.where(rs.rand(N, 32, 32) < 0.2, label, C)
                              .astype(np.float32)),
                "size": t(raw_sizes)},
        "pool_files": pool_files,
        "pool_idx": torch.tensor([6, 0, 3, 5], dtype=torch.int32),
    }
    for name in CONFIGS:
        inp[f"{name}_config"] = CONFIGS[name]
        inp[f"{name}_sd0"] = _state_dict0(name)
        inp[f"{name}_batch"] = {k: _nchw(v) for k, v in _nhwc_batch(name).items()}
    inp.update(chunk_inputs())
    return inp


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """The unit inputs, and both ranks' results of ``workers.units``."""
    root = tmp_path_factory.mktemp("ranks")
    write_synthetic_dataset(str(root / "pool"), "acdc", 7, (32, 32), C, C, seed=4)
    inp = _unit_inputs(sorted(glob.glob(str(root / "pool/acdc/slices/*.npz"))))
    torch.save(inp, root / "inputs.pt")
    mesh.spawn_ranks(workers.units, W, (["cpu"] * W, str(root / "store"),
                                        str(root / "inputs.pt"), str(root / "out")))
    return inp, [torch.load(f"{root}/out.{r}", weights_only=False) for r in range(W)]


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("devices", range(1, 17))
def test_factor_devices_matches_jax(devices):
    for batch in range(1, 17):
        assert mesh.factor_devices(devices, batch) == jax_factor_devices(devices, batch)


def test_ranks_joined_one_world(units):
    _, res = units
    assert [(r["world"], r["rank"]) for r in res] == [(W, 0), (W, 1)]


def test_sync_bn_matches_one_process(units):
    inp, res = units
    want = workers.sync_bn(inp)
    for r, got in enumerate(res):
        rows = slice(r * N // W, (r + 1) * N // W)
        _close(got["bn"][0], want[0][rows])                    # y
        _close(got["bn"][1], want[1][rows])                    # dx
        for g, w in zip(got["bn"][2:], want[2:]):              # dweight, dbias, stats
            _close(g, w)


@pytest.mark.parametrize("name", LOSSES)
def test_global_normaliser_losses_match_one_process(units, name):
    inp, res = units
    want_loss, want_dlw, want_dls = workers.loss_terms(inp)[name]
    _close(sum(r["losses"][name][0] for r in res), want_loss)
    for r, got in enumerate(res):
        rows = slice(r * N // W, (r + 1) * N // W)
        _close(got["losses"][name][1], want_dlw[rows])
        if want_dls is not None:
            _close(got["losses"][name][2], want_dls[rows])


@pytest.mark.parametrize("mode", BANK_MODES, ids=["-".join(m) for m in BANK_MODES])
def test_memory_update_of_the_gathered_batch_is_bit_equal(units, mode):
    inp, res = units
    want = workers.banks(inp)[mode]
    for got in res:
        assert torch.equal(got["banks"][mode], want)


def test_sharded_pool_gather_is_bit_equal(units):
    inp, res = units
    pool = stage_train_pool(SliceDataset(inp["pool_files"], 3, 3), "cpu")
    want = gather(pool, inp["pool_idx"])
    for got, per in (r["pool"] for r in res):
        assert per == 4                       # 7 slices padded to 8 over 2 ranks
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_augmented_rows_are_bit_equal(units):
    inp, res = units
    want = workers.augmented_rows(inp)
    for r, got in enumerate(res):
        rows = slice(r * N // W, (r + 1) * N // W)
        assert sorted(got["aug"]) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got["aug"][k], v[rows]), k


def _jax_step(name):
    """JAX's step on a 2-device data mesh from the same state and batch:
    ``(metrics, new state_dict, gradients)``.  The gradients (of the loss,
    by port parameter name) are read from Adam's first moment after this
    first update: ``mu = (1 - b1) (g + wd p)``."""
    sd0, batch = _state_dict0(name), _nhwc_batch(name)
    params, stats, bank = convert_state_dict({k: v.numpy() for k, v in sd0.items()})
    config = JaxConfig(**CONFIGS[name]).validate()
    upper = name == "upper_bound"
    model = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=not upper, hid_ch=HID,
                      s2d_hires=False, dtype=jnp.float32)
    tx = jax_optim.make_optimizer(config, STEPS_PER_EPOCH)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                     opt_state=tx.init(params),
                     memory_bank=None if upper else jnp.asarray(bank))
    make = jax_ub_step if upper else jax_pacing_step
    step = make(config, model, tx, STEPS_PER_EPOCH, donate=False)
    dmesh = data_mesh(2)
    args = (replicate(state, dmesh), shard_batch(batch, dmesh), jax.random.key(0, impl="rbg"))
    new, metrics = step.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    stats = _np(new.batch_stats)
    p0 = from_jax_variables(_np(params), stats)
    mu = from_jax_variables(_np(new.opt_state[1].mu), stats)
    return ({k: float(v) for k, v in _np(metrics).items()},
            from_jax_variables(_np(new.params), stats,
                               None if upper else np.array(new.memory_bank)),
            {k: mu[k] / (1 - 0.9) - config.wd * p0[k] for k in p0
             if k.endswith((".weight", ".bias"))})


def _assert_step_close(got, want, lr):
    """JAX's bounds for its sharded step against one device."""
    metrics, sd = got[:2]
    want_metrics, want_sd = want[:2]
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in want_metrics.items():
        assert np.isclose(metrics[k], v, rtol=2e-4, atol=1e-5), (k, metrics[k], v)
    for k, v in want_sd.items():
        if k.endswith(("running_mean", "running_var")):
            _close(sd[k], v, rtol=1e-4, atol=1e-6)
        elif k.endswith("memory_bank"):
            _close(sd[k], v, rtol=1e-4, atol=1e-5)
        elif not k.endswith("num_batches_tracked"):
            assert float((sd[k] - v).abs().max()) <= 2 * lr, k


def _assert_grads_close(grads, want, l2=1e-2):
    """The ranks' summed gradients against ``want``'s, leaf by leaf, each
    within ``l2`` of its L2 norm.  A conv bias that feeds a BatchNorm
    cancels out of the output, so its gradient is roundoff on both sides,
    held under 1e-4 x its weight's largest."""
    assert sorted(grads) == sorted(want)
    for k, g in want.items():
        if k.endswith(".conv.bias") or k == "aux_path.layer_bottleneck.1.bias":
            bound = 1e-4 * float(want[k[:-4] + "weight"].abs().max())
            assert float(grads[k].abs().max()) <= bound, k
            assert float(g.abs().max()) <= bound, k
            continue
        # The L2 bound of tests/test_torch_port_step.py, for its reason: the
        # two float32 forwards add the BN sums in another order, and a pixel
        # whose pre-activation lies that near 0 takes the other LeakyReLU
        # branch on one side (2.4e-3 of enc_block1's norm here).
        assert float((grads[k] - g).norm()) <= l2 * float(g.norm()), k


# The bounds of the JAX parity tests of the one-device steps on the
# gradients (tests/test_torch_port_step.py, tests/test_torch_port_upper_bound.py,
# whose docstrings give the float32 error of either side).  The ranks read
# 6.5e-3 and 1.16e-2 of a leaf's norm here, as the port's one-process step
# does (1.16e-2 in dec_block4's second BN shift, upper bound).
JAX_GRAD_L2 = {"pacing": 1e-2, "upper_bound": 2e-2}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_matches_jax_sharded_step(units, name):
    """JAX's bounds on the update, and the gradients beside them: with Adam
    the first update moves each element by about lr whatever the gradient,
    so 2·lr alone does not hold the summed gradients."""
    _, res = units
    lr = ExperimentConfig(**CONFIGS[name]).lr
    want = _jax_step(name)
    _assert_step_close(res[0][name], want, lr)
    _assert_grads_close(res[0][name][2], want[2], JAX_GRAD_L2[name])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_matches_one_process(units, name):
    inp, res = units
    want = workers.one_step(CONFIGS[name], inp[f"{name}_sd0"], inp[f"{name}_batch"])
    lr = ExperimentConfig(**CONFIGS[name]).lr
    _assert_step_close(res[0][name], want, lr)
    _assert_grads_close(res[0][name][2], want[2])


def assert_chunks_equal_single_updates(results, path):
    """On every rank the chunk equals its single updates bit for bit: the
    summed metrics, the model's state (BN statistics and bank included)
    and Adam's moments; and the ranks' states are equal."""
    for res in results:
        (acc_c, st_c), (acc_s, st_s) = (res["chunk"][(path, how)] for how in ("chunk", "single"))
        assert sorted(acc_c) == sorted(acc_s)
        for k, v in acc_s.items():
            assert acc_c[k] == v if k == "lr" else torch.equal(acc_c[k], v), k
        assert sorted(st_c) == sorted(st_s) and any(k.endswith("exp_avg_sq") for k in st_s)
        for k, v in st_s.items():
            assert torch.equal(st_c[k], v), k
    first = results[0]["chunk"][(path, "chunk")][1]
    for res in results[1:]:
        assert all(torch.equal(res["chunk"][(path, "chunk")][1][k], v) for k, v in first.items())


@pytest.mark.parametrize("path", ["resident", "streamed"])
def test_chunk_on_ranks_equals_single_updates(units, path):
    """A chunk of K = 2 updates on 2 ranks, resident (the sharded pool's
    gather inside) and streamed (the augmentation inside, reseeded from
    (seed, step) before each update), against the same updates one at a
    time."""
    _, res = units
    steps = [v for k, v in res[0]["chunk"][(path, "chunk")][1].items() if k.endswith(".step")]
    assert steps and all(float(v) == K for v in steps)      # Adam took K steps
    assert_chunks_equal_single_updates(res, path)


def _jax_chunk():
    """JAX's chunked step on a 2-device data mesh over the same pool
    (sharded as ``stage_resident_pool`` shards it) and index blocks, from
    the same state: ``(summed metrics, new state_dict)``."""
    from pacingpseudo_tpu.parallel import stage_resident_pool
    from pacingpseudo_tpu.train.step import make_resident_chunked_train_step as jax_chunked

    sd0 = _state_dict0("pacing")
    pool, blocks = _chunk_pool()
    params, stats, bank = convert_state_dict({k: v.numpy() for k, v in sd0.items()})
    config = JaxConfig(**CONFIGS["pacing"]).validate()
    model = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=True, hid_ch=HID,
                      s2d_hires=False, dtype=jnp.float32)
    tx = jax_optim.make_optimizer(config, STEPS_PER_EPOCH)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                     opt_state=tx.init(params), memory_bank=jnp.asarray(bank))
    body = jax_pacing_step(config, model, tx, STEPS_PER_EPOCH, jit=False)
    dmesh = data_mesh(2)
    args = (replicate(state, dmesh), stage_resident_pool(pool, dmesh), jnp.asarray(blocks),
            jax.random.key(0, impl="rbg"))
    new, metrics = jax_chunked(body, K, mesh=dmesh).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    assert int(new.step) == K
    return ({k: float(v) for k, v in _np(metrics).items()},
            from_jax_variables(_np(new.params), _np(new.batch_stats),
                               np.array(new.memory_bank)))


def test_chunk_on_ranks_matches_jax_chunk(units):
    """The resident chunk on 2 ranks (a pre-augmented pool, no
    augment_fn) against JAX's ``make_resident_chunked_train_step(body, 2,
    mesh=data_mesh(2))``, by ``test_step_matches_jax_sharded_step``'s
    bounds for what they hold after two updates: the metrics summed over
    the chunk rtol 2e-4 atol 1e-5, each parameter within 2·lr a step (Adam
    moves an element by about lr a step whatever its gradient).  The BN
    statistics and the bank after the second update come from a forward
    whose weights already differ by up to 2·lr an element (a running
    mean here by 3.7e-5, 16x the one-update bound; the bank by 1.9e-4, 8x),
    so they are held as ``tests/test_torch_port_resident.py`` holds the
    chunked step's against JAX's: within 1e-3 of the leaf's largest
    element (they read up to 8.5e-4 of it; the parameters up to 3.95·lr
    of 4·lr)."""
    _, res = units
    acc, tensors = res[0]["chunk"][("resident", "chunk")]
    metrics = {k: float(v) for k, v in acc.items()}
    sd = {k[len("model."):]: v for k, v in tensors.items() if k.startswith("model.")}
    want_metrics, want_sd = _jax_chunk()
    lr = ExperimentConfig(**CONFIGS["pacing"]).lr
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in want_metrics.items():
        assert np.isclose(metrics[k], v, rtol=2e-4, atol=1e-5), (k, metrics[k], v)
    assert sorted(sd) == sorted(want_sd)
    for k, v in want_sd.items():
        err = float((sd[k] - v).abs().max())
        if k.endswith(("running_mean", "running_var", "memory_bank")):
            assert err <= 1e-3 * float(v.abs().max()), (k, err)
        elif not k.endswith("num_batches_tracked"):
            assert err <= 2 * lr * K, (k, err)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("chunk", [1, 2, 8])
@pytest.mark.parametrize("backend", [None, "gloo", "nccl"])
def test_uses_graph_rule(device, chunk, backend):
    """Which dispatch a chunk takes, with no card needed: a graph only on a
    card, with ``chunk > 1``, alone or on NCCL ranks; gloo ranks, whose
    collectives go through the host, step eagerly."""
    want = device == "cuda" and chunk > 1 and backend != "gloo"
    assert uses_graph(torch.device(device), chunk, backend) is want
    assert uses_graph(device, chunk, backend) is want


def test_conv_layer_is_unfused_under_ranks():
    """A ConvLayer whose BatchNorm has ranks takes the unfused path under
    the fused conv impl: the kernels' BN statistics would be the rank's
    own.  This is what keeps the fused kernels off every rank of a run."""
    layer = ConvLayer(4, 8).train()
    prev = get_conv_impl()
    set_conv_impl("fused")
    try:
        assert layer.is_fused(S, S)
        mesh.attach_ranks(layer, object())
        assert not layer.is_fused(S, S)
        mesh.attach_ranks(layer, None)
        assert layer.is_fused(S, S)
    finally:
        set_conv_impl(prev)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ranks_hold_equal_replicas(units, name):
    """After the update the two ranks' states are equal bit for bit: the
    summed gradients, BN statistics and the bank are the same on both."""
    _, res = units
    sd0, sd1 = res[0][name][1], res[1][name][1]
    assert res[0][name][0] == res[1][name][0]
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k


# ---------------------------------------------------------------------------
# The loop on two ranks
# ---------------------------------------------------------------------------

EP = 2
ARGV = ["--session", "Experiment", "--dataset", "acdc", "--tag", "dp", "--fold", "0",
        "--do_loss_ent", "--do_decoder_consistency", "--do_aux_path", "--do_memory",
        "--input_size", str(S), str(S), "--init_ch", str(INIT_CH), "--hid_ch", str(HID),
        "--batch_size", str(N), "--epoch", str(EP), "--compute_dtype", "float32",
        "--steps_per_dispatch", "2", "--ckp_interval", "1", "--no-tb_figures",
        "--seed", "3"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dpdata"))
    spec = DATASETS["acdc"]
    write_synthetic_dataset(root, "acdc", 20, (S, S), spec.num_classes, spec.ignored_index,
                            seed=5)
    return root


def _config(**kw):
    args = train_cli.build_parser().parse_args(ARGV)
    return dataclasses.replace(train_cli.config_from_args(args), **kw).validate()


def _val(run_dir):
    log = Path(run_dir, "log.txt").read_text().splitlines()
    losses = [float(line.split("loss: ")[1].split(",")[0])
              for line in log if "val: " in line and "loss: " in line]
    return np.asarray(losses), np.load(os.path.join(run_dir, "valdice.npz"))["valdice"]


@pytest.fixture(scope="module")
def runs(data_root, tmp_path_factory):
    """One process and two ranks, resident and streamed: the run dirs.  The
    two 2-rank runs share one world (``workers.loops``); the CLI test below
    drives ``train_driver``'s own spawn."""
    root = tmp_path_factory.mktemp("dpruns")
    out = {}
    for res in ("on", "off"):
        out[(1, res)] = str(root / f"w1_{res}")
        os.makedirs(out[(1, res)])
        loop._train_driver(_config(device_resident_data=res), data_root, out[(1, res)],
                           device="cpu")
    jobs = []
    for res in ("on", "off"):
        out[(W, res)] = str(root / f"w{W}_{res}")
        jobs.append((_config(num_devices=W, device_resident_data=res), out[(W, res)]))
    # ARGV's dispatch is 2 a call: the same resident run one update a call
    out[(W, "on", 1)] = str(root / f"w{W}_on_spd1")
    jobs.append((_config(num_devices=W, device_resident_data="on", steps_per_dispatch=1),
                 out[(W, "on", 1)]))
    mesh.spawn_ranks(workers.loops, W, (["cpu"] * W, str(root / "store"), data_root, jobs))
    return out


@pytest.mark.parametrize("resident", ["on", "off"])
def test_two_rank_loop_matches_one_process(runs, resident):
    vl1, vd1 = _val(runs[(1, resident)])
    vl2, vd2 = _val(runs[(W, resident)])
    assert vl1.shape == vl2.shape == (EP,) and np.all(vl1 > 0)
    np.testing.assert_allclose(vl2, vl1, rtol=1e-3)
    np.testing.assert_allclose(vd2, vd1, atol=5e-3)
    log = Path(runs[(W, resident)], "log.txt").read_text()
    assert "data-parallel: data mesh of 2" in log and "over gloo" in log
    assert "steps per dispatch 2 (eager steps)" in log       # ARGV's, as the run asked


def _metric_lines(run_dir):
    """The log's epoch and validation lines without their times."""
    lines = [line.split("] ", 1)[1] for line in open(os.path.join(run_dir, "log.txt"))]
    return [re.sub(r", [\d.]+ s/epoch, [\d.]+ slices/s", "", line) for line in lines
            if line.startswith(("epoch: ", "val: "))]


def test_two_rank_loop_is_the_same_for_every_dispatch(runs):
    """On 2 ranks the loop with ``--steps_per_dispatch 2`` equals the same
    loop with 1 bit for bit: every checkpoint's model and optimizer state
    and the log's metric lines."""
    a, b = runs[(W, "on")], runs[(W, "on", 1)]
    assert "steps per dispatch 1 (eager steps)" in Path(b, "log.txt").read_text()
    assert _metric_lines(a) == _metric_lines(b) and len(_metric_lines(a)) == 2 * EP
    for e in range(EP):
        for name in ("model.pth", "train.pth"):
            got, want = (torch.load(os.path.join(d, "ckps", f"ckp_{e}", name),
                                    weights_only=False) for d in (a, b))
            flat_got, flat_want = _flatten(got), _flatten(want)
            assert sorted(flat_got) == sorted(flat_want) and flat_want
            for k, v in flat_want.items():
                assert (torch.equal(flat_got[k], v) if torch.is_tensor(v)
                        else flat_got[k] == v), (e, name, k)


def _flatten(tree, prefix=""):
    """A nested dict / list of a checkpoint file as ``{path: leaf}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}"))
    return out


def test_rank_zero_alone_writes_the_run(runs):
    """The 2-rank run directory has the one-process layout and nothing else
    (no second log, no rendezvous file left)."""
    def layout(d):
        return sorted(os.path.relpath(p, d) for p in glob.glob(f"{d}/**", recursive=True)
                      if "tb_summary" not in p)
    assert layout(runs[(W, "on")]) == layout(runs[(1, "on")])


def _truncate_to_epoch0(src, dst):
    """A copy of a finished run whose latest checkpoint is ``ckp_0``."""
    shutil.copytree(src, dst)
    shutil.rmtree(os.path.join(dst, "ckps", f"ckp_{EP - 1}"))
    return dst


def test_two_rank_checkpoint_resumes_in_one_process(runs, data_root, tmp_path):
    run_dir = _truncate_to_epoch0(runs[(W, "off")], str(tmp_path / "resume1"))
    loop._train_driver(_config(device_resident_data="off", resume=True), data_root, run_dir,
                       device="cpu")
    vl, vd = _val(run_dir)
    vl_full, vd_full = _val(runs[(1, "off")])
    np.testing.assert_allclose(vl[-1], vl_full[-1], rtol=1e-3)
    np.testing.assert_allclose(vd, vd_full, atol=5e-3)


def test_cli_resumes_a_one_process_checkpoint_on_two_ranks(runs, data_root, tmp_path):
    """``--gpu cpu --num_devices 2 --resume`` on a one-process run."""
    run_dir = _truncate_to_epoch0(runs[(1, "on")], str(tmp_path / "resume2"))
    train_cli.main([*ARGV, "--gpu", "cpu", "--num_devices", "2", "--resume",
                    "--device_resident_data", "on", "--data_root", data_root,
                    "--run_dir", run_dir])
    log = Path(run_dir, "log.txt").read_text()
    assert "resumed from" in log and "data-parallel: data mesh of 2" in log
    vl, vd = _val(run_dir)
    vl_full, vd_full = _val(runs[(1, "on")])
    np.testing.assert_allclose(vl[-1], vl_full[-1], rtol=1e-3)
    np.testing.assert_allclose(vd, vd_full, atol=5e-3)
    assert os.path.isdir(os.path.join(run_dir, "ckps", f"ckp_{EP - 1}"))


@pytest.mark.parametrize("argv,log", [
    (["--num_devices", "2", "--spatial_shards", "2"], "mesh data=1 x space=2"),
    (["--num_devices", "4", "--batch_size", "6"],
     "auto spatial fallback: batch 6 on 4 devices -> data=2 x space=2"),
    (["--num_devices", "1", "--spatial_shards", "3"], "clamping spatial_shards 3 -> 1 (devices)"),
], ids=["explicit", "auto", "one-device"])
def test_cli_refuses_height_sharding(data_root, tmp_path, argv, log):
    """The splits with a space axis run, as JAX splits them: an explicit
    space axis, the AUTO split with one, and a space axis clamped to one
    device.  One update each; ``log.txt`` says how the devices split.
    (The name is that of the refusal these three cases replaced: the port
    refused a space axis before it had height sharding.)"""
    run_dir = tmp_path / "split"
    train_cli.main([*ARGV, "--gpu", "cpu", *argv, "--epoch", "1", "--max_steps_per_epoch", "1",
                    "--data_root", data_root, "--run_dir", str(run_dir)])
    text = (run_dir / "log.txt").read_text()
    assert log in text and "epoch: 000" in text
    assert ("data-parallel: " in text) == (argv[1] != "1")       # ranks unless one device
    assert os.path.isdir(run_dir / "ckps" / "ckp_0")


def test_devices_resolve_as_listed():
    """``--gpu`` lists; ``num_devices`` takes the first k, never more than
    listed; a card that does not exist raises, with no CPU fallback."""
    assert train_cli.devices_from_gpu("0,1") == [torch.device("cuda", 0),
                                                 torch.device("cuda", 1)]
    assert loop.resolve_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert loop.resolve_devices([torch.device("cpu")], 0) == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop.resolve_devices(train_cli.devices_from_gpu("0,1"), 0)
    else:
        with pytest.raises(RuntimeError, match="does not exist"):
            loop.resolve_devices([torch.device("cuda", torch.cuda.device_count())], 0)
    with pytest.raises(SystemExit):
        train_cli.devices_from_gpu("0;1")
