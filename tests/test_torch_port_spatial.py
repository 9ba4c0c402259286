"""Port parity: height sharding (``pacingpseudo_torch/parallel/spatial.py``
and the space axis of the loop and of inference) against one process and
against the JAX package's sharded model and step.

Four gloo ranks on the CPU (one torch thread a rank; a ``FileStore`` under
``tmp_path``), float32, init_ch 8, output stride 8.  One spawn of
``tests/torch_spatial_ranks.py::units`` computes every unit on two grids of
the four ranks, space 4 (data 1) and data 2 x space 2:

* the split equals JAX's (``factor_devices`` and ``loop.py:331-351``) for a
  table of ``(devices, batch, spatial_shards)``, clamps included;
* ``halo_rows`` + conv at dilation 1, 2 and 4 and at stride 2, on equal and
  unequal shards (the coarse level's 7 rows over 4 shards: 2, 2, 2, 1, so a
  dilation-4 halo spans several shards), equals the unsharded ``F.conv2d``
  in output and input gradient (rtol 1e-5, atol 1e-5: the same products,
  added in another order) and in the weight gradient (1e-5 of its largest
  element: the shards' partial sums over the pixels, added again);
* the sharded 2x and 8x align-corners resize equals JAX's
  ``bilinear_resize_align_corners`` (atol 1e-6: the same interpolation
  matrices), and its input gradient equals ``F.interpolate``'s (atol 1e-5);
* the UNet forward on 4 and on 2 space ranks is within 1e-4 of JAX's
  forward on the same weights (``tests/test_sharding.py:98-119``'s
  bound), at 64x64 and at 56x64 (unequal shards); the stride-conv variant
  is held against the port's own one-process forward (1e-5);
* ``memory_update`` of features gathered over both axes is bit-equal to one
  process;
* one Experiment step on data 2 x space 2 is held against JAX's step on a
  ``train_mesh(2, 2)`` with its spatial constraint, by JAX's bounds
  (``tests/test_sharding.py:160-163``: metrics rtol 2e-4 atol 1e-5) and
  ``tests/test_torch_port_parallel.py``'s parameter, BN-statistics and
  gradient bounds, and against the port's one-process step by the same
  bounds; so is an upper-bound step (Dice loss over the space group); a
  step on 4 space ranks at 56x64 (unequal, thinner than the halo) against
  the one-process step; the ranks' replicas and banks are equal bit for
  bit after the update;
* a resident chunk of K = 2 updates on data 2 x space 2 equals the same
  updates one at a time bit for bit.

Then the loop on 2 space ranks and on the AUTO split of 4 devices at batch
6 (data 2 x space 2, resident and streamed) against one process, within
JAX's spatial bounds (``tests/test_driver_multidevice.py:112-118``: val
loss rtol 1e-2, val Dice atol 2e-2), and inference with ``--spatial_shards
2`` on 2 CPU ranks, whose ``eval_data.npz`` equals the one-process run's.
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
import torch.nn.functional as F

import torch_parallel_ranks
import torch_spatial_ranks as workers
from pacingpseudo_tpu.config import ExperimentConfig as JaxConfig
from pacingpseudo_tpu.models import PacingPseudoModel as JaxPacing
from pacingpseudo_tpu.models import UNet as JaxUNet
from pacingpseudo_tpu.ops.resize import bilinear_resize_align_corners as jax_resize
from pacingpseudo_tpu.parallel import replicate, shard_batch
from pacingpseudo_tpu.parallel import factor_devices as jax_factor_devices
from pacingpseudo_tpu.parallel.spatial import make_spatial_constraint, train_mesh
from pacingpseudo_tpu.tools.torch_import import convert_state_dict
from pacingpseudo_tpu.train import optim as jax_optim
from pacingpseudo_tpu.train.state import TrainState as JaxState
from pacingpseudo_tpu.train.step import make_pacing_train_step as jax_pacing_step
from pacingpseudo_tpu.train.step import make_upper_bound_train_step as jax_ub_step
from pacingpseudo_torch.cli import inference as infer_cli
from pacingpseudo_torch.cli import train as train_cli
from pacingpseudo_torch.config import DATASETS, ExperimentConfig
from pacingpseudo_torch.data.synthetic import write_synthetic_dataset
from pacingpseudo_torch.evals import infer
from pacingpseudo_torch.models.aux_path import memory_update
from pacingpseudo_torch.models.unet import UNet, torch_default_init_
from pacingpseudo_torch.parallel import mesh, spatial
from pacingpseudo_torch.tools.weights import from_jax_variables
from pacingpseudo_torch.train import loop
from pacingpseudo_torch.train.state import build_model
from test_torch_port_parallel import (JAX_GRAD_L2, _assert_grads_close, _assert_step_close,
                                      assert_chunks_equal_single_updates, chunk_inputs)

W, N, S, C, INIT_CH, HID = 4, 4, 64, 3, 8, 16
GRIDS = (4, 2)                      # space axes of the 4 ranks: 1 x 4 and 2 x 2
STEPS_PER_EPOCH = 4
CONFIGS = {
    "pacing": dict(num_classes=C, ignored_index=C, init_ch=INIT_CH, hid_ch=HID, batch_size=N,
                   do_loss_ent=True, do_decoder_consistency=True, do_aux_path=True,
                   do_memory=True, compute_dtype="float32"),
    "upper_bound": dict(session="Upperbound", num_classes=C, ignored_index=C,
                        init_ch=INIT_CH, batch_size=N, loss_dice=True,
                        compute_dtype="float32"),
}
# (name, session, space axis, batch height)
STEPS = (("pacing", "pacing", 2, S), ("upper_bound", "upper_bound", 2, S),
         ("pacing_thin", "pacing", 4, 56))
CONV_CASES = (   # (name, stride, dilation, level, height): level x the coarse rows
    ("d1", 1, 1, 8, 64), ("d2", 1, 2, 2, 16), ("d4", 1, 4, 1, 8),
    ("d1_uneven", 1, 1, 4, 28), ("d2_uneven", 1, 2, 2, 14), ("d4_uneven", 1, 4, 1, 7),
    ("stride2_uneven", 2, 1, 2, 14))
RESIZE_CASES = (("up2", 2, 8), ("up8", 8, 8), ("up2_uneven", 2, 7), ("up8_uneven", 8, 7))
FORWARD_CASES = (("square", S, {}), ("uneven", 56, {}),
                 ("stride_conv", S, dict(is_stride_conv=True, is_trans_conv=True)))
BANK_MODES = [(e, m) for e in ("cosine_similarity", "mean") for m in ("all", "first")]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread in this module (the ranks take one each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(x):
    return _t(np.moveaxis(np.asarray(x), -1, 1))


def _unet_state(seed, **kw):
    """A seeded eval-mode UNet state_dict with nontrivial BN statistics."""
    model = UNet(num_classes=4, init_ch=INIT_CH, output_stride=8, **kw)
    torch_default_init_(model, torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(_t(rs.randn(*buf.shape).astype(np.float32) * 0.1))
        elif name.endswith("running_var"):
            buf.copy_(_t(rs.uniform(0.5, 2.0, buf.shape).astype(np.float32)))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _state_dict0(name):
    """The seeded initial state of a session (a warm bank with a cold row)."""
    model = build_model(ExperimentConfig(**CONFIGS[name]).validate(), device="cpu")
    torch_default_init_(model, torch.Generator().manual_seed(5))
    if name == "pacing":
        bank = np.random.RandomState(6).randn(C, HID).astype(np.float32)
        bank[1] = 0.0
        model.aux_path.memory_bank.copy_(_t(bank)[:, :, None, None])
    return {k: v.clone() for k, v in model.state_dict().items()}


def _nhwc_batch(session, height):
    """A pre-augmented global batch (NHWC numpy, JAX's layout)."""
    rs = np.random.RandomState(1 if session == "pacing" else 2)
    image = rs.randn(N, height, S, 1).astype(np.float32)
    if session == "upper_bound":
        return {"image": image,
                "label": np.eye(C, dtype=np.float32)[rs.randint(0, C, (N, height, S))]}
    return {"image": image, "image_strong": rs.randn(N, height, S, 1).astype(np.float32),
            "scribble": np.eye(C + 1, dtype=np.float32)[rs.randint(0, C + 1, (N, height, S))],
            "valid_mask": (rs.rand(N, height, S, 1) > 0.2).astype(np.float32)}


def _unit_inputs():
    rs = np.random.RandomState(0)
    rnd = lambda *shape: _t(rs.randn(*shape).astype(np.float32))  # noqa: E731
    inp = {"convs": [], "resizes": [], "forwards": [], "forward_classes": 4,
           "forward_kw": {name: kw for name, _, kw in FORWARD_CASES},
           "steps": [(name, space) for name, _, space, _ in STEPS]}
    for name, stride, dil, level, h in CONV_CASES:
        inp["convs"].append((name, rnd(N, 3, h, 20), rnd(5, 3, 3, 3),
                             rnd(N, 5, h // stride, 20 // stride), stride, dil, level))
    for name, factor, h in RESIZE_CASES:
        inp["resizes"].append((name, rnd(N, 3, h, 12), factor, rnd(N, 3, h * factor, 12 * factor)))
    for seed, (name, h, kw) in enumerate(FORWARD_CASES):
        inp["forwards"].append((name, _unet_state(10 + seed, **kw), rnd(N, 1, h, S)))
    inp["aux_features"] = rnd(N, HID, 8, 8)
    inp["scribble"] = _t(np.eye(C + 1, dtype=np.float32)[rs.randint(0, C + 1, (N, S, S))]
                         .transpose(0, 3, 1, 2))
    inp["bank"] = _t(np.where(np.arange(C)[:, None] == 1, 0.0,
                              rs.randn(C, HID)).astype(np.float32))
    for name, session, _, height in STEPS:
        inp[f"{name}_config"] = CONFIGS[session]
        inp[f"{name}_sd0"] = _state_dict0(session)
        inp[f"{name}_batch"] = {k: _nchw(v) for k, v in _nhwc_batch(session, height).items()}
    inp.update(chunk_inputs())
    return inp


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """The unit inputs, and the four ranks' results of ``workers.units``."""
    root = tmp_path_factory.mktemp("spatial")
    inp = _unit_inputs()
    torch.save(inp, root / "inputs.pt")
    mesh.spawn_ranks(workers.units, W, (["cpu"] * W, str(root / "store"),
                                        str(root / "inputs.pt"), str(root / "out")))
    return inp, [torch.load(f"{root}/out.{r}", weights_only=False) for r in range(W)]


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want.detach()),
                               rtol=rtol, atol=atol)


def _block(t, r, n_space, level):
    """Rank ``r``'s rows and heights of ``t`` on a grid of ``n_space``
    space ranks, ``t`` at ``level`` times the coarse rows."""
    n_data = W // n_space
    rows = slice(r // n_space * N // n_data, (r // n_space + 1) * N // n_data)
    split = spatial.HeightSplit.of(t.shape[-2], level, n_space, r % n_space)
    return t[rows][..., split.rows(), :]


SPLIT_TABLE = [  # (devices, batch, spatial_shards) -> JAX's (n_data, n_space)
    (8, 12, 0), (5, 12, 0), (7, 12, 0), (6, 12, 0), (4, 6, 0), (4, 4, 0), (3, 12, 0),
    (2, 4, 2), (4, 6, 2), (8, 12, 4), (5, 12, 2), (1, 12, 3), (2, 12, 3), (3, 4, 1),
    (8, 6, 1), (8, 6, 8), (16, 12, 0)]


def _jax_split(avail, batch, spatial_shards):
    """``(n_data, n_space)`` by the JAX loop's rules (``loop.py:331-351``)."""
    n_space = spatial_shards
    if n_space == 0:
        n_space, n_dev = jax_factor_devices(avail, batch)
        return n_dev, n_space
    if n_space > 1 and avail // n_space < 1:
        n_space = avail
    avail_data = max(avail // n_space, 1)
    return max(d for d in range(1, avail_data + 1) if batch % d == 0), n_space


@pytest.mark.parametrize("devices,batch,spatial_shards", SPLIT_TABLE,
                         ids=[f"{d}dev-b{b}-s{s}" for d, b, s in SPLIT_TABLE])
def test_split_equals_jax(devices, batch, spatial_shards):
    n_data, n_space, note = mesh.plan_data_parallel(devices, batch, spatial_shards)
    assert (n_data, n_space) == _jax_split(devices, batch, spatial_shards)
    if (devices, batch, spatial_shards) == (8, 12, 0):
        assert (n_data, n_space) == (4, 2) and "data=4 x space=2" in note
        assert "auto spatial fallback: batch 12 on 8 devices" in note
    if (devices, batch, spatial_shards) == (5, 12, 0):
        assert (n_data, n_space) == (1, 5)
    if (devices, spatial_shards) == (1, 3):
        assert "clamping spatial_shards 3 -> 1 (devices)" in note and n_space == 1


def test_height_runs_and_refusal():
    """The coarse rows split as equal as they can be, longer runs first.
    More shards than coarse rows split at a finer level
    (``tests/test_torch_port_spatial_deep.py``); what exits, naming the
    sizes, is what the JAX UNet refuses (a height that is not a multiple of
    the output stride) and more shards than image rows."""
    assert spatial.height_runs(32, 5) == [7, 7, 6, 6, 6]
    assert spatial.height_runs(32, 3) == [11, 11, 10]
    split = spatial.HeightSplit.of(256, 8, 3, 2)
    assert split.rows() == slice(176, 256) and split.rows(1) == slice(22, 32)
    spatial.check_split(64, 8, 9)
    with pytest.raises(SystemExit, match="60 rows at output stride 8: the height must be a "
                                         "multiple of the output stride"):
        spatial.check_split(60, 8, 2)
    with pytest.raises(SystemExit, match="64 rows does not split over 65 space shards"):
        spatial.check_split(64, 8, 65)


class _Grid:
    """A rank's place on a grid, without a process group: what
    ``shard_batch`` reads."""

    def __init__(self, n_data, n_space, rank):
        self.n_data, self.n_space = n_data, n_space
        self.data_index, self.space_index = divmod(rank, n_space)

    def local_rows(self, t):
        per = t.shape[0] // self.n_data
        return t[self.data_index * per:(self.data_index + 1) * per]


@pytest.mark.parametrize("rank", range(6))
def test_shard_batch_cuts_contiguous_blocks(rank):
    """Each ``(N, ..., H, W)`` leaf's block is a contiguous copy (the fused
    loss kernel takes contiguous planes), rows-only leaves keep their rows,
    and the split of a 256-row image over 3 shards is 88, 88, 80 rows."""
    grid = _Grid(2, 3, rank)
    batch = {"image": torch.randn(4, 1, 256, 8), "valid_mask": torch.rand(4, 1, 256, 8),
             "label": torch.randn(4, 256, 8), "sample_valid": torch.ones(4, dtype=torch.bool)}
    got, shard = spatial.shard_batch(batch, grid, 8)
    rows = slice(grid.data_index * 2, grid.data_index * 2 + 2)
    heights = [slice(0, 88), slice(88, 176), slice(176, 256)][grid.space_index]
    assert shard.ranks is grid and shard.split.runs == (11, 11, 10)
    assert shard.split.rows() == heights
    for k, v in batch.items():
        want = v[rows][..., heights, :] if v.dim() >= 3 else v[rows]
        assert torch.equal(got[k], want) and got[k].is_contiguous(), k
    assert got["valid_mask"][:, 0].is_contiguous()


def test_grids_number_ranks_as_jax(units):
    """Rank ``r`` holds data index ``r // n_space`` and space index
    ``r % n_space``, as ``train_mesh`` lays out its devices."""
    _, res = units
    for r, got in enumerate(res):
        assert got["grid"] == {4: (0, r, 1), 2: (r // 2, r % 2, 2)}


@pytest.mark.parametrize("n_space", GRIDS)
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_halo_conv_equals_unsharded(units, case, n_space):
    inp, res = units
    name, stride, dil, level, _ = case
    x, w, cot = next((c[1], c[2], c[3]) for c in inp["convs"] if c[0] == name)
    xr = x.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    y = F.conv2d(xr, wr, None, stride, dil, dil)
    (y * cot).sum().backward()
    dw = 0
    for r, got in enumerate(res):
        y_r, dx_r, dw_r = got[n_space]["convs"][name]
        _close(y_r, _block(y, r, n_space, level // stride))
        _close(dx_r, _block(xr.grad, r, n_space, level))
        dw = dw + dw_r
    # the shards' partial sums of 4096-16384 products each, added again
    _close(dw, wr.grad, rtol=0, atol=1e-5 * float(wr.grad.abs().max()))


@pytest.mark.parametrize("n_space", GRIDS)
@pytest.mark.parametrize("case", RESIZE_CASES, ids=[c[0] for c in RESIZE_CASES])
def test_sharded_resize_equals_jax(units, case, n_space):
    inp, res = units
    name, factor, _ = case
    x, cot = next((c[1], c[3]) for c in inp["resizes"] if c[0] == name)
    h, w = x.shape[-2] * factor, x.shape[-1] * factor
    want = _nchw(jax_resize(jnp.asarray(np.moveaxis(x.numpy(), 1, -1)), h, w))
    xr = x.clone().requires_grad_(True)
    (F.interpolate(xr, size=(h, w), mode="bilinear", align_corners=True) * cot).sum().backward()
    for r, got in enumerate(res):
        y, dx = got[n_space]["resizes"][name]
        _close(y, want, rtol=0, atol=1e-6)
        _close(dx, _block(xr.grad, r, n_space, 1))


@pytest.mark.parametrize("n_space", GRIDS)
@pytest.mark.parametrize("case", FORWARD_CASES, ids=[c[0] for c in FORWARD_CASES])
def test_unet_forward_equals_jax(units, case, n_space):
    inp, res = units
    name, _, kw = case
    sd, image = next((c[1], c[2]) for c in inp["forwards"] if c[0] == name)
    if kw:            # the variant against the port's one-process forward
        model = UNet(num_classes=4, init_ch=INIT_CH, output_stride=8, **kw)
        model.load_state_dict(sd)
        with torch.no_grad():
            want = model.eval()(image)["segmentation/logits"]
        bound = 1e-5
    else:
        params, stats, _ = convert_state_dict({k: v.numpy() for k, v in sd.items()})
        model = JaxUNet(num_classes=4, init_ch=INIT_CH, output_stride=8, s2d_hires=False,
                        dtype=jnp.float32)
        want = _nchw(model.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(np.moveaxis(image.numpy(), 1, -1)),
                                 train=False)["segmentation/logits"])
        bound = 1e-4
    for r, got in enumerate(res):
        n_data = W // n_space
        rows = slice(r // n_space * N // n_data, (r // n_space + 1) * N // n_data)
        _close(got[n_space]["forwards"][name], want[rows], rtol=bound, atol=bound)


@pytest.mark.parametrize("n_space", GRIDS)
@pytest.mark.parametrize("mode", BANK_MODES, ids=["-".join(m) for m in BANK_MODES])
def test_bank_of_features_gathered_over_both_axes_is_bit_equal(units, mode, n_space):
    inp, res = units
    want = memory_update(inp["bank"], inp["aux_features"],
                                              inp["scribble"], step=1, max_step=4,
                                              ensemble_mode=mode[0], update_mode=mode[1])
    for got in res:
        assert torch.equal(got[n_space]["banks"][mode], want)


def _jax_step(session, height):
    """JAX's step on a ``train_mesh(2, 2)`` with its spatial constraint, from
    the same state and batch: ``(metrics, new state_dict, gradients)``; the
    gradients are read from Adam's first moment, ``mu = (1 - b1) (g + wd
    p)``."""
    sd0, batch = _state_dict0(session), _nhwc_batch(session, height)
    params, stats, bank = convert_state_dict({k: v.numpy() for k, v in sd0.items()})
    config = JaxConfig(**CONFIGS[session]).validate()
    upper = session == "upper_bound"
    model = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=not upper, hid_ch=HID,
                      s2d_hires=False, dtype=jnp.float32)
    tx = jax_optim.make_optimizer(config, STEPS_PER_EPOCH)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                     opt_state=tx.init(params),
                     memory_bank=None if upper else jnp.asarray(bank))
    tmesh = train_mesh(2, 2)
    make = jax_ub_step if upper else jax_pacing_step
    step = make(config, model, tx, STEPS_PER_EPOCH, donate=False,
                spatial_constraint=make_spatial_constraint(tmesh))
    args = (replicate(state, tmesh), shard_batch(batch, tmesh), jax.random.key(0, impl="rbg"))
    new, metrics = step.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    np_ = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731
    stats = np_(new.batch_stats)
    p0 = from_jax_variables(np_(params), stats)
    mu = from_jax_variables(np_(new.opt_state[1].mu), stats)
    return ({k: float(v) for k, v in np_(metrics).items()},
            from_jax_variables(np_(new.params), stats,
                               None if upper else np.array(new.memory_bank)),
            {k: mu[k] / (1 - 0.9) - config.wd * p0[k] for k in p0
             if k.endswith((".weight", ".bias"))})


@pytest.mark.parametrize("name", ["pacing", "upper_bound"])
def test_step_matches_jax_spatial_step(units, name):
    """JAX's bounds on the update on data 2 x space 2, and the summed
    gradients beside them (the bounds of the one-device parity tests)."""
    _, res = units
    want = _jax_step(name, S)
    lr = ExperimentConfig(**CONFIGS[name]).lr
    _assert_step_close(res[0][name], want, lr)
    _assert_grads_close(res[0][name][2], want[2], JAX_GRAD_L2[name])


@pytest.mark.parametrize("name", [s[0] for s in STEPS])
def test_step_matches_one_process(units, name):
    inp, res = units
    session = next(s[1] for s in STEPS if s[0] == name)
    want = torch_parallel_ranks.one_step(CONFIGS[session], inp[f"{name}_sd0"],
                                         inp[f"{name}_batch"])
    lr = ExperimentConfig(**CONFIGS[session]).lr
    _assert_step_close(res[0][name], want, lr)
    _assert_grads_close(res[0][name][2], want[2])


@pytest.mark.parametrize("name", [s[0] for s in STEPS])
def test_ranks_hold_equal_replicas_and_banks(units, name):
    """After the update the four ranks' states, the bank with them, are
    equal bit for bit, and so are their metrics."""
    _, res = units
    for got in res[1:]:
        assert got[name][0] == res[0][name][0]
        for k, v in res[0][name][1].items():
            assert torch.equal(got[name][1][k], v), k


def test_chunk_on_the_grid_equals_single_updates(units):
    """A resident chunk of K = 2 updates on data 2 x space 2 (the sharded
    pool's gather over the data axis, then each rank's heights) equals the
    same updates one at a time bit for bit, on every rank: summed metrics,
    state, Adam's moments, the bank."""
    _, res = units
    assert_chunks_equal_single_updates(res, "resident")


# ---------------------------------------------------------------------------
# The loop and inference
# ---------------------------------------------------------------------------

EP, LOOP_BATCH = 2, 6
ARGV = ["--session", "Experiment", "--dataset", "acdc", "--tag", "sp", "--fold", "0",
        "--do_loss_ent", "--do_decoder_consistency", "--do_aux_path", "--do_memory",
        "--input_size", str(S), str(S), "--init_ch", str(INIT_CH), "--hid_ch", str(HID),
        "--batch_size", str(LOOP_BATCH), "--epoch", str(EP), "--compute_dtype", "float32",
        "--ckp_interval", "1", "--no-tb_figures", "--seed", "3"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spdata"))
    spec = DATASETS["acdc"]
    write_synthetic_dataset(root, "acdc", 24, (S, S), spec.num_classes, spec.ignored_index,
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


# (key, devices, spatial_shards, device_resident_data)
LOOPS = (("space2", 2, 2, "off"), ("auto_on", 4, 0, "on"), ("auto_off", 4, 0, "off"))


@pytest.fixture(scope="module")
def runs(data_root, tmp_path_factory):
    """One process (resident and streamed) and the ranks' runs: the run
    dirs.  Each world runs its jobs in one spawn (``workers.loops``)."""
    root = tmp_path_factory.mktemp("spruns")
    out = {}
    for res in ("on", "off"):
        out[res] = str(root / f"one_{res}")
        os.makedirs(out[res])
        loop._train_driver(_config(device_resident_data=res), data_root, out[res],
                           device="cpu")
    worlds = {}
    for key, devices, shards, res in LOOPS:
        n_data, n_space, note = mesh.plan_data_parallel(devices, LOOP_BATCH, shards)
        out[key] = str(root / key)
        config = _config(num_devices=devices, spatial_shards=shards, device_resident_data=res)
        worlds.setdefault((n_data * n_space, n_space), []).append(
            (config, out[key], f"{note}, ranks over gloo"))
    for (world, n_space), jobs in worlds.items():
        mesh.spawn_ranks(workers.loops, world, (["cpu"] * world,
                                                str(root / f"store{world}"), n_space,
                                                data_root, jobs))
    return out


@pytest.mark.parametrize("key", [k[0] for k in LOOPS])
def test_height_sharded_loop_matches_one_process(runs, key):
    res = next(k[3] for k in LOOPS if k[0] == key)
    vl1, vd1 = _val(runs[res])
    vl, vd = _val(runs[key])
    assert vl1.shape == vl.shape == (EP,) and np.all(vl1 > 0)
    np.testing.assert_allclose(vl, vl1, rtol=1e-2)
    np.testing.assert_allclose(vd, vd1, atol=2e-2)
    log = Path(runs[key], "log.txt").read_text()
    split = "data=1 x space=2" if key == "space2" else "data=2 x space=2"
    assert "data-parallel: " in log and split in log
    if key != "space2":
        assert "auto spatial fallback: batch 6 on 4 devices" in log
    assert ("training data resident on the device" in log) == (res == "on")
    # the config's steps_per_dispatch (8), cut to the epoch, as eager steps on gloo
    spe = int(re.search(r"steps/epoch=(\d+)", log).group(1))
    assert f"steps per dispatch {min(8, spe)} (eager steps)" in log and spe > 1


def test_rank_zero_alone_writes_the_sharded_run(runs):
    def layout(d):
        return sorted(os.path.relpath(p, d) for p in glob.glob(f"{d}/**", recursive=True)
                      if "tb_summary" not in p)
    assert layout(runs["auto_on"]) == layout(runs["on"])


def test_cli_inference_height_sharded_equals_one_process(runs, data_root, tmp_path):
    """``--gpu cpu --num_devices 2 --spatial_shards 2`` (data 1 x space 2)
    writes the one-process run's ``eval_data.npz``."""
    ckp = tmp_path / "run-fold0-sp"
    shutil.copytree(os.path.join(runs["on"], "ckps", f"ckp_{EP - 1}"), ckp / "ckp")
    kw = dict(model_kwargs=dict(init_ch=INIT_CH, output_stride=8), compute_dtype="float32",
              num_workers=1, batch_size=3)
    (tmp_path / "one").mkdir()
    want = infer.run_inference("acdc", 0, str(ckp / "ckp"), data_root, str(tmp_path / "one"),
                               device="cpu", **kw)
    got = infer_cli.main(["--gpu", "cpu", "--num_devices", "2", "--spatial_shards", "2",
                          "--dataset", "acdc", "--fold", "0", "--checkpoint_file",
                          str(ckp / "ckp"), "--data_root", data_root, "--root",
                          str(tmp_path / "out"), "--init_ch", str(INIT_CH), "--compute_dtype",
                          "float32", "--batch_size", "3", "--num_workers", "1"])
    out_dir = tmp_path / "out" / "Inference" / "acdc" / "ckp"
    saved = np.load(out_dir / "eval_data.npz")
    one = np.load(tmp_path / "one" / "eval_data.npz")
    assert len(one["uids"]) > 3 and list(saved["uids"]) == list(one["uids"])
    np.testing.assert_array_equal(saved["dicearr"], one["dicearr"])
    np.testing.assert_array_equal(saved["hd95arr"], one["hd95arr"])
    assert got["dice"] == want["dice"] and got["uids"] == want["uids"]
    log = (out_dir / "log.txt").read_text()
    assert "inference mesh: data=1 x space=2" in log and "Fold 0, overall Dice" in log
