"""Port parity: height sharding with more space ranks than the coarsest
level has rows (``parallel/spatial.py``: the split taken at a finer level,
the levels below it replicated on every space rank).

One spawn of 8 gloo ranks on the CPU (one torch thread a rank, a
``FileStore`` under ``tmp_path``; ``tests/torch_spatial_ranks.py::
deep_units``) computes on two grids: space 5 (ranks 0-4) on 32x32 images
at output stride 8 (4 coarse rows: the split is cut at the 8-row level,
2, 2, 2, 1, 1), and data 2 x space 4 at output stride 16 and 32 (2 and 1
coarse rows: the split is cut at the 4-row level).  Each grid runs the
max-pool UNet and the stride-conv one (``is_stride_conv`` and
``is_trans_conv``: the stride-2 conv of the gathered split level is
computed whole, the transposed conv's output back at the split level is
cut to the shard's rows).  Float32, init_ch 8.

* The eval-mode UNet forward equals JAX's GSPMD-sharded ``spatial_forward``
  on as many host devices (``tests/test_sharding.py:98-119``'s bound,
  1e-4), which pads a height that does not divide.
* One Experiment step on space 5 is held against JAX's step with
  ``make_spatial_constraint(train_mesh(1, 5))`` by the bounds of
  ``tests/test_torch_port_spatial.py`` (metrics rtol 2e-4 atol 1e-5;
  parameters, BN statistics, the bank and the summed gradients as
  ``tests/test_torch_port_parallel.py`` holds them); each step (Experiment
  on every grid, its stride-conv model and Upperbound on space 5) against
  the port's one-process step by the same bounds.
* The traps of the replicated levels, one test each: their parameters'
  gradients enter the grid's sum once (each rank's share is partial and the
  shares add up to one process's); their BatchNorm statistics are one
  copy's (the running statistics of the replicated layers equal one
  process's on data 2 x space 4, where the data axis sums them); the
  memory bank and ``gather_heights`` take a replicated tensor as it is;
  ``gather_whole``'s backward hands each rank the space sum of the
  cotangents on its own rows; ``local_shard`` tells a whole tensor from a
  shard of the same height.
* ``cli.inference --spatial_shards 5`` on 5 ranks writes the one-process
  run's ``eval_data.npz``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks
import torch_spatial_ranks as workers
from pacingpseudo_tpu.config import ExperimentConfig as JaxConfig
from pacingpseudo_tpu.models import PacingPseudoModel as JaxPacing
from pacingpseudo_tpu.models import UNet as JaxUNet
from pacingpseudo_tpu.parallel import replicate, shard_batch
from pacingpseudo_tpu.parallel.spatial import (make_spatial_constraint, spatial_forward,
                                               spatial_mesh, train_mesh)
from pacingpseudo_tpu.tools.torch_import import convert_state_dict
from pacingpseudo_tpu.train import optim as jax_optim
from pacingpseudo_tpu.train.state import TrainState as JaxState
from pacingpseudo_tpu.train.step import make_pacing_train_step as jax_pacing_step
from pacingpseudo_torch.cli import inference as infer_cli
from pacingpseudo_torch.config import DATASETS, ExperimentConfig
from pacingpseudo_torch.data.synthetic import write_synthetic_dataset
from pacingpseudo_torch.models.unet import UNet, torch_default_init_
from pacingpseudo_torch.parallel import mesh, spatial
from pacingpseudo_torch.tools.weights import from_jax_variables
from pacingpseudo_torch.train.state import build_model
from test_torch_port_parallel import (JAX_GRAD_L2, _assert_grads_close, _assert_step_close,
                                      _close)

W, N, S, C, INIT_CH, HID = 8, 2, 32, 3, 8, 16
STEPS_PER_EPOCH = 4
PACING = dict(num_classes=C, ignored_index=C, init_ch=INIT_CH, hid_ch=HID, batch_size=N,
              do_loss_ent=True, do_decoder_consistency=True, do_aux_path=True,
              do_memory=True, compute_dtype="float32")
CONFIGS = {
    "pacing": PACING,
    "pacing_sc": dict(PACING, is_stride_conv=True, is_trans_conv=True),
    "pacing_os16": dict(PACING, output_stride=16),
    "upper_bound": dict(session="Upperbound", num_classes=C, ignored_index=C,
                        init_ch=INIT_CH, batch_size=N, loss_dice=True,
                        compute_dtype="float32"),
}
# grid (its space axis) -> the steps it takes, and its forwards (output
# stride, stride conv)
STEPS = {5: ("pacing", "pacing_sc", "upper_bound"), 4: ("pacing_os16",)}
FORWARDS = {5: ((8, False), (8, True)), 4: ((16, False), (32, False), (16, True))}
# grid -> the output stride of its gather unit (a 32x32 image: 4 coarse rows
# on 5 shards, 2 on 4)
GATHER_STRIDE = {5: 8, 4: 16}
# the levels below the split level: the replicated layers of the Experiment model
REPLICATED = {8: ("backbone.enc_block5.", "backbone.enc_block6.", "backbone.dec_block5.",
                  "backbone.dec_block4.", "aux_path."),
              16: ("backbone.enc_block5.", "backbone.enc_block6.", "backbone.dec_block5.",
                   "aux_path.")}


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


def _fwd_name(stride, sc):
    return f"os{stride}" + ("_sc" if sc else "")


def _unet_state(seed, classes, stride, sc=False):
    """A seeded eval-mode UNet state_dict with nontrivial BN statistics."""
    model = UNet(num_classes=classes, init_ch=INIT_CH, output_stride=stride,
                 is_stride_conv=sc, is_trans_conv=sc)
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
    if name != "upper_bound":
        bank = np.random.RandomState(6).randn(C, HID).astype(np.float32)
        bank[1] = 0.0
        model.aux_path.memory_bank.copy_(_t(bank)[:, :, None, None])
    return {k: v.clone() for k, v in model.state_dict().items()}


def _nhwc_batch(name):
    """A pre-augmented global batch (NHWC numpy, JAX's layout)."""
    rs = np.random.RandomState(3)
    image = rs.randn(N, S, S, 1).astype(np.float32)
    if name == "upper_bound":
        return {"image": image,
                "label": np.eye(C, dtype=np.float32)[rs.randint(0, C, (N, S, S))]}
    return {"image": image, "image_strong": rs.randn(N, S, S, 1).astype(np.float32),
            "scribble": np.eye(C + 1, dtype=np.float32)[rs.randint(0, C + 1, (N, S, S))],
            "valid_mask": (rs.rand(N, S, S, 1) > 0.2).astype(np.float32)}


def _inputs():
    rs = np.random.RandomState(0)
    rnd = lambda *shape: _t(rs.randn(*shape).astype(np.float32))  # noqa: E731
    inp = {"forward_classes": 4, "steps": STEPS,
           "forwards": {s: [(_fwd_name(st, sc), _unet_state(20 + st + s + sc, 4, st, sc),
                             rnd(N, 1, S, S), st, sc)
                            for st, sc in fwds] for s, fwds in FORWARDS.items()},
           # the split level and the replicated coarse level below it of a
           # 32x32 image (8 and 4 rows at output stride 8 on 5 shards, 4
           # and 2 at output stride 16 on 4)
           "gather": {s: ((S, S), st, rnd(N, 3, 2 * S // st, 2 * S // st),
                          rnd(N, 3, 2 * S // st, 2 * S // st), rnd(N, 3, S // st, S // st))
                      for s, st in GATHER_STRIDE.items()}}
    for name in CONFIGS:
        inp[f"{name}_config"] = CONFIGS[name]
        inp[f"{name}_sd0"] = _state_dict0(name)
        inp[f"{name}_batch"] = {k: _nchw(v) for k, v in _nhwc_batch(name).items()}
    return inp


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """The inputs, and the 8 ranks' results of ``workers.deep_units``."""
    root = tmp_path_factory.mktemp("spatial_deep")
    inp = _inputs()
    torch.save(inp, root / "inputs.pt")
    mesh.spawn_ranks(workers.deep_units, W, (["cpu"] * W, str(root / "store"),
                                             str(root / "inputs.pt"), str(root / "out")))
    return inp, [torch.load(f"{root}/out.{r}", weights_only=False) for r in range(W)]


def _members(res, s):
    """The results of grid ``s``'s ranks, in rank order."""
    return [got[s] for got in res if s in got]


@pytest.fixture(scope="module")
def one_process(units):
    """The port's one-process step of each session."""
    inp, _ = units
    return {name: torch_parallel_ranks.one_step(CONFIGS[name], inp[f"{name}_sd0"],
                                                inp[f"{name}_batch"])
            for name in CONFIGS}


def test_split_goes_below_the_coarse_level():
    """The split level, its runs and the replicated levels of each grid."""
    split = spatial.HeightSplit.of(32, 8, 5, 3, 32)
    assert (split.stride, split.runs, split.width) == (4, (2, 2, 2, 1, 1), 32)
    assert split.rows() == slice(24, 28) and split.rows(1) == slice(6, 7)
    assert [split.replicated(w) for w in (32, 16, 8, 4)] == [False, False, False, True]
    split = spatial.HeightSplit.of(96, 32, 4, 0, 96)
    assert (split.stride, split.runs) == (16, (2, 2, 1, 1))
    assert [split.replicated(w) for w in (96, 48, 24, 12, 6, 3)] == [False] * 5 + [True]
    # enough coarse rows: the split at the coarsest level, no level replicated
    split = spatial.HeightSplit.of(32, 8, 4, 0, 32)
    assert (split.stride, split.width) == (8, None) and not split.replicated(1)
    with pytest.raises(ValueError, match="needs the image's width"):
        spatial.HeightSplit.of(32, 8, 5, 0)


def test_local_shard_tells_a_whole_tensor():
    """Shard 3 of the 32-row split over 5 has 4 image rows 32 wide and 1 row
    8 wide at the split level; the replicated coarse level has 4 rows 4
    wide, the split level gathered whole (the stride-2 conv's input, the
    transposed conv's output) 8 rows 8 wide.  ``local_shard`` passes the
    shards, at the levels ``factor`` names, and stops the whole tensors,
    which ``gather_heights`` returns as they are."""
    split = spatial.HeightSplit.of(32, 8, 5, 3, 32)
    shard = spatial.Shard(None, split)
    for h, w, factor in ((4, 32, 4), (2, 16, 2), (1, 8, 1)):
        t = torch.zeros(1, 1, h, w)
        assert spatial.local_shard(t, shard) is shard and split.factor(h) == factor
    for h, w in ((4, 4), (8, 8), (16, 16), (32, 32), (2, 2)):
        t = torch.randn(1, 1, h, w)
        assert spatial.local_shard(t, shard) is None
        assert torch.equal(spatial.gather_heights(t, shard), t)
    # no level replicated: every tensor is a shard
    split = spatial.HeightSplit.of(32, 8, 4, 0, 32)
    shard = spatial.Shard(None, split)
    assert spatial.local_shard(torch.zeros(1, 1, 8, 32), shard) is shard


def test_grids_number_ranks_as_jax(units):
    _, res = units
    assert [g["grid"] for g in _members(res, 5)] == [(0, r, 1) for r in range(5)]
    assert [g["grid"] for g in _members(res, 4)] == [(r // 4, r % 4, 2) for r in range(8)]


FORWARD_CASES = [(s, st, sc) for s, fwds in FORWARDS.items() for st, sc in fwds]


@pytest.mark.parametrize("s,stride,sc", FORWARD_CASES,
                         ids=[f"space{s}-{_fwd_name(st, sc)}" for s, st, sc in FORWARD_CASES])
def test_unet_forward_equals_jax_spatial_forward(units, s, stride, sc):
    inp, res = units
    name = _fwd_name(stride, sc)
    _, sd, image, _, _ = next(f for f in inp["forwards"][s] if f[0] == name)
    params, stats, _ = convert_state_dict({k: v.numpy() for k, v in sd.items()})
    model = JaxUNet(num_classes=4, init_ch=INIT_CH, output_stride=stride, s2d_hires=False,
                    is_stride_conv=sc, is_trans_conv=sc, dtype=jnp.float32)
    fwd = spatial_forward(model, {"params": params, "batch_stats": stats}, spatial_mesh(s))
    want = _nchw(fwd(jnp.asarray(np.moveaxis(image.numpy(), 1, -1))))
    members = _members(res, s)
    n_data = len(members) // s
    for r, got in enumerate(members):
        d = r // s
        _close(got[name], want[d * N // n_data:(d + 1) * N // n_data],
               rtol=1e-4, atol=1e-4)


def _jax_step(name, n_space):
    """JAX's step on a ``train_mesh(1, n_space)`` with its spatial
    constraint: ``(metrics, new state_dict, gradients)`` (the gradients read
    from Adam's first moment, as ``tests/test_torch_port_spatial.py``)."""
    sd0, batch = _state_dict0(name), _nhwc_batch(name)
    params, stats, bank = convert_state_dict({k: v.numpy() for k, v in sd0.items()})
    config = JaxConfig(**CONFIGS[name]).validate()
    model = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=True, hid_ch=HID,
                      s2d_hires=False, dtype=jnp.float32)
    tx = jax_optim.make_optimizer(config, STEPS_PER_EPOCH)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                     opt_state=tx.init(params), memory_bank=jnp.asarray(bank))
    tmesh = train_mesh(1, n_space)
    step = jax_pacing_step(config, model, tx, STEPS_PER_EPOCH, donate=False,
                           spatial_constraint=make_spatial_constraint(tmesh))
    args = (replicate(state, tmesh), shard_batch(batch, tmesh), jax.random.key(0, impl="rbg"))
    new, metrics = step.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    np_ = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731
    stats = np_(new.batch_stats)
    p0 = from_jax_variables(np_(params), stats)
    mu = from_jax_variables(np_(new.opt_state[1].mu), stats)
    return ({k: float(v) for k, v in np_(metrics).items()},
            from_jax_variables(np_(new.params), stats, np.array(new.memory_bank)),
            {k: mu[k] / (1 - 0.9) - config.wd * p0[k] for k in p0
             if k.endswith((".weight", ".bias"))})


def test_step_matches_jax_spatial_step(units):
    """The Experiment step on space 5 against JAX's on ``train_mesh(1, 5)``."""
    _, res = units
    want = _jax_step("pacing", 5)
    got = _members(res, 5)[0]["pacing"]
    _assert_step_close(got, want, ExperimentConfig(**PACING).lr)
    _assert_grads_close(got[2], want[2], JAX_GRAD_L2["pacing"])


STEP_CASES = [(s, name) for s, names in STEPS.items() for name in names]


@pytest.mark.parametrize("s,name", STEP_CASES, ids=[f"space{s}-{n}" for s, n in STEP_CASES])
def test_step_matches_one_process(units, one_process, s, name):
    _, res = units
    want = one_process[name]
    members = _members(res, s)
    _assert_step_close(members[0][name], want, ExperimentConfig(**CONFIGS[name]).lr)
    _assert_grads_close(members[0][name][2], want[2])
    for got in members[1:]:          # equal replicas and banks on every rank
        assert got[name][0] == members[0][name][0]
        for k, v in members[0][name][1].items():
            assert torch.equal(got[name][1][k], v), k


def _shares(name, got):
    """A rank's own gradients before the grid's sum, by parameter name."""
    model = build_model(ExperimentConfig(**CONFIGS[name]).validate(), device="cpu")
    return {k: g for (k, _), g in zip(model.named_parameters(), got[name][3])
            if g is not None}


@pytest.mark.parametrize("s,name", [(5, "pacing"), (4, "pacing_os16")])
def test_replicated_gradients_enter_the_sum_once(units, one_process, s, name):
    """A replicated layer's gradient: each rank back-propagates its own
    rows' loss, so a rank's share is a part (more than 10% of the whole's
    norm away from it), the shares add up to the grid's sum, and the sum is
    one process's (were each share the whole, the sum would be ``n_space``
    times it)."""
    _, res = units
    want = one_process[name][2]
    prefixes = REPLICATED[CONFIGS[name].get("output_stride", 8)]
    keys = [k for k in want if k.startswith(prefixes) and k.endswith(".weight")]
    assert len(keys) >= 10
    members = _members(res, s)
    shares = [_shares(name, got) for got in members]
    for k in keys:
        total = sum(sh[k] for sh in shares)
        _close(total, members[0][name][2][k], rtol=0,
               atol=1e-5 * float(total.abs().max()))
        assert float((shares[0][k] - total).norm()) > 0.1 * float(total.norm()), k
    _assert_grads_close({k: members[0][name][2][k] for k in keys}, {k: want[k] for k in keys})


@pytest.mark.parametrize("s,name", [(5, "pacing"), (4, "pacing_os16")])
def test_replicated_batch_norm_statistics_are_one_copys(units, one_process, s, name):
    """The running statistics of the replicated layers equal one process's
    (a sum over the space axis would count ``n_space`` copies), on space 5
    and on data 2 x space 4, where they sum over the data axis."""
    _, res = units
    want = one_process[name][1]
    prefixes = REPLICATED[CONFIGS[name].get("output_stride", 8)]
    keys = [k for k in want if k.startswith(prefixes)
            and k.endswith(("running_mean", "running_var"))]
    assert len(keys) >= 10
    for got in _members(res, s):
        for k in keys:
            _close(got[name][1][k], want[k], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("s,name", [(5, "pacing"), (4, "pacing_os16")])
def test_replicated_tensors_are_not_summed_over_space(units, one_process, s, name):
    """``gather_heights`` of a replicated tensor is the tensor, and the bank
    (fed by the replicated aux features) equals one process's."""
    inp, res = units
    coarse = inp["gather"][s][4]
    for got in _members(res, s):
        d, _, n_data = got["grid"]
        assert torch.equal(got["gather"][2], coarse[d * N // n_data:(d + 1) * N // n_data])
        _close(got[name][1]["aux_path.memory_bank"],
               one_process[name][1]["aux_path.memory_bank"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("s", [5, 4])
def test_gather_backward_hands_each_rank_its_rows(units, s):
    """Rank ``r`` of the space axis weights its cotangent by ``r + 1``: the
    gradient of its block is the space sum of the ranks' cotangents on its
    own rows, ``s (s + 1) / 2`` times the cotangent there."""
    inp, res = units
    _, stride, x, cot, _ = inp["gather"][s]
    for got in _members(res, s):
        d, r, n_data = got["grid"]
        data = slice(d * N // n_data, (d + 1) * N // n_data)
        y, dx, _ = got["gather"]
        assert torch.equal(y, x[data])
        rows = spatial.HeightSplit.of(S, stride, s, r, S).rows(1)
        _close(dx, cot[data][..., rows, :] * (s * (s + 1) / 2), rtol=1e-6, atol=1e-6)


def test_cli_inference_past_the_coarse_rows_equals_one_process(tmp_path):
    """``--gpu cpu --num_devices 5 --spatial_shards 5`` on 32x32 slices at
    output stride 8 (4 coarse rows) writes the one-process run's
    ``eval_data.npz``."""
    spec = DATASETS["acdc"]
    data_root = str(tmp_path / "data")
    write_synthetic_dataset(data_root, "acdc", 20, (S, S), spec.num_classes,
                            spec.ignored_index, seed=7)
    ckp = tmp_path / "fold0.pth"
    torch.save(_unet_state(30, spec.num_classes, 8), ckp)
    common = ["--gpu", "cpu", "--dataset", "acdc", "--fold", "0", "--checkpoint_file",
              str(ckp), "--data_root", data_root, "--init_ch", str(INIT_CH),
              "--compute_dtype", "float32", "--batch_size", "3", "--num_workers", "1"]
    want = infer_cli.main(common + ["--root", str(tmp_path / "one")])
    got = infer_cli.main(common + ["--root", str(tmp_path / "ranks"), "--num_devices", "5",
                                   "--spatial_shards", "5"])
    run = {k: tmp_path / k / "Inference" / "acdc" / ckp.name for k in ("one", "ranks")}
    out = {k: np.load(run[k] / "eval_data.npz") for k in run}
    assert len(out["one"]["uids"]) >= 4
    assert list(out["ranks"]["uids"]) == list(out["one"]["uids"])
    np.testing.assert_array_equal(out["ranks"]["dicearr"], out["one"]["dicearr"])
    np.testing.assert_array_equal(out["ranks"]["hd95arr"], out["one"]["hd95arr"])
    assert got["dice"] == want["dice"]
    assert "inference mesh: data=1 x space=5" in (run["ranks"] / "log.txt").read_text()
