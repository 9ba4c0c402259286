"""Port parity: the UNet, the siamese model, the weight bridge and the memory
bank of ``pacingpseudo_torch`` against ``pacingpseudo_tpu`` (CPU, float32,
64x64, init_ch 8, batch 2).

* A JAX-initialised ``PacingPseudoModel(do_aux_path=True)`` loads into the
  port through ``tools.weights.from_jax_variables`` with ``strict=True``;
  both give the same outputs and BN statistics, in train and eval mode.
* UNet variants (output stride 8/16/32, stride/trans-conv) take the port's
  own seeded init, cross to JAX through the JAX package's importer
  (``convert_state_dict``) and back through the bridge.
* The JAX oracle is the logical layout (``s2d_hires=False``); one case
  runs the JAX default ``s2d_hires=True`` on the same parameters.
* ``memory_update`` in first/all x cosine/mean, cold and warm.

Inputs come from ``numpy.random.RandomState``; ``_nchw`` is the one place
that permutes JAX's NHWC into the port's NCHW.  The JAX init draws from an
``rbg`` key (threefry's per-shape compiles cost most of a minute on one
core) and the JAX forwards run eagerly, which compiles less than ``jit``
for one call.  Tolerance: every tensor
within 1e-4 x its max |value| (float32 convolutions in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacingpseudo_tpu.models import PacingPseudoModel as JaxPacing
from pacingpseudo_tpu.models import UNet as JaxUNet
from pacingpseudo_tpu.models.aux_path import memory_update as jax_memory_update
from pacingpseudo_tpu.tools.torch_import import convert_state_dict
from pacingpseudo_torch.models import PacingPseudoModel, UNet, memory_update
from pacingpseudo_torch.models.unet import torch_default_init_
from pacingpseudo_torch.tools.weights import from_jax_variables

N, S, C, INIT_CH, HID = 2, 64, 4, 8, 16
RTOL = 1e-4


def _nchw(x):
    """NHWC numpy -> NCHW torch: the one place the layouts meet."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def _assert_close(got, want, what=""):
    got = got.detach()
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    assert err <= RTOL * scale, f"{what}: max err {err} vs max |value| {scale}"


def _images(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(N, S, S, 1).astype(np.float32)
    xs = (1.3 * x + 0.2 * rs.randn(N, S, S, 1)).astype(np.float32)
    return x, xs


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bn_stats(state_dict):
    return {k: v for k, v in state_dict.items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def jax_pacing():
    """A JAX-initialised siamese model with an aux path: (params, stats)."""
    model = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=True,
                      hid_ch=HID, s2d_hires=False, dtype=jnp.float32)
    x, _ = _images(0)
    key = jax.random.key(0, impl="rbg")
    variables = jax.jit(lambda k: model.init(
        {"params": k, "dropout": k}, x, x, train=True))(key)
    return _np_tree(variables["params"]), _np_tree(variables["batch_stats"])


def _port_pacing(params, stats, **kw):
    model = PacingPseudoModel(num_classes=C, init_ch=INIT_CH, do_aux_path=True,
                              hid_ch=HID, **kw)
    model.load_state_dict(from_jax_variables(params, stats), strict=True)
    return model


def test_jax_init_strict_loads_and_counts_match(jax_pacing):
    params, stats = jax_pacing
    model = _port_pacing(params, stats)
    n_jax = sum(np.size(leaf) for leaf in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert tuple(model.aux_path.memory_bank.shape) == (C, HID, 1, 1)
    assert float(model.aux_path.memory_bank.abs().sum()) == 0.0


def test_full_width_parameter_count():
    """The reference UNet's 19,654,692 parameters (tests/test_unet.py)."""
    unet = UNet(num_classes=4, output_stride=8, device="meta")
    assert sum(p.numel() for p in unet.parameters()) == 19654692


@pytest.mark.parametrize("s2d_hires", [False, True])
def test_pacing_model_matches_jax(jax_pacing, s2d_hires):
    params, stats = jax_pacing
    jm = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=True,
                   hid_ch=HID, s2d_hires=s2d_hires, dtype=jnp.float32)
    x, xs = _images(1)
    out, mutated = jm.apply({"params": params, "batch_stats": stats}, x, xs,
                            train=True, mutable=["batch_stats"])
    # eval with the statistics the train forward left, as the port's BN has
    eval_out = jm.apply({"params": params, "batch_stats": mutated["batch_stats"]},
                        x, None, train=False)

    model = _port_pacing(params, stats)
    model.train()
    got = model(_nchw(x), _nchw(xs), train=True)
    assert sorted(got) == sorted(out)
    for k in out:
        _assert_close(got[k], _nchw(out[k]), k)
    want_stats = _bn_stats(from_jax_variables(params, _np_tree(mutated["batch_stats"])))
    got_stats = _bn_stats(model.state_dict())
    assert sorted(got_stats) == sorted(want_stats)
    for k in want_stats:
        _assert_close(got_stats[k], want_stats[k], k)

    model.eval()
    with torch.no_grad():
        got_eval = model(_nchw(x), None, train=False)
    assert sorted(got_eval) == ["segmentation/logits"]
    _assert_close(got_eval["segmentation/logits"],
                  _nchw(eval_out["segmentation/logits"]), "eval logits")


@pytest.mark.parametrize("output_stride,stride_conv",
                         [(8, False), (16, False), (32, False), (8, True)])
def test_unet_variants_match_jax(output_stride, stride_conv):
    kw = dict(num_classes=C, init_ch=INIT_CH, output_stride=output_stride,
              is_stride_conv=stride_conv, is_trans_conv=stride_conv,
              elab_end_points=True)
    model = torch_default_init_(UNet(**kw), torch.Generator().manual_seed(output_stride))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats, _ = convert_state_dict(sd)
    back = from_jax_variables(params, stats)
    assert sorted(back) == sorted(sd)
    assert all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)

    jm = JaxUNet(s2d_hires=False, dtype=jnp.float32, **kw)
    x, _ = _images(2)
    variables = {"params": params, "batch_stats": stats}
    out, mutated = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    eval_out = jm.apply({"params": params, "batch_stats": mutated["batch_stats"]},
                        x, train=False)

    model.train()
    got = model(_nchw(x))
    for k in out:
        _assert_close(got[k], _nchw(out[k]), k)
    want_stats = _bn_stats(from_jax_variables(params, _np_tree(mutated["batch_stats"])))
    for k, v in want_stats.items():
        _assert_close(model.state_dict()[k], v, k)
    model.eval()
    with torch.no_grad():
        got_eval = model(_nchw(x))
    for k in eval_out:
        _assert_close(got_eval[k], _nchw(eval_out[k]), "eval " + k)


@functools.lru_cache(maxsize=None)
def _jax_memory_update(update_mode, ensemble_mode):
    return jax.jit(functools.partial(
        jax_memory_update, max_step=400, momentum=0.9,
        ensemble_mode=ensemble_mode, update_mode=update_mode))


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("ensemble_mode", ["cosine_similarity", "mean"])
@pytest.mark.parametrize("update_mode", ["first", "all"])
def test_memory_update_matches_jax(update_mode, ensemble_mode, warm):
    rs = np.random.RandomState(7)
    bank = rs.randn(C, HID).astype(np.float32) if warm else np.zeros((C, HID), np.float32)
    if warm:
        bank[1] = 0.0                           # one cold row in a warm bank
    feats = rs.randn(3, 8, 8, HID).astype(np.float32)
    hard = rs.randint(0, C + 1, (3, 32, 32))
    hard[0][hard[0] == 2] = C                   # class 2 absent from sample 0
    scb = np.eye(C + 1, dtype=np.float32)[hard]
    want = _jax_memory_update(update_mode, ensemble_mode)(bank, feats, scb, step=37.0)
    got = memory_update(torch.from_numpy(bank), _nchw(feats), _nchw(scb),
                        step=37.0, max_step=400, momentum=0.9,
                        ensemble_mode=ensemble_mode, update_mode=update_mode)
    assert got.shape == (C, HID)
    _assert_close(got, torch.from_numpy(np.array(want)), "bank")
