"""Port parity: the fused training-mode ConvLayer
(``pacingpseudo_torch/ops/fused_convbn.py``) against
``pacingpseudo_tpu/ops/pallas/fused_convbn.py``, on the CPU in float32.

The same numpy inputs, made from a seed, go to both sides; the JAX kernels
run in Pallas interpret mode (as ``tests/test_fused_convbn.py`` runs them),
the port's wrappers run their plain versions (CPU tensors).  Tolerances:

* the three kernels' plain versions against the JAX calls they replace:
  ``y`` and ``dxp`` atol 1e-5 (the border of ``dxp`` exactly zero); the
  sums rtol 1e-5, with an atol of 1e-5 x the largest sum for a channel
  whose sum lies near 0;
* ``weight_grad`` from bfloat16 inputs against the weight-gradient
  convolution of JAX's ``_bwd`` (``preferred_element_type=float32``):
  float32, within 1e-5 x its max (rounded to bfloat16 it would be off by
  up to 2**-9 of a value);
* ``conv_bn_lrelu_train``: ``zp`` atol 1e-5, mean 1e-6, var 1e-5; the five
  gradients within 2e-4 x their max, except ``dbias`` at groups=1, whose
  true value is 0 (BatchNorm's mean subtraction absorbs the bias): both
  sides must give roundoff under 1e-3 x the largest ``dbeta``;
* ``ConvLayer`` / ``DoubleConv`` under "fused" on both sides, the
  tolerances of ``tests/test_fused_convbn.py`` (output 1e-4 / 2e-4, BN
  statistics 1e-5, gradients 2e-4 / 5e-4 x max, conv bias roundoff);
* one pacing train step under "fused" on both sides: the tolerances of
  ``tests/test_torch_port_step.py``, whose fixture pattern this reuses.

The conv impl is process-global in both packages; every test that sets it
restores both in ``finally`` (xdist runs other files in the same worker).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacingpseudo_tpu.models.unet import ConvLayer as JaxConvLayer
from pacingpseudo_tpu.models.unet import DoubleConv as JaxDoubleConv
from pacingpseudo_tpu.ops.pallas import fused_convbn as jfc
from pacingpseudo_torch.models.unet import ConvLayer, DoubleConv
from pacingpseudo_torch.ops import fused_convbn as fc

EPS, SLOPE = 1e-5, 1e-2


@contextlib.contextmanager
def _conv_impl(impl):
    prev = (jfc.get_conv_impl(), fc.get_conv_impl())
    try:
        jfc.set_conv_impl(impl)
        fc.set_conv_impl(impl)
        yield
    finally:
        jfc.set_conv_impl(prev[0])
        fc.set_conv_impl(prev[1])


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _padded(rng, n, h, w, c):
    x = rng.randn(n, h, w, c).astype(np.float32)
    return np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))


# ---------------------------------------------------------------------------
# The kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,h,w,ci,co", [(2, 32, 24, 8, 12), (2, 32, 16, 1, 8)])
def test_conv_stats_plain_matches_jax(n, h, w, ci, co):
    rng = np.random.RandomState(10 + ci)
    xp = _padded(rng, n, h, w, ci)
    w9 = (0.2 * rng.randn(9, ci, co)).astype(np.float32)
    bias = (0.1 * rng.randn(co)).astype(np.float32)
    y_j, sums_j = jfc._conv_stats_call(jnp.asarray(xp), jnp.asarray(w9),
                                       jnp.asarray(bias), co)
    y, sums = fc.conv_stats(_t(xp), _t(w9), _t(bias))
    assert y.shape == (n, h, w, co) and sums.shape == (2, co)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5, rtol=0)
    want = np.asarray(sums_j)
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,h,w,co", [(2, 32, 24, 12), (2, 32, 16, 1)])
def test_bn_sums_plain_matches_jax(n, h, w, co):
    rng = np.random.RandomState(20 + co)
    y = rng.randn(n, h, w, co).astype(np.float32)
    gzp = _padded(rng, n, h, w, co)
    aux = np.stack([0.1 * rng.randn(co), rng.rand(co) + 0.5,
                    rng.rand(co) + 0.5, 0.1 * rng.randn(co)]).astype(np.float32)
    want = np.asarray(jfc._bn_sums_call(jnp.asarray(y), jnp.asarray(gzp),
                                        jnp.asarray(aux), SLOPE))
    got = fc.bn_sums(_t(y), _t(gzp), _t(aux), SLOPE)
    assert got.shape == (2, co)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,h,w,co,ci", [(2, 32, 24, 12, 8), (2, 32, 16, 8, 1)])
def test_conv_pad_out_plain_matches_jax(n, h, w, co, ci):
    rng = np.random.RandomState(30 + ci)
    dyp = _padded(rng, n, h, w, co)
    w9t = (0.2 * rng.randn(9, co, ci)).astype(np.float32)
    want = np.asarray(jfc._conv_pad_out_call(jnp.asarray(dyp), jnp.asarray(w9t), ci))
    got = fc.conv_pad_out(_t(dyp), _t(w9t)).numpy()
    assert got.shape == (n, h + 2, w + 2, ci)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for border in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert np.all(border == 0.0)


def test_weight_grad_bf16_sums_in_float32():
    """The fused path's dW keeps JAX's float32 result for bfloat16 inputs."""
    rng = np.random.RandomState(40)
    n, h, w, ci, co = 2, 32, 24, 8, 12
    xp = jnp.asarray(_padded(rng, n, h, w, ci), jnp.bfloat16)
    dy = jnp.asarray(rng.randn(n, h, w, co), jnp.bfloat16)
    # The filter-gradient convolution of jfc._bwd, as it is written there.
    want = jax.lax.conv_general_dilated(
        xp, dy, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("CHWN", "IHWO", "NHWC"),
        preferred_element_type=jnp.float32)
    want = np.asarray(jnp.transpose(want, (1, 2, 0, 3)))
    got = fc.weight_grad(_t(xp.astype(jnp.float32)).bfloat16(),
                         _t(dy.astype(jnp.float32)).bfloat16())
    assert got.dtype == torch.float32 and got.shape == (3, 3, ci, co)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The differentiable op
# ---------------------------------------------------------------------------

def _op_inputs(seed, n, h, w, ci, co, c_log):
    rng = np.random.RandomState(seed)
    return (_padded(rng, n, h, w, ci),
            (0.2 * rng.randn(3, 3, ci, co)).astype(np.float32),
            (0.1 * rng.randn(co)).astype(np.float32),
            (rng.rand(c_log) + 0.5).astype(np.float32),
            (0.1 * rng.randn(c_log)).astype(np.float32))


@pytest.mark.parametrize("groups", [1, 4])
def test_conv_bn_lrelu_train_matches_jax(groups):
    co = 12 if groups == 1 else 16
    inputs = _op_inputs(groups, 2, 32, 16, 8, co, co // groups)
    cot = np.cos(0.1 * np.arange(2 * 34 * 18 * co)).reshape(2, 34, 18, co)

    def jax_loss(*args):
        zp, m, v = jfc.conv_bn_lrelu_train(*args, EPS, groups, SLOPE)
        return jnp.sum(zp * cot), (zp, m, v)

    grads_j, (zp_j, m_j, v_j) = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4),
                                         has_aux=True)(*map(jnp.asarray, inputs))
    args = [_t(a).requires_grad_() for a in inputs]
    zp, m, v = fc.conv_bn_lrelu_train(*args, EPS, groups, SLOPE)
    grads = torch.autograd.grad((zp * _t(cot)).sum(), args)

    np.testing.assert_allclose(zp.detach().numpy(), np.asarray(zp_j), atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-5)
    overall = float(np.abs(grads_j[4]).max())
    for name, got, want in zip(("dx", "dkernel", "dbias", "dscale", "dbeta"),
                               grads, grads_j):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape, name
        if name == "dbias" and groups == 1:
            assert np.abs(got).max() < 1e-3 * overall
            assert np.abs(want).max() < 1e-3 * overall
            continue
        np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_reference_matches_fused_op():
    """The port's unfused twin agrees with its fused op (the JAX test's
    contract for its own pair)."""
    args = [_t(a) for a in _op_inputs(7, 2, 32, 24, 8, 12, 12)]
    zf, mf, vf = fc.conv_bn_lrelu_train(*args, EPS, 1, SLOPE)
    zr, mr, vr = fc.conv_bn_lrelu_reference(*args, EPS, 1, SLOPE)
    torch.testing.assert_close(zf, zr, atol=1e-5, rtol=0)
    torch.testing.assert_close(mf, mr, atol=1e-6, rtol=0)
    torch.testing.assert_close(vf, vr, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# ConvLayer and DoubleConv
# ---------------------------------------------------------------------------

def _load_conv_layer(layer, params, stats):
    with torch.no_grad():
        layer.conv.weight.copy_(_t(params["conv"]["kernel"]).permute(3, 2, 0, 1))
        layer.conv.bias.copy_(_t(params["conv"]["bias"]))
        layer.norm_op.weight.copy_(_t(params["norm"]["scale"]))
        layer.norm_op.bias.copy_(_t(params["norm"]["bias"]))
        layer.norm_op.running_mean.copy_(_t(stats["norm"]["mean"]))
        layer.norm_op.running_var.copy_(_t(stats["norm"]["var"]))


def _layers(module, variables):
    """(port ConvLayer, JAX params, JAX stats) of a ConvLayer or DoubleConv."""
    params, stats = variables["params"], variables["batch_stats"]
    if isinstance(module, ConvLayer):
        return [(module, params, stats)]
    return [(getattr(module, k), params[k], stats[k])
            for k in ("conv_layer1", "conv_layer2")]


def _grad_of(layer):
    return {("conv", "kernel"): layer.conv.weight.grad.permute(2, 3, 1, 0),
            ("conv", "bias"): layer.conv.bias.grad,
            ("norm", "scale"): layer.norm_op.weight.grad,
            ("norm", "bias"): layer.norm_op.bias.grad}


def _check_module(jax_module, module, x, out_tol, grad_tol, bias_tol,
                  expect_fused, monkeypatch):
    """Both sides under "fused", from the same weights: output, running
    statistics and parameter gradients of ``sum(out**2)``; ``expect_fused``
    fused layers on the port side."""
    from pacingpseudo_torch.models import unet

    calls = []
    monkeypatch.setattr(unet, "conv_bn_lrelu_train",
                        lambda *a: calls.append(1) or fc.conv_bn_lrelu_train(*a))
    with _conv_impl("fused"):
        v = jax_module.init(jax.random.PRNGKey(0), x, True)

        def loss(variables):
            out, st = jax_module.apply(variables, x, True, mutable=["batch_stats"])
            return jnp.sum(out ** 2), (out, st)

        (_, (out_j, st_j)), g_j = jax.value_and_grad(loss, has_aux=True)(v)
        layers = _layers(module, v)
        for layer, params, stats in layers:
            _load_conv_layer(layer, params, stats)
        module.train()
        out = module(_t(np.moveaxis(np.asarray(x), -1, 1)))
        (out ** 2).sum().backward()
    assert len(calls) == expect_fused

    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(out_j), atol=out_tol)
    new_layers = _layers(module, {"params": g_j["params"], "batch_stats": st_j["batch_stats"]})
    overall = max(float(np.abs(le).max()) for le in jax.tree_util.tree_leaves(g_j["params"]))
    for (layer, grads_j, stats_j) in new_layers:
        for key, want in (("running_mean", stats_j["norm"]["mean"]),
                          ("running_var", stats_j["norm"]["var"])):
            np.testing.assert_allclose(getattr(layer.norm_op, key).numpy(),
                                       np.asarray(want), atol=1e-5, err_msg=key)
        assert int(layer.norm_op.num_batches_tracked) == 1
        for (scope, leaf), got in _grad_of(layer).items():
            want = np.asarray(grads_j[scope][leaf])
            if (scope, leaf) == ("conv", "bias"):
                assert float(got.abs().max()) < bias_tol * overall
                assert np.abs(want).max() < bias_tol * overall
                continue
            np.testing.assert_allclose(got.numpy(), want,
                                       atol=grad_tol * np.abs(want).max(),
                                       err_msg=f"{scope}/{leaf}")


def test_conv_layer_fused_matches_jax(monkeypatch):
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(2, 64, 64, 8).astype(np.float32))
    _check_module(JaxConvLayer(features=12), ConvLayer(8, 12), x,
                  1e-4, 2e-4, 1e-3, 1, monkeypatch)


@pytest.mark.parametrize("stride1,dilation,expect_fused",
                         [(1, 1, 2), (2, 1, 1), (1, 2, 0)])
def test_double_conv_fused_matches_jax(stride1, dilation, expect_fused, monkeypatch):
    """The padded canvas handed from layer to layer, and the stride 2 and
    dilation 2 gates: at 64x64 a stride-2 first layer leaves a fusable
    32x32 second layer; dilation keeps both unfused."""
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(2, 64, 64, 4).astype(np.float32))
    _check_module(JaxDoubleConv(features=8, stride1=stride1, dilation=dilation),
                  DoubleConv(4, 8, stride1, dilation), x, 2e-4, 5e-4, 2e-3,
                  expect_fused, monkeypatch)


def test_eval_mode_ignores_fused_impl():
    torch.manual_seed(4)
    layer = ConvLayer(4, 8).eval()
    x = torch.randn(1, 4, 32, 32)
    with _conv_impl("xla"):
        want = layer(x)
    with _conv_impl("fused"):
        assert not layer.is_fused(32, 32)
        got = layer(x)
    assert torch.equal(got, want)
    assert int(layer.norm_op.num_batches_tracked) == 0


def test_unfused_layer_refuses_canvas():
    """Padded canvases pass only between fused layers: a layer on the
    unfused path (here dilated) refuses them."""
    layer = ConvLayer(4, 8, dilation=2).train()
    with _conv_impl("fused"):
        assert not layer.is_fused(32, 32)
        for flags in ({"padded_in": True}, {"padded_out": True}):
            with pytest.raises(ValueError):
                layer(torch.zeros(1, 4, 34, 34), **flags)


def test_fusable_matches_jax():
    cases = [(h, w, k, s, d) for h in (16, 32, 48, 64, 128, 256) for w in (4, 8, 24, 64)
             for k in (1, 3) for s in (1, 2) for d in (1, 2, 4)]
    for case in cases:
        assert fc.fusable(*case) == jfc.fusable(*case), case
    assert fc.fusable(32, 64, 3, 1, 1) and not fc.fusable(48, 64, 3, 1, 1)


def test_conv_impl_selection():
    with _conv_impl("xla"):
        assert fc.get_conv_impl() == "xla"
        fc.set_conv_impl("fused")
        assert fc.get_conv_impl() == "fused"
        with pytest.raises(ValueError):
            fc.set_conv_impl("pallas")


def test_jax_fused_init_loads_strictly():
    """A JAX model initialised under "fused" declares the parameter and
    statistics tree of one initialised under "xla" (``ConvParamsOnly`` /
    ``BNParamsOnly``), and the weight bridge loads it into the port, which
    has one set of names for both paths, strictly."""
    from pacingpseudo_tpu.models import PacingPseudoModel as JaxPacing
    from pacingpseudo_torch.models.pacing import PacingPseudoModel
    from pacingpseudo_torch.tools.weights import from_jax_variables

    model = JaxPacing(num_classes=4, init_ch=8, do_aux_path=True, hid_ch=16,
                      s2d_hires=False, dtype=jnp.float32)
    x = jnp.zeros((2, 64, 64, 1), jnp.float32)

    def variables(impl):
        with _conv_impl(impl):
            shapes = jax.eval_shape(lambda k: model.init(
                {"params": k, "dropout": k}, x, x, train=True), jax.random.key(0))
        return jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)

    fused, xla = variables("fused"), variables("xla")
    assert jax.tree_util.tree_structure(fused) == jax.tree_util.tree_structure(xla)
    port = PacingPseudoModel(num_classes=4, init_ch=8, do_aux_path=True, hid_ch=16)
    port.load_state_dict(from_jax_variables(fused["params"], fused["batch_stats"]),
                         strict=True)


# ---------------------------------------------------------------------------
# One pacing train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fused_run():
    """The JAX train step under "fused", traced after the impl is set."""
    import optax
    from test_torch_port_step import (FLAGS, N, STEPS_PER_EPOCH, _batch, _compiled,
                                      _grad_stash, _initial_state_dict, _np)

    from pacingpseudo_tpu.config import ExperimentConfig as JaxConfig
    from pacingpseudo_tpu.models import PacingPseudoModel as JaxPacing
    from pacingpseudo_tpu.tools.torch_import import convert_state_dict
    from pacingpseudo_tpu.train import optim as jax_optim
    from pacingpseudo_tpu.train.state import TrainState as JaxState
    from pacingpseudo_tpu.train.step import make_pacing_train_step as jax_train_step
    from pacingpseudo_torch.tools.weights import from_jax_variables

    sd0 = _initial_state_dict()
    batch = _batch()
    params, stats, bank = convert_state_dict({k: v.numpy() for k, v in sd0.items()})
    config = JaxConfig(**FLAGS).validate()
    model = JaxPacing(num_classes=FLAGS["num_classes"], init_ch=FLAGS["init_ch"],
                      do_aux_path=True, hid_ch=FLAGS["hid_ch"], s2d_hires=False,
                      dtype=jnp.float32)
    tx = optax.chain(_grad_stash(), jax_optim.make_optimizer(config, STEPS_PER_EPOCH))
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=stats, opt_state=tx.init(params),
                     memory_bank=jnp.asarray(bank))
    with _conv_impl("fused"):
        step = jax_train_step(config, model, tx, STEPS_PER_EPOCH, donate=False)
        new_state, metrics = _compiled(step, state, batch, jax.random.key(0, impl="rbg"))
    assert batch["image"].shape[0] == N
    return dict(sd0=sd0, batch=batch, metrics=_np(metrics),
                grads=_np(new_state.opt_state[0]),
                new_sd=from_jax_variables(_np(new_state.params),
                                          _np(new_state.batch_stats),
                                          np.array(new_state.memory_bank)))


def test_train_step_fused_matches_jax(fused_run, monkeypatch):
    """At 64x64 the gate fuses enc_block1, enc_block2, dec_block2 and
    dec_block1 (both layers each) and leaves the rest unfused."""
    from test_torch_port_step import (STEPS_PER_EPOCH, _assert_grads_close,
                                      _assert_new_params_close, _port_batch,
                                      _port_state)

    from pacingpseudo_torch.models import unet
    from pacingpseudo_torch.tools.weights import from_jax_variables
    from pacingpseudo_torch.train.step import make_pacing_train_step

    calls = []
    monkeypatch.setattr(unet, "conv_bn_lrelu_train",
                        lambda *a: calls.append(1) or fc.conv_bn_lrelu_train(*a))
    with _conv_impl("fused"):
        config, state = _port_state(fused_run["sd0"])
        metrics = make_pacing_train_step(config, STEPS_PER_EPOCH)(
            state, _port_batch(fused_run["batch"]))
    assert len(calls) == 8
    assert state.step == 1
    assert sorted(metrics) == sorted(fused_run["metrics"])
    for k, want in fused_run["metrics"].items():
        assert np.isclose(float(metrics[k]), float(want), rtol=1e-4, atol=0), k

    params = dict(state.model.named_parameters())
    want_grads = from_jax_variables(fused_run["grads"], {})
    _assert_grads_close(params, want_grads)
    _assert_new_params_close(params, fused_run["sd0"], want_grads, fused_run["new_sd"],
                             float(fused_run["metrics"]["lr"]), config.wd)
    got_sd = state.model.state_dict()
    for name, want in fused_run["new_sd"].items():
        if name.endswith(("running_mean", "running_var", "memory_bank")):
            err = float((got_sd[name] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (name, err)
