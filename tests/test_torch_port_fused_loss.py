"""Port parity: ``pacingpseudo_torch.ops.fused_loss`` on the CPU (the plain
forward and the analytic backward, through the ``autograd.Function``)
against the JAX package's Pallas kernel in interpret mode,
``fused_pacing_losses(..., interpret=True)``, and its ``jax.grad``.

Cases mirror ``tests/test_pallas_fused_loss.py``: C in {2, 4, 5}, an
all-ignored target and an all-zero mask.  The kernels themselves run only
on a CUDA card; ``chip_smoke.py`` holds them against these plain versions
there.  Tolerances: loss values rtol 1e-5 / atol 1e-6; gradients within
1e-4 x the field's max |value| (float32 sums in a different order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacingpseudo_tpu.ops.pallas import fused_pacing_losses as jax_fused
from pacingpseudo_torch.losses import (
    entropy_minimization_loss,
    partial_cross_entropy_loss,
    soft_label_cross_entropy_loss,
)
from pacingpseudo_torch.ops import fused_loss as fl

N, H, W = 2, 8, 128
WEIGHTS = (1.0, 0.37, 2.1)        # arbitrary per-loss weights (ramp values)


def _nchw(x):
    """NHWC numpy -> NCHW torch: the one place the layouts meet."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _data(seed, c, case="random"):
    rs = np.random.RandomState(seed)
    lw = rs.randn(N, H, W, c).astype(np.float32) * 2.0
    ls = rs.randn(N, H, W, c).astype(np.float32) * 2.0
    tgt = rs.randint(0, c + 1, (N, H, W)).astype(np.int64)      # c = ignore
    mask = (rs.rand(N, H, W) > 0.3).astype(np.float32)
    if case == "all_ignored":
        tgt[:] = c
    if case == "zero_mask":
        mask[:] = 0.0
    return lw, ls, tgt, mask


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(c):
    def total(lw, ls, tgt, mask):
        losses = jax_fused(lw, ls, tgt, mask, c, True)
        return sum(w * l for w, l in zip(WEIGHTS, losses)), losses
    return jax.jit(jax.value_and_grad(total, argnums=(0, 1), has_aux=True))


def _jax(lw, ls, tgt, mask, c):
    (_, losses), (gw, gs) = _jax_value_and_grad(c)(
        jnp.asarray(lw), jnp.asarray(ls), jnp.asarray(tgt, jnp.int32),
        jnp.asarray(mask))
    return [float(v) for v in losses], _nchw(np.asarray(gw)), _nchw(np.asarray(gs))


def _port(lw, ls, tgt, mask, c):
    lw_t = _nchw(lw).requires_grad_()
    ls_t = _nchw(ls).requires_grad_()
    losses = fl.fused_pacing_losses(lw_t, ls_t, torch.from_numpy(tgt),
                                    torch.from_numpy(mask), c)
    sum(w * l for w, l in zip(WEIGHTS, losses)).backward()
    return [float(v.detach()) for v in losses], lw_t.grad, ls_t.grad


def _assert_grads_close(got, want):
    scale = max(float(want.abs().max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("case,c", [("random", 2), ("random", 4), ("random", 5),
                                    ("all_ignored", 5), ("zero_mask", 5)])
def test_fused_loss_matches_jax_kernel(case, c):
    lw, ls, tgt, mask = _data(c, c, case)
    want_losses, want_gw, want_gs = _jax(lw, ls, tgt, mask, c)
    got_losses, got_gw, got_gs = _port(lw, ls, tgt, mask, c)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5, atol=1e-6)
    assert torch.isfinite(got_gw).all() and torch.isfinite(got_gs).all()
    _assert_grads_close(got_gw, want_gw)
    _assert_grads_close(got_gs, want_gs)
    if case == "all_ignored":
        assert got_losses[0] == 0.0
    if case == "zero_mask":
        assert got_losses[1] == 0.0 and got_losses[2] == 0.0
        assert float(got_gs.abs().max()) == 0.0


@pytest.mark.parametrize("c", [2, 5])
def test_analytic_backward_equals_autograd_of_plain_forward(c):
    lw, ls, tgt, mask = _data(10 + c, c)
    _, got_gw, got_gs = _port(lw, ls, tgt, mask, c)
    lw_t = _nchw(lw).requires_grad_()
    ls_t = _nchw(ls).requires_grad_()
    out = fl.forward_plain(lw_t, ls_t, torch.from_numpy(tgt),
                           torch.from_numpy(mask), c)
    (WEIGHTS[0] * out[5] + WEIGHTS[1] * out[6] + WEIGHTS[2] * out[7]).backward()
    _assert_grads_close(got_gw, lw_t.grad)
    _assert_grads_close(got_gs, ls_t.grad)


def test_plain_forward_equals_loss_library():
    c = 5
    lw, ls, tgt, mask = _data(3, c)
    lw_t, ls_t, tgt_t = _nchw(lw), _nchw(ls), torch.from_numpy(tgt)
    mask4 = torch.from_numpy(mask)[:, None]
    got = fl.fused_pacing_losses(lw_t, ls_t, tgt_t, mask4[:, 0], c)
    want = (partial_cross_entropy_loss(lw_t, tgt_t, c),
            entropy_minimization_loss(lw_t, mask4),
            soft_label_cross_entropy_loss(ls_t, torch.softmax(lw_t, 1), mask4))
    for g, w in zip(got, want):
        assert np.isclose(float(g), float(w), rtol=1e-5, atol=1e-6)


def test_wrapper_checks_inputs_and_counts_no_cpu_launches():
    c = 4
    lw, ls, tgt, mask = _data(4, c)
    lw_t, ls_t = _nchw(lw), _nchw(ls)
    fl.reset_launch_counts()
    fl.fused_pacing_losses(lw_t, ls_t, torch.from_numpy(tgt),
                           torch.from_numpy(mask), c)
    assert fl.LAUNCHES == {"fused_loss_fwd": 0, "fused_loss_bwd": 0}
    with pytest.raises(TypeError):
        fl.fused_loss_forward(lw_t, ls_t, torch.from_numpy(tgt).int(),
                              torch.from_numpy(mask), c)
    with pytest.raises(TypeError):
        fl.fused_loss_forward(lw_t.double(), ls_t.double(),
                              torch.from_numpy(tgt), torch.from_numpy(mask), c)
    with pytest.raises(ValueError):
        fl.fused_loss_forward(lw_t[:, :1], ls_t[:, :1], torch.from_numpy(tgt),
                              torch.from_numpy(mask), c)
    with pytest.raises(ValueError):
        fl.fused_loss_forward(lw_t.to("meta"), ls_t.to("meta"),
                              torch.from_numpy(tgt).to("meta"),
                              torch.from_numpy(mask).to("meta"), c)

