"""Port parity: the ten losses of ``pacingpseudo_torch.losses`` against
``pacingpseudo_tpu.losses`` on the same arrays (CPU, float32).

Inputs come from ``numpy.random.RandomState`` and go to both sides; the
JAX side takes them NHWC, the port NCHW (``_nchw`` is the one place that
permutes).  Tolerance: rtol 1e-5, atol 1e-6 -- the same float32 formulas,
summed in a different order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacingpseudo_tpu import losses as jl
from pacingpseudo_torch import losses as tl

N, H, W, C = 2, 16, 16, 5
RTOL, ATOL = 1e-5, 1e-6


def _nchw(x):
    """NHWC numpy -> NCHW torch (float32 or integer kept)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _inputs(seed):
    rs = np.random.RandomState(seed)
    logits = rs.randn(N, H, W, C).astype(np.float32) * 2.0
    other = rs.randn(N, H, W, C).astype(np.float32) * 2.0
    target = rs.randint(0, C + 1, (N, H, W)).astype(np.int64)   # C = ignore
    mask = (rs.rand(N, H, W, 1) > 0.3).astype(np.float32)
    probs = np.exp(other) / np.exp(other).sum(-1, keepdims=True)
    one_hot = np.eye(C, dtype=np.float32)[rs.randint(0, C, (N, H, W))]
    return dict(logits=logits, other=other, target=target, mask=mask,
                probs=probs.astype(np.float32), one_hot=one_hot)


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# name -> (jax call, port call) over the input dict
CASES = {
    "entropy_masked": (
        lambda d: jl.entropy_minimization_loss(d["logits"], d["mask"]),
        lambda d: tl.entropy_minimization_loss(_nchw(d["logits"]), _nchw(d["mask"]))),
    "entropy_unmasked": (
        lambda d: jl.entropy_minimization_loss(d["logits"]),
        lambda d: tl.entropy_minimization_loss(_nchw(d["logits"]))),
    "cross_entropy": (
        lambda d: jl.cross_entropy_loss(d["logits"], np.minimum(d["target"], C - 1)),
        lambda d: tl.cross_entropy_loss(_nchw(d["logits"]),
                                        torch.from_numpy(np.minimum(d["target"], C - 1)))),
    "partial_cross_entropy": (
        lambda d: jl.partial_cross_entropy_loss(d["logits"], d["target"], C),
        lambda d: tl.partial_cross_entropy_loss(_nchw(d["logits"]),
                                                torch.from_numpy(d["target"]), C)),
    "soft_label_cross_entropy": (
        lambda d: jl.soft_label_cross_entropy_loss(d["logits"], d["probs"], d["mask"]),
        lambda d: tl.soft_label_cross_entropy_loss(
            _nchw(d["logits"]), _nchw(d["probs"]), _nchw(d["mask"]))),
    "l1": (
        lambda d: jl.l1_loss(_softmax(d["logits"]), d["probs"], d["mask"]),
        lambda d: tl.l1_loss(_nchw(_softmax(d["logits"])), _nchw(d["probs"]),
                             _nchw(d["mask"]))),
    "l2": (
        lambda d: jl.l2_loss(_softmax(d["logits"]), d["probs"]),
        lambda d: tl.l2_loss(_nchw(_softmax(d["logits"])), _nchw(d["probs"]))),
    "kl": (
        lambda d: jl.kl_loss(d["logits"], d["other"], d["mask"]),
        lambda d: tl.kl_loss(_nchw(d["logits"]), _nchw(d["other"]), _nchw(d["mask"]))),
    "bidirectional_kl": (
        lambda d: jl.bidirectional_kl_loss(d["logits"], d["other"], d["mask"]),
        lambda d: tl.bidirectional_kl_loss(_nchw(d["logits"]), _nchw(d["other"]),
                                           _nchw(d["mask"]))),
    "dice": (
        lambda d: jl.dice_loss_fn(d["logits"], d["one_hot"]),
        lambda d: tl.dice_loss_fn(_nchw(d["logits"]), _nchw(d["one_hot"]))),
    "multi_label_soft_margin": (
        lambda d: jl.multi_label_soft_margin_loss(d["logits"][:, 0, 0],
                                                  d["one_hot"][:, 0, 0]),
        lambda d: tl.multi_label_soft_margin_loss(
            torch.from_numpy(d["logits"][:, 0, 0]),
            torch.from_numpy(d["one_hot"][:, 0, 0]))),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name, seed):
    d = _inputs(seed)
    jax_fn, port_fn = CASES[name]
    want = float(jax_fn(d))
    got = port_fn(d)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert np.isclose(float(got), want, rtol=RTOL, atol=ATOL), (float(got), want)


def test_partial_ce_all_ignored_is_zero_like_jax():
    d = _inputs(0)
    target = np.full((N, H, W), C, np.int64)
    want = float(jl.partial_cross_entropy_loss(d["logits"], target, C))
    got = tl.partial_cross_entropy_loss(_nchw(d["logits"]),
                                        torch.from_numpy(target), C)
    assert want == 0.0 and float(got) == 0.0


def test_loss_gradients_match_jax():
    """The gradient of the masked soft CE flows into the teacher too."""
    import jax

    d = _inputs(2)
    mask = d["mask"]

    def jax_total(lw, ls):
        return jl.soft_label_cross_entropy_loss(
            ls, jax.nn.softmax(lw, axis=-1), mask) + \
            jl.entropy_minimization_loss(lw, mask)

    gw, gs = jax.grad(jax_total, argnums=(0, 1))(jnp.asarray(d["logits"]),
                                                  jnp.asarray(d["other"]))
    lw = _nchw(d["logits"]).requires_grad_()
    ls = _nchw(d["other"]).requires_grad_()
    m = _nchw(mask)
    total = tl.soft_label_cross_entropy_loss(ls, torch.softmax(lw, 1), m) + \
        tl.entropy_minimization_loss(lw, m)
    total.backward()
    for got, want in ((lw.grad, gw), (ls.grad, gs)):
        want = _nchw(np.asarray(want)).numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
