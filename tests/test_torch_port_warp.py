"""Port parity: ``pacingpseudo_torch.ops.warp_table`` and
``pacingpseudo_torch.ops.warp`` against ``pacingpseudo_tpu.ops`` (CPU,
float32, small canvases).

The same numpy inputs go through the JAX function, mapped over the batch
with ``vmap``, and through the port's batched function.  The Pallas
warp-table kernel runs in interpret mode, as ``tests/test_warp_table.py``
runs it.  On the CPU the port's ``build_warp_table`` takes its plain
version; the CUDA kernel is held against that plain version on the card by
``chip_smoke.py``.

Tolerances: the table is a pure copy and must be equal bit for bit, in
float32 and in bf16.  From the same coordinates the class votes must be
equal bit for bit (the port keeps the order of operations of the weights
and the vote); the interpolated image is held within 1e-5 x max, the room
that differently ordered float32 sums of 16 cubic taps need.  The bilinear
sample and the Gaussian blur are held within 1e-5 x max, the elastic field
within 1e-4 x max (its upsample is ``F.interpolate`` here and two matrix
products there), the amplitude correction within rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacingpseudo_tpu.aug import engine as jax_engine
from pacingpseudo_tpu.ops import warp as jax_warp
from pacingpseudo_tpu.ops.pallas import warp_table as jax_table
from pacingpseudo_torch.aug import engine
from pacingpseudo_torch.ops import warp, warp_table

NUM_VALUES = 6


def _planes(seed, n, h, w, sentinel=False):
    rs = np.random.RandomState(seed)
    img = rs.randn(n, h, w).astype(np.float32)
    lab = rs.randint(0, NUM_VALUES, (n, h, w)).astype(np.float32)
    scb = rs.randint(0, NUM_VALUES, (n, h, w)).astype(np.float32)
    if sentinel:
        lab[:, -3:] = 255.0
        scb[:, :, -5:] = NUM_VALUES - 1
    return img, lab, scb


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sentinel", [False, True], ids=["classes", "sentinel"])
def test_table_plain_equals_pallas_and_xla(sentinel):
    """(2, 64, 96): the port's plain table == the Pallas kernel (interpret)
    == the XLA construction, bit for bit, also with the sentinel 255."""
    img, lab, scb = _planes(0, 2, 64, 96, sentinel)
    got = warp_table.build_warp_table_plain(*_t(img, lab, scb)).numpy()
    assert got.shape == (2, 64 * 96, 24) and got.dtype == np.float32
    for i in range(2):
        args = tuple(jnp.asarray(a[i]) for a in (img, lab, scb))
        np.testing.assert_array_equal(
            got[i], np.asarray(jax_table.build_warp_table(*args)))
        np.testing.assert_array_equal(
            got[i], np.asarray(jax_table.build_warp_table_xla(*args)))


def test_table_bf16_equals_jax_bf16():
    img, lab, scb = _planes(1, 2, 64, 96, sentinel=True)
    got = warp_table.build_warp_table_plain(*_t(img, lab, scb),
                                            dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # The cast table of the main path is the same table.
    cast = warp_table.build_warp_table(*_t(img, lab, scb)).to(torch.bfloat16)
    assert torch.equal(got, cast)
    for i in range(2):
        want = jax_table.build_warp_table_xla(
            *(jnp.asarray(a[i]) for a in (img, lab, scb)), dtype=jnp.bfloat16)
        np.testing.assert_array_equal(got[i].float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_table_wrapper_routes_on_cpu():
    """On CPU tensors ``auto`` and ``plain`` give the plain table and count
    no launch; ``kernel`` raises instead of falling back."""
    args = _t(*_planes(2, 2, 16, 24))
    warp_table.reset_launch_counts()
    want = warp_table.build_warp_table_plain(*args)
    assert torch.equal(warp_table.build_warp_table(*args), want)
    assert torch.equal(warp_table.build_warp_table(*args, impl="plain"), want)
    with pytest.raises(ValueError, match="cuda"):
        warp_table.build_warp_table(*args, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        warp_table.build_warp_table(*args, impl="pallas")
    with pytest.raises(TypeError, match="float32"):
        warp_table.build_warp_table(args[0], args[1].long(), args[2])
    with pytest.raises(ValueError, match="must be"):
        warp_table.build_warp_table(args[0], args[1][:, :8], args[2])
    assert warp_table.LAUNCHES == {"warp_table": 0}


# ---------------------------------------------------------------------------
# The warp, from the same coordinates
# ---------------------------------------------------------------------------

def _coords(case, rs, n, h, w, bh, bw):
    """Sample coordinates (n, h, w) for one named case."""
    if case == "integer":
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        return np.tile(yy, (n, 1, 1)), np.tile(xx, (n, 1, 1))
    if case == "out_of_range":
        sy = rs.uniform(-1.5, bh + 1.5, (n, h, w)).astype(np.float32)
        sx = rs.uniform(-1.5, bw + 1.5, (n, h, w)).astype(np.float32)
    else:
        sy = rs.uniform(0, bh - 1, (n, h, w)).astype(np.float32)
        sx = rs.uniform(0, bw - 1, (n, h, w)).astype(np.float32)
    # integer coordinates and coordinates on the bound
    sy[:, 0, :6] = [0.0, bh - 1.0, 0.3, bh - 1.3, 5.0, bh - 1.0]
    sx[:, 0, :6] = [0.0, bw - 1.0, bw - 0.9, 0.2, bw - 1.0, 7.0]
    return sy, sx


WARP_CASES = [
    # name, canvas (h, w), live bound (bh, bw), table dtype
    ("uniform", (48, 48), (48, 48), "f32"),
    ("integer", (32, 32), (32, 32), "f32"),
    ("out_of_range", (24, 24), (20, 22), "f32"),
    ("uniform_rect", (40, 56), (33, 50), "f32"),
    ("uniform_bf16", (48, 48), (48, 48), "bf16"),
    ("out_of_range_bf16", (24, 24), (20, 22), "bf16"),
]


@pytest.mark.parametrize("case,canvas,bound,tdt", WARP_CASES,
                         ids=[c[0] for c in WARP_CASES])
def test_cubic_warp_votes_exact_image_close(case, canvas, bound, tdt):
    """``fused_warp_sample_cubic``: votes equal bit for bit, image within
    1e-5 x max, per-sample live bounds included."""
    n, (h, w), (bh, bw) = 3, canvas, bound
    rs = np.random.RandomState(3)
    img, lab, scb = _planes(4, n, h, w)
    sy, sx = _coords(case.split("_bf16")[0].replace("_rect", ""), rs, n, h, w,
                     bh, bw)
    bhs = np.array([bh, bh - 1, bh], np.float32)
    bws = np.array([bw, bw, bw - 2], np.float32)

    want = jax.vmap(lambda im, la, sc, y, x, b0, b1: jax_warp.fused_warp_sample_cubic(
        im, la, sc, y, x, NUM_VALUES, b0, b1, table_impl="pallas",
        table_dtype=tdt))(*(jnp.asarray(a) for a in
                            (img, lab, scb, sy, sx, bhs, bws)))
    got = warp.fused_warp_sample_cubic(
        *_t(img, lab, scb, sy, sx), NUM_VALUES, *_t(bhs, bws),
        table_dtype=tdt)
    _assert_close(got[0].numpy(), want[0], 1e-5, "image")
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if case == "integer":      # sample 0 has the full bound: the identity
        _assert_close(got[0][0].numpy(), img[0], 1e-5, "identity")
        np.testing.assert_array_equal(got[1][0].numpy(), lab[0].astype(np.int32))


@pytest.mark.parametrize("case,canvas,bound", [c[:3] for c in WARP_CASES[:4]],
                         ids=[c[0] for c in WARP_CASES[:4]])
def test_bilinear_warp_votes_exact_and_equal_to_cubic_votes(case, canvas, bound):
    """``fused_warp_sample``: votes equal to JAX's bit for bit and to the
    cubic variant's votes (only the image kernel differs); image 1e-5 x max."""
    n, (h, w), (bh, bw) = 2, canvas, bound
    rs = np.random.RandomState(5)
    img, lab, scb = _planes(6, n, h, w)
    sy, sx = _coords(case.replace("_rect", ""), rs, n, h, w, bh, bw)
    bhs = np.array([bh, bh - 1], np.float32)
    bws = np.array([bw - 1, bw], np.float32)
    want = jax.vmap(lambda im, la, sc, y, x, b0, b1: jax_warp.fused_warp_sample(
        im, la, sc, y, x, NUM_VALUES, b0, b1))(
            *(jnp.asarray(a) for a in (img, lab, scb, sy, sx, bhs, bws)))
    args = _t(img, lab, scb, sy, sx) + (NUM_VALUES,) + _t(bhs, bws)
    got = warp.fused_warp_sample(*args)
    cubic = warp.fused_warp_sample_cubic(*args)
    _assert_close(got[0].numpy(), want[0], 1e-5, "image")
    for k in (1, 2):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert torch.equal(got[k], cubic[k])


def test_warp_rejects_unknown_table_dtype():
    args = _t(*_planes(7, 1, 8, 8))
    sy = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError, match="table_dtype"):
        warp.fused_warp_sample_cubic(*args, sy, sy, NUM_VALUES, 8, 8,
                                     table_dtype="f16")


@pytest.mark.parametrize("bounded", [False, True], ids=["full", "live_bound"])
def test_bilinear_sample(bounded):
    """1e-5 x max, with the array's own size and with a per-sample bound."""
    n, h, w = 3, 20, 28
    rs = np.random.RandomState(8)
    src = rs.randn(n, h, w).astype(np.float32)
    sy = rs.uniform(-2, h + 2, (n, 16, 16)).astype(np.float32)
    sx = rs.uniform(-2, w + 2, (n, 16, 16)).astype(np.float32)
    if bounded:
        bhs = np.array([h, h - 3, h - 1], np.float32)
        bws = np.array([w - 2, w, w - 5], np.float32)
        want = jax.vmap(jax_warp.bilinear_sample)(
            *(jnp.asarray(a) for a in (src, sy, sx, bhs, bws)))
        got = warp.bilinear_sample(*_t(src, sy, sx, bhs, bws))
    else:
        want = jax.vmap(jax_warp.bilinear_sample)(
            *(jnp.asarray(a) for a in (src, sy, sx)))
        got = warp.bilinear_sample(*_t(src, sy, sx))
    _assert_close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("radius,shape", [(6, (40, 56)), (7, (32, 32)),
                                          (3, (4, 9))],
                         ids=["r6", "r7", "r3_small"])
def test_separable_gaussian_blur_per_sample_sigma(radius, shape):
    """Several sigmas in one batch, 1e-5 x max; also a scalar sigma."""
    sigmas = np.array([0.4, 1.0, 1.5, 2.3], np.float32)
    rs = np.random.RandomState(9)
    img = rs.randn(len(sigmas), *shape).astype(np.float32)
    want = jax.vmap(lambda im, s: jax_warp.separable_gaussian_blur(im, s, radius))(
        jnp.asarray(img), jnp.asarray(sigmas))
    got = warp.separable_gaussian_blur(*_t(img, sigmas), radius)
    _assert_close(got.numpy(), want, 1e-5)
    one = warp.separable_gaussian_blur(_t(img)[0], 1.5, radius)
    _assert_close(one[2].numpy(), np.asarray(want)[2], 1e-5)


@pytest.mark.parametrize("out,ds", [((64, 64), 8), ((48, 80), 8), ((8, 8), 8)],
                         ids=["64x64", "48x80", "clamped_radius"])
def test_make_elastic_field_from_the_same_noise(out, ds):
    """The port's field from the noise the JAX key gives: 1e-4 x max.  The
    8x8 case has a 2x2 coarse field, so the blur radius clamps to 1."""
    out_h, out_w = out
    sigmas = np.array([9.0, 11.5, 13.0], np.float32)
    alphas = np.array([200.0, 35.0, 120.0], np.float32)
    fh, fw = engine.elastic_field_shape(out_h, out_w, ds)
    keys = jax.random.split(jax.random.PRNGKey(10), len(sigmas))
    noise = np.stack([np.asarray(jax.random.uniform(k, (fh, fw))) for k in keys])
    want = np.stack([np.asarray(jax_engine.make_elastic_field(
        k, out_h, out_w, jnp.float32(s), jnp.float32(a), ds, 7))
        for k, s, a in zip(keys, sigmas, alphas)])
    got = engine.make_elastic_field(*_t(noise)[:1], out_h, out_w,
                                    *_t(sigmas, alphas), ds, 7)
    assert tuple(got.shape) == (3, out_h, out_w)
    _assert_close(got.numpy(), want, 1e-4)


def test_elastic_amplitude_correction():
    sigmas = np.array([9.0, 10.3, 11.0, 13.0, 15.5], np.float32)
    for ds, radius in ((8, 7), (8, 1), (4, 12)):
        want = np.array([float(jax_engine.elastic_amplitude_correction(
            jnp.float32(s), ds, radius)) for s in sigmas])
        got = engine.elastic_amplitude_correction(_t(sigmas)[0], ds, radius)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
