"""The direct-read cubic warp (``pacingpseudo_torch/ops/warp_cubic.py``)
against the port's table route and against
``pacingpseudo_tpu/ops/warp.py::fused_warp_sample_cubic`` (CPU, float32).

On the CPU ``warp_sample_cubic`` runs its plain version, which reads the 24
taps of each output pixel straight from the planes at the table's wrapped
indices and repeats the table route's arithmetic; the CUDA kernel
(``csrc/warp_cubic.cu``) is held against that plain version, and against
the table route, on the card by ``chip_smoke.py``.

Tolerances: against the port's table route (``table_impl="plain"``) the
image and both class maps are equal bit for bit: the same taps go through
the same operations in the same order.  Against JAX (the Pallas table in
interpret mode, mapped over the batch) the class votes are equal bit for
bit and the image is held within 1e-5 x max, the tolerance of
``tests/test_torch_port_warp.py``: differently ordered float32 sums of 16
cubic taps.

The inputs are numpy-made planes and coordinates at N = 2 on 40 x 48
canvases, with the edge cases of the anchor and the vote: fractions of
exactly 0, the anchor on the last live row and column (``y0 + 1 ==
bound``), live regions smaller than the canvas, outputs smaller than the
canvas, coordinates outside the live region, the sentinel 255 and ties
(two classes at 0.25 + 0.25 each, which the lower class wins).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacingpseudo_tpu.ops import warp as jax_warp
from pacingpseudo_torch.aug import engine
from pacingpseudo_torch.aug.params import BaseAugParams, StrongAugParams
from pacingpseudo_torch.ops import warp, warp_cubic, warp_table

NUM_VALUES = 6
N, H, W = 2, 40, 48


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _case(name, seed=0):
    """``(img, lab, scb, sy, sx, bound_h, bound_w)`` as numpy for one case."""
    rs = np.random.RandomState(seed)
    img = rs.randn(N, H, W).astype(np.float32)
    lab = rs.randint(0, NUM_VALUES, (N, H, W)).astype(np.float32)
    scb = rs.randint(0, NUM_VALUES, (N, H, W)).astype(np.float32)
    bh = np.array([H, H - 6], np.float32)
    bw = np.array([W - 9, W], np.float32)
    h, w = (32, 36) if name == "crop_smaller" else (H, W)
    lo_y, hi_y = (-1.5, H + 1.5) if name == "out_of_range" else (0.0, H - 6 - 1.0)
    lo_x, hi_x = (-1.5, W + 1.5) if name == "out_of_range" else (0.0, W - 9 - 1.0)
    sy = rs.uniform(lo_y, hi_y, (N, h, w)).astype(np.float32)
    sx = rs.uniform(lo_x, hi_x, (N, h, w)).astype(np.float32)
    cols = np.arange(w, dtype=np.float32)
    if name == "integer":
        sy[:] = np.floor(sy)
        sx[:] = np.floor(sx)
    if name == "last_live":
        # On and past the last live row and column: clamped to bound - 1,
        # so y0 + 1 == bound and the fraction is 0.
        sy[:, :4] = (bh - 1.0)[:, None, None] + np.array([0.0, 0.5, 3.0, 0.25],
                                                         np.float32)[:, None]
        sx[:, 4:8] = np.minimum(cols, bw[:, None] - 1.0)[:, None, :] + 0.5
    if name == "ties":
        checker = (np.arange(10)[:, None] + np.arange(20)) % 2
        lab[:, 5:15, 5:25] = 1.0 + 2.0 * checker
        scb[:, 5:15, 5:25] = 3.0 - 2.0 * checker
        sy[:, :3] = np.array([7.5, 8.5, 10.5], np.float32)[:, None]
        sx[:, :3] = 8.5 + (cols % 10)
    if name == "sentinel":
        lab[:, -4:] = 255.0
        scb[:, :, -6:] = NUM_VALUES - 1
    return img, lab, scb, sy, sx, bh, bw


CASES = ["uniform", "out_of_range", "integer", "last_live", "ties", "sentinel",
         "crop_smaller"]


@pytest.mark.parametrize("name", CASES)
def test_plain_equals_the_table_route_bit_for_bit(name):
    """Image and class maps equal to ``fused_warp_sample_cubic`` on the
    table (its plain version), and the direct route of that function is
    this plain version on CPU tensors."""
    img, lab, scb, sy, sx, bh, bw = _t(*_case(name))
    got = warp_cubic.warp_sample_cubic_plain(img, lab, scb, sy, sx, NUM_VALUES, bh, bw)
    table = warp.fused_warp_sample_cubic(img, lab, scb, sy, sx, NUM_VALUES, bh, bw,
                                         table_impl="plain")
    direct = warp.fused_warp_sample_cubic(img, lab, scb, sy, sx, NUM_VALUES, bh, bw,
                                          table_impl="direct")
    assert got[0].dtype == torch.float32 and got[0].shape == sy.shape
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32
    for k in range(3):
        assert torch.equal(got[k], table[k]), k
        assert torch.equal(got[k], direct[k]), k
    if name == "ties":      # 0.5 / 0.5 between classes 1 and 3: the lower wins
        assert bool((got[1][:, :3] == 1).all()) and bool((got[2][:, :3] == 1).all())
    if name == "integer":   # f == 0 everywhere: each pixel is its anchor's value
        y0 = np.minimum(np.maximum(sy.numpy(), 0), bh.numpy()[:, None, None] - 1)
        x0 = np.minimum(np.maximum(sx.numpy(), 0), bw.numpy()[:, None, None] - 1)
        idx = (np.arange(N)[:, None, None], y0.astype(int), x0.astype(int))
        np.testing.assert_array_equal(got[1].numpy(), lab.numpy()[idx].astype(np.int32))


@pytest.mark.parametrize("name", CASES)
def test_plain_against_jax(name):
    """Votes equal to JAX's bit for bit, image within 1e-5 x max."""
    img, lab, scb, sy, sx, bh, bw = case = _case(name)
    want = jax.vmap(lambda im, la, sc, y, x, b0, b1: jax_warp.fused_warp_sample_cubic(
        im, la, sc, y, x, NUM_VALUES, b0, b1, table_impl="pallas"))(
            *(jnp.asarray(a) for a in case))
    got = warp_cubic.warp_sample_cubic_plain(*_t(img, lab, scb, sy, sx), NUM_VALUES,
                                             *_t(bh, bw))
    err = np.abs(got[0].numpy().astype(np.float64) - np.asarray(want[0])).max()
    assert err <= 1e-5 * np.abs(np.asarray(want[0])).max(), err
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("bound", ["numbers", "tensors"])
def test_wrapper_on_cpu_runs_the_plain_version(bound):
    """On CPU tensors the wrapper is the plain version and counts no
    launch; per-sample bounds may be numbers or (N,) tensors."""
    img, lab, scb, sy, sx, bh, bw = _t(*_case("uniform", seed=1))
    bounds = (H - 6, W - 9) if bound == "numbers" else (bh, bw)
    warp_cubic.reset_launch_counts()
    got = warp_cubic.warp_sample_cubic(img, lab, scb, sy, sx, NUM_VALUES, *bounds)
    want = warp_cubic.warp_sample_cubic_plain(img, lab, scb, sy, sx, NUM_VALUES, *bounds)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert warp_cubic.LAUNCHES == {"warp_cubic": 0}


def test_wrapper_rejects_bad_inputs():
    img, lab, scb, sy, sx, bh, bw = _t(*_case("uniform", seed=2))
    with pytest.raises(TypeError, match="float32"):
        warp_cubic.warp_sample_cubic(img, lab.long(), scb, sy, sx, NUM_VALUES, bh, bw)
    with pytest.raises(ValueError, match="must be"):
        warp_cubic.warp_sample_cubic(img, lab[:, :8], scb, sy, sx, NUM_VALUES, bh, bw)
    with pytest.raises(ValueError, match="must be"):
        warp_cubic.warp_sample_cubic(img, lab, scb, sy, sx[:, :5], NUM_VALUES, bh, bw)
    with pytest.raises(ValueError, match="mismatched"):
        warp_cubic.warp_sample_cubic(img, lab, scb, sy[:1], sx[:1], NUM_VALUES, bh, bw)


@pytest.mark.parametrize("impl", ["auto", "direct", "kernel", "plain"])
def test_routes_on_cpu_tensors(impl):
    """``auto`` and ``plain`` take the plain table, ``direct`` the plain
    direct warp, all with the same numbers and no launch counted;
    ``kernel`` raises on CPU tensors instead of falling back."""
    args = _t(*_case("out_of_range", seed=3))
    img, lab, scb, sy, sx, bh, bw = args
    want = warp_cubic.warp_sample_cubic_plain(img, lab, scb, sy, sx, NUM_VALUES, bh, bw)
    warp_cubic.reset_launch_counts()
    warp_table.reset_launch_counts()
    call = lambda: warp.fused_warp_sample_cubic(img, lab, scb, sy, sx, NUM_VALUES, bh, bw,
                                                table_impl=impl)
    if impl == "kernel":
        with pytest.raises(ValueError, match="cuda"):
            call()
    else:
        for g, w in zip(call(), want):
            assert torch.equal(g, w)
    assert warp_cubic.LAUNCHES == {"warp_cubic": 0}
    assert warp_table.LAUNCHES == {"warp_table": 0}


def test_routes_refuse_what_they_cannot_do():
    """An unknown route raises; the direct route has no bf16 table; ``auto``
    with a bf16 table stays on the table route (on CPU tensors, its plain
    version) and rounds only the image taps."""
    img, lab, scb, sy, sx, bh, bw = _t(*_case("uniform", seed=4))
    args = (img, lab, scb, sy, sx, NUM_VALUES, bh, bw)
    with pytest.raises(ValueError, match="table_impl"):
        warp.fused_warp_sample_cubic(*args, table_impl="pallas")
    with pytest.raises(ValueError, match="float32"):
        warp.fused_warp_sample_cubic(*args, table_impl="direct", table_dtype="bf16")
    bf16 = warp.fused_warp_sample_cubic(*args, table_impl="auto", table_dtype="bf16")
    want = warp.fused_warp_sample_cubic(*args, table_impl="plain", table_dtype="bf16")
    for g, w in zip(bf16, want):
        assert torch.equal(g, w)
    assert warp.AUTO_CUDA_ROUTE in ("direct", "kernel")


def _raw(seed, sizes, canvas):
    """A raw canvas batch: smooth image, blocky labels, sparse scribbles,
    padded with 0 / the ignored index beyond each live size."""
    rs = np.random.RandomState(seed)
    c = 5
    yy, xx = np.mgrid[0:canvas, 0:canvas]
    n = len(sizes)
    image = np.zeros((n, canvas, canvas), np.float32)
    label = np.full((n, canvas, canvas), c, np.float32)
    scribble = np.full((n, canvas, canvas), c, np.float32)
    for i, (h, w) in enumerate(sizes):
        img = np.sin(yy / rs.uniform(3, 9)) * np.cos(xx / rs.uniform(3, 9))
        lab = ((yy // 7 + xx // 9 + i) % c).astype(np.float32)
        image[i, :h, :w] = img[:h, :w] + 0.3 * rs.randn(h, w)
        label[i, :h, :w] = lab[:h, :w]
        scribble[i, :h, :w] = np.where(rs.rand(h, w) < 0.2, lab[:h, :w], c)
    return {k: torch.from_numpy(v) for k, v in (
        ("image", image), ("label", label), ("scribble", scribble),
        ("size", np.asarray(sizes, np.int32)))}


@pytest.mark.parametrize("sizes", [((48, 48), (48, 48)), ((40, 33), (29, 48))],
                         ids=["full", "live_regions"])
def test_augment_batch_direct_equals_plain(sizes):
    """``augment_batch`` under ``warp_table_impl="direct"`` equals the same
    call under ``"plain"`` and ``"auto"``, output for output (every scale,
    elastic and rotation gate on, so every sample warps)."""
    raw = _raw(5, sizes, 48)
    base = BaseAugParams(crop_size=(48, 48), p_scale=1.0, p_elastic=1.0, p_rotate=1.0,
                         elastic_blur_radius=3)
    outs = {}
    for impl in ("direct", "plain", "auto"):
        gen = torch.Generator().manual_seed(7)
        outs[impl] = engine.augment_batch(raw, gen, dataclasses.replace(
            base, warp_table_impl=impl), StrongAugParams(), True)
    for impl in ("plain", "auto"):
        assert sorted(outs[impl]) == sorted(outs["direct"])
        for k, v in outs["direct"].items():
            assert torch.equal(v, outs[impl][k]), (impl, k)
