"""The routes and tiles that ``conv_plan`` picks for the fused ConvLayer's
two GEMMs (``pacingpseudo_torch/ops/fused_convbn.py``).

The plan is pure Python and is what the CUDA entry point validates, so its
rules are checked here on the CPU: every fused layer of the full-width
train step takes the ``"wgmma"`` route for both kernels except
``conv_stats`` at ``enc_block1`` layer 1 (Ci = 1); the rectangles of the
M tiles cover every centre pixel of every image exactly once (and, for
``conv_pad_out``, the border that ``csrc/conv_wgmma.cu`` assigns to the
edge tiles covers the rest of the padded canvas exactly once); the N and K
tiles divide their dimensions; the partial rows are the M tiles; float32,
Ci = 1 and shapes the rectangles do not tile take ``"simple"``.  The
kernels themselves run only on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from pacingpseudo_torch.config import ExperimentConfig
from pacingpseudo_torch.ops import fused_convbn as fc

ROOT = pathlib.Path(__file__).resolve().parent.parent
BN_CHOICES = (32, 64, 96, 128, 256)

# The fused ConvLayers of the full-width Experiment step (all but the
# dilated enc_block5 / enc_block6 layers).
FUSED = [f"backbone.{b}.conv_block.conv_layer{i}"
         for b in ("enc_block1", "enc_block2", "enc_block3", "enc_block4",
                   "dec_block5", "dec_block4", "dec_block3", "dec_block2",
                   "dec_block1")
         for i in (1, 2)]
FIRST = "backbone.enc_block1.conv_block.conv_layer1"

# (n, h, w, cin, cout): the check shapes of chip_smoke.py and a few more.
SHAPES = [
    (24, 256, 256, 32, 32), (24, 128, 128, 32, 64), (24, 128, 128, 64, 64),
    (24, 128, 128, 192, 64), (24, 64, 64, 128, 128), (24, 32, 32, 768, 256),
    (24, 32, 32, 1024, 512), (3, 64, 64, 96, 384), (2, 32, 256, 64, 160),
]


@pytest.fixture(scope="module")
def step_layers():
    """``{name: (n, ci, co, h, w, needs_dx)}`` of the fused layers, from
    ``scripts/reckon_fused_conv_bounds.py::conv_layer_shapes`` on the
    ``meta`` device."""
    spec = importlib.util.spec_from_file_location(
        "reckon_fused_conv_bounds", ROOT / "scripts" / "reckon_fused_conv_bounds.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    config = ExperimentConfig(
        session="Experiment", do_loss_ent=True, do_decoder_consistency=True,
        do_aux_path=True, do_memory=True).validate()
    return {name: (n, ci, co, h, w, dx)
            for name, n, ci, co, h, w, fused, dx in module.conv_layer_shapes(config)
            if fused}


def _plans(n, ci, co, h, w):
    """The plans of conv_stats (N = Co, K channels Ci) and conv_pad_out
    (N = Ci, K channels Co) of one layer."""
    return {"conv_stats": fc.conv_plan(torch.bfloat16, n, h, w, ci, co, False),
            "conv_pad_out": fc.conv_plan(torch.bfloat16, n, h, w, co, ci, True)}


def _paint(plan, n, h, w, pad_out):
    """How often each pixel of the output is written by the plan's tiles,
    tile m at image m // tiles_img, rectangle (rem // tiles_w, rem % tiles_w)
    as the kernel walks them; the border of conv_pad_out as the kernel
    assigns it to the edge tiles."""
    hp, wp, off = (h + 2, w + 2, 1) if pad_out else (h, w, 0)
    count = np.zeros((n, hp, wp), np.int64)
    tiles_w = w // plan.box_w
    tiles_img = tiles_w * (h // plan.box_h)
    for m in range(plan.rows):
        img, rem = divmod(m, tiles_img)
        h0, w0 = (rem // tiles_w) * plan.box_h, (rem % tiles_w) * plan.box_w
        count[img, h0 + off:h0 + off + plan.box_h, w0 + off:w0 + off + plan.box_w] += 1
        if not pad_out:
            continue
        first_w, last_w = w0 == 0, w0 + plan.box_w == w
        wlo, whi = (0 if first_w else w0 + 1), (w + 1 if last_w else w0 + plan.box_w)
        if h0 == 0:
            count[img, 0, wlo:whi + 1] += 1
        if h0 + plan.box_h == h:
            count[img, h + 1, wlo:whi + 1] += 1
        if first_w:
            count[img, h0 + 1:h0 + 1 + plan.box_h, 0] += 1
        if last_w:
            count[img, h0 + 1:h0 + 1 + plan.box_h, w + 1] += 1
    return count


def test_step_has_the_gated_layers(step_layers):
    assert list(step_layers) == FUSED
    assert [k for k, v in step_layers.items() if not v[5]] == [FIRST]


@pytest.mark.parametrize("kernel", ["conv_stats", "conv_pad_out"])
@pytest.mark.parametrize("layer", FUSED)
def test_step_layer_routes(step_layers, layer, kernel):
    n, ci, co, h, w, needs_dx = step_layers[layer]
    plan = _plans(n, ci, co, h, w)[kernel]
    if layer == FIRST:
        # Ci = 1: the simple kernel (which beats the library there); its dx
        # is never launched (the input is the image).
        assert plan.route == "simple"
        assert kernel == "conv_stats" or not needs_dx
    else:
        assert plan.route == "wgmma", plan


def test_step_route_counts(step_layers):
    """Per fused step: conv_stats 17 wgmma + 1 simple, conv_pad_out 17 wgmma."""
    counts = {k: {"wgmma": 0, "simple": 0} for k in ("conv_stats", "conv_pad_out")}
    for n, ci, co, h, w, needs_dx in step_layers.values():
        plans = _plans(n, ci, co, h, w)
        counts["conv_stats"][plans["conv_stats"].route] += 1
        if needs_dx:
            counts["conv_pad_out"][plans["conv_pad_out"].route] += 1
    assert counts == {"conv_stats": {"wgmma": 17, "simple": 1},
                      "conv_pad_out": {"wgmma": 17, "simple": 0}}


@pytest.mark.parametrize("pad_out", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_tiles_cover_every_pixel_once(shape, pad_out):
    n, h, w, cin, cout = shape
    plan = fc.conv_plan(torch.bfloat16, n, h, w, cin, cout, pad_out)
    assert plan.route == "wgmma"
    count = _paint(plan, n, h, w, pad_out)
    assert count.min() == 1 and count.max() == 1


@pytest.mark.parametrize("pad_out", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_tile_shapes(shape, pad_out):
    n, h, w, cin, cout = shape
    plan = fc.conv_plan(torch.bfloat16, n, h, w, cin, cout, pad_out)
    assert plan.box_w * plan.box_h == fc.WGMMA_TILE_M
    assert plan.rows == n * (h // plan.box_h) * (w // plan.box_w)
    assert plan.bn in BN_CHOICES and cout % plan.bn == 0
    assert plan.bn == cout or cout > 256 or cout not in BN_CHOICES
    assert plan.bk in (32, 64) and cin % plan.bk == 0
    lo, hi = fc.WGMMA_STAGES
    assert lo <= plan.stages <= hi
    # Ring, bf16 output tile, statistics rows, barriers, alignment.
    per_sm = 2 if plan.bn <= 96 else 1
    smem = fc.WGMMA_SMEM if per_sm == 1 else fc.WGMMA_SMEM_TWO_BLOCKS
    stage = (fc.WGMMA_TILE_M + plan.bn) * plan.bk * 2
    red = 0 if pad_out else 64 * plan.bn
    used = plan.stages * stage + 2 * fc.WGMMA_TILE_M * plan.bn + red + 16 * plan.stages + 1024
    assert used <= smem
    if plan.bk == 32 and cin % 64 == 0:
        # 64-channel K tiles would not leave room for the fewest stages.
        stage64 = (fc.WGMMA_TILE_M + plan.bn) * 128
        assert used - plan.stages * (stage + 16) + lo * (stage64 + 16) > smem
    # A persistent grid: every block has a tile, at most per_sm blocks an SM.
    tiles = plan.rows * (cout // plan.bn)
    assert plan.grid == min(tiles, per_sm * 132)


@pytest.mark.parametrize("args", [
    (torch.float32, 24, 256, 256, 32, 32, False),     # float32
    (torch.float32, 24, 32, 32, 1024, 512, True),
    (torch.bfloat16, 3, 32, 40, 12, 20, False),       # chip_smoke's ragged shape
    (torch.bfloat16, 3, 32, 40, 32, 32, True),        # W = 40 is not tiled by 128-pixel rectangles
    (torch.bfloat16, 24, 256, 256, 1, 32, False),     # Ci = 1
    (torch.bfloat16, 2, 30, 32, 32, 32, False),       # 4-row rectangles do not tile H = 30
], ids=["f32", "f32-pad", "ragged", "w40-pad", "ci1", "h30"])
def test_simple_route(args):
    dtype, n, h, w, cin, cout, pad_out = args
    plan = fc.conv_plan(*args)
    assert plan.route == "simple"
    pixels = n * (h + 2) * (w + 2) if pad_out else n * h * w
    assert plan.rows == -(-pixels // fc.SIMPLE_TILE_M)


def test_cpu_wrappers_count_no_route():
    """On CPU tensors the wrappers run the plain versions: no launch and no
    route is counted."""
    rs = np.random.RandomState(0)
    xp = torch.from_numpy(rs.randn(1, 34, 34, 32).astype(np.float32)).bfloat16()
    w9 = torch.from_numpy(rs.randn(9, 32, 32).astype(np.float32) / 17).bfloat16()
    fc.reset_launch_counts()
    y, _ = fc.conv_stats(xp, w9, torch.zeros(32))
    fc.conv_pad_out(xp, w9)
    assert y.shape == (1, 32, 32, 32)
    assert not any(fc.LAUNCHES.values())
    assert all(v == 0 for counts in fc.ROUTES.values() for v in counts.values())
