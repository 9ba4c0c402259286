"""The row partition that ``bn_sums_plan`` gives ``bn_sums``
(``pacingpseudo_torch/ops/fused_convbn.py``), checked on the CPU.

The plan is pure Python and the C entry of ``csrc/fused_convbn.cu``
refuses any other, so its rules are held here: at every fused layer of the
full-width train step (bf16, N = 24) and at ragged and float32 shapes, the
blocks' whole rows times their pixel lanes visit every pixel exactly once,
the channel chunks cover every channel exactly once, the launch writes and
adds ``grid_x`` partial rows, the grid is one wave of two blocks an SM, the
last block's columns fit its threads, and the vector width is 16 bytes
where Co allows it and 1 elsewhere.  A Python copy of the kernel's pointer
walk (no division per pixel) checks that its offset into the padded
cotangent lands on the centre pixel the plain version reads.  The kernel
itself runs only on the card (``chip_smoke.py``).
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
SMS = 132


def _step_layers():
    """``[(name, n, co, h, w)]`` of the step's fused layers, from
    ``scripts/reckon_fused_conv_bounds.py::conv_layer_shapes`` on the
    ``meta`` device."""
    spec = importlib.util.spec_from_file_location(
        "reckon_fused_conv_bounds", ROOT / "scripts" / "reckon_fused_conv_bounds.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    config = ExperimentConfig(
        session="Experiment", do_loss_ent=True, do_decoder_consistency=True,
        do_aux_path=True, do_memory=True).validate()
    return [(name.split("backbone.")[-1], n, co, h, w)
            for name, n, ci, co, h, w, fused, _ in module.conv_layer_shapes(config)
            if fused]


STEP = _step_layers()
# (dtype, n, co, h, w): ragged channel counts, float32, narrow and tall
# canvases, fewer rows than blocks, one row, pixel lanes wider than a row.
EXTRA = [
    (torch.bfloat16, 3, 20, 32, 40), (torch.float32, 3, 20, 32, 40),
    (torch.bfloat16, 2, 13, 32, 24), (torch.float32, 2, 13, 32, 24),
    (torch.float32, 24, 512, 32, 32), (torch.float32, 24, 32, 256, 256),
    (torch.bfloat16, 1, 8, 1, 5), (torch.bfloat16, 2, 1024, 7, 3),
    (torch.float32, 5, 6, 9, 300), (torch.bfloat16, 4, 40, 3, 2),
]


def _check_plan(dtype, n, co, h, w):
    plan = fc.bn_sums_plan(dtype, n, h, w, co, SMS)
    full = 8 if dtype == torch.bfloat16 else 4
    assert plan.vec == (full if co % full == 0 else 1)
    vectors = co // plan.vec
    assert plan.bx * plan.by <= fc.BN_SUMS_THREADS and plan.by == fc.BN_SUMS_THREADS // plan.bx
    assert plan.bx <= fc.BN_SUMS_VECTORS
    # The last block of a chunk adds 2 x its channels as columns: one or more
    # threads a column.
    assert 2 * plan.bx * plan.vec <= plan.bx * plan.by
    assert plan.grid_y <= fc.BN_SUMS_COUNTERS
    # Channels: chunk y holds vectors [y*bx, (y+1)*bx); each channel once.
    chan = np.zeros(co, np.int64)
    for y in range(plan.grid_y):
        for x in range(plan.bx):
            cv = y * plan.bx + x
            if (cv + 1) * plan.vec <= co:
                chan[cv * plan.vec:(cv + 1) * plan.vec] += 1
    assert (chan == 1).all()
    # Rows: block b takes rows [b*rpb, min((b+1)*rpb, n*h)), no block empty;
    # the launch writes and adds one partial row per block.
    rows = n * h
    assert (plan.grid_x - 1) * plan.rows_per_block < rows <= plan.grid_x * plan.rows_per_block
    assert plan.grid_x * plan.grid_y <= fc.BN_SUMS_BLOCKS_PER_SM * SMS
    # Pixels: lane ty of block b visits start + ty, start + ty + by, ...
    visits = []
    for b in range(plan.grid_x):
        start = b * plan.rows_per_block * w
        end = min((b + 1) * plan.rows_per_block, rows) * w
        visits += [np.arange(start + ty, end, plan.by) for ty in range(plan.by)]
    count = np.bincount(np.concatenate(visits), minlength=rows * w)
    assert count.shape == (rows * w,) and (count == 1).all()
    return plan


@pytest.mark.parametrize("layer", STEP, ids=[s[0] for s in STEP])
def test_step_layers_covered_once(layer):
    """bf16 at the step's 18 fused layers: 16-byte vectors, one wave."""
    _, n, co, h, w = layer
    plan = _check_plan(torch.bfloat16, n, co, h, w)
    assert plan.vec == 8 and n == 24
    assert plan.grid_x * plan.grid_y > fc.BN_SUMS_BLOCKS_PER_SM * SMS // 2


def test_the_step_has_eighteen_fused_layers():
    assert len(STEP) == 18


@pytest.mark.parametrize("shape", EXTRA, ids=[f"{str(s[0])[6:]}-{s[1]}x{s[2]}@{s[3]}x{s[4]}"
                                              for s in EXTRA])
def test_ragged_and_float32_shapes_covered_once(shape):
    _check_plan(*shape)


@pytest.mark.parametrize("dtype,co,vec", [
    (torch.bfloat16, 32, 8), (torch.bfloat16, 512, 8), (torch.bfloat16, 20, 1),
    (torch.bfloat16, 13, 1), (torch.float32, 32, 4), (torch.float32, 20, 4),
    (torch.float32, 13, 1), (torch.float32, 6, 1),
])
def test_vector_width(dtype, co, vec):
    assert fc.bn_sums_plan(dtype, 2, 8, 8, co, SMS).vec == vec


def test_plan_scales_with_the_card():
    """Fewer SMs, fewer blocks; the partial rows follow the grid."""
    small = fc.bn_sums_plan(torch.bfloat16, 24, 256, 256, 32, 16)
    big = fc.bn_sums_plan(torch.bfloat16, 24, 256, 256, 32, SMS)
    assert small.grid_x <= 2 * 16 < big.grid_x
    assert small.grid_x * small.rows_per_block >= 24 * 256


def _walk(plan, n, h, w, block, lane):
    """The kernel's walk for one thread: ``(p, q)`` pairs, p the pixel of y
    and q the same pixel of the padded cotangent, by increments only (one
    division at the start, as the kernel does)."""
    rows = n * h
    r0 = block * plan.rows_per_block
    p_end = min(r0 + plan.rows_per_block, rows) * w
    p = r0 * w + lane
    img, oh, ow = p // (h * w), (p // w) % h, p % w
    q = p + img * (2 * h + 2 * w + 4) + 2 * oh + w + 3
    out = []
    while p < p_end:
        out.append((p, q))
        p += plan.by
        q += plan.by
        ow += plan.by
        while ow >= w:
            ow -= w
            q += 2
            oh += 1
            if oh == h:
                oh = 0
                q += 2 * (w + 2)
    return out


@pytest.mark.parametrize("shape", [(torch.bfloat16, 2, 32, 5, 3), (torch.float32, 3, 8, 4, 7),
                                   (torch.bfloat16, 2, 16, 6, 40), (torch.float32, 1, 4, 2, 1)],
                         ids=["narrow", "small", "wide", "one_column"])
def test_kernel_walk_reads_the_centre_of_the_padded_cotangent(shape):
    """Every (p, q) of every thread: q is pixel p's centre in the padded
    (n, h+2, w+2) canvas, which is what ``bn_sums_plain`` reads."""
    dtype, n, co, h, w = shape
    plan = fc.bn_sums_plan(dtype, n, h, w, co, SMS)
    seen = []
    for block in range(plan.grid_x):
        for lane in range(plan.by):
            for p, q in _walk(plan, n, h, w, block, lane):
                img, rem = divmod(p, h * w)
                oh, ow = divmod(rem, w)
                assert q == (img * (h + 2) + oh + 1) * (w + 2) + ow + 1
                seen.append(p)
    assert sorted(seen) == list(range(n * h * w))
