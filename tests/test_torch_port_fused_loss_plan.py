"""The partition that ``fused_loss_plan`` gives ``fused_loss_fwd``
(``pacingpseudo_torch/ops/fused_loss.py``), checked on the CPU.

The plan is pure Python and the C entry of ``csrc/fused_loss.cu`` refuses
any plan that does not cover each image exactly, so its rules are held
here, at the train step's shape (12 x 5 x 256², weak and strong as the
halves of one tensor), a rank's block of the data-parallel and
height-sharded steps (unequal heights included), the other datasets' crops, odd widths, one image
and images of one pixel: the blocks' runs of pixels cover every pixel of
every image exactly once; a Python copy of the kernel's walk (thread t
takes the groups t, t + 256, ... of its block's run, FWD_UNROLL of them
a pass) visits every group exactly once and stays inside the run; the
16-byte route is picked exactly where hw % 4 == 0 and the planes are
aligned, and its runs start on a 16-byte boundary; a block has at least
one full pass of work unless the image is smaller; the grid is one wave of
FWD_BLOCKS_PER_SM blocks an SM (plus at most one block an image).  The
kernel itself runs only on the card (``chip_smoke.py``).  Exact integer
checks: no tolerance.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pacingpseudo_torch.ops import fused_loss as fl

THREADS = 256   # kThreads in the source

# (n, c, h, w, aligned, sm_count)
SHAPES = [
    (12, 5, 256, 256, True, 132),     # the CHAOS step
    (24, 5, 256, 256, True, 132),
    (6, 5, 256, 256, True, 132),      # a rank's rows of the step on 2 ranks
    (12, 5, 128, 256, True, 132),     # a rank's block on 2 space ranks
    (12, 5, 88, 256, True, 132),      # the uneven split on 3: 88, 88, 80 rows
    (12, 5, 80, 256, True, 132),
    (12, 5, 56, 256, True, 132),      # on 5 (JAX's AUTO split of 5 devices): 56 ...
    (12, 5, 48, 256, True, 132),      # ... and 48 rows
    (6, 5, 128, 256, True, 132),      # data 2 x space 2
    (12, 4, 224, 224, True, 132),     # ACDC
    (12, 2, 224, 224, True, 132),     # LVSC
    (6, 2, 224, 224, True, 132),      # a rank's rows of LVSC's step on 2 ranks
    (12, 5, 256, 256, True, 114),     # a card with fewer SMs
    (12, 5, 256, 256, False, 132),    # planes off 16-byte alignment
    (12, 5, 255, 255, True, 132),     # hw % 4 != 0
    (4, 3, 17, 33, True, 132),        # odd widths
    (2, 5, 64, 63, True, 132),        # hw % 4 == 0 with an odd width
    (3, 4, 64, 64, True, 132),
    (1, 5, 256, 256, True, 132),      # one image
    (1, 5, 16, 16, True, 132),        # one block
    (1, 3, 3, 5, True, 132),          # one block, scalar
    (300, 5, 64, 64, True, 132),      # more images than blocks an SM allows
    (5, 2, 1, 1, True, 132),          # one pixel an image
    (7, 5, 2, 2, True, 132),
]


def _ids(shape):
    n, c, h, w, aligned, sms = shape
    return f"{n}x{c}x{h}x{w}" + ("" if aligned else "-unaligned") + f"-sm{sms}"


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plan_covers_every_pixel_once(shape):
    n, c, h, w, aligned, sms = shape
    hw = h * w
    plan = fl.fused_loss_plan(n, c, h, w, sms, aligned)
    assert plan.vec == (4 if aligned and hw % 4 == 0 else 1)
    assert plan.grid_y == n
    assert plan.chunk % plan.vec == 0 and hw % plan.vec == 0
    # The C entry's cover rule, and each block's run inside the image.
    assert plan.grid_x * plan.chunk >= hw > (plan.grid_x - 1) * plan.chunk
    # At least one full pass of the block's groups, unless the image is smaller.
    assert plan.chunk >= min(hw, THREADS * fl.FWD_UNROLL * plan.vec)
    # One wave: per_image blocks an image at most.
    per_image = -(-fl.FWD_BLOCKS_PER_SM * sms // n)
    assert plan.grid_x <= max(1, per_image)
    assert plan.grid_x * n < fl.FWD_BLOCKS_PER_SM * sms + n

    visits = np.zeros(hw, np.int64)
    for bx in range(plan.grid_x):
        p0 = bx * plan.chunk
        p1 = min(p0 + plan.chunk, hw)
        if plan.vec == 4:
            assert (p0 * 4) % 16 == 0        # float32 plane offsets: 16-byte loads
            assert (p0 * 8) % 16 == 0        # the int64 target: two longlong2
        groups = (p1 - p0) // plan.vec
        # The kernel's walk: thread t, pass i, slot u -> group t + (i*U + u)*256.
        seen = np.zeros(groups, np.int64)
        stride = fl.FWD_UNROLL * THREADS
        for t in range(THREADS):
            for g in range(t, groups, stride):
                for u in range(fl.FWD_UNROLL):
                    gu = g + u * THREADS
                    if gu < groups:
                        seen[gu] += 1
        assert (seen == 1).all()
        pix = p0 + np.arange(groups * plan.vec)
        assert pix.max(initial=p0) < p1
        visits[pix] += 1
    assert (visits == 1).all()


def test_step_plan_is_the_vector_route_in_one_wave():
    """The CHAOS step: 12 images of 256², 33 blocks an image of 1988 pixels
    (497 groups of 4: two passes of a thread at most), 396 blocks: three
    an SM of 132."""
    plan = fl.fused_loss_plan(12, 5, 256, 256, 132)
    assert plan == fl.FusedLossPlan(vec=4, chunk=1988, grid_x=33, grid_y=12)


def test_alignment_of_a_batch_slice():
    """The weak and strong halves of one 2N tensor are both 16-byte
    aligned; a view one float into its buffer is not (the scalar route)."""
    logits = torch.empty(2 * 3 * 5 * 64 * 64 + 1)
    whole = logits[:-1].view(6, 5, 64, 64)
    assert fl._aligned16(whole[:3], whole[3:])
    shifted = logits[1:].view(6, 5, 64, 64)
    assert not fl._aligned16(shifted[:3])


@pytest.mark.parametrize("args", [(1, 1, 4, 4), (1, 6, 4, 4), (0, 5, 4, 4), (1, 5, 0, 4)])
def test_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        fl.fused_loss_plan(*args)
