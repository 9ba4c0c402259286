"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build   -- compile ``pacingpseudo_torch/csrc/*.cu`` with nvcc into
              ``build/`` (one nvcc per source, all started together).
2. kernels -- hold ``fused_loss_fwd`` and ``fused_loss_bwd`` against their
              plain PyTorch versions at ``FWD_CHECKS``: the train step's
              shapes (weak and strong as the halves of one 24 x C x 256 x
              256 tensor, C in 2..5, an all-ignored target, an all-zero
              mask; LVSC's and ACDC's 224 x 224 crops at C = 2 and 4, and
              a data-2 rank's half batch at C = 2) on the forward's 16-byte
              route, an hw that is not a
              multiple of 4 and planes off 16-byte alignment on its scalar
              route, one block on each route; three forward calls
              bit-equal, each on its planned route; ``warp_table`` against its plain version
              bit for bit, and ``warp_cubic`` (the direct-read warp) against
              its plain version and the table route (12 x 256 x 256, 3 x 64
              x 96, planes holding the sentinel 255 and the ignored index,
              coordinates with f == 0, y0 + 1 == bound, live regions smaller
              than the canvas and tied votes; votes bit for bit, the image
              within 2 float32 ulps and reported if not bit-equal); then
              time kernel and plain version with CUDA events beside the
              bound the card's memory rate sets.  Then hold the
              fused-ConvLayer kernels ``conv_stats``, ``bn_sums`` and
              ``conv_pad_out`` against their plain versions in bfloat16 and
              float32 at ``CONV_CHECK_SHAPES`` and at every fused layer of
              the Experiment (N = 24; at CHAOS's 256 x 256 and at LVSC's
              and ACDC's 224 x 224) and upper-bound (N = 12) steps whose
              ``conv_plan`` and ``bn_sums_plan`` no earlier shape had
              (``_conv_check_shapes``; in bfloat16 on the ``"wgmma"``
              route, covering every (BN, BK) tile pair that ``conv_plan``
              picks in either step; float32, Ci = 1 and the ragged shapes
              take ``"simple"``; ``bn_sums`` at all four (dtype, vector)
              variants, two calls bit-equal), and time each (bfloat16) at every fused
              layer of the step beside its bound, its plain version and the
              PyTorch call that computes the same function.  Hold the fused
              path's float32 weight gradient, from bfloat16 inputs, against
              a float64 sum.
3. parity  -- one train step at a small size in float32, once through the
              kernels and once through the loss library, from the same
              state: the losses and gradients must agree.  Then one such
              step through the fused conv kernels against the unfused
              ConvLayer (``parity (fused conv)``: at the model's LeakyReLU
              slope, with the branches that flip between the two forwards
              counted, and at slope 1), and the same for one
              upper-bound step on the bare model (``parity (upper bound,
              fused conv)``), whose ``loss_ce`` on a batch with crop padding
              (all-zero label rows, trained as background) is also held
              against ``F.cross_entropy``.
4. train   -- the full-width Experiment session (CHAOS shape: 256x256,
              batch 12, 5 classes, init_ch 32, max_ch 512, output stride 8,
              hid_ch 64, bf16 compute), 3 warm-up and 5 timed steps on a
              seeded pre-augmented batch, through the entry points a user
              calls.
5. eval    -- one eval step on the same batch.
6. augment -- write a seeded synthetic CHAOS pool (48 slices of 256x256) to a
              temporary directory, read it through ``read_fold_split``,
              ``SliceDataset`` and ``BatchLoader``, and run ``augment_batch``
              at full width: shapes, one-hot sums, the valid mask, mean 0 /
              std 1 inside it, one launch of the default route's warp kernel
              (``warp_cubic`` while ``ops/warp.py``'s ``AUTO_CUDA_ROUTE`` is
              ``"direct"``) and none of the other per call, and the
              ``direct``, ``kernel`` (table) and ``plain`` routes equal to
              the default route bit for bit.  An A/B of ``augment_batch``
              on the ``direct`` and ``kernel`` routes in turns: the default
              route must be the faster.  Times the call and, inside it, the
              table route's parts (table build, row gather, interpolation +
              vote) beside the ``warp_cubic`` kernel and the direct route.
7. train (raw) -- the same session with the augmentation inside the step
              (``augment_fn``) on raw batches from the loader: 3 warm-up and
              5 timed steps, one launch of each of the three kernels a step
              (the two fused-loss kernels and the default route's warp).
              Then the same on the other warp route (``train (raw, kernel
              warp)``): the path of the warp kernel the default route does
              not launch, timed in the same run.
8. eval (raw) -- ``eval_preprocess_batch`` on a raw validation batch, then
              the eval step with its ``region_mask``.
9. train (raw, fused conv) -- the raw session under the conv impl
              ``"fused"`` (``PACING_CONV_IMPL=fused``): 3 warm-up and 5 timed
              steps; each step launches ``conv_stats`` and ``bn_sums`` once
              per fused ConvLayer (18) and ``conv_pad_out`` once per fused
              layer whose input needs a gradient (17: not the first, which
              reads the image), and each of the three earlier kernels once;
              by route, ``conv_stats`` 17 ``"wgmma"`` + 1 ``"simple"`` (Ci =
              1) and ``conv_pad_out`` 17 ``"wgmma"`` a step.
10. train (raw, upper bound) -- the Upperbound session at full width on
              the same pool (the bare UNet at batch 12, the augmentation
              without the strong stream, CE and Dice on the labels): 3
              warm-up and 5 timed steps, one ``warp_cubic`` launch a step
              and no other kernel.  Then the same step under the conv impl
              ``"fused"``: ``conv_stats``, ``bn_sums`` and ``conv_pad_out``
              once per fused layer of the bare model (18 / 18 / 17 at N =
              12, counted by ``conv_layer_shapes``), each GEMM on its
              planned route.
11. loop   -- the epoch loop (``train/loop.py``) at full width on the
              same pool: 2 epochs of 3 steps with a checkpoint each epoch
              and the frozen-BN step from epoch 1; then a run stopped after
              epoch 0, its state restored bit for bit from its checkpoint,
              and resumed to the end (``phase_loop``).  Phases 11 and 12
              run today's eager loop on streamed batches
              (``steps_per_dispatch=1``, ``device_resident_data=off``).
12. loop (upper bound) -- ``train_driver`` with the Upperbound session: 2
              epochs of 3 steps, a checkpoint each epoch (``backbone.*``
              keys only, the layout the JAX importer reads), the frozen-BN
              step from epoch 1, validation on the card.
13. inference -- ``run_inference`` (``evals/infer.py``) on a seeded test
              split of 384 256x256 slices, the size of one fold of a
              1,916-slice pool (``make_test_fold``), at batch 8, bf16, from
              the upper-bound loop's final
              checkpoint (bare) and the Experiment loop's (siamese: its
              backbone is taken): ``eval_data.npz`` of shape (N_test, 5)
              with its uids, Dice in [0, 1] or NaN, each slice's row equal
              to ``dice_per_class_hard`` of the eval step's argmax for the
              same slices and weights, no kernel launched; the forward's
              slices/s alone, the whole run's with HD95 in host threads,
              and the host metrics' ms a slice in one thread.
14. train (raw, graph) -- after phase 10, on the same pool: the train
              augmentation captured in a CUDA graph equals the eager call
              bit for bit after the generator is seeded; one replayed
              update of the raw step (``train/graph.py``'s ``StepGraph``)
              held against the eager update from the same state and seeds
              (``_hold_replay``: losses, LeakyReLU branch flips, gradients
              and updates, beside the spread of two more eager updates),
              with Adam and with SGD momentum at the parity phases' size,
              then at full width in bfloat16 for the Experiment step, the
              Upperbound step and the Experiment step under the fused conv
              impl, each followed by its median replay against the eager
              raw step in this run (``_time_replay_and_eager``; both paths
              count the same launches).
15. loop (resident, graph) -- after phase 13: a seeded pool of 312
              slices (``make_loop_pool``; fold 1 trains on 240: 20 steps
              an epoch), the Experiment loop for 2 epochs with
              ``steps_per_dispatch=8`` and the pool resident (dispatches of
              8, 8 and 4; one capture an epoch, the frozen-BN graph in
              epoch 1), in turns with today's eager streamed loop, two runs
              each; a graph run's checkpoint restores into a fresh eager
              state bit for bit; the wrappers count the same launches in
              every run; the graph runs' per-epoch metrics held against the
              eager runs', and again in float32 at init_ch 8.
16. sweep  -- ``python -m pacingpseudo_torch.cli.sweep`` in a child process:
              folds 0 and 1 of that pool, the Upperbound session at full
              width, 8 steps and inference each; the fold JSONs, the
              summary, the table, and a second call that reads the cache.
              Then the Experiment session (the four pacing flags) the same
              way on a jagged pool of 5 patients, the child printing its
              launch counts: the fold JSONs' per-patient keys, and kernels
              1, 2 and 6b launched in the child.
16a. loader (native) -- the C++ npz loader (``data/native``, built by
              g++ at first use) on that pool: ``BatchLoader.route`` must be
              ``"native"``; an epoch's batches byte-equal to the numpy
              route's and the staged pool bit-equal; host slices/s of both
              routes in turns.
16b. train (data-parallel) -- the Experiment session at full width on 2
              ranks (``parallel/mesh.py``): NCCL on two cards, or both on
              ``cuda:0`` over gloo with one card.  Each rank's augmented
              rows equal the single-card batch bit for bit; one update held
              against the single-card eager update, in float32 beside two
              updates from weights nudged by 1e-7 (these and the ranks'
              update take the eager update's LeakyReLU branches, so that a
              flip, counted and held on its own, moves no leaf) and in bf16
              beside a
              second bf16 update and the float32 one (the ranks' forward
              runs at half the batch, where cuDNN rounds otherwise; flips
              counted); parameters, BN statistics and bank equal on the
              ranks;
              ``fused_loss_fwd``, ``fused_loss_bwd`` and ``warp_cubic`` once
              a rank an update.  Then the loop on 2 ranks (2 epochs of 20
              steps, the pool sharded, 8 a dispatch: replayed on NCCL, eager
              steps on gloo, as its log must say): rank 0 alone writes the
              run, and its ``ckp_0`` resumes on one card.  Update ms only
              with a card a rank.  A rank that fails ends the script
              non-zero.  ``train (height-sharded)``: the same hold on space
              ranks, and ``train_driver`` with ``spatial_shards=2``.
16c. train (ranks, graph) -- ``steps_per_dispatch`` on ranks
              (``phase_ranks_graph``).  With two cards or more, NCCL ranks
              a card each (data 2, space 2, and data 2 x space 2 with four):
              a replayed update held against the eager update on the same
              ranks (bf16 beside four eager repeats, float32 under
              deterministic algorithms beside a spread of 0), then 8
              replays and 8 eager updates timed after 8 of each, one
              ``fused_loss_fwd``, ``fused_loss_bwd`` and ``warp_cubic`` a
              rank an update, and the ranks' parameters, BN statistics and
              bank equal after them.  With one card: a one-rank NCCL world
              (in this process) does the same with its world-axis
              collectives captured, and two gloo ranks sharing the card run
              a chunk of 8 as eager steps, bit-equal in deterministic
              float32 to 8 single updates.
17. launches -- ``bn_sums`` and ``fused_loss_fwd`` are one kernel on the
              card per call, in a profiler trace of three calls at each of
              their variants; inside 4 replays of the raw step's graph the
              profiler counts 4 x the eager step's ``fused_loss_fwd``,
              ``fused_loss_bwd`` and ``warp_cubic`` kernels, and the
              wrappers' counts add one a kernel a replay.
16d. study (tiny) -- ``scripts/quality_study_torch.py`` at full width on a
              48-slice hard pool, 2 epochs an arm: Control, Experiment and
              Upperbound trained (replayed, the pool resident), evaluated
              and summarised; the Experiment arm launches ``fused_loss_fwd``,
              ``fused_loss_bwd`` and ``warp_cubic``; then
              ``scripts/quality_study_compare.py`` over the output
              (``phase_study_tiny``).
16e. study (tiny, dilated) -- the regime of ``study_r3_dilated``:
              ``scripts/study_r3_pool_torch.py --scribble_style dilated``
              writes a 48-slice pool (its marker must name the style), the
              runner trains Control and Experiment with
              ``--ref_quirk_bn_eval_after_first_epoch`` on the 200-epoch
              schedule, stopped after epoch 1 (each log must say that the
              frozen-BN step took over at epoch 1), evaluates both, and
              ``scripts/quality_study_compare.py --protocol dilated`` holds
              the output against ``study_r3_dilated/``; the Experiment arm
              launches ``fused_loss_fwd``, ``fused_loss_bwd`` and
              ``warp_cubic`` (``phase_study_tiny_dilated``).
16f. train (lvsc), train (acdc) -- the Experiment session at full width at
              each cardiac dataset's shape (224x224 crops, 2 and 4 classes,
              bf16) on a 48-slice pool written with that dataset's arguments,
              each slice's extent within 16 px of the crop, on a canvas of
              256: the augmentation's crop and embed inside the step, 2
              warm-up and 3 timed eager steps with finite losses and one
              launch each of ``fused_loss_fwd``, ``fused_loss_bwd`` and
              ``warp_cubic`` a step, then one replayed update held against
              the eager one (``_hold_replay``).  ``inference (lvsc)``: the
              trained LVSC state's ``run_inference`` on the pool's test fold
              on one card (``eval_data.npz`` of shape (slices, 2)) and on 2
              space ranks (a card each where there are two, else gloo on
              this card), held as ``inference (height-sharded)`` holds
              CHAOS's.
18. profile_dir -- a CLI training run with ``--profile_dir`` (3 epochs of
              2 steps, the graph path) writes one trace of epoch 1 with the
              card's kernels and logs it.  The profiler phases run last, so
              that no timed phase follows a profiler session.

Phases 1-8 and 11-18 run the default conv impl (``"xla"``, the unfused
ConvLayer) whatever ``PACING_CONV_IMPL`` says, but for phase 14's fused
timing.
Prints the card's name and power limit first, a ``kernels`` JSON line
before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX: it drives the port only.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
LOSS_WEIGHTS = (1.0, 0.37, 2.1)   # loss weights for the backward checks
TIMING_REPS = 100
# float32 operations a pixel of warp_cubic_kernel, compares included: the
# anchor 10, the masked Keys weights of both axes 70, their sums 6, the 16
# tap terms 47, the renormalisation 2, the clip 2, the bilinear weights 6,
# and two votes over 6 classes of 4 compares, 4 products, 3 sums and one
# compare each, 144.
WARP_CUBIC_OPS = 287
CONV_TIMING_REPS = 20
# Relative L2 error of a gradient leaf between the fused and unfused
# float32 steps where no LeakyReLU branch differs: 3e-6 to 6e-6 on an
# NVIDIA H100 80GB HBM3 (two summation orders; the same step run twice
# differs by ~3e-6).
ROUNDOFF_L2 = 5e-5
# Relative L2 error of a leaf's update between a replayed and an eager
# float32 step where no LeakyReLU branch differs: Adam's division by
# sqrt(v) amplifies the gradients' roundoff where an element's moments
# nearly cancel (measured 5.2e-5 at enc1 layer 1 on an NVIDIA H100 80GB
# HBM3, against ROUNDOFF_L2 for the gradients).
UPDATE_L2 = 1e-3
# (label, n, ci, co, h, w): where the fused-ConvLayer kernels are held
# against their plain versions, before the layers that _conv_check_shapes
# adds: fused layers of the full-width step (the weak and strong streams
# stacked, N = 24), and two ragged small shapes (Ci and Co off the bfloat16
# vector width, W != H; Co off the float32 one), so that bn_sums runs all
# four of its (dtype, vector) variants.
CONV_CHECK_SHAPES = (
    ("enc1 layer 1", 24, 1, 32, 256, 256),
    ("enc1 layer 2", 24, 32, 32, 256, 256),
    ("dec1 layer 1", 24, 96, 32, 256, 256),
    ("enc3 layer 2", 24, 128, 128, 64, 64),
    ("dec5 layer 1", 24, 1024, 512, 32, 32),
    ("ragged", 3, 12, 20, 32, 40),
    ("enc2 layer 1", 24, 32, 64, 128, 128),
    ("enc2 layer 2", 24, 64, 64, 128, 128),
    ("dec2 layer 1", 24, 192, 64, 128, 128),
    ("dec4 layer 1", 24, 768, 256, 32, 32),
    ("odd Co", 2, 12, 13, 32, 24),
)
GEMMS = ("conv_stats", "conv_pad_out")
CONV_KERNELS = ("conv_stats", "bn_sums", "conv_pad_out")
FUSED_LAYERS = 18   # ConvLayers of the full-width step on the fused path
# The loop phases 11 and 12 run the eager loop on streamed batches, the
# path whose launches the wrappers count a step (the graph loop is phase 16).
EAGER_LOOP = dict(steps_per_dispatch=1, device_resident_data="off")
# train (height-sharded, past the coarse rows): the Experiment session at
# full width on 48x48 images at output stride 16 (3 coarse rows) on 4 space
# ranks, the split cut at the 6-row level (2, 2, 1, 1 rows: 16, 16, 8, 8
# image rows); kernels 1-2 take each rank's block, 6b the global batch.
# Not output stride 32: the aux path concatenates encoder stages 6 and 5,
# which differ in size there (in the JAX package as in the port).
# inference (height-sharded, past the coarse rows): the bare UNet at output
# stride 32 on 96x96 slices (3 coarse rows) on 4 space ranks.
DEEP_WORLD = 4
DEEP_CONFIG = dict(input_size=(48, 48), output_stride=16)
DEEP_BATCH_SHAPE = (12, 48, 48)
DEEP_LOSS_BLOCKS = ((12, 5, 16, 48), (12, 5, 8, 48))
DEEP_INFER = dict(input_size=(96, 96), output_stride=32)
DEEP_TEST_SLICES = 96
DEEP_TIMED = 5
# train (lvsc) / train (acdc): the Experiment session at full width at each
# cardiac dataset's shape (its 224x224 crop, classes and ignore index) on a
# small pool written with that dataset's arguments, each slice's extent drawn
# within CARDIAC_JITTER px of the crop per axis (the LVSC rehearsal's pool,
# scripts/lvsc_rehearsal_torch.py), padded to a canvas of 256; inference
# (lvsc) on that pool's test fold.
CARDIAC = ("lvsc", "acdc")
CARDIAC_SLICES = 48
CARDIAC_JITTER = 16
CARDIAC_CANVAS = 256
CARDIAC_WARM, CARDIAC_TIMED = 2, 3
CARDIAC_LOSS_BLOCKS = ((12, 2, 224, 224), (12, 4, 224, 224), (6, 2, 224, 224))


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _time_ms(fn, flush, reps=TIMING_REPS):
    """Median ms of ``fn`` over ``reps`` launches, each timed with its own
    CUDA events, with L2 flushed before each (the step finds it cold).  The
    flush (``flush.zero_()``) must keep the card busy for longer than the
    host takes to launch ``fn``; otherwise the card idles between the start
    event and the kernel and the time includes the host's launch cost."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _loss_inputs(c, case, dev, seed, n=12, h=256, w=256, offset=0):
    """Weak and strong logits as the two halves of one (2n, C, H, W) NCHW
    tensor, as the fused-stream backbone leaves them (``offset`` elements
    into their buffer: 1 leaves the planes off 16-byte alignment); int64
    target with ``c`` as the ignore index; float32 mask."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = 2.0 * torch.randn(offset + 2 * n * c * h * w, generator=gen, device=dev)
    logits = buf[offset:].view(2 * n, c, h, w)
    tgt = torch.randint(0, c + 1, (n, h, w), generator=gen, device=dev)
    mask = (torch.rand((n, h, w), generator=gen, device=dev) > 0.3).float()
    if case == "all_ignored":
        tgt.fill_(c)
    if case == "zero_mask":
        mask.zero_()
    return logits[:n], logits[n:], tgt, mask


# (case, n, C, H, W, offset, route, blocks): where fused_loss_fwd is held
# against forward_plain.  The step's shape at every C, the edge cases at
# C = 5, an hw that is not a multiple of 4 and planes off 16-byte alignment
# (the scalar route), one block on each route, a rank's rows of the
# data-parallel step (6 of 12: the plan's chunk and grid follow n), and a
# rank's block of the height-sharded step (``fused_loss`` at shard heights:
# 128 rows of 256 at space 2, and 6 rows of the batch at data 2 x space 2;
# at space 3 the uneven split 88, 88, 80; past the coarse rows, 48x48 at
# output stride 16 on space 4: 16, 16, 8 and 8 rows); the cardiac steps'
# 224x224 crops (LVSC's C = 2 and ACDC's C = 4, and a data-2 rank's 6 rows
# of LVSC's batch).  ``blocks`` None: any.
FWD_CHECKS = (
    ("random", 12, 2, 256, 256, 0, "vec4", None),
    ("random", 12, 3, 256, 256, 0, "vec4", None),
    ("random", 12, 4, 256, 256, 0, "vec4", None),
    ("random", 12, 5, 256, 256, 0, "vec4", None),
    ("all_ignored", 12, 5, 256, 256, 0, "vec4", None),
    ("zero_mask", 12, 5, 256, 256, 0, "vec4", None),
    ("random", 12, 5, 255, 255, 0, "scalar", None),
    ("random", 3, 4, 64, 64, 1, "scalar", None),
    ("random", 1, 5, 16, 16, 0, "vec4", 1),
    ("random", 1, 3, 3, 5, 0, "scalar", 1),
    ("random", 6, 5, 256, 256, 0, "vec4", None),
    ("random", 12, 5, 128, 256, 0, "vec4", None),
    ("random", 6, 5, 128, 256, 0, "vec4", None),
    ("random", 12, 5, 88, 256, 0, "vec4", None),
    ("random", 12, 5, 80, 256, 0, "vec4", None),
    ("random", 12, 5, 16, 48, 0, "vec4", None),
    ("random", 12, 5, 8, 48, 0, "vec4", None),
    ("random", 12, 2, 224, 224, 0, "vec4", None),
    ("random", 12, 4, 224, 224, 0, "vec4", None),
    ("random", 6, 2, 224, 224, 0, "vec4", None),
)


def _bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _warp_planes(shape, dev, seed, sentinel=False):
    """Image, label and scribble planes (N, H, W) float32 for the warp table;
    with ``sentinel`` the label holds a band of 255 and the scribble is the
    ignored index 5 except on sparse strokes."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    image = torch.randn(shape, generator=gen, device=dev)
    label = torch.randint(0, 5, shape, generator=gen, device=dev).float()
    scribble = torch.randint(0, 6, shape, generator=gen, device=dev).float()
    if sentinel:
        label[:, -shape[1] // 8:] = 255.0
        stroke = torch.rand(shape, generator=gen, device=dev) < 0.02
        scribble = torch.where(stroke, scribble, torch.full_like(scribble, 5.0))
    return image, label, scribble


def _warp_case(shape, dev, seed, sentinel=False):
    """Planes and coordinates for the direct warp, ``(planes, sy, sx, bound_h,
    bound_w)``, with every edge case of the anchor and the vote: live regions
    smaller than the canvas (per-sample bounds), random coordinates from
    -1.5 to the bound + 0.5 (clamped), integer coordinates (f == 0),
    coordinates on and past the last live row and column (y0 + 1 ==
    bound), and half-integer coordinates over a checkerboard of classes 1
    and 3 in the label and scribble: two classes at 0.25 + 0.25 each, a tie
    that the lower class must win."""
    n, h, w = shape
    planes = _warp_planes(shape, dev, seed, sentinel)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    shrink = torch.arange(n, device=dev) % 3
    bound_h = (h - 4 * shrink).float()
    bound_w = (w - 7 * (shrink == 1)).float()
    bh, bw = bound_h.view(-1, 1, 1), bound_w.view(-1, 1, 1)
    sy = torch.rand(shape, generator=gen, device=dev) * (bh + 2.0) - 1.5
    sx = torch.rand(shape, generator=gen, device=dev) * (bw + 2.0) - 1.5
    cols = torch.arange(w, device=dev, dtype=torch.float32)
    sy[:, 0] = (cols % 8).view(1, -1)                         # f == 0
    sx[:, 0] = cols.view(1, -1)
    sy[:, 1] = bh.view(-1, 1) - 1.0 + (cols % 2).view(1, -1) * 0.5   # y0 + 1 == bound
    sx[:, 1] = torch.minimum(cols.view(1, -1), bw.view(-1, 1) - 0.25)
    sy[:, 2] = 8.5                                             # ties
    sx[:, 2] = 8.5 + (cols % 8).view(1, -1)
    checker = (torch.arange(8, device=dev).view(-1, 1) + torch.arange(24, device=dev)) % 2
    for plane in planes[1:]:
        plane[:, 6:14, 6:30] = 1.0 + 2.0 * checker
    return planes, sy, sx, bound_h, bound_w


def _warp_smooth(shape, dev, seed):
    """Planes and the coordinates an augmentation warp gives, ``(planes, sy,
    sx, bound_h, bound_w)``: per sample a rotation by up to 30 degrees and
    a scale of 0.7-1.4 about the centre, the whole canvas live.  Where the
    kernel is timed: neighbouring pixels read neighbouring source pixels,
    as on the main path."""
    n, h, w = shape
    planes = _warp_planes(shape, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    theta = (torch.rand(n, 1, 1, generator=gen, device=dev) - 0.5) * (math.pi / 3)
    scale = 0.7 + 0.7 * torch.rand(n, 1, 1, generator=gen, device=dev)
    yy = torch.arange(h, device=dev, dtype=torch.float32).view(1, -1, 1) - (h - 1) / 2
    xx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, -1) - (w - 1) / 2
    sy = (h - 1) / 2 + (yy * torch.cos(theta) - xx * torch.sin(theta)) / scale
    sx = (w - 1) / 2 + (yy * torch.sin(theta) + xx * torch.cos(theta)) / scale
    full = torch.full((n,), float(h), device=dev), torch.full((n,), float(w), device=dev)
    return planes, sy.contiguous(), sx.contiguous(), *full


def _ulps(value):
    """``value``'s float32 ulp: the gap above the largest power of 2 under it."""
    return 2.0 ** (math.floor(math.log2(max(value, 2.0 ** -126))) - 23)


def check_warp_cubic(wc, warp, dev):
    """``warp_cubic`` against its plain version and against the table
    route (``"kernel"``) from the same coordinates, at the ``_warp_planes``
    shapes with and without the sentinel and on ``_warp_case``'s edge
    cases.  Class votes equal bit for bit; the image bit-equal, or within 2
    float32 ulps of its largest value (the stated bound if an order of
    operations differed).  Returns the max abs error of the image."""
    err = 0.0
    for i, (shape, sentinel) in enumerate((((12, 256, 256), False), ((12, 256, 256), True),
                                           ((3, 64, 96), False), ((3, 64, 96), True),
                                           (DEEP_BATCH_SHAPE, False))):
        planes, sy, sx, bh, bw = _warp_case(shape, dev, 250 + i, sentinel)
        got = wc.warp_sample_cubic(*planes, sy, sx, 6, bh, bw)
        plain = wc.warp_sample_cubic_plain(*planes, sy, sx, 6, bh, bw)
        table = warp.fused_warp_sample_cubic(*planes, sy, sx, 6, bh, bw, table_impl="kernel")
        torch.cuda.synchronize()
        tag = f"warp_cubic {shape} sentinel={sentinel}"
        _check(got[0].dtype == torch.float32 and got[1].dtype == torch.int32
               and got[0].shape == sy.shape, f"{tag}: {got[0].dtype} {got[1].dtype}")
        _check(bool((plain[1][:, 2] == 1).all() and (plain[2][:, 2] == 1).all()),
               f"{tag}: a 0.5 / 0.5 tie of classes 1 and 3 did not go to class 1")
        for name, want in (("plain version", plain), ("table route", table)):
            for k in (1, 2):
                _check(torch.equal(got[k], want[k]),
                       f"{tag}: class votes {k} differ from the {name} in "
                       f"{int((got[k] != want[k]).sum())} pixels")
            e = float((got[0] - want[0]).abs().max())
            tol = 2 * _ulps(float(want[0].abs().max()))
            _check(bool(torch.isfinite(got[0]).all()) and e <= tol,
                   f"{tag}: image max abs error {e} against the {name} > {tol}")
            err = max(err, e)
            print(f"kernels: {tag} vs {name}: votes equal, image "
                  + ("bit-equal" if torch.equal(got[0], want[0]) else f"max abs error {e}"),
                  flush=True)
    return err


def check_fused_loss(fl, dev):
    """``fused_loss_fwd`` and ``fused_loss_bwd`` against their plain
    versions at ``FWD_CHECKS``: the forward on its planned route, three
    calls bit-equal (the third after the counter was reset twice), rtol
    1e-5 (sums of non-negative terms in float, then double, against
    PyTorch's float sums); the backward within 1e-4 of its largest value.
    Returns the two max abs errors."""
    err = {"fused_loss_fwd": 0.0, "fused_loss_bwd": 0.0}
    for i, (case, n, c, h, w, offset, route, blocks) in enumerate(FWD_CHECKS):
        lw, ls, tgt, mask = _loss_inputs(c, case, dev, 100 + i, n, h, w, offset)
        tag = f"fwd {case} {n}x{c}x{h}x{w} offset {offset}"
        plan = fl.forward_plan(lw, ls, tgt, mask)
        _check(("vec4" if plan.vec == 4 else "scalar") == route
               and blocks in (None, plan.grid_x * plan.grid_y),
               f"{tag}: plan {plan}, want route {route} and {blocks} blocks")
        fl.reset_launch_counts()
        got = fl.fused_loss_forward(lw, ls, tgt, mask, c)
        again = [fl.fused_loss_forward(lw, ls, tgt, mask, c) for _ in range(2)]
        want = fl.forward_plain(lw, ls, tgt, mask, c)
        torch.cuda.synchronize()
        _check(fl.ROUTES["fused_loss_fwd"][route] == 3 and fl.LAUNCHES["fused_loss_fwd"] == 3,
               f"{tag}: launches by route {fl.ROUTES}")
        _check(bool(torch.isfinite(got).all()), f"{tag}: not finite")
        _check(all(torch.equal(got, a) for a in again),
               f"{tag}: three calls differ: {got.tolist()} {[a.tolist() for a in again]}")
        close = torch.allclose(got, want, rtol=1e-5, atol=0.0)
        e = float((got - want).abs().max())
        _check(close, f"{tag}: {got.tolist()} vs {want.tolist()}")
        err["fused_loss_fwd"] = max(err["fused_loss_fwd"], e)
        scal = torch.tensor(LOSS_WEIGHTS, device=dev) / want[8:]
        for name, g, w in zip(
                ("dlw", "dls"),
                fl.fused_loss_backward(lw, ls, tgt, mask, scal, c),
                fl.backward_plain(lw, ls, tgt, mask, scal, c)):
            torch.cuda.synchronize()
            e = float((g - w).abs().max())
            tol = 1e-4 * float(w.abs().max())
            _check(bool(torch.isfinite(g).all()) and e <= tol,
                   f"bwd {tag} {name}: max err {e} > {tol}")
            err["fused_loss_bwd"] = max(err["fused_loss_bwd"], e)
        print(f"kernels: {tag} ok: {route}, {plan.grid_x} x {plan.grid_y} blocks of "
              f"{plan.chunk} pixels, three calls bit-equal", flush=True)

    return err["fused_loss_fwd"], err["fused_loss_bwd"]


def phase_kernels(fl, wt, wc, warp, dev):
    """Kernel vs plain version at the step's shapes; returns the rows of the
    ``kernels`` line, without ``launches``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    err = {"warp_table": 0.0, "warp_cubic": check_warp_cubic(wc, warp, dev)}
    err["fused_loss_fwd"], err["fused_loss_bwd"] = check_fused_loss(fl, dev)

    # The warp table is a pure copy: equal bit for bit (tolerance 0).
    for i, (shape, sentinel) in enumerate((((12, 256, 256), False),
                                           ((12, 256, 256), True),
                                           ((3, 64, 96), False),
                                           ((3, 64, 96), True))):
        planes = _warp_planes(shape, dev, seed=200 + i, sentinel=sentinel)
        got = wt.build_warp_table(*planes, impl="kernel")
        want = wt.build_warp_table_plain(*planes)
        torch.cuda.synchronize()
        _check(got.shape == want.shape and got.dtype == want.dtype,
               f"warp_table {shape}: {tuple(got.shape)} {got.dtype}")
        err["warp_table"] = max(err["warp_table"], float((got - want).abs().max()))
        _check(torch.equal(got, want),
               f"warp_table {shape} sentinel={sentinel}: differs from the plain "
               f"version in {int((got != want).sum())} entries")
        print(f"kernels: warp_table {shape} sentinel={sentinel} ok", flush=True)

    # Timing at the main path's shapes: C = 5, the Experiment session's.
    c = 5
    lw, ls, tgt, mask = _loss_inputs(c, "random", dev, seed=7)
    out = fl.forward_plain(lw, ls, tgt, mask, c)
    scal = torch.tensor(LOSS_WEIGHTS, device=dev) / out[8:]
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=dev)   # ~0.16 ms
    npix = tgt.numel()
    fwd_bytes = _bytes(lw, ls, tgt, mask, out)
    bwd_bytes = _bytes(lw, ls, tgt, mask, scal) + 2 * _bytes(lw)
    # Operations per pixel, exp and log counted as one each: two softmaxes of
    # 6C, then 6C for the three per-pixel terms and 8 for the sums (fwd), or
    # 4C for the entropy and soft-CE terms and 10C for the two gradients (bwd).
    fwd_ops = npix * (18 * c + 8)
    bwd_ops = npix * (26 * c)
    # The warp table at the augmentation's shapes: three (12, 256, 256) planes
    # in, the (12, 65536, 24) table out; a copy, so no operations to count.
    planes = _warp_planes((12, 256, 256), dev, seed=8)
    table_bytes = _bytes(*planes) + 24 * _bytes(planes[0])
    # The direct warp at the same shapes: the planes, sy and sx and the four
    # per-sample arrays read once, the image and the two class maps written
    # once; WARP_CUBIC_OPS float32 operations a pixel.
    wplanes, sy, sx, bh, bw = _warp_smooth((12, 256, 256), dev, seed=9)
    lo, hi = (t.reshape(-1).contiguous() for t in warp.live_range(wplanes[0], bh, bw))
    cubic_bytes = _bytes(*wplanes, sy, sx, bh, bw, lo, hi) + 3 * _bytes(sy)
    rows = []
    for name, source, replaces, fn, plain, nbytes, ops in (
            ("fused_loss_fwd", "fused_loss", "fused_loss.py:60",
             lambda: fl.fused_loss_forward(lw, ls, tgt, mask, c),
             lambda: fl.forward_plain(lw, ls, tgt, mask, c),
             fwd_bytes, fwd_ops),
            ("fused_loss_bwd", "fused_loss", "fused_loss.py:96",
             lambda: fl.fused_loss_backward(lw, ls, tgt, mask, scal, c),
             lambda: fl.backward_plain(lw, ls, tgt, mask, scal, c),
             bwd_bytes, bwd_ops),
            ("warp_table", "warp_table", "warp_table.py:32",
             lambda: wt.build_warp_table(*planes, impl="kernel"),
             lambda: wt.build_warp_table_plain(*planes),
             table_bytes, 0),
            ("warp_cubic", "warp_cubic", "warp_table.py:32",
             lambda: wc.launch(*wplanes, sy, sx, bh, bw, lo, hi, 6),
             lambda: wc.warp_sample_cubic_plain(*wplanes, sy, sx, 6, bh, bw),
             cubic_bytes, WARP_CUBIC_OPS * sy.numel())):
        row = {"name": name, "route": "cuda",
               "source": f"pacingpseudo_torch/csrc/{source}.cu",
               "replaces": f"pacingpseudo_tpu/ops/pallas/{replaces}",
               "launches": None, "max_abs_err": err[name],
               **_row_times(fn, plain, nbytes, ops, flush), "library_ms": None}
        print(f"kernels: {name} {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}"
              f" ms, bound {row['bound_ms']:.4f} ms ({nbytes} bytes)", flush=True)
        rows.append(row)
    shard_shapes = time_shard_shapes(fl, wc, warp, dev, flush, err)
    cardiac_shapes = _time_loss_blocks(fl, dev, flush, err, CARDIAC_LOSS_BLOCKS, 320)
    for name, entries in cardiac_shapes.items():
        for e in entries:
            print(f"kernels: {name} at {e['shape']} (the cardiac steps) {e['ms']:.4f} ms, "
                  f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms", flush=True)
    for row in rows:
        if row["name"] in shard_shapes:
            row["shard_shapes"] = shard_shapes[row["name"]]
        if row["name"] in cardiac_shapes:
            row["cardiac_shapes"] = cardiac_shapes[row["name"]]
    return rows


def _row_times(fn, plain, nbytes, ops, flush):
    """A kernel's ms, its plain version's and the bound of the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"ms": _time_ms(fn, flush), "plain_ms": _time_ms(plain, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _time_loss_blocks(fl, dev, flush, err, blocks, seed):
    """Kernels 1 and 2 at each ``(n, c, h, w)`` of ``blocks`` (held against
    their plain versions by ``check_fused_loss`` before).  Returns each
    kernel's entries."""
    out = {"fused_loss_fwd": [], "fused_loss_bwd": []}
    for i, (n, c, h, w) in enumerate(blocks):
        lw, ls, tgt, mask = _loss_inputs(c, "random", dev, seed + i, n, h, w)
        res = fl.forward_plain(lw, ls, tgt, mask, c)
        scal = torch.tensor(LOSS_WEIGHTS, device=dev) / res[8:]
        npix = tgt.numel()
        for name, fn, plain, nbytes, ops in (
                ("fused_loss_fwd", lambda: fl.fused_loss_forward(lw, ls, tgt, mask, c),
                 lambda: fl.forward_plain(lw, ls, tgt, mask, c),
                 _bytes(lw, ls, tgt, mask, res), npix * (18 * c + 8)),
                ("fused_loss_bwd", lambda: fl.fused_loss_backward(lw, ls, tgt, mask, scal, c),
                 lambda: fl.backward_plain(lw, ls, tgt, mask, scal, c),
                 _bytes(lw, ls, tgt, mask, scal) + 2 * _bytes(lw), npix * 26 * c)):
            entry = {"shape": [n, c, h, w], "max_abs_err": err[name], "library_ms": None,
                     **_row_times(fn, plain, nbytes, ops, flush)}
            out[name].append(entry)
    return out


def time_shard_shapes(fl, wc, warp, dev, flush, err):
    """Kernels 1, 2 and 6b at the shapes ``train (height-sharded, past the
    coarse rows)`` gives them (each held against its plain version by
    ``check_fused_loss`` and ``check_warp_cubic`` before): the fused loss at
    each rank's block (``DEEP_LOSS_BLOCKS``), the direct warp on the global
    batch (``DEEP_BATCH_SHAPE``).  Returns each kernel's entries."""
    out = {**_time_loss_blocks(fl, dev, flush, err, DEEP_LOSS_BLOCKS, 300), "warp_cubic": []}
    wplanes, sy, sx, bh, bw = _warp_smooth(DEEP_BATCH_SHAPE, dev, seed=310)
    lo, hi = (t.reshape(-1).contiguous() for t in warp.live_range(wplanes[0], bh, bw))
    out["warp_cubic"].append({
        "shape": list(DEEP_BATCH_SHAPE), "max_abs_err": err["warp_cubic"], "library_ms": None,
        **_row_times(lambda: wc.launch(*wplanes, sy, sx, bh, bw, lo, hi, 6),
                     lambda: wc.warp_sample_cubic_plain(*wplanes, sy, sx, 6, bh, bw),
                     _bytes(*wplanes, sy, sx, bh, bw, lo, hi) + 3 * _bytes(sy),
                     WARP_CUBIC_OPS * sy.numel(), flush)})
    for name, entries in out.items():
        for e in entries:
            print(f"kernels: {name} at {e['shape']} (past the coarse rows) {e['ms']:.4f} ms, "
                  f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms", flush=True)
    return out


def _conv_inputs(n, ci, co, h, w, dtype, dev, seed):
    """Padded NHWC canvases with a zero border and (9, Cin, Cout) weights at
    a conv's fan-in scale: ``xp``, ``w9``, ``bias`` (float32) for
    ``conv_stats``; ``gzp`` and ``w9t`` for ``bn_sums`` / ``conv_pad_out``."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def canvas(c):
        x = torch.zeros((n, h + 2, w + 2, c), dtype=dtype, device=dev)
        x[:, 1:-1, 1:-1] = torch.randn((n, h, w, c), generator=gen, device=dev)
        return x

    def weights(cin, cout):
        return (torch.randn((9, cin, cout), generator=gen, device=dev)
                / math.sqrt(9 * cin)).to(dtype)

    bias = 0.1 * torch.randn(co, generator=gen, device=dev)
    return canvas(ci), weights(ci, co), bias, canvas(co), weights(co, ci)


def _bn_aux(sums, count, dev, seed):
    """(4, Co) rows [mean, rstd, gamma, beta] from conv_stats' sums."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    co = sums.shape[1]
    mean = sums[0] / count
    var = sums[1] / count - mean.square()
    gamma = 0.5 + torch.rand(co, generator=gen, device=dev)
    beta = 0.1 * torch.randn(co, generator=gen, device=dev)
    return torch.stack([mean, torch.rsqrt(var + 1e-5), gamma, beta])


def _held(name, got, want, atol, rtol=0.0):
    """``|got - want| <= atol + rtol·|want|`` everywhere; the max abs error."""
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    worst = float((err - bound).max())
    _check(bool(torch.isfinite(got).all()) and worst <= 0,
           f"{name}: max abs error {float(err.max())}, exceeds its tolerance by {worst}")
    return float(err.max())


def _kernels_launched(fn, calls=3):
    """Names of the kernels the card ran in ``calls`` calls of ``fn`` (after
    one call outside the trace), from a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = f"{tmp}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


def check_fused_loss_launches(fl, dev):
    """One kernel on the card per ``fused_loss_fwd`` call, on each route: a
    profiler trace of three calls at the step's shape (vector route) and at
    an hw that is not a multiple of 4 (scalar route).  Run last: no timed
    phase follows a profiler session."""
    for case in (FWD_CHECKS[3], FWD_CHECKS[6]):
        _, n, c, h, w, offset, route, _ = case
        lw, ls, tgt, mask = _loss_inputs(c, "random", dev, 500, n, h, w, offset)
        names = _kernels_launched(lambda: fl.fused_loss_forward(lw, ls, tgt, mask, c))
        _check(len(names) == 3 and all("fwd_kernel" in k for k in names),
               f"fused_loss_fwd {n}x{c}x{h}x{w} ({route}): three calls ran the kernels {names}")
    print("fused_loss_fwd: one kernel a call in a profiler trace, routes vec4 and scalar",
          flush=True)


def check_bn_sums_launches(fc, dev):
    """One kernel on the card per ``bn_sums`` call, at the first check shape
    of each (dtype, vector) variant: a profiler trace of three calls.  Run
    last: no timed phase follows a profiler session."""
    seen = set()
    for i, (label, n, ci, co, h, w) in enumerate(CONV_CHECK_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            variant = (str(dtype)[6:], fc.bn_sums_plan(dtype, n, h, w, co).vec)
            if variant in seen:
                continue
            seen.add(variant)
            xp, w9, bias, gzp, _ = _conv_inputs(n, ci, co, h, w, dtype, dev, 300 + i)
            y, sums = fc.conv_stats(xp, w9, bias)
            aux = _bn_aux(sums, n * h * w, dev, 400 + i)
            names = _kernels_launched(lambda: fc.bn_sums(y, gzp, aux, 1e-2))
            _check(len(names) == 3 and all("bn_sums_kernel" in k for k in names),
                   f"bn_sums {label} {variant}: three calls ran the kernels {names}")
    print(f"bn_sums: one kernel a call in a profiler trace, variants {sorted(seen)}",
          flush=True)


def check_conv_kernels(fc, dev):
    """``conv_stats``, ``bn_sums`` and ``conv_pad_out`` against their plain
    versions at ``_conv_check_shapes``, in bfloat16 and float32.  Returns the
    max abs error of each kernel.

    Tolerances.  ``y`` and ``dxp``: both sides sum exact products in float32
    in different orders, so they differ by float32 roundoff (1e-4 of the
    largest value) and, in bfloat16, by one rounding step of the result
    (rtol 2**-7, one bfloat16 ulp).  The sums (of conv_stats and bn_sums):
    rtol 1e-4, with an atol of 1e-4 of the row's largest sum for a channel
    whose sum lies near 0.  The border of ``dxp`` exactly 0.  Each GEMM
    must take the route its plan names, and the bfloat16 shapes must cover
    every (BN, BK) pair that the plan picks at the step's layers.
    ``bn_sums``: two calls equal bit for bit, and each (dtype, vector)
    variant of its plan met (``check_bn_sums_launches`` counts its kernels
    at the end of the run)."""
    from scripts.reckon_fused_conv_bounds import conv_layer_shapes

    err = dict.fromkeys(CONV_KERNELS, 0.0)
    covered = set()
    bn_variants = {}
    shapes = _conv_check_shapes(fc, fc._sm_count(dev.index))
    for i, (label, n, ci, co, h, w) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{label} ({ci} -> {co} @ {h}x{w}, N {n}) {str(dtype)[6:]}"
            rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
            plans = _gemm_plans(fc, dtype, n, ci, co, h, w)
            covered |= {(k, p.bn, p.bk) for k, p in plans.items() if p.route == "wgmma"}
            fc.reset_launch_counts()
            xp, w9, bias, gzp, w9t = _conv_inputs(n, ci, co, h, w, dtype, dev, 300 + i)
            y, sums = fc.conv_stats(xp, w9, bias)
            y_p, sums_p = fc.conv_stats_plain(xp, w9, bias)
            torch.cuda.synchronize()
            scale = 1e-4 * float(y_p.float().abs().max())
            e = _held(f"conv_stats y {tag}", y, y_p, scale, rtol)
            row = 1e-4 * sums_p.abs().amax(dim=1, keepdim=True)
            e = max(e, _held(f"conv_stats sums {tag}", sums, sums_p, row, 1e-4))
            err["conv_stats"] = max(err["conv_stats"], e)

            aux = _bn_aux(sums_p, n * h * w, dev, 400 + i)
            got = fc.bn_sums(y, gzp, aux, 1e-2)
            again = fc.bn_sums(y, gzp, aux, 1e-2)
            want = fc.bn_sums_plain(y, gzp, aux, 1e-2)
            torch.cuda.synchronize()
            row = 1e-4 * want.abs().amax(dim=1, keepdim=True)
            err["bn_sums"] = max(err["bn_sums"],
                                 _held(f"bn_sums {tag}", got, want, row, 1e-4))
            _check(torch.equal(got, again), f"bn_sums {tag}: two calls differ")
            plan = fc.bn_sums_plan(dtype, n, h, w, co, fc._sm_count(dev.index))
            bn_variants.setdefault((str(dtype)[6:], plan.vec), tag)

            dxp = fc.conv_pad_out(gzp, w9t)
            dxp_p = fc.conv_pad_out_plain(gzp, w9t)
            torch.cuda.synchronize()
            scale = 1e-4 * float(dxp_p.float().abs().max())
            err["conv_pad_out"] = max(err["conv_pad_out"], _held(
                f"conv_pad_out {tag}", dxp, dxp_p, scale, rtol))
            border = torch.cat([dxp[:, 0].flatten(), dxp[:, -1].flatten(),
                                dxp[:, :, 0].flatten(), dxp[:, :, -1].flatten()])
            _check(bool((border == 0).all()), f"conv_pad_out {tag}: border not zero")
            for k, p in plans.items():
                _check(fc.ROUTES[k][p.route] == 1 and sum(fc.ROUTES[k].values()) == 1,
                       f"{k} {tag}: routes {fc.ROUTES[k]}, plan {p}")
            print(f"kernels: fused conv {tag} ok ({_route_tag(plans)}; bn_sums vec "
                  f"{plan.vec}, {plan.bx} x {plan.by} threads, grid {plan.grid_x} x "
                  f"{plan.grid_y}, {plan.rows_per_block} rows a block)", flush=True)
            del xp, w9, gzp, w9t, y, y_p, dxp, dxp_p
    step = {(k, p.bn, p.bk)
            for config in _conv_configs()
            for s in conv_layer_shapes(config) if s[6]
            for k, p in _gemm_plans(fc, torch.bfloat16, *s[1:6]).items()
            if p.route == "wgmma" and (k == "conv_stats" or s[7])}
    _check(step <= covered, f"check shapes miss the step's wgmma tiles {sorted(step - covered)}")
    _check(sorted(bn_variants) == [("bfloat16", 1), ("bfloat16", 8), ("float32", 1),
                                   ("float32", 4)],
           f"bn_sums: the check shapes meet the variants {sorted(bn_variants)}")
    print(f"kernels: bn_sums two calls bit-equal, variants {sorted(bn_variants)}",
          flush=True)
    print(f"kernels: the check shapes cover all {len(step)} (kernel, BN, BK) wgmma tiles "
          f"of the Experiment (CHAOS, LVSC, ACDC) and upper-bound steps; "
          f"{len(shapes) - len(CONV_CHECK_SHAPES)} "
          f"of the {len(shapes)} shapes are step layers whose plans no shape before had",
          flush=True)
    return err


def _conv_check_shapes(fc, sms):
    """``CONV_CHECK_SHAPES``, then every fused layer of the Experiment step
    (N = 24), of the upper-bound step (the bare model, N = 12) and of the
    Experiment step at LVSC's and ACDC's 224x224 (widths 224, 112, 56, 28)
    whose bfloat16 plans differ from those of every shape before it: the
    GEMMs' tiles and persistent grid (``conv_plan``) and ``bn_sums``' row
    partition (``bn_sums_plan``) depend on N and H x W as well as on the
    channels.
    A check shape runs all three kernels; a layer whose input needs no
    gradient runs no ``conv_pad_out``, so its plan is not compared.  A
    ``"simple"`` plan names no channels (at 224 x 224 every fused layer
    takes it, whatever its channels), so its layer's channels join the
    comparison."""
    from scripts.reckon_fused_conv_bounds import conv_layer_shapes

    def plans(n, ci, co, h, w):
        gemm = _gemm_plans(fc, torch.bfloat16, n, ci, co, h, w)
        simple = any(p.route == "simple" for p in gemm.values())
        return (gemm["conv_stats"], fc.bn_sums_plan(torch.bfloat16, n, h, w, co, sms),
                gemm["conv_pad_out"], (ci, co) if simple else None)

    shapes = list(CONV_CHECK_SHAPES)
    checked = [plans(*s[1:]) for s in shapes]
    for config in _conv_configs():
        for name, n, ci, co, h, w, fused, needs_dx in conv_layer_shapes(config):
            want = plans(n, ci, co, h, w)
            if fused and not any(c[:2] == want[:2] and (c[2] == want[2] or not needs_dx)
                                 and c[3] == want[3] for c in checked):
                label = name.replace("backbone.", "").replace(".conv_block.conv_layer",
                                                              " layer ")
                where = "" if config.dataset == "chaos" else f" {config.dataset}"
                shapes.append((f"{label}, {config.session}{where}", n, ci, co, h, w))
                checked.append(want)
    return shapes


def _gemm_plans(fc, dtype, n, ci, co, h, w):
    """The plans of a layer's two GEMMs: conv_stats (N = Co over Ci) and
    conv_pad_out (N = Ci over Co)."""
    return {"conv_stats": fc.conv_plan(dtype, n, h, w, ci, co, False),
            "conv_pad_out": fc.conv_plan(dtype, n, h, w, co, ci, True)}


def _route_tag(plans):
    return ", ".join(f"{k} {p.route}" + (f" BN {p.bn} BK {p.bk} box {p.box_h}x{p.box_w} "
                                         f"{p.stages} stages" if p.route == "wgmma" else "")
                     for k, p in plans.items())


def check_weight_grad(fc, dev):
    """The fused path's ``dW`` in bfloat16 at one layer of the step (enc3
    layer 2: 128 -> 128 @ 64x64, N 24) against a float64 sum of the same
    bfloat16 products.  It must be float32 and within 2**-12 of the largest
    value, an eighth of a bfloat16 step: rounded to bfloat16, as a bfloat16
    library call returns it, it would be off by up to 2**-9 of a value, and
    that gap is printed beside it."""
    n, ci, co, h, w = 24, 128, 128, 64, 64
    xp, _, _, gzp, _ = _conv_inputs(n, ci, co, h, w, torch.bfloat16, dev, 700)
    dy = gzp[:, 1:-1, 1:-1].contiguous()
    got = fc.weight_grad(xp, dy)
    x64, dy64 = xp.double(), dy.double()
    want = torch.stack([torch.einsum("nhwc,nhwd->cd", x64[:, i:i + h, j:j + w], dy64)
                        for i in range(3) for j in range(3)]).reshape(3, 3, ci, co)
    torch.cuda.synchronize()
    _check(got.dtype == torch.float32 and tuple(got.shape) == (3, 3, ci, co),
           f"weight_grad: {got.dtype} {tuple(got.shape)}")
    top = float(want.abs().max())
    err = _held("weight_grad (bf16 in, float32 out)", got, want, 2.0 ** -12 * top)
    rounded = float((got.bfloat16().double() - want).abs().max())
    print(f"kernels: fused dW (bf16, {ci} -> {co} @ {h}x{w}, N {n}) max abs error "
          f"{err:.3e} against float64 ({err / top:.2e} of the largest value); "
          f"rounded to bfloat16 {rounded:.3e} ({rounded / top:.2e})", flush=True)
    del xp, gzp, dy, x64, dy64


def time_conv_kernels(fc, dev, err, flush):
    """Each fused-ConvLayer kernel, alone with L2 flushed, at every fused
    layer of the full-width step (bfloat16), beside its plain version, its
    bound and the PyTorch call that computes the same function where there
    is one: ``F.conv2d`` on the channels-last canvas (kernel 3) and the
    input-gradient ``convolution_backward`` (kernel 5).  Returns the rows of
    the ``kernels`` line; times and bounds are sums over the layers that
    launch the kernel in one step."""
    import torch.nn.functional as F

    from scripts.reckon_fused_conv_bounds import (BF16_OPS_PER_S, conv_layer_shapes,
                                                  kernel_costs)

    replaces = {"conv_stats": "fused_convbn.py:127", "bn_sums": "fused_convbn.py:160",
                "conv_pad_out": "fused_convbn.py:201"}
    cost_key = {"conv_stats": "_conv_stats_kernel", "bn_sums": "_bn_sums_kernel",
                "conv_pad_out": "_conv_pad_out_kernel"}
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
               "ops_ms": 0.0, "bound_ms": 0.0} for k in CONV_KERNELS}
    layers = [s for s in conv_layer_shapes(_experiment_config()) if s[6]]
    for i, (name, n, ci, co, h, w, _, needs_dx) in enumerate(layers):
        xp, w9, bias, gzp, w9t = _conv_inputs(n, ci, co, h, w, torch.bfloat16, dev, 500 + i)
        y, sums = fc.conv_stats(xp, w9, bias)
        aux = _bn_aux(sums, n * h * w, dev, 600 + i)
        x_cl = xp.permute(0, 3, 1, 2)
        w_oihw = w9.reshape(3, 3, ci, co).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bias_dt = bias.to(torch.bfloat16)
        dy_cl = gzp[:, 1:-1, 1:-1].contiguous().permute(0, 3, 1, 2)
        x_like = torch.empty((n, ci, h, w), dtype=torch.bfloat16, device=dev,
                             memory_format=torch.channels_last)
        w_lib = w9t.reshape(3, 3, co, ci).flip((0, 1)).permute(2, 3, 0, 1).contiguous(
            memory_format=torch.channels_last)
        calls = {
            "conv_stats": (lambda: fc.conv_stats(xp, w9, bias),
                           lambda: fc.conv_stats_plain(xp, w9, bias),
                           lambda: F.conv2d(x_cl, w_oihw, bias_dt)),
            "bn_sums": (lambda: fc.bn_sums(y, gzp, aux, 1e-2),
                        lambda: fc.bn_sums_plain(y, gzp, aux, 1e-2), None),
            "conv_pad_out": (lambda: fc.conv_pad_out(gzp, w9t),
                             lambda: fc.conv_pad_out_plain(gzp, w9t),
                             lambda: torch.ops.aten.convolution_backward(
                                 dy_cl, x_like, w_lib, None, [1, 1], [1, 1], [1, 1],
                                 False, [0, 0], 1, [True, False, False])),
        }
        plans = _gemm_plans(fc, torch.bfloat16, n, ci, co, h, w)
        line = f"kernels: {name.split('backbone.')[-1]} {ci} -> {co} @ {h}x{w}:"
        costs = kernel_costs(n, ci, co, h, w)
        for k, (fn, plain, library) in calls.items():
            if k == "conv_pad_out" and not needs_dx:
                line += " conv_pad_out not launched (no dx);"
                continue
            nbytes, tensor_ops, f32_ops = costs[cost_key[k]]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = max(tensor_ops / BF16_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
            ms = {"ms": _time_ms(fn, flush, CONV_TIMING_REPS),
                  "plain_ms": _time_ms(plain, flush, CONV_TIMING_REPS),
                  "library_ms": (_time_ms(library, flush, CONV_TIMING_REPS)
                                 if library else 0.0),
                  "bytes_ms": t_bytes, "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops)}
            for key, v in ms.items():
                tot[k][key] += v
            line += (f" {k}" + (f" [{plans[k].route}]" if k in plans else "")
                     + f" {ms['ms']:.4f} ms (bound {ms['bound_ms']:.4f}, plain "
                     f"{ms['plain_ms']:.4f}" + (f", library {ms['library_ms']:.4f}"
                                                if library else "")
                     + (f", {tensor_ops / ms['ms'] * 1e-9:.1f} TFLOP/s" if tensor_ops
                        else "") + ");")
        print(line, flush=True)
        del xp, w9, gzp, w9t, y, x_like, dy_cl, w_lib, w_oihw
    rows = []
    for k in CONV_KERNELS:
        t = tot[k]
        rows.append({"name": k, "route": "cuda",
                     # The GEMMs' main route is conv_wgmma.cu (the simple
                     # route and the reduction stay in fused_convbn.cu).
                     "source": "pacingpseudo_torch/csrc/"
                               + ("conv_wgmma.cu" if k in GEMMS else "fused_convbn.cu"),
                     "replaces": f"pacingpseudo_tpu/ops/pallas/{replaces[k]}",
                     "launches": None, "max_abs_err": err[k], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
                     "library_ms": t["library_ms"] if k != "bn_sums" else None})
        print(f"kernels: {k} over the step's layers {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms, library "
              f"{rows[-1]['library_ms']}", flush=True)
    return rows


def make_batch(n, size, num_classes, seed, dev):
    """A seeded synthetic batch in the step's NCHW form: blobs of each class
    on a noisy background, an intensity-jittered strong stream, scribble
    strokes one-hot over C+1 (the last channel is ignore), full labels and
    a valid mask with a zero border band."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size] / size
    label = np.zeros((n, size, size), np.int64)
    for i in range(n):
        for k in range(1, num_classes):
            cy, cx = rs.uniform(0.2, 0.8, 2)
            ry, rx = rs.uniform(0.05, 0.2, 2)
            label[i][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1] = k
    image = (label * (1.0 / num_classes)
             + 0.1 * rs.randn(n, size, size)).astype(np.float32)
    gain = rs.uniform(0.7, 1.3, (n, 1, 1))
    bias = rs.uniform(-0.2, 0.2, (n, 1, 1))
    strong = (image * gain + bias).astype(np.float32)
    scribble = np.full((n, size, size), num_classes, np.int64)
    for i in range(n):
        for k in range(num_classes):
            ys, xs = np.nonzero(label[i] == k)
            if len(ys) == 0:
                continue
            j = rs.randint(len(ys))
            y0, x0 = ys[j], xs[j]
            stroke = (np.abs(yy * size - y0) < 2) & (np.abs(xx * size - x0) < size // 16)
            scribble[i][stroke & (label[i] == k)] = k
    valid = np.zeros((n, size, size), np.float32)
    border = size // 16
    valid[:, border:-border, border:-border] = 1.0
    eye = np.eye(num_classes + 1, dtype=np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return {"image": t(image[:, None]), "image_strong": t(strong[:, None]),
            "scribble": t(np.moveaxis(eye[scribble], -1, 1)),
            "label": t(np.moveaxis(eye[label][..., :num_classes], -1, 1)),
            "valid_mask": t(valid[:, None])}


# Start epochs of the parity holds (of the 400-epoch schedule): at epoch 0
# the entropy and soft-CE losses weigh e^-8 = 3.4e-4 of their weight
# (``gaussian_ramp_up``, max_t 80), at epoch 395 all of it, with the bank's
# momentum at 0.0175.
PARITY_EPOCHS = (0, 395)


def phase_parity(dev):
    """The kernels' step against the loss library's step, same state, at
    each start epoch of ``PARITY_EPOCHS``, TF32 off (the bounds are
    float32's)."""
    from pacingpseudo_torch.config import ExperimentConfig
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import make_pacing_train_step

    steps_per_epoch = 4
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    batch = make_batch(2, 64, 4, seed=3, dev=dev)
    for epoch in PARITY_EPOCHS:
        runs = {}
        for mode in ("auto", "off"):
            config = ExperimentConfig(
                num_classes=4, ignored_index=4, init_ch=8, hid_ch=16, batch_size=2,
                session="Experiment", do_loss_ent=True, do_decoder_consistency=True,
                do_aux_path=True, do_memory=True, compute_dtype="float32",
                use_pallas_loss=mode).validate()
            state = create_train_state(config, device=dev, seed=11)
            state.step = epoch * steps_per_epoch
            metrics = make_pacing_train_step(config, steps_per_epoch)(state, batch)
            grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
            runs[mode] = ({k: float(v) for k, v in metrics.items()}, grads,
                          state.model.aux_path.memory_bank.clone())
        (m_k, g_k, bank_k), (m_l, g_l, bank_l) = runs["auto"], runs["off"]
        tag = f"parity, epoch {epoch}"
        for k in m_l:
            _check(math.isclose(m_k[k], m_l[k], rel_tol=1e-4, abs_tol=1e-7),
                   f"{tag}: {k} {m_k[k]} vs {m_l[k]}")
        for k, want in g_l.items():
            # A conv bias that feeds a BatchNorm has a true gradient of 0: hold
            # it against its conv weight's gradient instead.
            bn_fed = k.endswith(".conv.bias") or k == "aux_path.layer_bottleneck.1.bias"
            scale = float((g_l[k[:-4] + "weight"] if bn_fed else want).abs().max())
            e = float((g_k[k] - want).abs().max())
            _check(e <= 1e-3 * scale, f"{tag}: grad {k} err {e} vs max {scale}")
        e = float((bank_k - bank_l).abs().max())
        _check(e <= 1e-4 * float(bank_l.abs().max()), f"{tag}: bank err {e}")
        print(f"{tag}: kernel step == library step over {len(g_l)} gradients and the "
              f"bank, loss_ent {m_k['loss_ent']:.6f}, loss_cr {m_k['loss_cr']:.6f}, "
              f"loss_total {m_k['loss_total']:.6f}", flush=True)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _grads_close_l2(tag, got, want, rtol):
    """Per leaf: L2 error within ``rtol`` of the leaf's L2 norm.  A conv
    bias that feeds a BatchNorm has a true gradient of 0; both sides must
    give roundoff under 1e-3 x the max gradient of its conv weight."""
    for k, w in want.items():
        if k.endswith(".conv.bias") or k == "aux_path.layer_bottleneck.1.bias":
            scale = 1e-3 * float(want[k[:-4] + "weight"].abs().max())
            _check(float(got[k].abs().max()) <= scale and float(w.abs().max()) <= scale,
                   f"{tag}: BN-fed bias grad {k} is not roundoff")
            continue
        e = float((got[k] - w).norm())
        _check(e <= rtol * float(w.norm()), f"{tag}: grad {k} L2 err {e} vs norm "
               f"{float(w.norm())}")


def _record_signs(model, signs, branches=None):
    """Forward hooks that append to ``signs`` where each ConvLayer's output
    is positive: the sign of its LeakyReLU's pre-activation.  With
    ``branches`` (a bool tensor for each ConvLayer call, in call order, as
    ``signs`` records them) each output takes the branch ``branches`` names
    instead: where the two disagree the output is scaled by the other
    branch's slope over its own, so that the gradient takes that slope too
    (the value moves by no more than the pre-activation, which is about its
    rounding there).  Returns the hooks' handles."""
    from pacingpseudo_torch.models.unet import NEGATIVE_SLOPE, ConvLayer

    def hook(module, inputs, out):
        pos = out.detach() > 0
        signs.append(pos)
        if branches is None:
            return None
        want = branches[len(signs) - 1]
        _check(want.shape == pos.shape, f"branches {tuple(want.shape)} for a ConvLayer "
               f"output {tuple(pos.shape)}")
        factor = torch.ones_like(out)
        factor[pos & ~want] = NEGATIVE_SLOPE
        factor[~pos & want] = 1 / NEGATIVE_SLOPE
        return out * factor

    return [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, ConvLayer)]


def _sign_flips(got, want):
    """Pixels whose LeakyReLU branch differs between two forwards' signs
    (``_record_signs``); a fused layer's padded canvas is cut to its
    centre; a layer whose ``want`` is None is not counted."""
    _check(len(got) == len(want), f"{len(got)} vs {len(want)} ConvLayer calls")
    flips = 0
    for a, b in zip(got, want):
        if b is None:
            continue
        if a.shape[-1] > b.shape[-1]:
            a = a[..., 1:-1, 1:-1]
        elif b.shape[-1] > a.shape[-1]:
            b = b[..., 1:-1, 1:-1]
        flips += int((a != b).sum())
    return flips


def _parity_batch(upper_bound, dev):
    """The parity phases' batch (2 x 64 x 64, 4 classes); for the upper
    bound with its last 8 rows of crop padding: all-zero label rows."""
    batch = make_batch(2, 64, 4, seed=3, dev=dev)
    if upper_bound:
        batch["label"][:, :, 56:] = 0.0
    return batch


def phase_parity_fused(fc, dev, upper_bound=False):
    """One train step at 64x64 in float32, TF32 off for convolutions and
    matmuls, through the fused conv kernels and through the unfused path
    from the same state: the Experiment step, or with ``upper_bound`` the
    upper-bound step on the bare model.  At 64x64 the gate fuses
    enc_block1, enc_block2, dec_block2 and dec_block1: 8 layers, 7 of which
    need dx.  The upper bound's batch has crop padding, and its unfused
    ``loss_ce`` is also held against ``F.cross_entropy`` of the same
    forward's logits on the label's argmax with the padding as background
    (rtol 1e-5).

    Two runs.  At the model's LeakyReLU slope: losses rtol 1e-4; float32
    differences between the two forwards can flip the LeakyReLU branch of
    single pixels whose pre-activation lies nearer 0 (ROADMAP.md Queue 3),
    and one flip moves every leaf upstream of it by up to a few 1e-3 of its
    norm, so the flips (ConvLayer outputs whose sign differs) may be at most
    1e-5 of the pre-activations and the gradients are held in L2 within
    1e-2 of each leaf's norm, or ``ROUNDOFF_L2`` where nothing flipped.
    Then with the ConvLayers' slope set to 1, which leaves no branch to
    flip, on the same batch: the gradients within ``ROUNDOFF_L2``."""
    import torch.nn.functional as F

    from pacingpseudo_torch.config import ExperimentConfig
    from pacingpseudo_torch.models import unet
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import (make_pacing_train_step,
                                               make_upper_bound_train_step)

    name = "parity (upper bound, fused conv)" if upper_bound else "parity (fused conv)"
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    slope = unet.NEGATIVE_SLOPE
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    batch = _parity_batch(upper_bound, dev)
    flags = (dict(session="Upperbound") if upper_bound else dict(
        session="Experiment", do_loss_ent=True, do_decoder_consistency=True,
        do_aux_path=True, do_memory=True, hid_ch=16))
    config = ExperimentConfig(num_classes=4, ignored_index=4, init_ch=8, batch_size=2,
                              compute_dtype="float32", **flags).validate()
    make_step = make_upper_bound_train_step if upper_bound else make_pacing_train_step
    runs = {}
    try:
        for run_slope in (slope, 1.0):
            unet.NEGATIVE_SLOPE = run_slope
            for impl in ("fused", "xla"):
                fc.set_conv_impl(impl)
                state = create_train_state(config, device=dev, seed=11)
                signs = []
                hooks = _record_signs(state.model, signs)
                fc.reset_launch_counts()
                metrics = make_step(config, steps_per_epoch=4)(state, batch)
                torch.cuda.synchronize()
                for hook in hooks:
                    hook.remove()
                grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
                runs[run_slope, impl] = ({k: float(v) for k, v in metrics.items()}, grads,
                                         dict(fc.LAUNCHES), signs)
        unet.NEGATIVE_SLOPE = slope
        if upper_bound:
            model = create_train_state(config, device=dev, seed=11).model
            with torch.no_grad():
                logits = model(batch["image"], None, train=True)["segmentation/logits"]
            label = batch["label"]
            target = torch.where(label.sum(1) > 0, label.argmax(1), 0)
            library_ce = float(F.cross_entropy(logits, target))
    finally:
        unet.NEGATIVE_SLOPE = slope
        fc.set_conv_impl("xla")
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    readings = []
    for run_slope in (slope, 1.0):
        (m_f, g_f, n_f, s_f), (m_x, g_x, n_x, s_x) = (runs[run_slope, "fused"],
                                                      runs[run_slope, "xla"])
        tag = f"{name} at slope {run_slope:g}"
        _check(n_f == {"conv_stats": 8, "bn_sums": 8, "conv_pad_out": 7}
               and not any(n_x.values()),
               f"{tag}: launches {n_f} fused, {n_x} unfused")
        for k in m_x:
            _check(math.isclose(m_f[k], m_x[k], rel_tol=1e-4, abs_tol=1e-7),
                   f"{tag}: {k} {m_f[k]} vs {m_x[k]}")
        flips, signs = _sign_flips(s_f, s_x), sum(t.numel() for t in s_x)
        bound = ROUNDOFF_L2 if run_slope == 1.0 or not flips else 1e-2
        if run_slope != 1.0:
            _check(flips <= 1e-5 * signs,
                   f"{tag}: {flips} of {signs} LeakyReLU branches differ")
        _grads_close_l2(tag, g_f, g_x, bound)
        worst, leaf = max((float((g_f[k] - g_x[k]).norm() / g_x[k].norm().clamp_min(1e-30)),
                           k) for k in g_x if not k.endswith("bias"))
        branches = (f"{flips} of {signs} LeakyReLU branches differ" if run_slope != 1.0
                    else "no branch")
        readings.append(f"slope {run_slope:g}: worst relative L2 error of a weight "
                        f"{worst:.2e} ({leaf}), held at {bound:g}; {branches}")
    extra = ""
    if upper_bound:
        m_x = runs[slope, "xla"][0]
        _check(bool((batch["label"].sum(1) == 0).any())
               and math.isclose(m_x["loss_ce"], library_ce, rel_tol=1e-5),
               f"{name}: loss_ce {m_x['loss_ce']} vs F.cross_entropy {library_ce} on a "
               "batch with crop padding")
        extra = f", loss_ce {m_x['loss_ce']:.6f} == F.cross_entropy {library_ce:.6f}"
    print(f"{name}: fused step == unfused step over {len(g_x)} gradients "
          f"({'; '.join(readings)}), launches {n_f}, loss_total "
          f"{runs[slope, 'fused'][0]['loss_total']:.6f}{extra}", flush=True)


def _experiment_config(dataset="chaos"):
    """The Experiment session at ``dataset``'s shape, classes and ignore
    index (CHAOS by default)."""
    from pacingpseudo_torch.config import DATASETS, ExperimentConfig
    spec = DATASETS[dataset]
    return ExperimentConfig(
        dataset=dataset, num_classes=spec.num_classes, ignored_index=spec.ignored_index,
        session="Experiment", do_loss_ent=True, do_decoder_consistency=True,
        do_aux_path=True, do_memory=True).validate()


def _conv_configs():
    """The sessions whose fused layers the ConvLayer kernels are held at: the
    Experiment and upper-bound sessions at CHAOS's shape, and the Experiment
    session at each cardiac dataset's."""
    return (_experiment_config(), _upper_bound_config(),
            *(_experiment_config(dataset) for dataset in CARDIAC))


def _upper_bound_config():
    """The Upperbound session at the same shape: the bare UNet, CE and the
    Dice loss on the labels, no strong stream."""
    from pacingpseudo_torch.config import ExperimentConfig
    return ExperimentConfig(session="Upperbound", loss_dice=True).validate()


def _reset_launch_counts(counters):
    for module in counters:
        module.reset_launch_counts()


def _launch_counts(counters):
    return {k: v for module in counters for k, v in module.LAUNCHES.items()}


def phase_train(name, counters, expected, dev, next_batch, augment_fn=None,
                generator=None, steps_warm=3, steps_timed=5, config=None):
    """The full-width train step of ``config``'s session (the Experiment
    session by default; the Upperbound session's bare model and
    upper-bound step), ``steps_warm + steps_timed`` times, on the batches
    ``next_batch()`` gives.  The launch counts are set
    to 0 just before the first step and read just after the last; each
    kernel of ``expected`` (name -> launches a step) must have launched that
    many times per step, and no other kernel at all.  BatchNorm running
    statistics must move in ``enc_block1`` (fused under the fused conv
    impl) and in the dilated ``enc_block5`` (never fused).  Returns the
    state, the counts and the median ms of the timed steps."""
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import (make_pacing_train_step,
                                               make_upper_bound_train_step)

    config = config or _experiment_config()
    siamese = config.session != "Upperbound"
    state = create_train_state(config, device=dev)
    model = state.model
    n_params = sum(p.numel() for p in model.parameters())
    make_step = make_pacing_train_step if siamese else make_upper_bound_train_step
    train_step = make_step(config, steps_per_epoch=100, augment_fn=augment_fn)
    bns = {k: getattr(model.backbone, k).conv_block.conv_layer1.norm_op
           for k in ("enc_block1", "enc_block5")}
    stats0 = {k: (bn.running_mean.clone(), bn.running_var.clone())
              for k, bn in bns.items()}
    print(f"{name}: {n_params} parameters, batch {config.batch_size} x "
          f"{config.spec.input_size}, {config.compute_dtype}", flush=True)

    steps = steps_warm + steps_timed
    batches = [next_batch() for _ in range(steps)]
    torch.cuda.synchronize()
    _reset_launch_counts(counters)
    step_ms, losses = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        metrics = train_step(state, batch, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
        if i == 0 and state.memory_bank is not None:
            _check(float(state.memory_bank.abs().sum()) > 0,
                   f"{name}: the memory bank is still zero after step 1")
    launches = _launch_counts(counters)

    if not siamese:
        _check(not model.do_aux_path and {"loss_ce", "loss_dice"} <= set(losses[0]),
               f"{name}: the upper-bound step has an aux path or lacks a loss: "
               f"{sorted(losses[0])}")

    for i, m in enumerate(losses):
        _check(all(math.isfinite(v) for v in m.values()),
               f"{name}: non-finite metrics at step {i}: {m}")
    _check(all(launches[k] == n * steps for k, n in expected.items())
           and all(v == 0 for k, v in launches.items() if k not in expected),
           f"{name}: kernel launches {launches} over {steps} steps, expected "
           f"{expected} a step and none of the others")
    for k, bn in bns.items():
        _check(not (torch.equal(bn.running_mean, stats0[k][0])
                    or torch.equal(bn.running_var, stats0[k][1])),
               f"{name}: BatchNorm running statistics of {k} did not move")
    median_ms = statistics.median(step_ms[steps_warm:])
    print(f"{name}: losses step 1 {losses[0]}", flush=True)
    print(f"{name}: losses step {steps} {losses[-1]}", flush=True)
    print(f"{name}: step ms {[round(t, 3) for t in step_ms]}, median of the "
          f"{steps_timed} timed steps {median_ms:.3f} ms", flush=True)
    return state, launches, median_ms


def phase_eval(name, state, batch):
    """One eval step on an NCHW batch: logits of the expected shape, a
    finite loss, finite Dice wherever the label holds the class."""
    from pacingpseudo_torch.train.step import make_pacing_eval_step

    config = _experiment_config()
    loss_pce, dice, logits = make_pacing_eval_step(config)(state, batch)
    torch.cuda.synchronize()
    _check(tuple(logits.shape) == (batch["image"].shape[0], config.num_classes)
           + tuple(batch["image"].shape[2:]),
           f"{name}: logits shape {tuple(logits.shape)}")
    _check(math.isfinite(float(loss_pce)), f"{name}: loss_pce is not finite")
    label_sum = batch["label"].sum(dim=(2, 3))
    _check(bool(torch.isfinite(dice[label_sum > 0]).all()),
           f"{name}: Dice is not finite for a class present in the label")
    print(f"{name}: loss_pce {float(loss_pce):.6f}, mean Dice per class "
          f"{torch.nanmean(dice, dim=0).tolist()}", flush=True)
    return dice


def make_raw_pool(root, dev, num_slices=48):
    """Write the seeded synthetic CHAOS pool under ``root`` and open it as a
    user would: ``(raw_batches, val_loader, config)``.  ``raw_batches`` is a
    generator that walks the shuffled training loader epoch after epoch and
    hands each raw batch over on the device; close it to stop the loader's
    threads."""
    from pacingpseudo_torch.data.npz_dataset import BatchLoader, SliceDataset
    from pacingpseudo_torch.data.splits import read_fold_split
    from pacingpseudo_torch.data.synthetic import write_synthetic_dataset

    config = _experiment_config()
    spec = config.spec
    t0 = time.perf_counter()
    write_synthetic_dataset(root, config.dataset, num_slices, spec.input_size,
                            spec.num_classes, spec.ignored_index,
                            modality=config.modality, seed=config.seed)
    print(f"augment: wrote {num_slices} synthetic {spec.input_size} slices in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    train_files, val_files = read_fold_split(root, config.dataset, config.fold,
                                             config.modality)
    kw = dict(num_classes=spec.num_classes, ignored_index=spec.ignored_index)
    train_set = SliceDataset(train_files, **kw)
    val_set = SliceDataset(val_files, canvas_size=train_set.canvas_size, **kw)
    _check(train_set.canvas_size == spec.input_size[0],
           f"augment: canvas {train_set.canvas_size}")
    loader = BatchLoader(train_set, config.batch_size, shuffle=True,
                         drop_last=True, seed=config.seed, num_threads=4)
    val_loader = BatchLoader(val_set, config.batch_size, num_threads=4)
    print(f"augment: {len(train_set)} training and {len(val_set)} validation "
          f"slices, {len(loader)} batches of {config.batch_size} an epoch",
          flush=True)
    return _device_batches(loader, dev), val_loader, config


def _device_batches(loader, dev):
    """The shuffled ``loader``'s raw batches on ``dev``, epoch after epoch."""
    from pacingpseudo_torch.data.npz_dataset import raw_batch_to_device

    epoch = 0
    while True:
        loader.set_epoch(epoch)
        for batch in loader:
            yield raw_batch_to_device(batch, dev)
        epoch += 1


def phase_augment(wt, wc, dev, raw, config, flush):
    """``augment_batch`` at full width on one raw batch from the loader.
    Returns the train augmentation on the default route and on the other
    card route of the warp (``"kernel"``, the table, where the default is
    ``"direct"``, and the reverse)."""
    import dataclasses

    from pacingpseudo_torch.aug import engine
    from pacingpseudo_torch.aug.presets import base_params_for, strong_params_for
    from pacingpseudo_torch.ops import warp

    n, (ch, cw), c = config.batch_size, config.spec.input_size, config.num_classes
    base = base_params_for(config.dataset)
    strong = strong_params_for(config.augmentations, config.strength)
    _check(base.image_interp == "bicubic" and base.warp_table_impl == "auto",
           f"augment: unexpected defaults {base}")
    by_route = {r: dataclasses.replace(base, warp_table_impl=r)
                for r in ("direct", "kernel", "plain")}
    auto = warp.AUTO_CUDA_ROUTE
    _check(auto in ("direct", "kernel"), f"augment: auto routes to {auto}")

    def run(params, seed=config.seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return engine.augment_batch(raw, gen, params, strong, do_strong=True)

    def launches():
        return wt.LAUNCHES["warp_table"], wc.LAUNCHES["warp_cubic"]

    wt.reset_launch_counts()
    wc.reset_launch_counts()
    out = run(base)
    torch.cuda.synchronize()
    want = (0, 1) if auto == "direct" else (1, 0)
    _check(launches() == want, f"augment: (warp_table, warp_cubic) launches "
           f"{launches()} in one call on the default route ({auto}), want {want}")
    shapes = {"image": (n, 1, ch, cw), "image_strong": (n, 1, ch, cw),
              "label": (n, c, ch, cw), "scribble": (n, c + 1, ch, cw),
              "valid_mask": (n, 1, ch, cw)}
    _check(sorted(out) == sorted(shapes), f"augment: keys {sorted(out)}")
    for k, shape in shapes.items():
        _check(tuple(out[k].shape) == shape and out[k].dtype == torch.float32,
               f"augment: {k} is {tuple(out[k].shape)} {out[k].dtype}")
        _check(bool(torch.isfinite(out[k]).all()), f"augment: {k} is not finite")
    _check(bool((out["scribble"].sum(1) == 1).all()),
           "augment: the scribble one-hot does not sum to 1 everywhere")
    _check(bool((out["label"].sum(1) <= 1).all()),
           "augment: the label one-hot sums to more than 1 somewhere")
    mask = out["valid_mask"]
    _check(bool(((mask == 0) | (mask == 1)).all()) and float(mask.mean()) > 0.5,
           f"augment: valid_mask is not 0/1 or covers {float(mask.mean()):.3f}")
    cnt = mask.sum(dim=(1, 2, 3))
    mean = (out["image"] * mask).sum(dim=(1, 2, 3)) / cnt
    var = ((out["image"] - mean.view(-1, 1, 1, 1)) ** 2 * mask).sum(dim=(1, 2, 3)) / cnt
    _check(float(mean.abs().max()) < 1e-3 and float((var.sqrt() - 1).abs().max()) < 1e-3,
           f"augment: weak image mean {mean.tolist()} std {var.sqrt().tolist()} "
           "inside valid_mask (want 0 and 1 within 1e-3)")
    _check(not torch.equal(out["image"], out["image_strong"]),
           "augment: the strong image equals the weak image")

    # Every route gives the same outputs, from the same raw batch and seed.
    outs = {r: run(p) for r, p in by_route.items()}
    torch.cuda.synchronize()
    for r, o in outs.items():
        for k in shapes:
            _check(torch.equal(o[k], out[k]),
                   f"augment: {k} differs between the {r} route and the default route "
                   f"({auto}) in {int((o[k] != out[k]).sum())} values, max abs "
                   f"{float((o[k] - out[k]).abs().max())}")
    want = (want[0] + 1, want[1] + 1)
    _check(launches() == want,
           f"augment: (warp_table, warp_cubic) launches {launches()} after the default, "
           f"direct, kernel and plain routes, want {want} (the plain route launches none)")
    print(f"augment: checks ok, valid coverage {float(mask.mean()):.3f}; the direct, "
          f"kernel and plain routes equal the default route ({auto}) bit for bit",
          flush=True)

    # What one call costs on the two card routes, in turns (kernel, direct,
    # direct, kernel, ...), and inside it the parts of the warp.  The call is
    # many small launches, so its time on the card's clock includes the gaps
    # the host leaves between them.
    reps = 10
    ab = {"kernel": [], "direct": []}
    for i in range(reps):
        for r in (("kernel", "direct") if i % 2 == 0 else ("direct", "kernel")):
            ab[r].append(_time_ms(lambda: run(by_route[r]), flush, 2))
    ab = {r: statistics.median(v) for r, v in ab.items()}
    faster = min(ab, key=ab.get)
    print(f"augment: A/B of augment_batch in turns, median of {reps} calls each: "
          f"direct {ab['direct']:.4f} ms, kernel (table) {ab['kernel']:.4f} ms; "
          f"faster: {faster}; auto routes to {auto}", flush=True)
    _check(faster == auto, f"augment: auto routes to {auto}, but {faster} was faster "
           f"in this run ({ab})")

    draws = engine.draw_base(n, base, torch.Generator(device=dev).manual_seed(1), dev)
    size = raw["size"]
    sy, sx, _, _ = engine.base_source_coordinates(size, draws, base)
    planes = (raw["image"].float(), raw["label"].float(), raw["scribble"].float())
    bound_h, bound_w = size[:, 0].float(), size[:, 1].float()
    y0, x0, fy, fx = warp.warp_anchor(sy, sx, bound_h, bound_w)
    table = wt.build_warp_table(*planes)
    rows = warp.gather_warp_rows(table, y0, x0, planes[0].shape[2])
    lo, hi = (t.reshape(-1).contiguous()
              for t in warp.live_range(planes[0], bound_h, bound_w))
    treps = 20
    ms = {
        "augment_batch (auto)": _time_ms(lambda: run(base), flush, treps),
        "augment_batch, plain table": _time_ms(lambda: run(by_route["plain"]), flush, treps),
        "table build": _time_ms(lambda: wt.build_warp_table(*planes), flush, treps),
        "row gather": _time_ms(
            lambda: warp.gather_warp_rows(table, y0, x0, planes[0].shape[2]), flush, treps),
        "interpolation + vote": _time_ms(
            lambda: warp.interpolate_warp_rows(rows, planes[0], y0, x0, fy, fx,
                                               c + 1, bound_h, bound_w), flush, treps),
        "table route warp (build + gather + interpolation + vote)": _time_ms(
            lambda: warp.fused_warp_sample_cubic(*planes, sy, sx, c + 1, bound_h, bound_w,
                                                 table_impl="kernel"), flush, treps),
        "warp_cubic kernel": _time_ms(
            lambda: wc.launch(*planes, sy.contiguous(), sx.contiguous(), bound_h, bound_w,
                              lo, hi, c + 1), flush, treps),
        "direct route warp (live range + warp_cubic)": _time_ms(
            lambda: wc.warp_sample_cubic(*planes, sy, sx, c + 1, bound_h, bound_w),
            flush, treps),
    }
    print("augment: ms per call, median of %d with L2 flushed: %s" % (
        treps, ", ".join(f"{k} {v:.4f}" for k, v in ms.items())), flush=True)
    other = "kernel" if auto == "direct" else "direct"
    return (engine.make_train_augment_fn(base, strong, do_strong=True),
            engine.make_train_augment_fn(by_route[other], strong, do_strong=True))


def phase_eval_raw(state, val_loader, config, dev):
    """``eval_preprocess_batch`` on a raw validation batch, then the eval
    step; the live-region mask must reach the Dice."""
    from pacingpseudo_torch.aug.engine import eval_preprocess_batch
    from pacingpseudo_torch.data.npz_dataset import raw_batch_to_device
    from pacingpseudo_torch.train.step import make_pacing_eval_step

    raw = raw_batch_to_device(next(iter(val_loader)), dev)
    batch = eval_preprocess_batch(raw, config.num_classes)
    n, s = raw["image"].shape[:2]
    _check(tuple(batch["region_mask"].shape) == (n, 1, s, s)
           and bool((batch["region_mask"] == 1).all()),
           "eval (raw): region_mask does not cover the full 256x256 slices")
    dice = phase_eval("eval (raw)", state, batch)
    hidden = dict(batch, region_mask=torch.zeros_like(batch["region_mask"]))
    _, dice_hidden, _ = make_pacing_eval_step(config)(state, hidden)
    _check(bool(torch.isnan(dice_hidden).all()) and not bool(torch.isnan(dice).all()),
           "eval (raw): region_mask does not reach dice_per_class")


def _state_tensors(state):
    """Every tensor of a train state: the model's state_dict (parameters,
    BatchNorm statistics, the bank) and Adam's state."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        for k, v in state.optimizer.state[p].items():
            out[f"adam.{name}.{k}"] = v
    return out


def _check_states_equal(tag, got, want):
    a, b = _state_tensors(got), _state_tensors(want)
    _check(got.step == want.step and sorted(a) == sorted(b),
           f"{tag}: step {got.step} vs {want.step}, {len(a)} vs {len(b)} tensors")
    bad = [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]
    _check(not bad, f"{tag}: {len(bad)} tensors differ, e.g. {bad[:3]}")
    return len(a)


def phase_loop(dev, counters, data_root, smi):
    """The epoch loop at full width (``train/loop.py``): the Experiment
    session with ``ref_quirk_bn_eval_after_first_epoch`` for 2 epochs of 3
    steps on the synthetic pool, a checkpoint every epoch.  Checks the
    artifacts, the frozen-BN step in epoch 1 (BatchNorm statistics equal in
    ``ckp_0`` and ``ckp_1``, parameters not), ``best_ckp`` written exactly
    when an epoch's Dice beat 0, and one launch of each loss kernel and at
    least one of the warp kernel a step.  Then a run stopped after epoch 0
    into a fresh directory: its ``ckp_0`` and a save/restore of its final
    state give that state back bit for bit (timed), and the resumed run
    finishes epoch 1.  Prints the epochs' seconds and slices/s and the
    checkpoint times with the card's name and power limit."""
    import dataclasses
    import re

    from pacingpseudo_torch.train import checkpoint as ckpt
    from pacingpseudo_torch.train import loop
    from pacingpseudo_torch.train.state import create_train_state

    config = dataclasses.replace(_experiment_config(), epoch=2, ckp_interval=1,
                                 ref_quirk_bn_eval_after_first_epoch=True,
                                 **EAGER_LOOP)
    steps = 3
    runs = os.path.join(data_root, "runs")
    torch.cuda.synchronize()
    _reset_launch_counts(counters)
    full_dir, state = loop._train_driver(config, data_root, os.path.join(runs, "full"),
                                         max_steps_per_epoch=steps, device=dev)
    torch.cuda.synchronize()
    launches = _launch_counts(counters)
    n = config.epoch * steps
    _check(state.step == n, f"loop: {state.step} steps, want {n}")
    _check(launches["fused_loss_fwd"] == launches["fused_loss_bwd"] == n
           and launches["warp_cubic"] >= n
           and all(v == 0 for k, v in launches.items()
                   if k not in ("fused_loss_fwd", "fused_loss_bwd", "warp_cubic")),
           f"loop: kernel launches {launches} over {n} steps")
    for rel in ("log.txt", "config.json", "valdice.npz", "ckps/ckp_0", "ckps/ckp_1"):
        _check(os.path.exists(os.path.join(full_dir, rel)), f"loop: {rel} is missing")
    valdice = np.load(os.path.join(full_dir, "valdice.npz"))["valdice"]
    _check(valdice.shape == (2,) and bool(np.isfinite(valdice).all()),
           f"loop: valdice {valdice}")
    _check(os.path.isdir(os.path.join(full_dir, "best_ckp")) == bool(valdice.max() > 0),
           f"loop: best_ckp written {os.path.isdir(os.path.join(full_dir, 'best_ckp'))} "
           f"with valdice {valdice}: it is written exactly when an epoch beats 0")
    log = open(os.path.join(full_dir, "log.txt")).read()
    _check("epoch 001 on: frozen-BN step" in log, "loop: no frozen-BN step in epoch 1")
    sd0, sd1 = (torch.load(os.path.join(full_dir, "ckps", f"ckp_{e}", ckpt.MODEL_FILE))
                for e in (0, 1))
    stats = [k for k in sd0 if k.endswith(("running_mean", "running_var"))]
    _check(all(torch.equal(sd0[k], sd1[k]) for k in stats)
           and not torch.equal(sd0["backbone.final_conv.weight"],
                               sd1["backbone.final_conv.weight"]),
           "loop: epoch 1 moved the BatchNorm statistics or not the weights")
    epochs = re.findall(r"epoch: (\d+), .*, ([\d.]+) s/epoch, ([\d.]+) slices/s", log)
    saves = re.findall(r"checkpoint (\S+) saved in ([\d.]+) s", log)
    _check(len(epochs) == 2, f"loop: epoch lines {epochs}")
    print(f"loop: {smi}: epochs (s, slices/s) {[(float(a), float(b)) for _, a, b in epochs]}, "
          f"valdice {valdice.tolist()}, checkpoint saves (s) {saves}, launches {launches}",
          flush=True)
    del state

    part_dir = os.path.join(runs, "part")
    _, stopped = loop._train_driver(config, data_root, part_dir, max_steps_per_epoch=steps,
                                    stop_after_epoch=0, device=dev)
    _check(sorted(os.listdir(os.path.join(part_dir, "ckps"))) == ["ckp_0"],
           "loop: stop_after_epoch=0 did not leave ckp_0 alone")
    restored = ckpt.restore_checkpoint(os.path.join(part_dir, "ckps", "ckp_0"),
                                       create_train_state(config, device=dev, seed=7))
    count = _check_states_equal("loop: ckp_0 restored", restored, stopped)
    probe = os.path.join(runs, "probe_ckp")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_checkpoint(probe, stopped)
    t1 = time.perf_counter()
    ckpt.restore_checkpoint(probe, restored)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _check_states_equal("loop: save/restore", restored, stopped)
    del restored, stopped
    _, resumed = loop._train_driver(dataclasses.replace(config, resume=True), data_root,
                                    part_dir, max_steps_per_epoch=steps, device=dev)
    log = open(os.path.join(part_dir, "log.txt")).read()
    _check(resumed.step == n and "resumed from" in log and "epoch: 001" in log
           and os.path.isdir(os.path.join(part_dir, "ckps", "ckp_1")),
           f"loop: the resumed run ended at step {resumed.step}")
    print(f"loop: {smi}: stop after epoch 0 and resume: ckp_0 and a save/restore give the "
          f"stopped state back bit for bit ({count} tensors); checkpoint save "
          f"{t1 - t0:.3f} s, restore {t2 - t1:.3f} s; the resumed run finished epoch 1",
          flush=True)
    return os.path.join(full_dir, "ckps", "ckp_1")


def phase_loop_upper_bound(dev, counters, data_root, smi):
    """The epoch loop of the Upperbound session at full width: 2 epochs of
    3 steps on the synthetic pool with ``ref_quirk_bn_eval_after_first_epoch``,
    a checkpoint every epoch, validation on the card.  Checks the artifacts,
    the log's ``loss_ce`` and ``loss_dice``, the frozen-BN step in epoch 1,
    a checkpoint of ``backbone.*`` keys alone (the layout that the JAX
    importer reads into JAX's upper-bound state, held by a CPU test), and
    one ``warp_cubic`` launch a step and no other kernel.  Returns the
    final checkpoint."""
    import dataclasses
    import re

    from pacingpseudo_torch.train import checkpoint as ckpt
    from pacingpseudo_torch.train import loop

    config = dataclasses.replace(_upper_bound_config(), epoch=2, ckp_interval=1,
                                 ref_quirk_bn_eval_after_first_epoch=True,
                                 **EAGER_LOOP)
    steps = 3
    torch.cuda.synchronize()
    _reset_launch_counts(counters)
    run_dir, state = loop._train_driver(config, data_root,
                                        os.path.join(data_root, "runs", "upper_bound"),
                                        max_steps_per_epoch=steps, device=dev)
    torch.cuda.synchronize()
    launches = _launch_counts(counters)
    n = config.epoch * steps
    _check(state.step == n and not state.model.do_aux_path,
           f"loop (upper bound): {state.step} steps, want {n}")
    _check(launches["warp_cubic"] == n
           and all(v == 0 for k, v in launches.items() if k != "warp_cubic"),
           f"loop (upper bound): kernel launches {launches} over {n} steps")
    for rel in ("log.txt", "config.json", "valdice.npz", "ckps/ckp_0", "ckps/ckp_1"):
        _check(os.path.exists(os.path.join(run_dir, rel)),
               f"loop (upper bound): {rel} is missing")
    valdice = np.load(os.path.join(run_dir, "valdice.npz"))["valdice"]
    _check(valdice.shape == (2,) and bool(np.isfinite(valdice).all()),
           f"loop (upper bound): valdice {valdice}")
    log = open(os.path.join(run_dir, "log.txt")).read()
    _check("loss_ce" in log and "loss_dice" in log and "epoch 001 on: frozen-BN step" in log
           and "val: 001, loss: " in log, "loop (upper bound): the log lacks a line")
    sd0, sd1 = (torch.load(os.path.join(run_dir, "ckps", f"ckp_{e}", ckpt.MODEL_FILE))
                for e in (0, 1))
    _check(all(k.startswith("backbone.") for k in sd1) and sorted(sd0) == sorted(sd1),
           f"loop (upper bound): checkpoint keys {sorted(sd1)[:3]}...")
    stats = [k for k in sd0 if k.endswith(("running_mean", "running_var"))]
    _check(all(torch.equal(sd0[k], sd1[k]) for k in stats)
           and not torch.equal(sd0["backbone.final_conv.weight"],
                               sd1["backbone.final_conv.weight"]),
           "loop (upper bound): epoch 1 moved the BatchNorm statistics or not the weights")
    epochs = re.findall(r"epoch: (\d+), .*, ([\d.]+) s/epoch, ([\d.]+) slices/s", log)
    saves = re.findall(r"checkpoint (\S+) saved in ([\d.]+) s", log)
    print(f"loop (upper bound): {smi}: epochs (s, slices/s) "
          f"{[(float(a), float(b)) for _, a, b in epochs]}, valdice {valdice.tolist()}, "
          f"checkpoint saves (s) {saves}, launches {launches}", flush=True)
    return os.path.join(run_dir, "ckps", "ckp_1")


# Test slices of the inference phase: the test fifth of a 1,916-slice
# five-fold pool (README.md's full-shape sweep), in pseudo-patients of 24
# slices as write_synthetic_dataset groups them at study scale.
TEST_FOLD_SLICES = 384
TEST_PATIENT_SLICES = 24
INFER_WORKERS = 4       # the host threads of HD95: the inference CLI's default


def make_test_fold(root, seed, num_slices=TEST_FOLD_SLICES, size=None):
    """Write ``num_slices`` seeded synthetic CHAOS test slices of 256x256
    (or ``size``; the phantoms of ``write_synthetic_dataset``) and the split
    file that names them as fold 1's test set, under ``root``.  Inference
    reads no scribble, so each slice's is all ignore (the skeleton
    scribbles would take ~0.2 s a slice of host time)."""
    from pacingpseudo_torch.data.synthetic import make_phantom

    spec = _experiment_config().spec
    size = tuple(size or spec.input_size)
    t0 = time.perf_counter()
    slices = os.path.join(root, "chaos", "slices")
    split = os.path.join(root, "chaos", "train_test_split", "five_fold_split", "t1")
    os.makedirs(slices)
    os.makedirs(split)
    rng = np.random.RandomState(seed)
    scb = np.full(size, spec.ignored_index, np.float32)
    names = []
    for i in range(num_slices):
        img, lab = make_phantom(rng, size, spec.num_classes, "easy")
        uid = f"pat{i // TEST_PATIENT_SLICES:03d}_slice{i % TEST_PATIENT_SLICES:03d}"
        np.savez(os.path.join(slices, uid + ".npz"), uid=uid, img=img,
                 lab=lab.astype(np.float32), scb=scb)
        names.append(f"slices/{uid}.npz")
    with open(os.path.join(split, f"test_fold{_experiment_config().fold}.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    print(f"inference: wrote {num_slices} synthetic {size} test slices of "
          f"{-(-num_slices // TEST_PATIENT_SLICES)} patients in {time.perf_counter() - t0:.2f} s",
          flush=True)


def phase_inference(dev, counters, data_root, checkpoints, smi, batch_size=8, passes=2,
                    host_slices=48):
    """``run_inference`` on the test split under ``data_root``
    (``make_test_fold``) at ``batch_size``, bf16, from each ``(tag, config,
    checkpoint)``: the bare upper-bound model's and the siamese Experiment
    model's, whose backbone is taken.  Checks
    ``eval_data.npz`` (``dicearr`` and ``hd95arr`` of shape (N_test, 5), the
    uids in the loader's order), Dice in [0, 1] or NaN, no kernel launched,
    and each slice's ``dicearr`` row against ``dice_per_class_hard`` of the
    argmax of the session's eval step on the card, from the same
    checkpoint, on the same batches of the float16-rounded images (rtol
    1e-6: the device forms each quotient in float32, the host in float64).
    Times the forward alone (upload, normalisation, UNet, argmax) over
    ``passes`` passes after one warm-up pass, reads the whole run's slices/s
    with HD95 from ``run_inference``, and times the host metrics of one
    slice (``compute_dice_hard`` and ``compute_95hd`` of the eval step's
    argmax) in one thread and in the run's pool of host threads over the
    first ``host_slices`` slices."""
    from pacingpseudo_torch.aug.engine import eval_preprocess_batch
    from pacingpseudo_torch.data.npz_dataset import (BatchLoader, SliceDataset,
                                                     raw_batch_to_device)
    from pacingpseudo_torch.data.splits import read_test_split
    from pacingpseudo_torch.evals import infer
    from pacingpseudo_torch.evals.dice import compute_dice_hard, dice_per_class_hard
    from pacingpseudo_torch.evals.hd import compute_95hd
    from pacingpseudo_torch.train import checkpoint as ckpt
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import (make_pacing_eval_step,
                                               make_upper_bound_eval_step)

    spec = _experiment_config().spec
    c, fold = spec.num_classes, _experiment_config().fold
    ds = SliceDataset(read_test_split(data_root, spec.name, fold), c, spec.ignored_index)
    batches = list(BatchLoader(ds, batch_size))
    n_test = len(ds)
    uids = [u for b in batches for u in b["uid"]]
    _check(n_test == TEST_FOLD_SLICES
           and all(bool((b["size"] == ds.canvas_size).all()) for b in batches),
           f"inference: {n_test} test slices, or some do not fill their canvases")
    for tag, config, path in checkpoints:
        siamese = config.session != "Upperbound"
        keys = torch.load(os.path.join(path, ckpt.MODEL_FILE)).keys()
        _check(ckpt.saved_is_siamese(path)
               and any(k.startswith("aux_path.") for k in keys) == siamese,
               f"inference ({tag}): checkpoint keys {sorted(keys)[:3]}...")
        kwargs = dict(input_ch=config.input_ch, init_ch=config.init_ch,
                      max_ch=config.max_ch, output_stride=config.output_stride,
                      is_stride_conv=config.is_stride_conv,
                      is_trans_conv=config.is_trans_conv)
        model = infer.load_inference_model(path, c, kwargs, "bfloat16", dev)

        def forward_pass():
            for raw in batches:
                image = torch.from_numpy(raw["image"].astype(np.float16)).to(dev)
                infer.forward_hard(model, image, torch.from_numpy(raw["size"]).to(dev))

        forward_pass()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(passes):
            forward_pass()
        torch.cuda.synchronize()
        forward_rate = passes * n_test / (time.perf_counter() - t0)

        out_dir = os.path.join(data_root, "inference", tag.split()[0])
        os.makedirs(out_dir)
        _reset_launch_counts(counters)
        res = infer.run_inference(spec.name, fold, path, data_root, out_dir,
                                  batch_size=batch_size, model_kwargs=kwargs,
                                  compute_dtype="bfloat16", num_workers=INFER_WORKERS,
                                  device=dev)
        launches = _launch_counts(counters)
        saved = np.load(os.path.join(out_dir, "eval_data.npz"))
        dicearr, hd95arr = saved["dicearr"], saved["hd95arr"]
        _check(dicearr.shape == hd95arr.shape == (n_test, c)
               and list(saved["uids"]) == uids == res["uids"],
               f"inference ({tag}): eval_data.npz {dicearr.shape} {hd95arr.shape}, uids "
               f"{list(saved['uids'])[:3]}...")
        finite = dicearr[np.isfinite(dicearr)]
        _check(bool(((finite >= 0) & (finite <= 1)).all()) and not any(launches.values()),
               f"inference ({tag}): Dice outside [0, 1] or kernels launched {launches}")

        state = create_train_state(config, device=dev)
        ckpt.restore_checkpoint(path, state)
        eval_step = (make_pacing_eval_step if siamese else make_upper_bound_eval_step)(config)
        rows, preds = [], []
        for raw in batches:
            batch = raw_batch_to_device(raw, dev)
            batch["image"] = batch["image"].half().float()
            logits = eval_step(state, eval_preprocess_batch(batch, c))[-1]
            preds.append(logits.argmax(dim=1))
            rows.append(dice_per_class_hard(preds[-1], batch["label"].long(), c))
        want = torch.cat(rows).cpu().numpy()
        preds = torch.cat(preds)[:host_slices].cpu().numpy()
        labels = np.concatenate([b["label"] for b in batches])[:host_slices].astype(np.int64)

        def host_metrics(pred, label):
            return compute_dice_hard(pred, label, c), compute_95hd(pred, label, c,
                                                                   spec.spacing)

        t0 = time.perf_counter()
        for pred, label in zip(preds, labels):
            host_metrics(pred, label)
        host_ms = (time.perf_counter() - t0) * 1e3 / len(preds)
        with concurrent.futures.ThreadPoolExecutor(INFER_WORKERS) as pool:
            t0 = time.perf_counter()
            list(pool.map(host_metrics, preds, labels))
            pool_ms = (time.perf_counter() - t0) * 1e3 / len(preds)
        same = np.isclose(dicearr, want, rtol=1e-6, atol=0.0, equal_nan=True)
        _check(bool(same.all()),
               f"inference ({tag}): {int((~same.all(axis=1)).sum())} of {n_test} slices' "
               f"Dice differ from the eval step's argmax: {dicearr[~same]} vs {want[~same]}")
        del model, state
        print(f"inference ({tag}): {smi}: {n_test} test slices at batch {batch_size}, bf16: "
              f"the forward alone {forward_rate:.1f} slices/s ({passes} passes), the whole "
              f"run with HD95 in {INFER_WORKERS} host threads {res['slices_per_sec']:.1f} "
              f"slices/s; Dice and HD95 on the host {host_ms:.2f} ms a slice in one "
              f"thread, {pool_ms:.2f} ms a slice in {INFER_WORKERS} ({len(preds)} slices); "
              f"Dice {res['dice']:.4f}, "
              f"HD95 {res['hd95']:.2f}, per patient {res['dice_per_patient']:.4f} over "
              f"{res['num_patients']} patients; each slice's Dice equals the eval step's",
              flush=True)


def _fused_step_plan(fc, config, name):
    """The launches a fused step of ``config``'s session makes (``conv_stats``
    and ``bn_sums`` once per fused layer, ``conv_pad_out`` once per fused
    layer whose input needs a gradient) and the GEMMs' routes a step, from
    ``conv_layer_shapes`` and ``conv_plan``; held against the layers JAX
    fuses at this shape (all but the four dilated ones; enc_block1's first
    layer reads the image), whose conv_stats takes the simple route."""
    from scripts.reckon_fused_conv_bounds import conv_layer_shapes

    layers = [s for s in conv_layer_shapes(config) if s[6]]
    kernels = {"conv_stats": len(layers), "bn_sums": len(layers),
               "conv_pad_out": sum(s[7] for s in layers)}
    routes = {k: {"wgmma": 0, "simple": 0} for k in GEMMS}
    for s in layers:
        for k, p in _gemm_plans(fc, torch.bfloat16, *s[1:6]).items():
            routes[k][p.route] += k == "conv_stats" or s[7]
    _check(routes == {"conv_stats": {"wgmma": FUSED_LAYERS - 1, "simple": 1},
                      "conv_pad_out": {"wgmma": FUSED_LAYERS - 1, "simple": 0}},
           f"{name}: the plan routes {routes} a step; want conv_stats "
           f"{FUSED_LAYERS - 1} wgmma + 1 simple, conv_pad_out {FUSED_LAYERS - 1} wgmma")
    _check(len(layers) == FUSED_LAYERS and kernels["conv_pad_out"] == FUSED_LAYERS - 1,
           f"{name}: {len(layers)} fused layers, {kernels['conv_pad_out']} with dx; "
           f"want {FUSED_LAYERS} and {FUSED_LAYERS - 1}")
    return kernels, routes


def _phase_fused_train(fc, name, counters, kernels, routes, dev, raw_batches, augment_fn,
                       config):
    """``phase_train`` under the conv impl ``"fused"``, then the GEMMs'
    launches by route against the plan's ``routes`` a step.  Returns the
    launches, the routes counted and the median step ms."""
    fc.set_conv_impl("fused")
    try:
        _, launches, ms = phase_train(
            name, counters, kernels, dev, lambda: next(raw_batches), augment_fn=augment_fn,
            generator=torch.Generator(device=dev).manual_seed(config.seed), config=config)
        counted = {k: dict(v) for k, v in fc.ROUTES.items()}
    finally:
        fc.set_conv_impl("xla")
    steps = launches["conv_stats"] // kernels["conv_stats"]
    _check(counted == {k: {r: n * steps for r, n in v.items()} for k, v in routes.items()},
           f"{name}: GEMM launches by route {counted} over {steps} steps, expected "
           f"{routes} a step")
    print(f"{name}: GEMM launches by route a step {routes}", flush=True)
    return launches, counted, ms


# ---------------------------------------------------------------------------
# The CUDA-graph path: chunked dispatch, the resident pool, the sweep and
# profile_dir
# ---------------------------------------------------------------------------

GRAPH_TIMED = 8          # timed steps a path in train (raw, graph)
LOOP_EPOCHS = 2
LOOP_PATIENTS = 13       # of 24 slices: fold 1 keeps 10 for training (240 slices)
LOOP_DISPATCH = 8        # steps_per_dispatch of the graph loop: 20 steps = 8 + 8 + 4
REPLAYS_PROFILED = 4
# The graph loop's per-epoch metrics against the eager loop's, beside 4 x
# the eager runs' own spread.  At full width in bfloat16 the runs part ways
# by the weight gradients' varying summation order (two eager runs' epoch-1
# loss_pce 0.9399 and 0.9274 on an NVIDIA H100 80GB HBM3); in float32 at
# init_ch 8 on deterministic cuDNN much less (1.3618 and 1.3627).
LOOP_RTOL = 5e-2
LOOP_RTOL_F32 = 1e-3


def _release_memory():
    """Return the allocator's cached blocks to the card: the graph phases'
    private pools cannot use them, nor can a child process."""
    gc.collect()
    torch.cuda.empty_cache()


def _small_raw(seed, dev, n=2, s=64, c=4):
    """A seeded raw canvas batch of the parity phases' size (the CPU tests'
    form): noise image, random labels, scribbles on a tenth of the pixels."""
    rs = np.random.RandomState(seed)
    scribble = np.full((n, s, s), c, np.float32)
    pick = rs.rand(n, s, s) < 0.1
    scribble[pick] = rs.randint(0, c, pick.sum())
    return {"image": torch.from_numpy(rs.randn(n, s, s).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rs.randint(0, c, (n, s, s)).astype(np.float32)).to(dev),
            "scribble": torch.from_numpy(scribble).to(dev),
            "size": torch.tensor([[s, s]] * n, dtype=torch.int32, device=dev)}


def check_graph_augment(augment_fn, raws, dev):
    """``augment_fn`` captured in a CUDA graph with its generator registered:
    each replay, after the generator is seeded, equals the eager call from
    the same seed bit for bit, on the full-width raw batches ``raws``."""
    from pacingpseudo_torch.train.step import step_seed

    gen = torch.Generator(device=dev)
    static = {k: v.clone() for k, v in raws[0].items()}
    stream, current = torch.cuda.Stream(dev), torch.cuda.current_stream(dev)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        gen.manual_seed(1)
        augment_fn(static, gen)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        graph.capture_begin()
        out = augment_fn(static, gen)
        graph.capture_end()
    current.wait_stream(stream)
    for i, raw in enumerate(raws[1:]):
        seed = step_seed(1, i)
        gen.manual_seed(seed)
        want = augment_fn(raw, gen)
        for k, v in raw.items():
            static[k].copy_(v)
        gen.manual_seed(seed)
        graph.replay()
        bad = [k for k in want if not torch.equal(out[k], want[k])]
        _check(not bad, f"train (raw, graph): replayed augmentation differs from the eager "
                        f"one in {bad} (batch {i})")
    graph.reset()
    print(f"train (raw, graph): the captured augmentation equals the eager one bit for bit "
          f"on {len(raws) - 1} full-width raw batches ({sorted(out)})", flush=True)


def _bn_fed_bias(name):
    """A conv bias that feeds a BatchNorm: its true gradient is 0."""
    return name.endswith(".conv.bias") or name == "aux_path.layer_bottleneck.1.bias"


def _hold_replay(name, config, augment_fn, raws, dev, start=0):
    """One replayed update of ``config``'s raw step against the eager update
    from the same state and seeds, on ``raws[1]`` after an update on
    ``raws[0]``, held twice (:func:`_hold_replay_once`):

    * in the default mode, on the kernels the timed replays and users run:
      the yardstick is the spread of four more eager updates
      (``EAGER_RUNS_DEFAULT``), since the card adds in a varying order
      there (the align-corners upsample's backward adds with atomics,
      cuDNN's bf16 weight gradient varies), and two draws of that noise
      were once exceeded by a replay, the Upperbound step's at full width
      (one BN weight's update 1.08e-2 of its norm off against a spread of
      2.2e-3, on an NVIDIA H100 80GB HBM3);
    * under ``torch.use_deterministic_algorithms(True, warn_only=True)``
      and deterministic cuDNN, where the eager updates agree bit for bit,
      so that the replay is held against a spread of 0.  In that mode
      ``F.interpolate``'s bilinear upsample on the card is PyTorch's
      decomposition (``_upsample_linear_vec``, an ``index_put`` backward),
      not the kernel of the default mode.

    Both start at update ``start``.  Returns the phase line's summary of
    both."""
    out = ["default mode: " + _hold_replay_once(f"{name} (default mode)", config,
                                                 augment_fn, raws, dev, EAGER_RUNS_DEFAULT,
                                                 start=start)]
    modes = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        out.append("deterministic: " + _hold_replay_once(f"{name} (deterministic)", config,
                                                         augment_fn, raws, dev, EAGER_RUNS,
                                                         start=start))
    finally:
        torch.use_deterministic_algorithms(modes[0], warn_only=True)
        torch.backends.cudnn.deterministic = modes[1]
    return " || ".join(out)


def _hold_replay_once(name, config, augment_fn, raws, dev, eager_runs, ranks=None,
                      start=0):
    """The hold of :func:`_hold_replay` in the current mode; with ``ranks``
    (``parallel.mesh.RankGroup``) every state is this rank's replica, every
    update one on the ranks, and the LeakyReLU flips this rank's block's.
    The graph's first update runs eagerly (the warm-up) and the step is captured
    (``StepGraph``); its state goes through a checkpoint (the eager layout)
    into one fresh eager state a name of ``eager_runs``; then the second
    update is a replay on one side and the eager step on each of the
    others.  The first update is update ``start`` of the schedule (100
    updates an epoch).  The largest difference of ``eager_runs[1:]`` from ``"eager"``
    is the step's own spread (``yard``), taken in this run.  Each quantity
    is held at the larger of its fixed bound and 4 x yard
    (:func:`_hold_against_eager`):

    * the losses, rtol 1e-4;
    * the LeakyReLU branches that differ between the replay's forward and
      the eager one (the ConvLayer outputs' signs), at most 1e-5 of them;
    * each gradient leaf in L2, within 1e-2 of its norm where a branch
      differs and ``ROUNDOFF_L2`` where none does (``phase_parity_fused``'s
      bounds); a conv bias that feeds a BatchNorm, whose gradient is
      roundoff, at most 4 x the eager ones' largest element + 1e-3 x its
      conv weight's largest gradient;
    * each leaf's update (new minus old), 1e-2 of its norm where a branch
      differs and ``UPDATE_L2`` where none does (Adam divides by sqrt(v),
      which turns an element's gradient roundoff into a larger relative
      update error where its moments nearly cancel, and the replay's bias
      correction is the capturable one, float32 on the card); a BN-fed
      bias's within 2 lr, as ``tests/test_torch_port_step.py`` holds it.

    Returns the summary."""
    from pacingpseudo_torch.train import checkpoint as ckpt
    from pacingpseudo_torch.train.graph import StepGraph
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.parallel import mesh
    from pacingpseudo_torch.train.step import (make_pacing_train_step,
                                               make_upper_bound_train_step, seed_step)

    make = (make_upper_bound_train_step if config.session == "Upperbound"
            else make_pacing_train_step)
    state_g = create_train_state(config, device=dev, seed=11)
    state_g.step = start
    if ranks is not None:
        mesh.replicate(state_g.model, ranks)
    signs = {"graph": []}
    hooks = _record_signs(state_g.model, signs["graph"])
    step_g = make(config, 100, augment_fn=augment_fn, ranks=ranks)
    gen_g = torch.Generator(device=dev)
    graph = StepGraph()

    def reseed(n):
        seed_step(gen_g, dev, config.seed, n)

    def as_batch(raw):
        return raw

    graph.run(step_g, state_g, raws[0], as_batch, gen_g, reseed)    # eager + capture
    _check(graph.captures == 1 and graph.replays == 0 and state_g.step == start + 1,
           f"{name}: {graph.captures} captures, {graph.replays} replays")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
        ckpt.save_checkpoint(os.path.join(tmp, "ckp"), state_g)
        states = {r: ckpt.restore_checkpoint(os.path.join(tmp, "ckp"),
                                             create_train_state(config, device=dev, seed=5))
                  for r in eager_runs}
    _check(not any(g.get("capturable") for s in states.values()
                   for g in s.optimizer.param_groups),
           f"{name}: the checkpoint did not restore an eager optimizer")
    before = {k: p.detach().clone() for k, p in state_g.model.named_parameters()}
    metrics = {}
    for r, state in states.items():
        signs[r] = []
        hooks += _record_signs(state.model, signs[r])
        gen = torch.Generator(device=dev)
        seed_step(gen, dev, config.seed, state.step)
        metrics[r] = make(config, 100, augment_fn=augment_fn, ranks=ranks)(state, raws[1], gen)
    metrics["graph"] = graph.run(step_g, state_g, raws[1], as_batch, gen_g, reseed)  # replay
    torch.cuda.synchronize()
    for hook in hooks:
        hook.remove()
    states["graph"] = state_g
    _check(graph.replays == 1 and all(s.step == start + 2 for s in states.values()),
           f"{name}: {graph.replays} replays, steps {[s.step for s in states.values()]}")
    metrics = {r: {k: float(v) for k, v in m.items()} for r, m in metrics.items()}
    grads = {r: {k: p.grad.clone() for k, p in s.model.named_parameters()}
             for r, s in states.items()}
    deltas = {r: {k: p.detach() - before[k] for k, p in s.model.named_parameters()}
              for r, s in states.items()}
    n_calls = len(signs["eager"])
    signs["graph"] = signs["graph"][-n_calls:]      # the capture's, refreshed by the replay
    n_signs = sum(t.numel() for t in signs["eager"])
    flips = {r: _sign_flips(signs[r], signs["eager"]) for r in ("graph", *eager_runs[1:])}
    state_g.optimizer.zero_grad(set_to_none=True)   # the replay's gradients live in the pool
    graph.reset()
    del states, signs, state_g, before

    return "replayed update == eager update" + _hold_against_eager(
        name, "graph", "replayed", metrics, grads, deltas, flips, n_signs)


EAGER_RUNS = ("eager", "eager 2", "eager 3")
EAGER_RUNS_DEFAULT = EAGER_RUNS + ("eager 4", "eager 5")


def _hold_against_eager(name, cand, verb, metrics, grads, deltas, flips, n_signs,
                        bias_roundoff=None, leaves_held=True):
    """Hold the update ``cand`` (its ``metrics``, ``grads``, ``deltas``
    entries and its LeakyReLU branch ``flips`` against ``"eager"``) against
    the eager update ``"eager"`` beside the spread of the yardstick updates,
    every other entry of ``metrics`` (``_hold_replay``: two or four more
    eager updates from the same state and seeds; ``_dp_rank``: two from
    weights nudged by about the dtype's rounding), under the bounds
    ``_hold_replay_once`` lists.  ``bias_roundoff``: for each BN-fed bias, the
    rounding the candidate's gradient may carry beyond the eager ones'
    (the ranks add partial gradients that cancel).  Without
    ``leaves_held`` the gradients and updates of the other leaves are read
    but not held in L2.  Returns the summary's tail, with the check that
    came nearest its bound."""
    eager_runs = ("eager", *(r for r in metrics if r not in ("eager", cand)))
    m_e, lr = metrics["eager"], metrics["eager"]["lr"]
    tight = (0.0, "")

    def near(err, bound, what):
        nonlocal tight
        if bound > 0 and err / bound > tight[0]:
            tight = (err / bound, what)

    for k in m_e:
        yard = max(abs(metrics[r][k] - m_e[k]) for r in eager_runs[1:])
        diff = abs(metrics[cand][k] - m_e[k])
        near(diff, max(1e-4 * abs(m_e[k]) + 1e-7, 4 * yard), k)
        _check(diff <= max(1e-4 * abs(m_e[k]) + 1e-7, 4 * yard),
               f"{name}: {k} {metrics[cand][k]} {verb} vs {m_e[k]} eager (eager "
               f"runs' spread {yard})")
    flip_yard = max(flips[r] for r in eager_runs[1:])
    _check(flips[cand] <= max(1e-5 * n_signs, 4 * flip_yard),
           f"{name}: {flips[cand]} of {n_signs} LeakyReLU branches differ (eager runs' "
           f"spread {flip_yard})")
    bounds = {"gradient": 1e-2 if flips[cand] else ROUNDOFF_L2,
              "update": 1e-2 if flips[cand] else UPDATE_L2}
    worst = {t: (0.0, "", 0.0) for t in bounds}
    worst_bias = (0.0, "", 0.0, 0.0, 0.0, 0.0, 0.0)
    g_e, d_e = grads["eager"], deltas["eager"]
    for k in g_e:
        if _bn_fed_bias(k):
            weight = 1e-3 * float(g_e[k[:-4] + "weight"].abs().max())
            roundoff = (bias_roundoff or {}).get(k, 0.0)
            cap = max(float(grads[r][k].abs().max()) for r in eager_runs)
            got = float(grads[cand][k].abs().max())
            bound = 4 * cap + weight + roundoff
            _check(got <= bound,
                   f"{name}: the BN-fed bias gradient {k} reaches {got}; eager {cap}, "
                   f"bound {bound} (4 x eager + {weight} + roundoff {roundoff})")
            if got / bound > worst_bias[0]:
                worst_bias = (got / bound, k, got, cap, weight, roundoff, bound)
            e = float((deltas[cand][k] - d_e[k]).abs().max())
            _check(e <= 2 * lr, f"{name}: update of the BN-fed bias {k} max err {e}")
            continue
        for tag, ours in (("gradient", grads), ("update", deltas)):
            want = ours["eager"][k]
            norm = float(want.norm())
            err = float((ours[cand][k] - want).norm())
            yard = max(float((ours[r][k] - want).norm()) for r in eager_runs[1:])
            if leaves_held:
                near(err, max(bounds[tag] * norm, 4 * yard), f"{tag} of {k}")
            _check(not leaves_held or err <= max(bounds[tag] * norm, 4 * yard),
                   f"{name}: {tag} of {k} L2 err {err}, norm {norm}, eager runs' spread "
                   f"{yard}")
            if not k.endswith("bias") and err / max(norm, 1e-30) > worst[tag][0]:
                worst[tag] = (err / max(norm, 1e-30), k, yard / max(norm, 1e-30))
    held = "held at max({:g}, 4 x theirs)" if leaves_held else "read, not held"
    return (f" over {len(g_e)} leaves; "
            + "; ".join(f"worst relative L2 error of a weight's {t} {worst[t][0]:.2e} "
                        f"({worst[t][1]}; the eager runs' {worst[t][2]:.2e}), "
                        + held.format(bounds[t]) for t in bounds)
            + "; a BN-fed bias's largest gradient at most {:.2f} of its bound (worst {}: "
            "{:.3e} against 4 x {:.3e} eager + {:.3e} (1e-3 x its weight's) + {:.3e} "
            "roundoff = {:.3e})".format(*worst_bias)
            + f"; {flips[cand]} of {n_signs} LeakyReLU branches differ (eager runs "
            f"{[flips[r] for r in eager_runs[1:]]}); loss_total "
            f"{metrics[cand]['loss_total']:.6f} {verb}, {m_e['loss_total']:.6f} eager "
            f"(eager runs {[round(metrics[r]['loss_total'], 6) for r in eager_runs[1:]]})"
            f"; nearest its bound: {tight[1]} at {tight[0]:.3f} of it")


def phase_graph_parity(dev, optimizer):
    """``_hold_replay`` for the Experiment step with the augmentation inside
    at the parity phases' size (2 x 64 x 64, init_ch 8, float32, TF32 off,
    deterministic cuDNN), with ``optimizer``, from each start epoch of
    ``PARITY_EPOCHS``."""
    from pacingpseudo_torch.aug.engine import make_train_augment_fn
    from pacingpseudo_torch.aug.params import BaseAugParams, StrongAugParams
    from pacingpseudo_torch.config import ExperimentConfig

    name = f"train (raw, graph) parity, {optimizer}"
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        config = ExperimentConfig(
            num_classes=4, ignored_index=4, init_ch=8, hid_ch=16, batch_size=2,
            session="Experiment", do_loss_ent=True, do_decoder_consistency=True,
            do_aux_path=True, do_memory=True, compute_dtype="float32",
            optimizer=optimizer).validate()
        augment_fn = make_train_augment_fn(
            BaseAugParams(crop_size=(64, 64), num_classes=4, ignored_index=4),
            StrongAugParams.color(1.0), True)
        raws = [_small_raw(700 + i, dev) for i in range(2)]
        summaries = [(epoch, _hold_replay(f"{name}, epoch {epoch}", config, augment_fn,
                                          raws, dev, start=100 * epoch))
                     for epoch in PARITY_EPOCHS]
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    for epoch, summary in summaries:
        print(f"{name}, epoch {epoch}: {summary}", flush=True)


def _time_replay_and_eager(name, config, augment_fn, raws, dev, counters, ranks=None):
    """The raw step of ``config``'s session on ``raws``: the eager step
    (``make_chunked_train_step(step, 1)``) and the replay of its graph
    (``chunk`` = ``len(raws)``), each from a fresh seeded state; per path
    the first dispatch warms up (for the graph: the eager update, the
    capture and the replays of the rest), then ``len(raws)`` updates are
    timed one dispatch each with a sync.  Both paths make ``2 len(raws)``
    updates, and the wrappers' counts must be equal on both.  With
    ``ranks`` (NCCL) the states are replicas, each timed update starts
    after an eager ``all_reduce`` that brings the ranks together (an eager
    collective between replays, on the communicator the graph's own use),
    and after each path the ranks' parameters, BN statistics and bank must
    be equal.  Returns (eager median ms, replay median ms, the graph path's
    launches)."""
    from pacingpseudo_torch.parallel import mesh
    from pacingpseudo_torch.train.graph import StepGraph
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import (make_chunked_train_step,
                                               make_pacing_train_step,
                                               make_upper_bound_train_step)

    make = (make_upper_bound_train_step if config.session == "Upperbound"
            else make_pacing_train_step)
    k = len(raws)
    stack = {key: torch.stack([r[key] for r in raws]) for key in raws[0]}
    medians, launches = {}, {}
    for path in ("eager", "graph"):
        graph = StepGraph()
        state = create_train_state(config, device=dev)
        if ranks is not None:
            mesh.replicate(state.model, ranks)
        chunked = make_chunked_train_step(make(config, 1000, augment_fn=augment_fn, ranks=ranks),
                                          k if path == "graph" else 1, graph)
        gen = torch.Generator(device=dev)
        torch.cuda.synchronize()
        _reset_launch_counts(counters)
        if path == "graph":
            chunked(state, stack, gen, config.seed)
        else:
            for i in range(k):
                chunked(state, {key: v[i:i + 1] for key, v in stack.items()}, gen, config.seed)
        ms, losses = [], None
        for i in range(k):
            if ranks is not None:
                ranks.sum_(torch.zeros(1, device=dev))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = chunked(state, {key: v[i:i + 1] for key, v in stack.items()}, gen,
                             config.seed)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches[path] = _launch_counts(counters)
        _check(all(math.isfinite(float(v)) for v in losses.values()),
               f"{name}: non-finite losses on the {path} path: {losses}")
        want = (1, 2 * k - 1) if path == "graph" else (0, 0)
        _check((graph.captures, graph.replays) == want,
               f"{name}: {graph.captures} captures and {graph.replays} replays on the {path} "
               f"path, want {want}")
        _check(ranks is None or _equal_on_ranks(ranks, state),
               f"{name}: after {2 * k} {path} updates the ranks' parameters, BN statistics "
               f"or bank differ")
        medians[path] = statistics.median(ms)
        print(f"{name}: {path} step ms {[round(t, 3) for t in ms]}", flush=True)
        state.optimizer.zero_grad(set_to_none=True)   # a replay's grads live in the pool
        graph.reset()
        del state, chunked, graph
        _release_memory()
    _check(launches["graph"] == launches["eager"],
           f"{name}: launches {launches['graph']} on the graph path, {launches['eager']} "
           f"eager, in {2 * k} updates each")
    return medians["eager"], medians["graph"], launches["graph"]


def phase_graph_train(dev, counters, raw_batches, augment_fn, ub_augment_fn, fc, smi):
    """``train (raw, graph)``: the captured augmentation bit for bit, one
    replayed update against the eager one (Adam and SGD) at the parity
    size; then for the Experiment step, the Upperbound step and the
    Experiment step under the fused conv impl at full width, one replayed
    update held against the eager one (``_hold_replay``) and the median
    replay against the eager raw step in this run.  Returns each graph
    path's launches (the warm-up updates and the replays), and the
    Experiment step's (eager, replay) median ms."""
    check_graph_augment(augment_fn, [next(raw_batches) for _ in range(4)], dev)
    for optimizer in ("adam", "momentum"):
        phase_graph_parity(dev, optimizer)
    raws = [next(raw_batches) for _ in range(GRAPH_TIMED)]
    readings, paths = [], {}
    runs = (("Experiment", _experiment_config(), augment_fn, "xla"),
            ("Upperbound", _upper_bound_config(), ub_augment_fn, "xla"),
            ("Experiment, fused conv", _experiment_config(), augment_fn, "fused"))
    for label, config, fn, impl in runs:
        name = f"train (raw, graph) {label}"
        fc.set_conv_impl(impl)
        try:
            print(f"{name}: {_hold_replay(name, config, fn, raws[:2], dev)}", flush=True)
            _release_memory()
            eager, replay, launches = _time_replay_and_eager(name, config, fn, raws, dev,
                                                             counters)
        finally:
            fc.set_conv_impl("xla")
        paths[f"train (raw, graph, {label})"] = launches
        if label == "Experiment":
            one_card = (eager, replay)
        readings.append(f"{label}: eager {eager:.3f} ms, replay {replay:.3f} ms "
                        f"({config.batch_size * 1e3 / replay:.1f} slices/s)")
    print(f"train (raw, graph): {smi}: median of {GRAPH_TIMED} steps, "
          f"{'; '.join(readings)}", flush=True)
    return paths, one_card


def make_loop_pool(root, seed, patients=LOOP_PATIENTS, per_patient=TEST_PATIENT_SLICES,
                   difficulty="easy", name="loop (resident, graph)", threaded=False):
    """A seeded synthetic CHAOS pool of ``patients x per_patient`` 256x256
    slices for the graph loop and the sweep: the ``difficulty`` phantoms of
    ``write_synthetic_dataset`` with grid scribbles (the label on every 16th
    row and column, ignore elsewhere: the skeleton scribbles take ~0.15 s a
    slice of host time) and its patient-level five-fold split (the test set
    of fold k: patients k, k + 5, ...).  Fold 1 trains on 10 patients (240
    slices: 20 steps of 12) and validates on 3.  The phantoms come from one
    stream in order, or, ``threaded``, from a stream a patient
    (``RandomState([seed, patient])``), each patient written in a thread of
    its own (numpy's array work releases the GIL: the jagged phantoms take
    ~0.09 s a slice)."""
    from pacingpseudo_torch.data.synthetic import make_phantom

    spec = _experiment_config().spec
    t0 = time.perf_counter()
    slices = os.path.join(root, "chaos", "slices")
    split = os.path.join(root, "chaos", "train_test_split", "five_fold_split", "t1")
    os.makedirs(slices)
    os.makedirs(split)
    grid = np.zeros(spec.input_size, bool)
    grid[::16] = True
    grid[:, ::16] = True
    names = {p: [f"slices/pat{p:03d}_slice{j:03d}.npz" for j in range(per_patient)]
             for p in range(patients)}

    def write_patient(p, rng):
        for rel in names[p]:
            img, lab = make_phantom(rng, spec.input_size, spec.num_classes, difficulty)
            scb = np.where(grid, lab, spec.ignored_index).astype(np.float32)
            uid = os.path.basename(rel)[:-len(".npz")]
            np.savez(os.path.join(slices, uid + ".npz"), uid=uid, img=img,
                     lab=lab.astype(np.float32), scb=scb)

    if threaded:
        with concurrent.futures.ThreadPoolExecutor(patients) as pool:
            list(pool.map(lambda p: write_patient(p, np.random.RandomState([seed, p])),
                          range(patients)))
    else:
        rng = np.random.RandomState(seed)
        for p in range(patients):
            write_patient(p, rng)
    for fold in range(5):
        test = set(range(fold, patients, 5))
        for part, keep in (("train", False), ("test", True)):
            with open(os.path.join(split, f"{part}_fold{fold}.txt"), "w") as f:
                f.write("\n".join(n for p in range(patients) if (p in test) == keep
                                  for n in names[p]) + "\n")
    print(f"{name}: wrote {patients * per_patient} synthetic {difficulty} "
          f"{spec.input_size} slices of {patients} patients in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def _loop_epochs(run_dir):
    """``log.txt`` of a loop run and its epoch lines: (s, slices/s) and the
    metrics of each epoch."""
    import re

    log = open(os.path.join(run_dir, "log.txt")).read()
    lines = re.findall(r"epoch: \d+, (.*), ([\d.]+) s/epoch, ([\d.]+) slices/s", log)
    return log, [(float(a), float(b)) for _, a, b in lines], [
        {k: float(v) for k, v in (kv.split(": ") for kv in m.split(", "))}
        for m, _, _ in lines]


def _loop_metrics_close(tag, graph_runs, eager_runs, rtol):
    """Each graph run's per-epoch metrics against each eager run's: within
    ``rtol`` of the eager value, or 4 x the eager runs' own spread where
    that is larger, + 1e-6 (the log's rounding)."""
    for g in graph_runs:
        for e in eager_runs:
            for epoch, (mg, me) in enumerate(zip(g, e)):
                for k, want in me.items():
                    yard = max(abs(o[epoch][k] - want) for o in eager_runs)
                    # + 1e-6: the log prints six decimals
                    _check(abs(mg[k] - want) <= max(rtol * abs(want), 4 * yard) + 1e-6,
                           f"{tag}: epoch {epoch} {k} {mg[k]} on the graph path, {want} "
                           f"eager (eager runs' spread {yard})")


def _loop_run(loop, config, data_root, run_dir, dev, counters):
    """One ``_train_driver`` run with the launch counts set to 0 just before
    and read just after: (run_dir, state, launches)."""
    torch.cuda.synchronize()
    _reset_launch_counts(counters)
    run_dir, state = loop._train_driver(config, data_root, run_dir, device=dev)
    torch.cuda.synchronize()
    return run_dir, state, _launch_counts(counters)


def phase_loop_graph(dev, counters, data_root, smi):
    """``loop (resident, graph)``: the Experiment session at full width with
    ``ref_quirk_bn_eval_after_first_epoch`` on the 240 training slices of
    ``make_loop_pool``'s fold 1, 2 epochs of 20 steps with no cut, a
    checkpoint each epoch: ``steps_per_dispatch=8`` with the pool resident
    (dispatches of 8, 8 and the remainder 4, each update a replay but the
    first of an epoch), in turns with ``steps_per_dispatch=1`` streamed
    (today's eager loop), two runs each.  Checks finite losses, one capture
    an epoch and the frozen-BN graph in epoch 1 (BatchNorm statistics equal
    in ``ckp_0`` and ``ckp_1``, the weights not), that the graph run's
    checkpoint restores into a fresh eager state bit for bit, that the
    wrappers count the same launches on both paths (40 updates and the two
    figure warps), and each graph run's per-epoch metrics against the eager
    runs' (``LOOP_RTOL``, or 4 x the eager runs' spread).  Then the same
    loop at init_ch 8 in float32 with TF32 off and deterministic cuDNN,
    eager, graph, eager, held at ``LOOP_RTOL_F32``, under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: the
    backward of the align-corners bilinear upsample (the decoder's and the
    aux path's) adds with atomics, so three eager float32 loops part by up
    to 4e-4 in an epoch's ``loss_pce``; that mode gives it its
    deterministic form, and the eager loops are equal bit for bit
    (``scripts/loop_determinism.py``).  Prints each run's epochs (s,
    slices/s) and metrics."""
    import dataclasses

    from pacingpseudo_torch.train import checkpoint as ckpt
    from pacingpseudo_torch.train import loop
    from pacingpseudo_torch.train.state import create_train_state

    base = dataclasses.replace(_experiment_config(), epoch=LOOP_EPOCHS, ckp_interval=1,
                               ref_quirk_bn_eval_after_first_epoch=True)
    _release_memory()
    paths = {"graph": dict(steps_per_dispatch=LOOP_DISPATCH, device_resident_data="on"),
             "eager": dict(steps_per_dispatch=1, device_resident_data="off")}
    readings, launches, metrics = [], {}, {"graph": [], "eager": []}
    for turn, path in enumerate(("graph", "eager", "graph", "eager")):
        config = dataclasses.replace(base, **paths[path])
        run_dir, state, launches[turn] = _loop_run(
            loop, config, data_root, os.path.join(data_root, "runs", f"{path}{turn}"), dev,
            counters)
        log, epochs, epoch_metrics = _loop_epochs(run_dir)
        metrics[path].append(epoch_metrics)
        steps = state.step // LOOP_EPOCHS
        _check(steps == 20 and len(epochs) == LOOP_EPOCHS,
               f"loop (resident, graph) {path}: {steps} steps an epoch, epoch lines {epochs}")
        _check("epoch 001 on: frozen-BN step" in log
               and all(math.isfinite(v) for m in epoch_metrics for v in m.values()),
               f"loop (resident, graph) {path}: no frozen-BN step, or metrics {epoch_metrics}")
        if path == "graph":
            _check("CUDA graph: 2 captures, 38 replays" in log
                   and "training data resident on the device" in log,
                   f"loop (resident, graph): the graph path did not run as planned")
            sd0, sd1 = (torch.load(os.path.join(run_dir, "ckps", f"ckp_{e}",
                                                ckpt.MODEL_FILE)) for e in (0, 1))
            stats = [k for k in sd0 if k.endswith(("running_mean", "running_var"))]
            _check(all(torch.equal(sd0[k], sd1[k]) for k in stats)
                   and not torch.equal(sd0["backbone.final_conv.weight"],
                                       sd1["backbone.final_conv.weight"]),
                   "loop (resident, graph): epoch 1 moved the BatchNorm statistics or not "
                   "the weights")
            fresh = ckpt.restore_checkpoint(os.path.join(run_dir, "ckps", "ckp_1"),
                                            create_train_state(config, device=dev, seed=7))
            count = _check_states_equal("loop (resident, graph): ckp_1 restored eagerly",
                                        fresh, state)
            del fresh
        readings.append(f"{path}: epochs (s, slices/s) {epochs}")
        print(f"loop (resident, graph) {path} run {turn}: {smi}: epochs (s, slices/s) "
              f"{epochs}, metrics {epoch_metrics}", flush=True)
        del state
        _release_memory()
    _check(all(launches[t] == launches[0] for t in launches),
           f"loop (resident, graph): the wrappers' launch counts differ between the runs: "
           f"{launches}")
    _loop_metrics_close("loop (resident, graph)", metrics["graph"], metrics["eager"], LOOP_RTOL)
    print(f"loop (resident, graph): {smi}: in turns, 20 steps an epoch, "
          f"{'; '.join(readings)}; the graph run's ckp_1 restores into a fresh eager state "
          f"bit for bit ({count} tensors); launches in each run, graph and eager alike: "
          f"{ {k: v for k, v in launches[0].items() if v} }; the graph runs' metrics within "
          f"{LOOP_RTOL:g} of the eager runs' (or 4 x their spread)", flush=True)

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    small = {"graph": [], "eager": []}
    try:
        for turn, path in enumerate(("eager", "graph", "eager")):
            config = dataclasses.replace(base, init_ch=8, hid_ch=16, compute_dtype="float32",
                                         **paths[path])
            run_dir, state, _ = _loop_run(
                loop, config, data_root, os.path.join(data_root, "runs", f"f32_{path}{turn}"),
                dev, counters)
            small[path].append(_loop_epochs(run_dir)[2])
            del state
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"loop (resident, graph) float32: init_ch 8, deterministic: graph {small['graph']}; "
          f"eager {small['eager']}", flush=True)
    _loop_metrics_close("loop (resident, graph) float32", small["graph"], small["eager"],
                        LOOP_RTOL_F32)
    print(f"loop (resident, graph) float32: the graph run's metrics within {LOOP_RTOL_F32:g} "
          f"of the eager runs' (or 4 x their spread)", flush=True)
    return launches[0]


# ``python -m <module>`` under runpy, then the child's kernel launch counts
# (each wrapper's LAUNCHES) on a last line of their own.
LAUNCHES_TAG = "child launches: "
_COUNTED_CHILD = (
    "import json, runpy, sys\n"
    "from pacingpseudo_torch.ops import fused_convbn, fused_loss, warp_cubic, warp_table\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n"
    f"print({LAUNCHES_TAG!r} + json.dumps({{k: v for m in (fused_loss, warp_table, "
    "warp_cubic, fused_convbn) for k, v in m.LAUNCHES.items()}))\n")


def _run_cli(module, args, timeout=600, count_launches=False):
    """``python -m <module> <args>`` in a child process on this card;
    returns its stdout, fails with its stderr's tail.  With
    ``count_launches`` returns ``(stdout, the child's launch counts)``."""
    _release_memory()     # the child needs the memory this process caches
    cmd = ([sys.executable, "-c", _COUNTED_CHILD, module] if count_launches
           else [sys.executable, "-m", module])
    proc = subprocess.run(cmd + list(args), cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=timeout)
    _check(proc.returncode == 0, f"{module} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    if not count_launches:
        return proc.stdout
    last = proc.stdout.rstrip().splitlines()[-1]
    _check(last.startswith(LAUNCHES_TAG), f"{module}: no launch counts:\n{proc.stdout[-2000:]}")
    return proc.stdout, json.loads(last[len(LAUNCHES_TAG):])


def phase_sweep(data_root, smi):
    """``python -m pacingpseudo_torch.cli.sweep`` on the card: the
    Upperbound session at full width, folds 0 and 1 of ``make_loop_pool``'s
    pool, 1 epoch of 8 steps each (lr 0.003, so that a fold predicts some
    foreground and writes the ``best_ckp`` inference reads), inference on
    each fold's test split.  Checks the fold JSONs, the summary (the fold
    means) and the table, then a second call that reads both folds from the
    cache.  Then ``phase_sweep_jagged``; returns its child's launch counts."""
    out = os.path.join(data_root, "sweep")
    args = ["--session", "Upperbound", "--tag", "sweep", "--folds", "0", "1",
            "--epoch", "1", "--max_steps_per_epoch", "8", "--lr", "0.003",
            "--no-tb_figures", "--data_root", data_root, "--root", data_root,
            "--sweep_out", out]
    t0 = time.perf_counter()
    stdout = _run_cli("pacingpseudo_torch.cli.sweep", args)
    t1 = time.perf_counter()
    folds = {f: json.load(open(os.path.join(out, f"fold{f}.json"))) for f in (0, 1)}
    summary = json.load(open(os.path.join(out, "sweep_summary.json")))
    _check(all(0.0 <= r["dice"] <= 1.0 and r["num_patients"] >= 1 for r in folds.values())
           and math.isclose(summary["overall_dice"],
                            (folds[0]["dice"] + folds[1]["dice"]) / 2, rel_tol=1e-12)
           and "| DSC |" in open(os.path.join(out, "sweep_table.md")).read()
           and "| DSC |" in stdout,
           f"sweep: fold results {folds} and summary {summary}")
    again = _run_cli("pacingpseudo_torch.cli.sweep", args)
    t2 = time.perf_counter()
    _check("fold 0: cached" in again and "fold 1: cached" in again,
           f"sweep: the second call did not read the cache:\n{again[-2000:]}")
    print(f"sweep: {smi}: 2 folds trained and evaluated in {t1 - t0:.1f} s (child process), "
          f"Dice {folds[0]['dice']:.4f} / {folds[1]['dice']:.4f}, HD95 "
          f"{folds[0]['hd95']:.2f} / {folds[1]['hd95']:.2f}; the second call read both folds "
          f"from the cache in {t2 - t1:.1f} s", flush=True)
    return phase_sweep_jagged(os.path.join(os.path.dirname(data_root), "sweep_jagged"), smi)


# The jagged pool of the Experiment sweep: fold k tests patient k and trains
# on the other four (96 slices: 8 steps of 12).
SWEEP_PATIENTS = 5
PACING_FLAGS = ["--do_loss_ent", "--do_decoder_consistency", "--do_aux_path", "--do_memory"]


def phase_sweep_jagged(root, smi):
    """``cli.sweep`` with the Experiment session (the four pacing flags, as
    ``scripts/sweep_torch.py`` runs ``study_r5/sweep/``'s arm) in a child
    process on a jagged pool of ``SWEEP_PATIENTS`` patients: folds 0 and 1,
    1 epoch of 8 steps each at lr 0.003 (so that a fold saves the
    ``best_ckp`` inference reads), inference on each fold's test patient.
    The fold JSONs must carry the per-patient keys, and the child must have
    launched kernels 1, 2 and 6b (``fused_loss_fwd`` as often as
    ``fused_loss_bwd``); returns the child's launch counts."""
    seed = _experiment_config().seed
    make_loop_pool(root, seed, SWEEP_PATIENTS, difficulty="jagged", name="sweep (jagged)",
                   threaded=True)
    out = os.path.join(root, "sweep")
    args = ["--session", "Experiment", *PACING_FLAGS, "--tag", "sweep", "--folds", "0", "1",
            "--epoch", "1", "--max_steps_per_epoch", "8", "--lr", "0.003", "--no-tb_figures",
            "--data_root", root, "--root", root, "--sweep_out", out]
    t0 = time.perf_counter()
    stdout, launches = _run_cli("pacingpseudo_torch.cli.sweep", args, count_launches=True)
    t1 = time.perf_counter()
    folds = {f: json.load(open(os.path.join(out, f"fold{f}.json"))) for f in (0, 1)}
    keys = ("dice", "hd95", "dice_per_patient", "hd95_per_patient", "num_patients")
    _check(all(all(k in r for k in keys) and r["num_patients"] == 1 and 0 <= r["dice"] <= 1
               for r in folds.values()) and "| DSC |" in stdout,
           f"sweep (jagged): fold results {folds}")
    _check(all(launches.get(k, 0) >= 1 for k in ("fused_loss_fwd", "fused_loss_bwd",
                                                   "warp_cubic"))
           and launches["fused_loss_fwd"] == launches["fused_loss_bwd"],
           f"sweep (jagged): the child's launches {launches}")
    print(f"sweep (jagged): {smi}: the Experiment session, 2 folds of {SWEEP_PATIENTS} jagged "
          f"patients trained and evaluated in {t1 - t0:.1f} s (child process), Dice "
          f"{folds[0]['dice']:.4f} / {folds[1]['dice']:.4f} (per patient "
          f"{folds[0]['dice_per_patient']:.4f} / {folds[1]['dice_per_patient']:.4f}); the "
          f"child's launches { {k: v for k, v in launches.items() if v} }", flush=True)
    return launches


def phase_loader_native(data_root, dev, smi):
    """``loader (native)``: the C++ npz loader (``data/native``) on the 312
    slices of ``make_loop_pool``.  Fails unless its library builds here and
    ``BatchLoader.route`` is ``"native"``.  An epoch of shuffled batches of
    12 through the native and the numpy route must be equal byte for byte
    (uids too), and the training pool staged through the native route (the
    loop's ``stage_train_pool``) equal bit for bit to one staged from numpy
    batches.  Then host slices/s of each route, in turns, on this machine's
    CPU (``os.cpu_count()`` cores)."""
    import glob

    from pacingpseudo_torch.data.native import loader as native
    from pacingpseudo_torch.data.npz_dataset import BatchLoader, SliceDataset, raw_batch_to_device
    from pacingpseudo_torch.data.resident import STAGE_BATCH, stage_train_pool

    spec = _experiment_config().spec
    _check(native.native_available(),
           f"loader (native): the library did not build: {native.build_error()}")
    files = sorted(glob.glob(os.path.join(data_root, "chaos", "slices", "*.npz")))
    ds = SliceDataset(files, spec.num_classes, spec.ignored_index)

    batch = _experiment_config().batch_size

    def loader(route, seed=3):
        return BatchLoader(ds, batch, shuffle=True, seed=seed, native=route == "native")

    loaders = {route: loader(route) for route in ("native", "numpy")}
    _check([ld.route for ld in loaders.values()] == ["native", "numpy"],
           f"loader (native): routes {[ld.route for ld in loaders.values()]}")
    n = 0
    for a, b in zip(loaders["native"], loaders["numpy"], strict=True):
        _check(a["uid"] == b["uid"] and all(a[k].dtype == b[k].dtype
                                            and a[k].tobytes() == b[k].tobytes()
                                            for k in ("image", "label", "scribble", "size")),
               f"loader (native): the routes' batches differ at slice {n}")
        n += len(a["uid"])
    pool = stage_train_pool(ds, dev)
    parts = [raw_batch_to_device(b, dev, shrink=True)
             for b in BatchLoader(ds, STAGE_BATCH, native=False)]
    for k, v in pool.items():
        want = torch.cat([p[k] for p in parts])
        _check(v.dtype == want.dtype and torch.equal(v, want),
               f"loader (native): the staged pool's {k} differs between the routes")
    del pool, parts
    rates = {"native": [], "numpy": []}
    for turn, route in enumerate(("native", "numpy", "native", "numpy")):
        t0 = time.perf_counter()
        count = sum(len(b["uid"]) for b in loader(route, seed=10 + turn))
        rates[route].append(count / (time.perf_counter() - t0))
    print(f"loader (native): {smi}: host {os.cpu_count()} CPU cores; {n} slices of "
          f"{ds.canvas_size}x{ds.canvas_size} byte-equal on both routes, the staged pool "
          f"({len(ds)} slices) bit-equal; slices/s in turns native "
          f"{[round(r, 1) for r in rates['native']]}, numpy "
          f"{[round(r, 1) for r in rates['numpy']]} (batches of 12, 8 loader threads)",
          flush=True)


DP_WORLD = 2
DP_TIMED = 5
# The update on the ranks is held in float32 (TF32 off, deterministic
# cuDNN) and in the session's bf16.
DP_DTYPES = ("float32", "bfloat16")
# The yardstick runs start from weights nudged by this much (relative
# standard deviation), about the dtype's unit roundoff: in float32 1e-7,
# as tests/test_torch_port_trajectory.py does; in bf16 2^-8, the rounding
# the half-batch forward may change in each bf16 value.
DP_NUDGE = {"float32": 1e-7, "bfloat16": 2.0 ** -8}


def _rank_block(t, rows, n, split, space_index=0, every_rank=False):
    """A rank's block (its ``rows``, a slice of a batch of ``n``, and on a
    space axis its heights of the ``HeightSplit`` ``split``) of a tensor of
    the single-card forward: ``2n`` rows (weak, strong) where the two
    streams share the backbone, else ``n``.  A level below the split level
    is whole on every space rank: the block of space rank 0, None on the
    others (its flips count once), or with ``every_rank`` the whole level on
    every rank."""
    if t.shape[0] == 2 * n:
        t = torch.cat([t[rows], t[n + rows.start:n + rows.stop]])
    else:
        t = t[rows]
    if split is not None:
        if split.replicated(t.shape[-1]):
            return t if space_index == 0 or every_rank else None
        t = t[..., split.rows(t.shape[-2] * split.stride // split.height), :]
    return t


def _dp_rank(rank, devices, store, work, n_space=1, config_kw=None):
    """One rank of ``train (data-parallel)`` or, with ``n_space > 1``, of
    ``train (height-sharded)`` (a spawned process); ``config_kw`` replaces
    fields of the Experiment config (``train (height-sharded, past the
    coarse rows)``).  For each compute dtype of ``DP_DTYPES``: three
    single-card eager updates and the update on the ranks, all from the
    checkpoint in ``work`` on the raw batch there, and their checks; then,
    where the ranks have a card each, the timed
    updates.  Writes ``rank<r>.json``."""
    import dataclasses

    from pacingpseudo_torch.aug.engine import make_train_augment_fn
    from pacingpseudo_torch.ops import fused_convbn as fc
    from pacingpseudo_torch.ops import fused_loss as fl
    from pacingpseudo_torch.ops import warp_cubic as wc
    from pacingpseudo_torch.ops import warp_table as wt
    from pacingpseudo_torch.parallel import mesh, spatial
    from pacingpseudo_torch.train import checkpoint as ckpt
    from pacingpseudo_torch.train.loop import _augment_params
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import make_pacing_train_step, seed_step

    ranks = mesh.init_rank_group(rank, devices, store, n_space)
    dev = ranks.device
    phase = ("train (data-parallel" if n_space == 1 else
             f"train (height-sharded{', past the coarse rows' if config_kw else ''}, "
             f"data {ranks.n_data} x space {n_space}")
    counters = (fl, wt, wc, fc)
    config = dataclasses.replace(_experiment_config(), **(config_kw or {}))
    augment_fn = make_train_augment_fn(*_augment_params(config), True)
    raw = {k: v.to(dev) for k, v in torch.load(os.path.join(work, "raw.pt")).items()}
    want = torch.load(os.path.join(work, "augmented.pt"))
    n, rows = config.batch_size, ranks.rows(config.batch_size)
    height, width = _augment_params(config)[0].crop_size
    split = (spatial.HeightSplit.of(height, config.output_stride, n_space, ranks.space_index,
                                    width) if n_space > 1 else None)
    captured = {}

    def capture(raw_batch, gen):
        captured["batch"] = augment_fn(raw_batch, gen)
        return captured["batch"]

    def update(cfg, step_ranks, nudge=None, branches=None):
        state = ckpt.restore_checkpoint(os.path.join(work, "ckp"),
                                        create_train_state(cfg, device=dev, seed=5))
        # A BN-fed bias's gradient on a rank, before the ranks sum them:
        # the partial sums cancel, and their rounding stays in the sum.
        partial = {}
        if step_ranks is not None:
            for k, p in state.model.named_parameters():
                if _bn_fed_bias(k):
                    p.register_hook(lambda g, k=k: partial.__setitem__(
                        k, g.detach().abs().max().reshape(1)))
        if nudge is not None:                 # (relative size, seed)
            gen = torch.Generator(device=dev).manual_seed(nudge[1])
            with torch.no_grad():
                for p in state.model.parameters():
                    p.mul_(1 + nudge[0] * torch.randn(p.shape, generator=gen,
                                                      device=dev))
        before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
        signs = []
        hooks = _record_signs(state.model, signs, branches)
        step = make_pacing_train_step(cfg, 100, ranks=step_ranks,
                                      augment_fn=capture if step_ranks else augment_fn)
        gen = torch.Generator(device=dev)
        seed_step(gen, dev, cfg.seed, state.step)
        torch.cuda.synchronize()
        _reset_launch_counts(counters)
        metrics = step(state, raw, gen)
        torch.cuda.synchronize()
        launches = _launch_counts(counters)
        for hook in hooks:
            hook.remove()
        return (state, {k: float(v) for k, v in metrics.items()},
                {k: p.grad.clone() for k, p in state.model.named_parameters()},
                {k: p.detach() - before[k] for k, p in state.model.named_parameters()},
                signs, launches, partial)

    def hold(dtype):
        name = f"{phase}, {dtype})"
        cfg = dataclasses.replace(config, compute_dtype=dtype)
        metrics, grads, deltas, signs = {}, {}, {}, {}
        # "eager": the single-card update.  The yardstick ("eager 2",
        # "eager 3"): the ranks' forward runs at half the batch, where
        # cuDNN rounds otherwise, so two updates from one state (which
        # run the same forward) are no yardstick: two single-card updates
        # from weights nudged by about the dtype's unit roundoff.  Only
        # float32 holds the gradients and updates in L2: in bf16 two such
        # updates differ by a large part of a leaf's norm, as much as a
        # gradient averaged where it should be summed, so bf16 holds the
        # losses and branch flips beside its spread and reads the leaves.
        # Where the leaves are held, the yardstick updates and the ranks'
        # take the LeakyReLU branches of the single-card update ("eager"):
        # a pre-activation within rounding of zero that takes the other
        # branch (a flip, counted from the signs before the branch is
        # taken and held on its own) moves a leaf's gradient by a pixel's
        # share, in one channel as much as the leaf's whole spread, and
        # where the ranks flipped it and no yardstick update did, beyond
        # four yardsticks.  With the branches matched a leaf's error is
        # the rounding the ranks add.
        match = dtype == "float32"
        runs = (("eager", None), ("eager 2", (DP_NUDGE[dtype], 1)),
                ("eager 3", (DP_NUDGE[dtype], 2)))
        for r, nudge in runs:
            branches = signs["eager"] if match and r != "eager" else None
            _, metrics[r], grads[r], deltas[r], signs[r], _, _ = update(cfg, None, nudge,
                                                                        branches)
        branches = ([_rank_block(t, rows, n, split, ranks.space_index, every_rank=True)
                     for t in signs["eager"]] if match else None)
        state, metrics["ranks"], grads["ranks"], deltas["ranks"], signs["ranks"], \
            launches, partial = update(cfg, ranks, branches=branches)
        # One eps of the dtype on the ranks' partial gradients, summed.
        names = sorted(partial)
        eps = torch.finfo(getattr(torch, dtype)).eps
        bias_roundoff = dict(zip(names, (eps * ranks.sum(torch.cat(
            [partial[k] for k in names]))).tolist()))
        # The rank's augmented rows against the single-card augmentation.
        _check(sorted(captured["batch"]) == sorted(want)
               and all(torch.equal(captured["batch"][k][rows].cpu(), v[rows])
                       for k, v in want.items()),
               f"{name}: rank {rank}'s augmented rows differ from the single-card "
               f"batch's")
        # One update a rank: each kernel of the path once, no other.
        expected = {"fused_loss_fwd": 1, "fused_loss_bwd": 1, "warp_cubic": 1}
        _check(all(launches[k] == v for k, v in expected.items())
               and all(v == 0 for k, v in launches.items() if k not in expected),
               f"{name}: rank {rank} launched {launches} in one update, expected "
               f"{expected}")
        # Replicas equal on every rank: parameters, BN statistics, the bank.
        _check(_equal_on_ranks(ranks, state),
               f"{name}: the ranks' parameters, BN statistics or bank differ")
        # Branch flips: this rank's block against the single-card
        # forward's, summed over the ranks.
        mine = _sign_flips(signs["ranks"], [_rank_block(t, rows, n, split, ranks.space_index)
                                            for t in signs["eager"]])
        flips = {"ranks": int(ranks.sum(torch.tensor([mine], device=dev)).item())}
        flips.update({r: _sign_flips(signs[r], signs["eager"]) for r in EAGER_RUNS[1:]})
        n_signs = sum(t.numel() for t in signs["eager"])
        del signs
        summary = ""
        if rank == 0:
            summary = _hold_against_eager(name, "ranks", "on the ranks", metrics, grads,
                                          deltas, flips, n_signs, bias_roundoff,
                                          leaves_held=dtype == "float32")
        return state, summary, launches, mine, max(float(v) for v in partial.values())

    out = {"launches": {}, "summary": {}, "flips": {}, "partial": {}}
    for dtype in DP_DTYPES:
        deterministic = dtype == "float32"
        _deterministic_f32(deterministic)
        try:
            (state, out["summary"][dtype], out["launches"][dtype], out["flips"][dtype],
             out["partial"][dtype]) = hold(dtype)
        finally:
            _deterministic_f32(False)
    out["step_ms"] = []
    if mesh.backend_for(devices) == "nccl":
        step = make_pacing_train_step(config, 100, augment_fn=augment_fn, ranks=ranks)
        gen = torch.Generator(device=dev)
        for _ in range(3 + DP_TIMED):
            seed_step(gen, dev, config.seed, state.step)
            ranks.sum_(torch.zeros(1, device=dev))     # the ranks start together
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, raw, gen)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mesh.close_rank_group(ranks)


def _deterministic_f32(on: bool) -> None:
    """TF32 off and deterministic cuDNN (``on``), or the defaults back."""
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.allow_tf32 = not on
    torch.backends.cuda.matmul.allow_tf32 = False if on else _MATMUL_TF32


_MATMUL_TF32 = torch.backends.cuda.matmul.allow_tf32


def _rank_devices(dev, world):
    """``world`` ranks: a card each where the machine has them, else all on
    ``dev`` (gloo)."""
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(world)] if cards >= world else [dev] * world


def _hold_on_ranks(name, dev, data_root, raws, smi, single_ms, world, n_space=1,
                   config_kw=None):
    """The update on ``world`` ranks (``n_space`` of them a space axis) held
    against the single-card eager update (``_dp_rank``), from a checkpoint
    taken after one eager update on ``raws[0]``, on ``raws[1]``; the
    Experiment config with ``config_kw``'s fields replaced.  Prints the
    checks and, where the ranks have a card each, the median update on them
    beside ``single_ms``.  Returns each rank's result."""
    from pacingpseudo_torch.aug.engine import make_train_augment_fn
    from pacingpseudo_torch.parallel import mesh
    from pacingpseudo_torch.train import checkpoint as ckpt
    from pacingpseudo_torch.train import loop
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import make_pacing_train_step, seed_step

    devices = _rank_devices(dev, world)
    backend = mesh.backend_for(devices)
    print(f"{name}: world {world} (data {world // n_space} x space {n_space}), backend "
          f"{backend}, ranks on {', '.join(map(str, devices))} ({torch.cuda.device_count()} "
          f"card(s) on this machine)", flush=True)
    config = dataclasses.replace(_experiment_config(), **(config_kw or {}))
    augment_fn = make_train_augment_fn(*loop._augment_params(config), True)
    work = os.path.join(data_root, f"ranks_{world}x{n_space}" + ("_deep" if config_kw else ""))
    os.makedirs(work)
    state = create_train_state(config, device=dev, seed=11)
    gen = torch.Generator(device=dev)
    seed_step(gen, dev, config.seed, 0)
    make_pacing_train_step(config, 100, augment_fn=augment_fn)(state, raws[0], gen)
    ckpt.save_checkpoint(os.path.join(work, "ckp"), state)
    seed_step(gen, dev, config.seed, state.step)
    with torch.no_grad():
        want = augment_fn(raws[1], gen)
    torch.save({k: v.cpu() for k, v in want.items()}, os.path.join(work, "augmented.pt"))
    torch.save({k: v.cpu() for k, v in raws[1].items()}, os.path.join(work, "raw.pt"))
    del state, want
    _release_memory()
    t0 = time.perf_counter()
    mesh.spawn_ranks(_dp_rank, world, (devices, os.path.join(work, "store"), work, n_space,
                                       config_kw))
    results = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(world)]
    for dtype in DP_DTYPES:
        print(f"{name} {dtype}: {smi}: each rank's augmented rows == the single-card batch's "
              f"bit for bit; the update on {world} ranks == the single-card eager update"
              f"{' on its LeakyReLU branches' if dtype == 'float32' else ''}"
              f"{results[0]['summary'][dtype]}; LeakyReLU flips by rank "
              f"{[r['flips'][dtype] for r in results]}; a BN-fed bias's largest partial "
              f"gradient before the sum by rank {[r['partial'][dtype] for r in results]}; "
              f"parameters, BN statistics and bank "
              f"equal on the ranks; launches a rank "
              f"{[{k: v for k, v in r['launches'][dtype].items() if v} for r in results]}",
              flush=True)
    print(f"{name}: {time.perf_counter() - t0:.1f} s with the ranks' start", flush=True)
    if backend == "nccl":
        ms = statistics.median(results[0]["step_ms"][3:])
        print(f"{name}: {smi}: median update {ms:.3f} ms on {world} cards (NCCL), "
              f"{config.batch_size * 1e3 / ms:.1f} slices/s; one card {single_ms:.3f} ms "
              f"in this run", flush=True)
    else:
        print(f"{name}: the {world} ranks share one card over gloo: no speed is "
              f"measured", flush=True)
    return results


def phase_data_parallel(dev, data_root, raws, smi, single_ms):
    """``train (data-parallel)``: the Experiment session at full width (the
    CHAOS shape, batch 12, bf16) on ``DP_WORLD`` = 2 ranks: NCCL on
    ``cuda:0`` and ``cuda:1`` where the machine has two cards, else both
    ranks on ``cuda:0`` over gloo.  From a checkpoint taken after one
    eager update on ``raws[0]``, each rank (``_dp_rank``) runs, in float32
    (TF32 off, deterministic cuDNN) and in bf16, the single-card eager
    update, two yardstick updates from weights nudged by about the dtype's
    rounding (``DP_NUDGE``) and the update on the ranks, on ``raws[1]``:
    its augmented rows must equal the single-card augmentation bit for bit,
    the update is held against the eager one beside the yardstick's spread
    (``_hold_against_eager``, with the LeakyReLU branch flips of each
    rank's rows summed; two eager updates from one state run the same
    forward, but the ranks' forward runs at half the batch, where cuDNN
    rounds otherwise; in float32 the yardstick updates and the ranks' take
    the eager update's LeakyReLU branches, the flips counted before; in
    bf16 the losses, flips and BN-fed biases, with
    the other leaves' gradients and updates read, not held), the ranks'
    parameters, BN statistics and bank must
    be equal, and each rank must launch ``fused_loss_fwd``,
    ``fused_loss_bwd`` and ``warp_cubic`` once in the update.  Then the
    loop on 2 ranks (2 epochs of 20 steps, the pool resident and sharded,
    a checkpoint each epoch): rank 0 alone writes the run directory, and
    its ``ckp_0`` resumes in a single-card run whose epoch 1 is held
    against the ranks' at ``LOOP_RTOL``.  Per-update ms only where the
    ranks have a card each.  Returns each rank's launches."""
    import dataclasses
    import shutil

    from pacingpseudo_torch.parallel import mesh
    from pacingpseudo_torch.train import checkpoint as ckpt
    from pacingpseudo_torch.train import loop

    name = "train (data-parallel)"
    devices = _rank_devices(dev, DP_WORLD)
    backend = mesh.backend_for(devices)
    config = _experiment_config()
    results = _hold_on_ranks(name, dev, data_root, raws, smi, single_ms, DP_WORLD)

    loop_config = dataclasses.replace(config, epoch=LOOP_EPOCHS, ckp_interval=1,
                                      device_resident_data="on", num_devices=DP_WORLD)
    run_dir = os.path.join(data_root, "runs", "data_parallel")
    _release_memory()
    t0 = time.perf_counter()
    loop.train_driver(loop_config, data_root, run_dir, device=devices)
    seconds = time.perf_counter() - t0
    log, epochs, epoch_metrics = _loop_epochs(run_dir)
    dispatch = _loop_dispatch(loop_config.steps_per_dispatch, backend)
    _check(f"data-parallel: data mesh of {DP_WORLD}" in log and f"over {backend}" in log
           and dispatch in log and len(epochs) == LOOP_EPOCHS
           and all(math.isfinite(v) for m in epoch_metrics for v in m.values()),
           f"{name}: the loop on the ranks did not run as planned:\n{log[-2000:]}")
    files = sorted(os.path.relpath(os.path.join(d, f), run_dir)
                   for d, _, fs in os.walk(run_dir) for f in fs)
    want_files = {"config.json", "log.txt", "valdice.npz"} | {
        f"ckps/ckp_{e}/{f}" for e in range(LOOP_EPOCHS) for f in (ckpt.MODEL_FILE,
                                                                  ckpt.TRAIN_FILE)}
    extra = [f for f in files if f not in want_files and not f.startswith(("best_ckp/",
                                                                          "tb_summary/"))]
    events = [f for f in files if f.startswith("tb_summary/")]
    _check(want_files <= set(files) and not extra and len(events) == 1,
           f"{name}: the loop's run directory holds {files}")
    resumed = os.path.join(data_root, "runs", "data_parallel_resumed")
    shutil.copytree(run_dir, resumed)
    shutil.rmtree(os.path.join(resumed, "ckps", f"ckp_{LOOP_EPOCHS - 1}"))
    _release_memory()
    loop._train_driver(dataclasses.replace(loop_config, num_devices=0, resume=True),
                       data_root, resumed, device=dev)
    log_r, _, metrics_r = _loop_epochs(resumed)
    _check("resumed from" in log_r and len(metrics_r) == LOOP_EPOCHS + 1,
           f"{name}: the single-card run did not resume the ranks' ckp_0:\n{log_r[-2000:]}")
    for k, want in epoch_metrics[-1].items():
        _check(abs(metrics_r[-1][k] - want) <= LOOP_RTOL * abs(want) + 1e-6,
               f"{name}: epoch {LOOP_EPOCHS - 1} {k} {metrics_r[-1][k]} resumed on one "
               f"card, {want} on the ranks")
    print(f"{name}: {smi}: loop on {DP_WORLD} ranks ({backend}), 2 epochs of 20 steps, "
          f"pool resident and sharded, {dispatch}, in {seconds:.1f} s with the ranks' "
          f"start: epochs "
          f"(s, slices/s) {epochs}, metrics {epoch_metrics}; rank 0 alone wrote the run "
          f"({len(files)} files); its ckp_0 resumed on one card: epoch 1 {metrics_r[-1]}",
          flush=True)
    return [r["launches"][config.compute_dtype] for r in results]


def _loop_dispatch(steps_per_dispatch, backend):
    """The loop's log of its dispatch on ranks of ``backend``: a chunk of
    ``steps_per_dispatch`` updates, replayed on NCCL, eager on gloo."""
    how = "CUDA graph replays" if backend == "nccl" else "eager steps"
    return f"steps per dispatch {steps_per_dispatch} ({how})"


SP_WORLD = 2             # space 2 (data 1); with four cards also data 2 x space 2
SP_LOOP_STEPS = 5


def phase_height_sharded(dev, data_root, raws, smi, single_ms):
    """``train (height-sharded)``: the Experiment session at full width (the
    CHAOS shape, batch 12, bf16) on ``SP_WORLD`` = 2 ranks of one sample's
    heights each (data 1 x space 2: 16 of the 32 coarse rows): NCCL on
    ``cuda:0`` and ``cuda:1`` where the machine has two cards, else both
    ranks on ``cuda:0`` over gloo; where it has four, data 2 x space 2 as
    well.  Each rank (``_dp_rank``) holds its update against the
    single-card eager update as ``phase_data_parallel``'s ranks do (float32
    and bf16, ``_hold_against_eager`` beside nudged updates' spread, the
    LeakyReLU flips of each rank's block summed), checks its augmented rows
    against the single-card batch, that replicas and banks are equal on
    every rank, and that it launched ``fused_loss_fwd``, ``fused_loss_bwd``
    and ``warp_cubic`` once.  Then the user's entry point, ``train_driver``
    with ``spatial_shards=2`` on 2 ranks: 1 epoch of ``SP_LOOP_STEPS``
    steps on the resident pool and the validation, whose log must say
    ``mesh data=1 x space=2``.  Returns each path's launches by rank."""
    import dataclasses

    from pacingpseudo_torch.parallel import mesh
    from pacingpseudo_torch.train import loop

    name = "train (height-sharded)"
    config = _experiment_config()
    paths = {}
    grids = [(SP_WORLD, SP_WORLD)] + ([(4, 2)] if torch.cuda.device_count() >= 4 else [])
    for world, n_space in grids:
        tag = f"data {world // n_space} x space {n_space}"
        results = _hold_on_ranks(f"{name}, {tag}", dev, data_root, raws, smi, single_ms,
                                 world, n_space)
        for r, res in enumerate(results):
            paths[f"{name}, {tag}, rank {r}"] = res["launches"][config.compute_dtype]
        _release_memory()

    devices = _rank_devices(dev, SP_WORLD)
    loop_config = dataclasses.replace(config, epoch=1, ckp_interval=1, device_resident_data="on",
                                      num_devices=SP_WORLD, spatial_shards=SP_WORLD)
    run_dir = os.path.join(data_root, "runs", "height_sharded")
    t0 = time.perf_counter()
    loop.train_driver(loop_config, data_root, run_dir, max_steps_per_epoch=SP_LOOP_STEPS,
                      device=devices)
    seconds = time.perf_counter() - t0
    log, epochs, epoch_metrics = _loop_epochs(run_dir)
    dispatch = _loop_dispatch(min(loop_config.steps_per_dispatch, SP_LOOP_STEPS),
                              mesh.backend_for(devices))
    _check(f"mesh data=1 x space={SP_WORLD}" in log and dispatch in log
           and f"over {mesh.backend_for(devices)}" in log and "val: 000" in log
           and len(epochs) == 1
           and all(math.isfinite(v) for m in epoch_metrics for v in m.values()),
           f"{name}: the loop on the ranks did not run as planned:\n{log[-2000:]}")
    print(f"{name}: {smi}: train_driver with spatial_shards={SP_WORLD} on "
          f"{', '.join(map(str, devices))}: 1 epoch of {SP_LOOP_STEPS} steps ({dispatch}) "
          f"and the validation in {seconds:.1f} s with the ranks' start, epoch (s, "
          f"slices/s) {epochs}, metrics {epoch_metrics}", flush=True)
    return paths


def phase_height_sharded_deep(dev, data_root, raws, smi):
    """``train (height-sharded, past the coarse rows)``: the Experiment
    session at full width (init_ch 32, max_ch 512, hid_ch 64, the four
    flags, bf16, batch 12) on 48x48 images at output stride 16, whose
    coarsest level has 3 rows, on ``DEEP_WORLD`` = 4 space ranks: the split
    is cut at the 6-row level and the levels below it are replicated
    (``parallel/spatial.py``).  NCCL on 4 cards where the machine has them,
    else the 4 ranks on ``cuda:0`` over gloo.  First one card's eager update
    at this shape, timed (median of ``DEEP_TIMED`` after 3); then each rank
    (``_dp_rank``) holds its update against the single-card eager update as
    ``train (height-sharded)`` does (float32 and bf16, beside nudged
    updates' spread, the LeakyReLU flips of each rank's block summed, the
    replicated levels' counted once), checks its augmented rows, equal
    replicas and banks, and that it launched ``fused_loss_fwd``,
    ``fused_loss_bwd`` and ``warp_cubic`` once, and times its update on
    cards of its own (NCCL); then
    ``train_driver`` with ``spatial_shards=4`` on the 4 ranks (1 epoch of
    ``SP_LOOP_STEPS`` steps: replayed on NCCL, eager on gloo) and the
    validation, whose log must say ``mesh data=1 x space=4``.  Returns each
    rank's launches."""
    from pacingpseudo_torch.aug.engine import make_train_augment_fn
    from pacingpseudo_torch.parallel import mesh
    from pacingpseudo_torch.train import loop
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import make_pacing_train_step, seed_step

    name = "train (height-sharded, past the coarse rows)"
    config = dataclasses.replace(_experiment_config(), **DEEP_CONFIG)
    augment_fn = make_train_augment_fn(*loop._augment_params(config), True)
    state = create_train_state(config, device=dev, seed=13)
    step = make_pacing_train_step(config, 100, augment_fn=augment_fn)
    gen = torch.Generator(device=dev)
    times = []
    for _ in range(3 + DEEP_TIMED):
        seed_step(gen, dev, config.seed, state.step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, raws[1], gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    _check(all(math.isfinite(float(v)) for v in metrics.values()),
           f"{name}: one card's update at {DEEP_CONFIG}: {metrics}")
    single_ms = statistics.median(times[3:])
    print(f"{name}: {smi}: one card's eager update at {DEEP_CONFIG}: median "
          f"{single_ms:.3f} ms", flush=True)
    del state, step
    _release_memory()
    paths = {}
    results = _hold_on_ranks(name, dev, data_root, raws, smi, single_ms, DEEP_WORLD,
                             DEEP_WORLD, DEEP_CONFIG)
    for r, res in enumerate(results):
        paths[f"{name}, rank {r}"] = res["launches"][config.compute_dtype]
    _release_memory()

    devices = _rank_devices(dev, DEEP_WORLD)
    loop_config = dataclasses.replace(config, epoch=1, ckp_interval=1, device_resident_data="on",
                                      num_devices=DEEP_WORLD, spatial_shards=DEEP_WORLD)
    run_dir = os.path.join(data_root, "runs", "height_sharded_deep")
    t0 = time.perf_counter()
    loop.train_driver(loop_config, data_root, run_dir, max_steps_per_epoch=SP_LOOP_STEPS,
                      device=devices)
    seconds = time.perf_counter() - t0
    log, epochs, epoch_metrics = _loop_epochs(run_dir)
    dispatch = _loop_dispatch(min(loop_config.steps_per_dispatch, SP_LOOP_STEPS),
                              mesh.backend_for(devices))
    _check(f"mesh data=1 x space={DEEP_WORLD}" in log and dispatch in log
           and f"over {mesh.backend_for(devices)}" in log and "val: 000" in log
           and len(epochs) == 1
           and all(math.isfinite(v) for m in epoch_metrics for v in m.values()),
           f"{name}: the loop on the ranks did not run as planned:\n{log[-2000:]}")
    print(f"{name}: {smi}: train_driver with spatial_shards={DEEP_WORLD}, {DEEP_CONFIG}, "
          f"on {', '.join(map(str, devices))}: 1 epoch of {SP_LOOP_STEPS} "
          f"steps ({dispatch}) and the validation in {seconds:.1f} s with the ranks' start, "
          f"epoch (s, slices/s) {epochs}, metrics {epoch_metrics}", flush=True)
    return paths


GR_TIMED = 8             # updates timed a path, and the gloo ranks' chunk, in train (ranks, graph)


def _equal_on_ranks(ranks, state):
    """Whether ``state``'s parameters, BN statistics and bank are equal bit
    for bit on every rank (each rank's copy in its slot of a zero-filled
    buffer, summed)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in
                      list(state.model.parameters()) + list(state.model.buffers())])
    every = ranks.sum_(torch.stack([flat if r == ranks.rank else torch.zeros_like(flat)
                                    for r in range(ranks.world)]))
    return all(torch.equal(every[0], every[r]) for r in range(ranks.world))


def _chunk_on_gloo(name, config, augment_fn, raws, dev, counters, ranks):
    """A chunk of ``len(raws)`` updates on gloo ranks, which ``uses_graph``
    steps eagerly, against the same updates one at a time, each reseeded
    from ``(seed, step)``, in float32 under deterministic algorithms: the
    summed metrics and the whole state bit for bit.  Returns the chunk's
    launches."""
    import dataclasses

    from pacingpseudo_torch.parallel import mesh
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import (_accumulate, make_chunked_train_step,
                                               make_pacing_train_step, seed_step, uses_graph)

    k = len(raws)
    _check(ranks.backend == "gloo" and not uses_graph(dev, k, ranks.backend),
           f"{name}: the {ranks.backend} ranks would replay a graph")
    cfg = dataclasses.replace(config, compute_dtype="float32")
    stack = {key: torch.stack([r[key] for r in raws]) for key in raws[0]}
    runs = {}
    for how in ("chunk", "single"):
        state = create_train_state(cfg, device=dev, seed=11)
        mesh.replicate(state.model, ranks)
        step = make_pacing_train_step(cfg, 1000, augment_fn=augment_fn, ranks=ranks)
        gen = torch.Generator(device=dev)
        _reset_launch_counts(counters)
        if how == "chunk":
            acc = make_chunked_train_step(step, k)(state, stack, gen, cfg.seed)
            launches = {key: v for key, v in _launch_counts(counters).items() if v}
        else:
            acc = None
            for i in range(k):
                seed_step(gen, dev, cfg.seed, state.step)
                acc = _accumulate(acc, step(state, {key: v[i] for key, v in stack.items()},
                                            gen))
        torch.cuda.synchronize()
        runs[how] = (state, acc)
    (chunk, acc_c), (single, acc_s) = runs["chunk"], runs["single"]
    n = _check_states_equal(f"{name}: chunk vs single updates", chunk, single)
    _check(all(acc_c[key] == v if key == "lr" else torch.equal(acc_c[key], v)
               for key, v in acc_s.items()),
           f"{name}: the chunk's summed metrics differ from the single updates'")
    want = {"fused_loss_fwd": k, "fused_loss_bwd": k, "warp_cubic": k}
    _check(launches == want, f"{name}: rank {ranks.rank} counted {launches} in a chunk of "
                             f"{k}, want {want}")
    _check(_equal_on_ranks(ranks, chunk), f"{name}: the ranks' states differ")
    return launches, n, float(acc_c["loss_total"]) / k


def _graph_rank(rank, devices, store, work, raws_path, n_space=1):
    """One rank of ``train (ranks, graph)`` (a spawned process, or the main
    process for a one-rank world).  On NCCL: the replayed update on the
    ranks held against the eager update on the same ranks
    (``_hold_replay_once`` with ``ranks``: in bf16 in the default mode
    beside four eager repeats, and in float32 under deterministic
    algorithms beside a spread of 0), then ``_time_replay_and_eager`` on
    the ranks, whose graph path must count one ``fused_loss_fwd``,
    ``fused_loss_bwd`` and ``warp_cubic`` launch a rank an update (each
    replay adds what its capture counted: ``StepGraph``) and nothing else.
    On gloo: ``_chunk_on_gloo``.  Writes ``rank<r>.json``."""
    import dataclasses

    from pacingpseudo_torch.aug.engine import make_train_augment_fn
    from pacingpseudo_torch.ops import fused_convbn as fc
    from pacingpseudo_torch.ops import fused_loss as fl
    from pacingpseudo_torch.ops import warp_cubic as wc
    from pacingpseudo_torch.ops import warp_table as wt
    from pacingpseudo_torch.parallel import mesh
    from pacingpseudo_torch.train.loop import _augment_params
    from pacingpseudo_torch.train.step import uses_graph

    ranks = mesh.init_rank_group(rank, devices, store, n_space)
    dev = ranks.device
    name = (f"train (ranks, graph), data {ranks.n_data} x space {n_space} over "
            f"{ranks.backend}")
    config = _experiment_config()
    augment_fn = make_train_augment_fn(*_augment_params(config), True)
    raws = [{k: v.to(dev) for k, v in r.items()} for r in torch.load(raws_path)]
    counters = (fl, wt, wc, fc)
    out = {"backend": ranks.backend}
    if uses_graph(dev, len(raws), ranks.backend):
        out["hold bf16, default mode"] = _hold_replay_once(
            f"{name} (default mode)", config, augment_fn, raws[:2], dev, EAGER_RUNS_DEFAULT,
            ranks)
        _release_memory()
        modes = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        _deterministic_f32(True)
        try:
            out["hold float32, deterministic"] = _hold_replay_once(
                f"{name} (float32, deterministic)",
                dataclasses.replace(config, compute_dtype="float32"), augment_fn, raws[:2],
                dev, EAGER_RUNS, ranks)
        finally:
            torch.use_deterministic_algorithms(modes, warn_only=True)
            _deterministic_f32(False)
        _release_memory()
        out["eager_ms"], out["graph_ms"], launches = _time_replay_and_eager(
            name, config, augment_fn, raws, dev, counters, ranks)
        out["graph_launches"] = {k: v for k, v in launches.items() if v}
        updates = 2 * len(raws)
        want = {"fused_loss_fwd": updates, "fused_loss_bwd": updates, "warp_cubic": updates}
        _check(out["graph_launches"] == want,
               f"{name}: rank {rank} counted {out['graph_launches']} in {updates} updates of "
               f"the graph path, want {want}")
    else:
        torch.use_deterministic_algorithms(True, warn_only=True)
        _deterministic_f32(True)
        try:
            out["chunk_launches"], out["tensors"], out["loss_total"] = _chunk_on_gloo(
                name, config, augment_fn, raws, dev, counters, ranks)
        finally:
            torch.use_deterministic_algorithms(False, warn_only=True)
            _deterministic_f32(False)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mesh.close_rank_group(ranks)


def phase_ranks_graph(dev, data_root, raws, smi, one_card):
    """``train (ranks, graph)``: ``steps_per_dispatch`` on ranks, the
    Experiment session at full width (the CHAOS shape, batch 12, bf16).
    With two cards or more, NCCL ranks a card each, data 2, space 2 and,
    with four, data 2 x space 2: the replayed update (collectives, kernels
    1, 2 and 6b, the optimizer, captured in one ``StepGraph``) held against
    the eager update on the same ranks, launches and replicas after the
    replays, and the median replayed and eager update on the ranks beside
    ``one_card`` (one card's eager and replayed ms in this run).  With one
    card, a one-rank NCCL world in this process runs the same (its
    world-axis collectives captured), and two gloo ranks sharing the card
    run a chunk of ``GR_TIMED`` updates, which the rule steps eagerly,
    against as many single updates.  The loop on NCCL ranks with
    ``steps_per_dispatch`` 8 is ``phase_data_parallel``'s.  Returns each
    path's launches by rank."""
    from pacingpseudo_torch.parallel import mesh

    name = "train (ranks, graph)"
    batch = _experiment_config().batch_size
    cards = torch.cuda.device_count()
    if cards >= 2:
        grids = [(2, 1), (2, 2)] + ([(4, 2)] if cards >= 4 else [])
        runs = [(f"data {w // s} x space {s}", [torch.device("cuda", i) for i in range(w)],
                 s, True) for w, s in grids]
        print(f"{name}: {cards} cards: NCCL ranks a card each, captured", flush=True)
    else:
        runs = [("one-rank NCCL world", [dev], 1, False),
                ("two gloo ranks sharing the card", [dev, dev], 1, True)]
        print(f"{name}: one card: a one-rank NCCL world captures its world-axis "
              f"collectives (sync BN, the losses' normalisers, gradients, metrics); two "
              f"ranks on one card run over gloo, which cannot be captured, so they run a "
              f"chunk of {len(raws)} as eager steps", flush=True)
    root = os.path.join(data_root, "ranks_graph")
    os.makedirs(root)
    raws_path = os.path.join(root, "raws.pt")
    torch.save([{k: v.cpu() for k, v in r.items()} for r in raws], raws_path)
    paths = {}
    for tag, devices, n_space, spawn in runs:
        work = os.path.join(root, tag.replace(" ", "_"))
        os.makedirs(work)
        args = (devices, os.path.join(work, "store"), work, raws_path, n_space)
        _release_memory()
        t0 = time.perf_counter()
        if spawn:
            mesh.spawn_ranks(_graph_rank, len(devices), args)
        else:
            _graph_rank(0, *args)
        results = [json.load(open(os.path.join(work, f"rank{r}.json")))
                   for r in range(len(devices))]
        seconds = time.perf_counter() - t0
        backend = results[0]["backend"]
        if "graph_ms" in results[0]:
            for key in ("hold bf16, default mode", "hold float32, deterministic"):
                print(f"{name}, {tag} ({backend}), {key}: {results[0][key]}", flush=True)
            replay, eager = results[0]["graph_ms"], results[0]["eager_ms"]
            print(f"{name}, {tag} ({backend}): {smi}: median of {len(raws)} updates: "
                  f"replayed {replay:.3f} ms ({batch * 1e3 / replay:.1f} slices/s), eager "
                  f"{eager:.3f} ms on the same ranks; one card in this run: replayed "
                  f"{one_card[1]:.3f} ms, eager {one_card[0]:.3f} ms; medians by rank: "
                  f"replayed {[round(r['graph_ms'], 3) for r in results]}, eager "
                  f"{[round(r['eager_ms'], 3) for r in results]}; launches a rank in "
                  f"{2 * len(raws)} updates of the graph path (1 eager, the rest replays) "
                  f"{[r['graph_launches'] for r in results]}; parameters, BN statistics "
                  f"and bank equal on the ranks; {seconds:.1f} s with the ranks' start",
                  flush=True)
            for r, res in enumerate(results):
                paths[f"{name}, {tag}, rank {r}"] = res["graph_launches"]
        else:
            print(f"{name}, {tag} ({backend}): a chunk of {len(raws)} eager steps == "
                  f"{len(raws)} single updates bit for bit (float32, deterministic; "
                  f"{results[0]['tensors']} tensors of state and the summed metrics; mean "
                  f"loss_total {results[0]['loss_total']:.6f}); launches a rank "
                  f"{[r['chunk_launches'] for r in results]}; {seconds:.1f} s with the "
                  f"ranks' start", flush=True)
            for r, res in enumerate(results):
                paths[f"{name}, {tag}, rank {r}"] = res["chunk_launches"]
    return paths


# Height-sharded inference may predict a pixel differently from one card
# where bf16 rounding (a halo conv adds in another order than the whole
# image's) tips a near tie.  Of the test fold's 25,165,824 pixels, 1,369
# and 1,324 differed from this script's trained checkpoint, at most 24 in a
# slice; 20 (at most 3) from random weights and 1,317 (at most 9) after 20
# steps (``scripts/sharded_inference_diff.py``).  With zeroed halos, 71,773
# differ, 443 in one slice.  All on an NVIDIA H100 80GB HBM3 at 700.00 W.
# The limits: a share of the fold's pixels, and of a slice's.
SHARDED_PIXELS_MAX = 2e-4
SHARDED_SLICE_PIXELS_MAX = 2e-3


def sharded_inference_diff(dev, data_root, model_kwargs, checkpoint, shards=2,
                           batch_size=8, slices=TEST_FOLD_SLICES, name="inference (height-sharded)",
                           config=None):
    """``run_inference`` (bf16) on the test fold of ``make_test_fold``
    (or of ``config``'s dataset and fold; CHAOS's by default) under
    ``data_root`` from ``checkpoint`` on one card, then with
    ``spatial_shards=shards`` on ``shards`` ranks (a card each where there
    are enough, else all on ``dev`` over gloo).  Returns both results and,
    for each slice, how many predicted pixels differ."""
    from pacingpseudo_torch.evals import infer

    config = config or _experiment_config()
    spec, fold = config.spec, config.fold
    runs = {}
    for tag, devices, n in (("one card", dev, 1),
                            (f"space {shards}", _rank_devices(dev, shards), shards)):
        out_dir = os.path.join(data_root, "inference_sharded", tag.replace(" ", "_"))
        os.makedirs(out_dir)
        _release_memory()
        res = infer.run_inference(spec.name, fold, checkpoint, data_root, out_dir,
                                  batch_size=batch_size, model_kwargs=model_kwargs,
                                  compute_dtype="bfloat16", num_workers=INFER_WORKERS,
                                  save_pred=os.path.join(out_dir, "preds"), device=devices,
                                  spatial_shards=n)
        runs[tag] = (res, out_dir)
    (one, one_dir), (sp, sp_dir) = runs["one card"], runs[f"space {shards}"]
    _check(sp["uids"] == one["uids"] and len(one["uids"]) == slices,
           f"{name}: uids differ or {len(one['uids'])} slices")
    differ = [int((np.load(os.path.join(one_dir, "preds", f"{uid}.npz"))["pred"]
                   != np.load(os.path.join(sp_dir, "preds", f"{uid}.npz"))["pred"]).sum())
              for uid in one["uids"]]
    saved = np.load(os.path.join(sp_dir, "eval_data.npz"))
    _check(saved["dicearr"].shape == (slices, spec.num_classes)
           and list(saved["uids"]) == one["uids"],
           f"{name}: eval_data.npz {saved['dicearr'].shape}")
    return one, sp, differ


def phase_inference_sharded(dev, data_root, config, checkpoint, smi, shards=2,
                            slices=TEST_FOLD_SLICES, name="inference (height-sharded)"):
    """``inference (height-sharded)``: :func:`sharded_inference_diff` on
    ``shards`` ranks, the model of ``config``, on the ``slices`` test slices
    under ``data_root``.  The pixels predicted differently from one card
    must stay within ``SHARDED_PIXELS_MAX`` of the fold's and
    ``SHARDED_SLICE_PIXELS_MAX`` of each slice's, and each slice's Dice
    and HD95 must equal the single-card run's wherever the two runs
    predicted the same slice.  Prints the counts and each run's slices/s
    (the whole run, HD95 in the host threads)."""
    kwargs = dict(input_ch=config.input_ch, init_ch=config.init_ch, max_ch=config.max_ch,
                  output_stride=config.output_stride, is_stride_conv=config.is_stride_conv,
                  is_trans_conv=config.is_trans_conv)
    one, sp, differ = sharded_inference_diff(dev, data_root, kwargs, checkpoint, shards,
                                             slices=slices, name=name, config=config)
    ds_dir = "chaos" if config.dataset.startswith("chaos") else config.dataset
    sizes = [np.load(os.path.join(data_root, ds_dir, "slices", f"{uid}.npz"))["img"].shape
             for uid in one["uids"]]
    planes = [h * w for h, w in sizes]
    total, worst = sum(differ), max(differ)
    _check(total <= SHARDED_PIXELS_MAX * sum(planes)
           and all(n <= SHARDED_SLICE_PIXELS_MAX * p for n, p in zip(differ, planes)),
           f"{name}: {total} predicted pixels of "
           f"{sum(planes)} differ from one card's, {worst} in one slice "
           f"(limits {SHARDED_PIXELS_MAX:g} and {SHARDED_SLICE_PIXELS_MAX:g} of them)")
    for i, (uid, n) in enumerate(zip(one["uids"], differ)):
        if n == 0:
            for key in ("dicearr", "hd95arr"):
                _check(np.array_equal(sp[key][i], one[key][i], equal_nan=True),
                       f"{name}: {uid}'s {key} {sp[key][i]} on {shards} ranks, "
                       f"{one[key][i]} on one card, with the same prediction")
    print(f"{name}: {smi}: {slices} test slices of {min(sizes)}-{max(sizes)}, bf16, output "
          f"stride {config.output_stride}, spatial_shards {shards} on "
          f"{', '.join(map(str, _rank_devices(dev, shards)))}: {total} "
          f"predicted pixels of {sum(planes)} differ from the single-card "
          f"run's (limit {SHARDED_PIXELS_MAX:g} of them), in {sum(n > 0 for n in differ)} "
          f"slices, at most {worst} in one (limit {SHARDED_SLICE_PIXELS_MAX:g} of a slice's); "
          f"every other slice's Dice and HD95 equal; the whole "
          f"run {sp['slices_per_sec']:.1f} slices/s on the ranks, "
          f"{one['slices_per_sec']:.1f} on one card; Dice {sp['dice']:.4f} vs "
          f"{one['dice']:.4f}, HD95 {sp['hd95']:.2f} vs {one['hd95']:.2f}", flush=True)


# The profiler's kernel names of the wrappers' kernels on the raw step's path.
REPLAY_KERNELS = {"fused_loss_fwd": "fwd_kernel", "fused_loss_bwd": "bwd_kernel",
                  "warp_cubic": "warp_cubic_kernel"}


def check_graph_replay_launches(dev, raw, augment_fn, counters):
    """Kernels inside replays, by the profiler: the raw step on the batch
    ``raw``, one eager update and ``REPLAYS_PROFILED`` replays of its graph
    (captured outside the traces, each trace after one untraced call); the
    replays must run ``REPLAYS_PROFILED`` x the eager step's
    ``fused_loss_fwd``, ``fused_loss_bwd`` and ``warp_cubic`` kernels, and
    the wrappers' counts must add one a kernel a replay, traced or not.
    Returns the profiler's counts in the replays by wrapper name."""
    from pacingpseudo_torch.train.graph import StepGraph
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import make_pacing_train_step, seed_step

    config = _experiment_config()
    state = create_train_state(config, device=dev)
    step = make_pacing_train_step(config, 1000, augment_fn=augment_fn)
    gen = torch.Generator(device=dev)
    graph = StepGraph()

    def reseed(n):
        seed_step(gen, dev, config.seed, n)

    def as_batch(r):
        return r

    graph.run(step, state, raw, as_batch, gen, reseed)     # eager + capture
    kernels = tuple(REPLAY_KERNELS)

    def count(names):
        return {k: sum(REPLAY_KERNELS[k] in n for n in names) for k in kernels}

    eager = count(_kernels_launched(lambda: (reseed(state.step), step(state, raw, gen)),
                                    calls=1))
    replays = graph.replays
    _reset_launch_counts(counters)
    got = count(_kernels_launched(lambda: graph.run(step, state, raw, as_batch, gen, reseed),
                                  calls=REPLAYS_PROFILED))
    counted = {k: v for k, v in _launch_counts(counters).items() if v}
    _check(graph.captures == 1 and graph.replays == replays + REPLAYS_PROFILED + 1
           and all(eager[k] == 1 for k in kernels)
           and all(got[k] == REPLAYS_PROFILED * eager[k] for k in kernels)
           and counted == {k: REPLAYS_PROFILED + 1 for k in kernels},
           f"train (raw, graph): the profiler saw {got} in {REPLAYS_PROFILED} replays, "
           f"{eager} in one eager step ({graph.captures} captures); the wrappers counted "
           f"{counted} in {REPLAYS_PROFILED + 1} replays")
    state.optimizer.zero_grad(set_to_none=True)
    graph.reset()
    print(f"train (raw, graph): kernels inside {REPLAYS_PROFILED} replays (profiler) {got}, "
          f"in one eager step {eager}; the wrappers counted {counted} in "
          f"{REPLAYS_PROFILED + 1} replays", flush=True)
    return got


STUDY_SLICES = 48        # the tiny study's hard pool
STUDY_EPOCHS = 2


def _script(name):
    """``scripts/<name>.py`` as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_study_tiny(root, counters, smi):
    """``scripts/quality_study_torch.py`` at full width on this card: a hard
    pool of ``STUDY_SLICES`` phantoms, ``--epochs 2``, every arm trained
    (the loop's defaults: 8 updates a dispatch, replayed, the pool resident)
    and its best checkpoint evaluated, the summary written; the Experiment
    arm alone between the counts' reset and read.  At lr 0.003 (the one
    extra ``cli.train`` flag), as in ``phase_sweep``, so that an arm predicts
    some foreground in 6 updates and saves the best checkpoint that its
    evaluation reads.  Then ``scripts/quality_study_compare.py`` over the
    output against ``study_r3``: its JSON must parse, with a verdict for
    each rule (none is taken at 2 epochs)."""
    runner, compare = _script("quality_study_torch"), _script("quality_study_compare")
    study = os.path.join(root, "study")
    args = ["--root", study, "--epochs", str(STUDY_EPOCHS), "--slices", str(STUDY_SLICES)]
    extra = ["--", "--lr", "0.003"]
    _release_memory()
    t0 = time.perf_counter()
    runner.main(args + ["--arms", "Control", "Upperbound"] + extra)
    _reset_launch_counts(counters)
    t1 = time.perf_counter()
    rows = runner.main(args + ["--arms", "Experiment"] + extra)
    t2 = time.perf_counter()
    launches = _launch_counts(counters)
    _check(all(launches[k] >= 1 for k in ("fused_loss_fwd", "fused_loss_bwd", "warp_cubic"))
           and launches["fused_loss_fwd"] == launches["fused_loss_bwd"],
           f"study (tiny): the Experiment arm's launches {launches}")
    epochs = {}
    for row in rows:
        arm = row["arm"]
        run_dir = os.path.join(study, arm, "run-fold0")
        log = open(os.path.join(run_dir, "log.txt")).read()
        valdice = np.load(os.path.join(run_dir, "valdice.npz"))["valdice"]
        _check(valdice.shape == (STUDY_EPOCHS,) and np.isfinite(valdice).all()
               and all(f"val: {e:03d}," in log for e in range(STUDY_EPOCHS))
               and os.path.exists(os.path.join(study, arm, "DONE")),
               f"study (tiny): {arm} ran {valdice} epochs, or left no DONE marker")
        _check(all(row.get(k) is not None and math.isfinite(row[k])
                   for k in ("test_dice_slice", "test_dice_patient", "test_hd95_slice")),
               f"study (tiny): {arm}'s summary row {row}")
        epochs[arm] = [float(x) for x in re.findall(r"([0-9.]+) s/epoch", log)]
    _check([r["arm"] for r in rows] == ["Control", "Experiment", "Upperbound"],
           f"study (tiny): summary rows {rows}")
    compare.main(["--jax", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "study_r3"), "--port", study])
    rules = json.load(open(os.path.join(study, "compare.json")))["rules"]
    _check(sorted(rules) == ["a", "b", "c", "d"]
           and all(r["verdict"] in ("pass", "fail", "not evaluated") for r in rules.values()),
           f"study (tiny): compare.json's rules {rules}")
    print(f"study (tiny): {smi}: {STUDY_SLICES} hard slices, {STUDY_EPOCHS} epochs an arm; "
          f"Control and Upperbound {t1 - t0:.1f} s, Experiment {t2 - t1:.1f} s (pool, training, "
          f"inference); s/epoch {epochs}; Experiment arm launches "
          f"{ {k: v for k, v in launches.items() if v} }; summary "
          f"{[(r['arm'], round(r['best_val_dice'], 4), round(r['test_dice_slice'], 4), round(r['test_hd95_slice'], 2)) for r in rows]}",
          flush=True)
    return launches


def phase_study_tiny_dilated(root, counters, smi):
    """The dilated, frozen-BN study at ``STUDY_SLICES`` slices and full
    width: ``scripts/study_r3_pool_torch.py --scribble_style dilated``, then
    ``scripts/quality_study_torch.py --r3_split --scribble_style dilated`` on
    that pool, both arms under the BatchNorm quirk on the 200-epoch schedule
    of ``study_r3_dilated``, stopped after epoch ``STUDY_EPOCHS - 1``, at lr
    0.003 as ``phase_study_tiny``; the Experiment arm alone between the
    counts' reset and read.  Then ``scripts/quality_study_compare.py
    --protocol dilated`` against ``study_r3_dilated``: its identity checks
    pass (the quirk and 200 epochs in every arm's config, the pool's fold 0
    in every log header) and its JSON parses, with a verdict for each
    rule."""
    runner, compare = _script("quality_study_torch"), _script("quality_study_compare")
    pool = _script("study_r3_pool_torch")
    study = os.path.join(root, "study_dilated")
    data = os.path.join(study, "data")
    _release_memory()
    t0 = time.perf_counter()
    pool.main(["--data_root", data, "--slices", str(STUDY_SLICES), "--scribble_style", "dilated"])
    t1 = time.perf_counter()
    mark = pool.read_marker(data)
    _check(mark is not None and mark["scribble_style"] == "dilated"
           and mark["slices"] == STUDY_SLICES,
           f"study (tiny, dilated): the pool's marker {mark}")
    args = ["--root", study, "--r3_split", "--scribble_style", "dilated", "--tag",
            "study_torch_dilated", "--epochs", "200", "--slices", str(STUDY_SLICES),
            "--stop_after_epoch", str(STUDY_EPOCHS - 1)]
    extra = ["--", "--ref_quirk_bn_eval_after_first_epoch", "--lr", "0.003"]
    runner.main(args + ["--arms", "Control"] + extra)
    _reset_launch_counts(counters)
    t2 = time.perf_counter()
    rows = runner.main(args + ["--arms", "Experiment"] + extra)
    t3 = time.perf_counter()
    launches = _launch_counts(counters)
    _check(all(launches[k] >= 1 for k in ("fused_loss_fwd", "fused_loss_bwd", "warp_cubic"))
           and launches["fused_loss_fwd"] == launches["fused_loss_bwd"],
           f"study (tiny, dilated): the Experiment arm's launches {launches}")
    _check([r["arm"] for r in rows] == ["Control", "Experiment"],
           f"study (tiny, dilated): summary rows {rows}")
    epochs = {}
    for row in rows:
        arm = row["arm"]
        run_dir = os.path.join(study, arm, "run-fold0")
        log = open(os.path.join(run_dir, "log.txt")).read()
        config = json.load(open(os.path.join(run_dir, "config.json")))
        valdice = np.load(os.path.join(run_dir, "valdice.npz"))["valdice"]
        _check(config["ref_quirk_bn_eval_after_first_epoch"] is True and config["epoch"] == 200
               and valdice.shape == (200,) and np.isfinite(valdice).all()
               and all(f"val: {e:03d}," in log for e in range(STUDY_EPOCHS))
               and f"val: {STUDY_EPOCHS:03d}," not in log,
               f"study (tiny, dilated): {arm} ran {valdice[:STUDY_EPOCHS + 1]}")
        frozen = log.split("val: 000,")[1].split("epoch: 001,")[0]
        _check("epoch 001 on: frozen-BN step" in frozen,
               f"study (tiny, dilated): {arm}'s epoch 1 did not take the frozen-BN step")
        _check(all(row.get(k) is not None and math.isfinite(row[k])
                   for k in ("test_dice_slice", "test_dice_patient", "test_hd95_slice")),
               f"study (tiny, dilated): {arm}'s summary row {row}")
        epochs[arm] = [float(x) for x in re.findall(r"([0-9.]+) s/epoch", log)]
    out = compare.main(["--protocol", "dilated", "--jax",
                        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                     "study_r3_dilated"),
                        "--port", study, "--slices", str(STUDY_SLICES)])
    rules = json.load(open(os.path.join(study, "compare.json")))["rules"]
    _check(out["protocol"] == "dilated" and sorted(rules) == ["a", "b", "c", "d"]
           and all(r["verdict"] in ("pass", "fail", "not evaluated") for r in rules.values()),
           f"study (tiny, dilated): compare.json's rules {rules}")
    print(f"study (tiny, dilated): {smi}: pool of {STUDY_SLICES} dilated slices {t1 - t0:.1f} s; "
          f"{STUDY_EPOCHS} epochs an arm under the BN quirk; Control {t2 - t1:.1f} s, "
          f"Experiment {t3 - t2:.1f} s (training, inference); s/epoch {epochs}; Experiment arm "
          f"launches { {k: v for k, v in launches.items() if v} }; rules "
          f"{ {k: r['verdict'] for k, r in rules.items()} }; summary "
          f"{[(r['arm'], round(r['best_val_dice'], 4), round(r['test_dice_slice'], 4), round(r['test_hd95_slice'], 2)) for r in rows]}",
          flush=True)
    return launches


def make_cardiac_pool(root, dataset, dev, num_slices=CARDIAC_SLICES):
    """Write a seeded pool of ``num_slices`` "easy" phantoms with
    ``dataset``'s arguments (its crop, classes and ignore index; extents
    within ``CARDIAC_JITTER`` px of the crop) under ``root`` and open it as
    the loop does.  Returns ``(config, raw_batches)``: the Experiment
    session at that shape, and a generator that walks the shuffled training
    loader and hands each raw batch over on the device (close it to stop
    the loader's threads)."""
    from pacingpseudo_torch.data.npz_dataset import BatchLoader, SliceDataset
    from pacingpseudo_torch.data.splits import read_fold_split
    from pacingpseudo_torch.data.synthetic import write_synthetic_dataset

    config = _experiment_config(dataset)
    spec = config.spec
    t0 = time.perf_counter()
    write_synthetic_dataset(root, dataset, num_slices, spec.input_size, spec.num_classes,
                            spec.ignored_index, modality=config.modality, seed=config.seed,
                            size_jitter=CARDIAC_JITTER, difficulty="easy")
    seconds = time.perf_counter() - t0
    train_files, _ = read_fold_split(root, dataset, config.fold)
    train_set = SliceDataset(train_files, spec.num_classes, spec.ignored_index)
    loader = BatchLoader(train_set, config.batch_size, shuffle=True, drop_last=True,
                         seed=config.seed, num_threads=4)
    extents = {tuple(train_set.load(i)["size"]) for i in range(len(train_set))}
    _check(train_set.canvas_size == CARDIAC_CANVAS and len(extents) > 1
           and all(abs(e - c) <= CARDIAC_JITTER for ext in extents
                   for e, c in zip(ext, spec.input_size)),
           f"train ({dataset}): canvas {train_set.canvas_size}, extents {sorted(extents)}")
    print(f"train ({dataset}): wrote {num_slices} slices of extents "
          f"{min(e[0] for e in extents)}-{max(e[0] for e in extents)} x "
          f"{min(e[1] for e in extents)}-{max(e[1] for e in extents)} in {seconds:.2f} s; "
          f"{len(train_set)} training slices on a canvas of {train_set.canvas_size}, "
          f"{len(loader)} batches an epoch", flush=True)
    return config, _device_batches(loader, dev)


def phase_cardiac_train(dataset, counters, expected, dev, root, smi):
    """``train (<dataset>)``: the Experiment session at full width on
    ``make_cardiac_pool``'s pool, the loop's augmentation inside the step
    (the crop and embed of 224x224 from each slice's extent on the 256
    canvas): ``CARDIAC_WARM`` + ``CARDIAC_TIMED`` eager steps through
    ``phase_train`` (finite losses, ``expected`` launches a step: kernels 1,
    2 and 6b once each), then one replayed update held against the eager
    one (``_hold_replay``, as ``train (raw, graph)`` holds CHAOS's).
    Returns ``(state, launches, median step ms)``."""
    from pacingpseudo_torch.aug.engine import make_train_augment_fn
    from pacingpseudo_torch.train import loop

    name = f"train ({dataset})"
    config, raw_batches = make_cardiac_pool(os.path.join(root, dataset), dataset, dev)
    augment_fn = make_train_augment_fn(*loop._augment_params(config), True)
    raw = next(raw_batches)
    batch = augment_fn(raw, torch.Generator(device=dev).manual_seed(config.seed))
    crop = (config.batch_size, 1, *config.spec.input_size)
    _check(tuple(batch["image"].shape) == crop and tuple(batch["label"].shape)
           == (config.batch_size, config.num_classes, *config.spec.input_size),
           f"{name}: augmented image {tuple(batch['image'].shape)}, label "
           f"{tuple(batch['label'].shape)}, want {crop} and C = {config.num_classes}")
    del batch
    _release_memory()
    state, launches, ms = phase_train(
        name, counters, expected, dev, lambda: next(raw_batches), augment_fn=augment_fn,
        generator=torch.Generator(device=dev).manual_seed(config.seed),
        steps_warm=CARDIAC_WARM, steps_timed=CARDIAC_TIMED, config=config)
    raws = [next(raw_batches), next(raw_batches)]
    raw_batches.close()
    _release_memory()
    print(f"{name}: {_hold_replay(name, config, augment_fn, raws, dev)}", flush=True)
    print(f"{name}: {smi}: median eager step {ms:.3f} ms "
          f"({config.batch_size * 1e3 / ms:.1f} slices/s), C = {config.num_classes}, "
          f"launches {({k: v for k, v in launches.items() if v})} over "
          f"{CARDIAC_WARM + CARDIAC_TIMED} steps", flush=True)
    return state, launches, ms


def phase_inference_lvsc(dev, counters, root, state, smi):
    """``inference (lvsc)``: ``run_inference`` from ``state`` (``train
    (lvsc)``'s, saved as a checkpoint) on the test fold of its jittered pool,
    on one card and on 2 space ranks (a card each where there are two, else
    both on this card over gloo): ``eval_data.npz`` of shape (slices, 2),
    no kernel launched on one card, and the ranks held against one card by
    :func:`phase_inference_sharded`."""
    from pacingpseudo_torch.data.splits import read_test_split
    from pacingpseudo_torch.train import checkpoint as ckpt

    config = _experiment_config("lvsc")
    data_root = os.path.join(root, "lvsc")
    path = os.path.join(root, "lvsc_ckp")
    ckpt.save_checkpoint(path, state)
    slices = len(read_test_split(data_root, "lvsc", config.fold))
    _reset_launch_counts(counters)
    phase_inference_sharded(dev, data_root, config, path, smi, slices=slices,
                            name="inference (lvsc)")
    launches = _launch_counts(counters)
    saved = np.load(os.path.join(data_root, "inference_sharded", "one_card", "eval_data.npz"))
    _check(saved["dicearr"].shape == saved["hd95arr"].shape == (slices, config.num_classes)
           and not any(launches.values()),
           f"inference (lvsc): eval_data.npz {saved['dicearr'].shape}, kernels launched "
           f"{launches}")


def phase_profile_dir(data_root, smi):
    """``--profile_dir``: a CLI training run (the Experiment session at full
    width, 3 epochs of 2 steps, the graph path) writes one
    ``torch.profiler`` trace of epoch 1 with the card's kernels in it, and
    logs it."""
    profile = os.path.join(data_root, "profile")
    run_dir = os.path.join(data_root, "runs", "profiled")
    t0 = time.perf_counter()
    _run_cli("pacingpseudo_torch.cli.train", [
        "--session", "Experiment", *PACING_FLAGS, "--tag", "profiled", "--epoch", "3",
        "--max_steps_per_epoch", "2", "--no-tb_figures", "--data_root", data_root,
        "--run_dir", run_dir, "--profile_dir", profile])
    traces = os.listdir(profile)
    _check(traces == ["trace_epoch001.json"], f"profile_dir: traces {traces}")
    path = os.path.join(profile, traces[0])
    events = json.load(open(path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    log = open(os.path.join(run_dir, "log.txt")).read()
    _check(len(kernels) > 0 and f"profiler trace written to {path}" in log,
           f"profile_dir: {len(kernels)} kernels in the trace, or no log line")
    print(f"profile_dir: {smi}: the CLI run ({time.perf_counter() - t0:.1f} s) wrote "
          f"{traces[0]} ({os.path.getsize(path)} bytes, {len(kernels)} kernel events) and "
          f"logged it", flush=True)


def _print_clocks(when: str) -> None:
    """The card's SM and memory clocks, power draw and temperature, as
    ``nvidia-smi`` reads them, so that a kernel's time can be told from the
    card's state."""
    query = "clocks.sm,clocks.mem,power.draw,temperature.gpu"
    line = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(f"clocks {when}: {query}: {line.splitlines()[0]}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        _fail("no CUDA device: chip_smoke.py runs on a GPU only")
    from pacingpseudo_torch.aug import engine
    from pacingpseudo_torch.aug.presets import base_params_for
    from pacingpseudo_torch.ops import _build
    from pacingpseudo_torch.ops import fused_convbn as fc
    from pacingpseudo_torch.ops import fused_loss as fl
    from pacingpseudo_torch.ops import warp
    from pacingpseudo_torch.ops import warp_cubic as wc
    from pacingpseudo_torch.ops import warp_table as wt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    seconds, logs = _build.build()
    print(f"build: {seconds:.2f} s for {', '.join(_build.SOURCES)}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"build: {name}: {line.strip()}", flush=True)

    # The phases before the last run the default (unfused) ConvLayer,
    # whatever PACING_CONV_IMPL says.
    fc.set_conv_impl("xla")
    counters = (fl, wt, wc, fc)
    loss_kernels = {"fused_loss_fwd": 1, "fused_loss_bwd": 1}
    # The default route's warp kernel (ops/warp.py AUTO_CUDA_ROUTE) and the
    # table route's.
    warp_kernels = {"direct": "warp_cubic", "kernel": "warp_table"}
    warp_kernel = warp_kernels[warp.AUTO_CUDA_ROUTE]
    other_route = "kernel" if warp.AUTO_CUDA_ROUTE == "direct" else "direct"
    raw_kernels = {**loss_kernels, warp_kernel: 1}
    other_kernels = {**loss_kernels, warp_kernels[other_route]: 1}
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=dev)
    _print_clocks("before the kernels phase")
    rows = phase_kernels(fl, wt, wc, warp, dev)
    conv_rows = time_conv_kernels(fc, dev, check_conv_kernels(fc, dev), flush)
    _print_clocks("after the kernels phase")
    check_weight_grad(fc, dev)
    phase_parity(dev)
    phase_parity_fused(fc, dev)
    phase_parity_fused(fc, dev, upper_bound=True)

    config = _experiment_config()
    batch = make_batch(config.batch_size, config.spec.input_size[0],
                       config.num_classes, seed=config.seed, dev=dev)
    state, _, pre_ms = phase_train("train", counters, loss_kernels, dev,
                                   lambda: batch)
    phase_eval("eval", state, batch)
    del state, batch

    fused_kernels, fused_routes = _fused_step_plan(fc, config, "train (raw, fused conv)")
    fused_kernels.update(raw_kernels)
    ub_config = _upper_bound_config()
    ub_fused_kernels, ub_fused_routes = _fused_step_plan(
        fc, ub_config, "train (raw, upper bound, fused conv)")
    ub_fused_kernels[warp_kernel] = 1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pool_") as root:
        raw_batches, val_loader, config = make_raw_pool(root, dev)
        augment_fn, other_augment_fn = phase_augment(wt, wc, dev, next(raw_batches),
                                                     config, flush)
        del flush
        state, launches, raw_ms = phase_train(
            "train (raw)", counters, raw_kernels, dev,
            lambda: next(raw_batches), augment_fn=augment_fn,
            generator=torch.Generator(device=dev).manual_seed(config.seed))
        print(f"train (raw): median step {raw_ms:.3f} ms with the augmentation "
              f"inside ({warp_kernel} warp), {pre_ms:.3f} ms on the pre-augmented batch: "
              f"the augmentation adds {raw_ms - pre_ms:.3f} ms a step", flush=True)
        phase_eval_raw(state, val_loader, config, dev)
        del state
        # The other card route of the warp: the path of the warp kernel that
        # the default route does not launch.
        name = f"train (raw, {other_route} warp)"
        _, other_launches, other_ms = phase_train(
            name, counters, other_kernels, dev,
            lambda: next(raw_batches), augment_fn=other_augment_fn,
            generator=torch.Generator(device=dev).manual_seed(config.seed))
        print(f"{name}: median step {other_ms:.3f} ms with the {other_route} route's "
              f"warp, {raw_ms:.3f} ms with the default route's in this run", flush=True)
        fused_launches, routes, fused_ms = _phase_fused_train(
            fc, "train (raw, fused conv)", counters, fused_kernels, fused_routes, dev,
            raw_batches, augment_fn, config)
        print(f"train (raw, fused conv): median step {fused_ms:.3f} ms with the "
              f"fused ConvLayer, {raw_ms:.3f} ms unfused in this run; "
              f"launches a step {fused_kernels}", flush=True)

        # The Upperbound session: the bare model, the augmentation without
        # the strong stream, then the same under the fused conv impl (N = 12).
        ub_augment_fn = engine.make_train_augment_fn(base_params_for(ub_config.dataset),
                                                     do_strong=False)
        _, ub_launches, ub_ms = phase_train(
            "train (raw, upper bound)", counters, {warp_kernel: 1}, dev,
            lambda: next(raw_batches), augment_fn=ub_augment_fn,
            generator=torch.Generator(device=dev).manual_seed(config.seed), config=ub_config)
        ub_fused_launches, ub_routes, ub_fused_ms = _phase_fused_train(
            fc, "train (raw, upper bound, fused conv)", counters, ub_fused_kernels,
            ub_fused_routes, dev, raw_batches, ub_augment_fn, ub_config)
        graph_paths, one_card = phase_graph_train(dev, counters, raw_batches, augment_fn,
                                                  ub_augment_fn, fc, smi)
        replay_raw = next(raw_batches)
        dp_raws = [next(raw_batches), next(raw_batches)]
        sp_raws = [next(raw_batches), next(raw_batches)]
        deep_raws = [next(raw_batches), next(raw_batches)]
        rg_raws = [next(raw_batches) for _ in range(GR_TIMED)]
        raw_batches.close()
        print(f"train (raw, upper bound): {smi}: median step {ub_ms:.3f} ms "
              f"({ub_config.batch_size * 1e3 / ub_ms:.1f} slices/s), {ub_fused_ms:.3f} ms "
              f"under the fused conv impl (launches a step {ub_fused_kernels}); the "
              f"Experiment raw step {raw_ms:.3f} ms in this run", flush=True)

        exp_checkpoint = phase_loop(dev, counters, root, smi)
        ub_checkpoint = phase_loop_upper_bound(dev, counters, root, smi)
        test_root = os.path.join(root, "test")
        make_test_fold(test_root, config.seed)
        phase_inference(dev, counters, test_root,
                        (("upper bound (bare)", ub_config, ub_checkpoint),
                         ("experiment (siamese)", config, exp_checkpoint)), smi)
        phase_inference_sharded(dev, test_root, config, exp_checkpoint, smi)
        # The same checkpoint's weights at output stride 32 (the strides and
        # dilations differ, the parameters do not) on 96x96 slices: 3 coarse
        # rows on 4 space ranks.
        deep_root = os.path.join(root, "test_deep")
        make_test_fold(deep_root, config.seed, DEEP_TEST_SLICES, DEEP_INFER["input_size"])
        phase_inference_sharded(dev, deep_root,
                                dataclasses.replace(config, **DEEP_INFER), exp_checkpoint,
                                smi, shards=DEEP_WORLD, slices=DEEP_TEST_SLICES,
                                name="inference (height-sharded, past the coarse rows)")
        loop_root = os.path.join(root, "loop")
        make_loop_pool(loop_root, config.seed)
        loop_launches = phase_loop_graph(dev, counters, loop_root, smi)
        sweep_launches = phase_sweep(loop_root, smi)
        phase_loader_native(loop_root, dev, smi)
        dp_launches = phase_data_parallel(dev, loop_root, dp_raws, smi, raw_ms)
        _release_memory()
        sp_launches = phase_height_sharded(dev, loop_root, sp_raws, smi, raw_ms)
        _release_memory()
        deep_launches = phase_height_sharded_deep(dev, loop_root, deep_raws, smi)
        _release_memory()
        rg_launches = phase_ranks_graph(dev, loop_root, rg_raws, smi, one_card)
        del dp_raws, sp_raws, deep_raws, rg_raws
        study_launches = phase_study_tiny(root, counters, smi)
        dilated_launches = phase_study_tiny_dilated(root, counters, smi)
        cardiac_launches = {}
        for dataset in CARDIAC:
            _release_memory()
            state, cardiac_launches[f"train ({dataset})"], _ = phase_cardiac_train(
                dataset, counters, raw_kernels, dev, root, smi)
            if dataset == "lvsc":
                _release_memory()
                phase_inference_lvsc(dev, counters, root, state, smi)
            del state

        # Profiler sessions last: none is followed by a timed phase.
        check_bn_sums_launches(fc, dev)
        check_fused_loss_launches(fl, dev)
        replay_launches = check_graph_replay_launches(dev, replay_raw, augment_fn, counters)
        phase_profile_dir(loop_root, smi)
    paths = {"train (raw)": launches, f"train (raw, {other_route} warp)": other_launches,
             "train (raw, fused conv)": fused_launches,
             "train (raw, upper bound)": ub_launches,
             "train (raw, upper bound, fused conv)": ub_fused_launches,
             **graph_paths, "loop (resident, graph)": loop_launches,
             **{f"train (data-parallel), rank {r}": n for r, n in enumerate(dp_launches)},
             **sp_launches, **deep_launches, **rg_launches,
             "study (tiny), Experiment arm": study_launches,
             "study (tiny, dilated), Experiment arm": dilated_launches, **cardiac_launches,
             "sweep (jagged), Experiment session (child process)": sweep_launches}
    for row in rows:
        # Each kernel's launches on the path that runs it: the default raw
        # step, or the raw step on the other warp route for the warp kernel
        # that the default route does not launch.
        row["launches"] = (launches if raw_kernels.get(row["name"]) else
                           other_launches)[row["name"]]
    for row in conv_rows:
        row["launches"] = fused_launches[row["name"]]
        if row["name"] in routes:
            row["gemm_routes"] = routes[row["name"]]
            row["gemm_routes_upper_bound"] = ub_routes[row["name"]]
    for row in rows + conv_rows:
        # The launches of every path that runs the kernel, as its wrapper
        # counts them: 8 steps a timed eager path, 16 updates a timed graph
        # path (its eager warm-ups and the replays; the capture launches
        # nothing), 40 updates and the figure warps in a graph loop run.
        row["launches_by_path"] = {p: n[row["name"]] for p, n in paths.items()
                                   if n.get(row["name"])}
        if row["name"] in replay_launches:
            row["profiled_in_replays"] = {f"{REPLAYS_PROFILED} replays of the raw step":
                                          replay_launches[row["name"]]}
    print(json.dumps({"kernels": rows + conv_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
