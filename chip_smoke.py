"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build   -- compile ``pacingpseudo_torch/csrc/*.cu`` with nvcc into
              ``build/`` (one nvcc per source, all started together).
2. kernels -- hold ``fused_loss_fwd`` and ``fused_loss_bwd`` against their
              plain PyTorch versions at the train step's shapes (12 x C x
              256 x 256 for C in 2, 4, 5, an all-ignored target, an
              all-zero mask), and ``warp_table`` against its plain version
              bit for bit (12 x 256 x 256, 3 x 64 x 96, planes holding the
              sentinel 255 and the ignored index); then time kernel and
              plain version with CUDA events beside the bound the card's
              memory rate sets.  Then hold the fused-ConvLayer kernels
              ``conv_stats``, ``bn_sums`` and ``conv_pad_out`` against their
              plain versions in bfloat16 and float32 at ``CONV_CHECK_SHAPES``
              (bfloat16 ones cover every (BN, BK) tile pair that ``conv_plan``
              picks in the step, on the ``"wgmma"`` route; float32, Ci = 1
              and the ragged shape take ``"simple"``), and time each
              (bfloat16) at every fused layer of the step beside its bound,
              its plain version and the PyTorch call that computes the same
              function.  Hold the fused path's float32 weight gradient, from
              bfloat16 inputs, against a float64 sum.
3. parity  -- one train step at a small size in float32, once through the
              kernels and once through the loss library, from the same
              state: the losses and gradients must agree.  Then one such
              step through the fused conv kernels against the unfused
              ConvLayer (``parity (fused conv)``).
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
              std 1 inside it, one ``warp_table`` launch per call, and the
              kernel route equal to the plain route.  Times one call and,
              inside it, the table build, the row gather and the
              interpolation + vote.
7. train (raw) -- the same session with the augmentation inside the step
              (``augment_fn``) on raw batches from the loader: 3 warm-up and
              5 timed steps, one launch of each of the three kernels a step.
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

Phases 1-8 run the default conv impl (``"xla"``, the unfused ConvLayer)
whatever ``PACING_CONV_IMPL`` says.
Prints the card's name and power limit first, a ``kernels`` JSON line
before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX: it drives the port only.
"""
from __future__ import annotations

import json
import math
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
CONV_TIMING_REPS = 20
# (label, n, ci, co, h, w): where the fused-ConvLayer kernels are held
# against their plain versions: fused layers of the full-width step (the
# weak and strong streams stacked, N = 24) and one ragged small shape (Ci
# and Co off every vector width, W != H).  In bfloat16 they cover every
# (BN, BK) pair of the wgmma route that conv_plan picks in the step
# (check_conv_kernels fails otherwise).
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
)
GEMMS = ("conv_stats", "conv_pad_out")
CONV_KERNELS = ("conv_stats", "bn_sums", "conv_pad_out")
FUSED_LAYERS = 18   # ConvLayers of the full-width step on the fused path


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


def _loss_inputs(c, case, dev, seed):
    """Weak and strong logits as the two halves of one (24, C, H, W) NCHW
    tensor, as the fused-stream backbone leaves them; int64 target with
    ``c`` as the ignore index; float32 mask."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, h, w = 12, 256, 256
    logits = 2.0 * torch.randn((2 * n, c, h, w), generator=gen, device=dev)
    tgt = torch.randint(0, c + 1, (n, h, w), generator=gen, device=dev)
    mask = (torch.rand((n, h, w), generator=gen, device=dev) > 0.3).float()
    if case == "all_ignored":
        tgt.fill_(c)
    if case == "zero_mask":
        mask.zero_()
    return logits[:n], logits[n:], tgt, mask


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


def phase_kernels(fl, wt, dev):
    """Kernel vs plain version at the step's shapes; returns the rows of the
    ``kernels`` line, without ``launches``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    err = {"fused_loss_fwd": 0.0, "fused_loss_bwd": 0.0, "warp_table": 0.0}
    cases = [("random", 2), ("random", 4), ("random", 5),
             ("all_ignored", 5), ("zero_mask", 5)]
    for i, (case, c) in enumerate(cases):
        lw, ls, tgt, mask = _loss_inputs(c, case, dev, seed=100 + i)
        got = fl.fused_loss_forward(lw, ls, tgt, mask, c)
        want = fl.forward_plain(lw, ls, tgt, mask, c)
        torch.cuda.synchronize()
        _check(bool(torch.isfinite(got).all()), f"fwd {case} C={c}: not finite")
        close = torch.allclose(got, want, rtol=1e-5, atol=0.0)
        e = float((got - want).abs().max())
        _check(close, f"fwd {case} C={c}: {got.tolist()} vs {want.tolist()}")
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
                   f"bwd {case} C={c} {name}: max err {e} > {tol}")
            err["fused_loss_bwd"] = max(err["fused_loss_bwd"], e)
        print(f"kernels: {case} C={c} ok", flush=True)

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
             table_bytes, 0)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        row = {"name": name, "route": "cuda",
               "source": f"pacingpseudo_torch/csrc/{source}.cu",
               "replaces": f"pacingpseudo_tpu/ops/pallas/{replaces}",
               "launches": None, "max_abs_err": err[name],
               "ms": _time_ms(fn, flush), "plain_ms": _time_ms(plain, flush),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None}
        print(f"kernels: {name} {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}"
              f" ms, bound {row['bound_ms']:.4f} ms ({nbytes} bytes)", flush=True)
        rows.append(row)
    return rows


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


def check_conv_kernels(fc, dev):
    """``conv_stats``, ``bn_sums`` and ``conv_pad_out`` against their plain
    versions at ``CONV_CHECK_SHAPES``, in bfloat16 and float32.  Returns the
    max abs error of each kernel.

    Tolerances.  ``y`` and ``dxp``: both sides sum exact products in float32
    in different orders, so they differ by float32 roundoff (1e-4 of the
    largest value) and, in bfloat16, by one rounding step of the result
    (rtol 2**-7, one bfloat16 ulp).  The sums (of conv_stats and bn_sums):
    rtol 1e-4, with an atol of 1e-4 of the row's largest sum for a channel
    whose sum lies near 0.  The border of ``dxp`` exactly 0.  Each GEMM
    must take the route its plan names, and the bfloat16 shapes must cover
    every (BN, BK) pair that the plan picks at the step's layers."""
    from scripts.reckon_fused_conv_bounds import conv_layer_shapes

    err = dict.fromkeys(CONV_KERNELS, 0.0)
    covered = set()
    for i, (label, n, ci, co, h, w) in enumerate(CONV_CHECK_SHAPES):
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
            want = fc.bn_sums_plain(y, gzp, aux, 1e-2)
            torch.cuda.synchronize()
            row = 1e-4 * want.abs().amax(dim=1, keepdim=True)
            err["bn_sums"] = max(err["bn_sums"],
                                 _held(f"bn_sums {tag}", got, want, row, 1e-4))

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
            print(f"kernels: fused conv {tag} ok ({_route_tag(plans)})", flush=True)
            del xp, w9, gzp, w9t, y, y_p, dxp, dxp_p
    step = {(k, p.bn, p.bk) for s in conv_layer_shapes(_experiment_config()) if s[6]
            for k, p in _gemm_plans(fc, torch.bfloat16, *s[1:6]).items()
            if p.route == "wgmma" and (k == "conv_stats" or s[7])}
    _check(step <= covered, f"check shapes miss the step's wgmma tiles {sorted(step - covered)}")
    print(f"kernels: the check shapes cover all {len(step)} (kernel, BN, BK) wgmma tiles "
          "of the step", flush=True)
    return err


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


def phase_parity(dev):
    """The kernels' step against the loss library's step, same state."""
    from pacingpseudo_torch.config import ExperimentConfig
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import make_pacing_train_step

    torch.backends.cudnn.deterministic = True
    batch = make_batch(2, 64, 4, seed=3, dev=dev)
    runs = {}
    for mode in ("auto", "off"):
        config = ExperimentConfig(
            num_classes=4, ignored_index=4, init_ch=8, hid_ch=16, batch_size=2,
            session="Experiment", do_loss_ent=True, do_decoder_consistency=True,
            do_aux_path=True, do_memory=True, compute_dtype="float32",
            use_pallas_loss=mode).validate()
        state = create_train_state(config, device=dev, seed=11)
        metrics = make_pacing_train_step(config, steps_per_epoch=4)(state, batch)
        grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
        runs[mode] = ({k: float(v) for k, v in metrics.items()}, grads)
    torch.backends.cudnn.deterministic = False
    (m_k, g_k), (m_l, g_l) = runs["auto"], runs["off"]
    for k in m_l:
        _check(math.isclose(m_k[k], m_l[k], rel_tol=1e-4, abs_tol=1e-7),
               f"parity: {k} {m_k[k]} vs {m_l[k]}")
    for k, want in g_l.items():
        # A conv bias that feeds a BatchNorm has a true gradient of 0: hold
        # it against its conv weight's gradient instead.
        bn_fed = k.endswith(".conv.bias") or k == "aux_path.layer_bottleneck.1.bias"
        scale = float((g_l[k[:-4] + "weight"] if bn_fed else want).abs().max())
        e = float((g_k[k] - want).abs().max())
        _check(e <= 1e-3 * scale, f"parity: grad {k} err {e} vs max {scale}")
    print(f"parity: kernel step == library step over {len(g_l)} gradients, "
          f"loss_total {m_k['loss_total']:.6f}", flush=True)


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


def phase_parity_fused(fc, dev):
    """One train step at 64x64 in float32, TF32 off for convolutions and
    matmuls, through the fused conv kernels and through the unfused path
    from the same state.  Losses rtol 1e-4; gradients in L2 within 1e-2 of
    each leaf's norm: float32 differences of ~5e-5 flip the LeakyReLU
    branch of single pixels whose pre-activation lies nearer 0 (ROADMAP.md
    Queue 3).  At 64x64 the gate fuses enc_block1, enc_block2, dec_block2
    and dec_block1: 8 layers, 7 of which need dx."""
    from pacingpseudo_torch.config import ExperimentConfig
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import make_pacing_train_step

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    batch = make_batch(2, 64, 4, seed=3, dev=dev)
    runs = {}
    try:
        for impl in ("fused", "xla"):
            fc.set_conv_impl(impl)
            config = ExperimentConfig(
                num_classes=4, ignored_index=4, init_ch=8, hid_ch=16, batch_size=2,
                session="Experiment", do_loss_ent=True, do_decoder_consistency=True,
                do_aux_path=True, do_memory=True, compute_dtype="float32").validate()
            state = create_train_state(config, device=dev, seed=11)
            fc.reset_launch_counts()
            metrics = make_pacing_train_step(config, steps_per_epoch=4)(state, batch)
            torch.cuda.synchronize()
            grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
            runs[impl] = ({k: float(v) for k, v in metrics.items()}, grads,
                          dict(fc.LAUNCHES))
    finally:
        fc.set_conv_impl("xla")
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (m_f, g_f, n_f), (m_x, g_x, n_x) = runs["fused"], runs["xla"]
    _check(n_f == {"conv_stats": 8, "bn_sums": 8, "conv_pad_out": 7}
           and not any(n_x.values()),
           f"parity (fused conv): launches {n_f} fused, {n_x} unfused")
    for k in m_x:
        _check(math.isclose(m_f[k], m_x[k], rel_tol=1e-4, abs_tol=1e-7),
               f"parity (fused conv): {k} {m_f[k]} vs {m_x[k]}")
    _grads_close_l2("parity (fused conv)", g_f, g_x, 1e-2)
    worst = max(float((g_f[k] - g_x[k]).norm() / g_x[k].norm().clamp_min(1e-30))
                for k in g_x if not k.endswith("bias"))
    print(f"parity (fused conv): fused step == unfused step over {len(g_x)} "
          f"gradients (worst relative L2 error of a weight {worst:.2e}), "
          f"launches {n_f}, loss_total {m_f['loss_total']:.6f}", flush=True)


def _experiment_config():
    from pacingpseudo_torch.config import ExperimentConfig
    return ExperimentConfig(
        session="Experiment", do_loss_ent=True, do_decoder_consistency=True,
        do_aux_path=True, do_memory=True).validate()


def _reset_launch_counts(counters):
    for module in counters:
        module.reset_launch_counts()


def _launch_counts(counters):
    return {k: v for module in counters for k, v in module.LAUNCHES.items()}


def phase_train(name, counters, expected, dev, next_batch, augment_fn=None,
                generator=None, steps_warm=3, steps_timed=5):
    """The full-width Experiment train step, ``steps_warm + steps_timed``
    times, on the batches ``next_batch()`` gives.  The launch counts are set
    to 0 just before the first step and read just after the last; each
    kernel of ``expected`` (name -> launches a step) must have launched that
    many times per step, and no other kernel at all.  BatchNorm running
    statistics must move in ``enc_block1`` (fused under the fused conv
    impl) and in the dilated ``enc_block5`` (never fused).  Returns the
    state, the counts and the median ms of the timed steps."""
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import make_pacing_train_step

    config = _experiment_config()
    state = create_train_state(config, device=dev)
    model = state.model
    n_params = sum(p.numel() for p in model.parameters())
    train_step = make_pacing_train_step(config, steps_per_epoch=100,
                                        augment_fn=augment_fn)
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
        if i == 0:
            _check(float(state.memory_bank.abs().sum()) > 0,
                   f"{name}: the memory bank is still zero after step 1")
    launches = _launch_counts(counters)

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
    from pacingpseudo_torch.data.npz_dataset import (BatchLoader, SliceDataset,
                                                     raw_batch_to_device)
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

    def batches():
        epoch = 0
        while True:
            loader.set_epoch(epoch)
            for batch in loader:
                yield raw_batch_to_device(batch, dev)
            epoch += 1

    return batches(), val_loader, config


def phase_augment(wt, dev, raw, config, flush):
    """``augment_batch`` at full width on one raw batch from the loader."""
    import dataclasses

    from pacingpseudo_torch.aug import engine
    from pacingpseudo_torch.aug.presets import base_params_for, strong_params_for
    from pacingpseudo_torch.ops import warp

    n, (ch, cw), c = config.batch_size, config.spec.input_size, config.num_classes
    base = base_params_for(config.dataset)
    strong = strong_params_for(config.augmentations, config.strength)
    _check(base.image_interp == "bicubic" and base.warp_table_impl == "auto",
           f"augment: unexpected defaults {base}")

    def run(params, seed=config.seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return engine.augment_batch(raw, gen, params, strong, do_strong=True)

    wt.reset_launch_counts()
    out = run(base)
    torch.cuda.synchronize()
    _check(wt.LAUNCHES["warp_table"] == 1,
           f"augment: {wt.LAUNCHES['warp_table']} warp_table launches in one call")
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

    # Kernel route == plain route, from the same raw batch and the same seed.
    by_kernel = run(dataclasses.replace(base, warp_table_impl="kernel"))
    by_plain = run(dataclasses.replace(base, warp_table_impl="plain"))
    torch.cuda.synchronize()
    for k in shapes:
        _check(torch.equal(by_kernel[k], by_plain[k]) and torch.equal(out[k], by_kernel[k]),
               f"augment: {k} differs between the kernel and the plain route")
    _check(wt.LAUNCHES["warp_table"] == 2,
           f"augment: {wt.LAUNCHES['warp_table']} launches after the auto, kernel "
           "and plain routes (want 2: the plain route launches none)")
    print(f"augment: checks ok, valid coverage {float(mask.mean()):.3f}, kernel "
          "route == plain route", flush=True)

    # What one call costs, and inside it the three parts of the fused warp.
    # The call is some hundreds of small launches, so its time on the card's
    # clock includes the gaps the host leaves between them.
    draws = engine.draw_base(n, base, torch.Generator(device=dev).manual_seed(1), dev)
    size = raw["size"]
    sy, sx, _, _ = engine.base_source_coordinates(size, draws, base)
    planes = (raw["image"].float(), raw["label"].float(), raw["scribble"].float())
    bound_h, bound_w = size[:, 0].float(), size[:, 1].float()
    y0, x0, fy, fx = warp.warp_anchor(sy, sx, bound_h, bound_w)
    table = wt.build_warp_table(*planes)
    rows = warp.gather_warp_rows(table, y0, x0, cw)
    reps = 20
    ms = {
        "augment_batch": _time_ms(lambda: run(base), flush, reps),
        "augment_batch, plain table": _time_ms(
            lambda: run(dataclasses.replace(base, warp_table_impl="plain")), flush, reps),
        "table build": _time_ms(lambda: wt.build_warp_table(*planes), flush, reps),
        "row gather": _time_ms(
            lambda: warp.gather_warp_rows(table, y0, x0, cw), flush, reps),
        "interpolation + vote": _time_ms(
            lambda: warp.interpolate_warp_rows(rows, planes[0], y0, x0, fy, fx,
                                               c + 1, bound_h, bound_w), flush, reps),
    }
    print("augment: ms per call, median of %d with L2 flushed: %s" % (
        reps, ", ".join(f"{k} {v:.4f}" for k, v in ms.items())), flush=True)
    return engine.make_train_augment_fn(base, strong, do_strong=True)


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


def main() -> None:
    if not torch.cuda.is_available():
        _fail("no CUDA device: chip_smoke.py runs on a GPU only")
    from pacingpseudo_torch.ops import _build
    from pacingpseudo_torch.ops import fused_convbn as fc
    from pacingpseudo_torch.ops import fused_loss as fl
    from pacingpseudo_torch.ops import warp_table as wt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
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
    counters = (fl, wt, fc)
    loss_kernels = {"fused_loss_fwd": 1, "fused_loss_bwd": 1}
    raw_kernels = {**loss_kernels, "warp_table": 1}
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=dev)
    rows = phase_kernels(fl, wt, dev)
    conv_rows = time_conv_kernels(fc, dev, check_conv_kernels(fc, dev), flush)
    check_weight_grad(fc, dev)
    phase_parity(dev)
    phase_parity_fused(fc, dev)

    config = _experiment_config()
    batch = make_batch(config.batch_size, config.spec.input_size[0],
                       config.num_classes, seed=config.seed, dev=dev)
    state, _, pre_ms = phase_train("train", counters, loss_kernels, dev,
                                   lambda: batch)
    phase_eval("eval", state, batch)
    del state, batch

    from scripts.reckon_fused_conv_bounds import conv_layer_shapes
    layers = [s for s in conv_layer_shapes(config) if s[6]]
    fused_kernels = {**raw_kernels, "conv_stats": len(layers), "bn_sums": len(layers),
                     "conv_pad_out": sum(s[7] for s in layers)}
    fused_routes = {k: {"wgmma": 0, "simple": 0} for k in GEMMS}
    for s in layers:
        for k, p in _gemm_plans(fc, torch.bfloat16, *s[1:6]).items():
            fused_routes[k][p.route] += k == "conv_stats" or s[7]
    _check(fused_routes == {"conv_stats": {"wgmma": FUSED_LAYERS - 1, "simple": 1},
                            "conv_pad_out": {"wgmma": FUSED_LAYERS - 1, "simple": 0}},
           f"train (raw, fused conv): the plan routes {fused_routes} a step; want "
           f"conv_stats {FUSED_LAYERS - 1} wgmma + 1 simple, conv_pad_out "
           f"{FUSED_LAYERS - 1} wgmma")
    # The gate and the dx skip are the code under test: hold what they give
    # against the layers JAX fuses at this shape (all but the four dilated
    # ones; enc_block1's first layer reads the image).
    _check(len(layers) == FUSED_LAYERS and fused_kernels["conv_pad_out"] == FUSED_LAYERS - 1,
           f"train (raw, fused conv): {len(layers)} fused layers, "
           f"{fused_kernels['conv_pad_out']} with dx; want {FUSED_LAYERS} and "
           f"{FUSED_LAYERS - 1}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pool_") as root:
        raw_batches, val_loader, config = make_raw_pool(root, dev)
        augment_fn = phase_augment(wt, dev, next(raw_batches), config, flush)
        del flush
        state, launches, raw_ms = phase_train(
            "train (raw)", counters, raw_kernels, dev,
            lambda: next(raw_batches), augment_fn=augment_fn,
            generator=torch.Generator(device=dev).manual_seed(config.seed))
        print(f"train (raw): median step {raw_ms:.3f} ms with the augmentation "
              f"inside, {pre_ms:.3f} ms on the pre-augmented batch: the "
              f"augmentation adds {raw_ms - pre_ms:.3f} ms a step", flush=True)
        phase_eval_raw(state, val_loader, config, dev)
        del state
        fc.set_conv_impl("fused")
        try:
            _, fused_launches, fused_ms = phase_train(
                "train (raw, fused conv)", counters, fused_kernels, dev,
                lambda: next(raw_batches), augment_fn=augment_fn,
                generator=torch.Generator(device=dev).manual_seed(config.seed))
            routes = {k: dict(v) for k, v in fc.ROUTES.items()}
        finally:
            fc.set_conv_impl("xla")
        raw_batches.close()
        steps = fused_launches["conv_stats"] // len(layers)
        _check(routes == {k: {r: n * steps for r, n in v.items()}
                          for k, v in fused_routes.items()},
               f"train (raw, fused conv): GEMM launches by route {routes} over {steps} "
               f"steps, expected {fused_routes} a step")
        print(f"train (raw, fused conv): GEMM launches by route a step {fused_routes}",
              flush=True)
        print(f"train (raw, fused conv): median step {fused_ms:.3f} ms with the "
              f"fused ConvLayer, {raw_ms:.3f} ms unfused in this run; "
              f"launches a step {fused_kernels}", flush=True)

    for row in rows:
        row["launches"] = launches[row["name"]]
    for row in conv_rows:
        row["launches"] = fused_launches[row["name"]]
        if row["name"] in routes:
            row["gemm_routes"] = routes[row["name"]]
    print(json.dumps({"kernels": rows + conv_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
