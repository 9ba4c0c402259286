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
              memory rate sets.
3. parity  -- one train step at a small size in float32, once through the
              kernels and once through the loss library, from the same
              state: the losses and gradients must agree.
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
    to 0 just before the first step and read just after the last; every
    kernel of ``expected`` must have launched once per step.  Returns the
    state, the counts and the median ms of the timed steps."""
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import make_pacing_train_step

    config = _experiment_config()
    state = create_train_state(config, device=dev)
    model = state.model
    n_params = sum(p.numel() for p in model.parameters())
    train_step = make_pacing_train_step(config, steps_per_epoch=100,
                                        augment_fn=augment_fn)
    bn = model.backbone.enc_block1.conv_block.conv_layer1.norm_op
    stats0 = (bn.running_mean.clone(), bn.running_var.clone())
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
    _check(all(launches[k] == steps for k in expected)
           and all(v == 0 for k, v in launches.items() if k not in expected),
           f"{name}: kernel launches {launches} over {steps} steps, expected "
           f"one a step of each of {expected} and none of the others")
    _check(not (torch.equal(bn.running_mean, stats0[0])
                or torch.equal(bn.running_var, stats0[1])),
           f"{name}: BatchNorm running statistics did not move")
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
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}", flush=True)

    counters = (fl, wt)
    loss_kernels = ("fused_loss_fwd", "fused_loss_bwd")
    rows = phase_kernels(fl, wt, dev)
    phase_parity(dev)

    config = _experiment_config()
    batch = make_batch(config.batch_size, config.spec.input_size[0],
                       config.num_classes, seed=config.seed, dev=dev)
    state, _, pre_ms = phase_train("train", counters, loss_kernels, dev,
                                   lambda: batch)
    phase_eval("eval", state, batch)
    del state

    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pool_") as root:
        raw_batches, val_loader, config = make_raw_pool(root, dev)
        augment_fn = phase_augment(wt, dev, next(raw_batches), config, flush)
        del flush
        state, launches, raw_ms = phase_train(
            "train (raw)", counters, loss_kernels + ("warp_table",), dev,
            lambda: next(raw_batches), augment_fn=augment_fn,
            generator=torch.Generator(device=dev).manual_seed(config.seed))
        raw_batches.close()
        print(f"train (raw): median step {raw_ms:.3f} ms with the augmentation "
              f"inside, {pre_ms:.3f} ms on the pre-augmented batch: the "
              f"augmentation adds {raw_ms - pre_ms:.3f} ms a step", flush=True)
        phase_eval_raw(state, val_loader, config, dev)

    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
