"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build   -- compile ``pacingpseudo_torch/csrc/*.cu`` with nvcc into
              ``build/`` (one nvcc per source, all started together).
2. kernels -- hold ``fused_loss_fwd`` and ``fused_loss_bwd`` against their
              plain PyTorch versions at the train step's shapes (12 x C x
              256 x 256 for C in 2, 4, 5, an all-ignored target, an
              all-zero mask), then time kernel and plain version with CUDA
              events beside the bound the card's memory rate sets.
3. parity  -- one train step at a small size in float32, once through the
              kernels and once through the loss library, from the same
              state: the losses and gradients must agree.
4. train   -- the full-width Experiment session (CHAOS shape: 256x256,
              batch 12, 5 classes, init_ch 32, max_ch 512, output stride 8,
              hid_ch 64, bf16 compute), 3 warm-up and 5 timed steps on a
              seeded synthetic batch, through the entry points a user calls.
5. eval    -- one eval step on the same batch.

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


def _time_ms(fn, flush):
    """Median ms of ``fn`` over TIMING_REPS launches, each timed with its own
    CUDA events, with L2 flushed before each (the step finds it cold).  The
    flush (``flush.zero_()``) must keep the card busy for longer than the
    host takes to launch ``fn``; otherwise the card idles between the start
    event and the kernel and the time includes the host's launch cost."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(TIMING_REPS):
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


def phase_kernels(fl, dev):
    """Kernel vs plain version at the step's shapes; returns the rows of the
    ``kernels`` line, without ``launches``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    err = {"fused_loss_fwd": 0.0, "fused_loss_bwd": 0.0}
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
    rows = []
    for name, line, fn, plain, nbytes, ops in (
            ("fused_loss_fwd", 60,
             lambda: fl.fused_loss_forward(lw, ls, tgt, mask, c),
             lambda: fl.forward_plain(lw, ls, tgt, mask, c),
             fwd_bytes, fwd_ops),
            ("fused_loss_bwd", 96,
             lambda: fl.fused_loss_backward(lw, ls, tgt, mask, scal, c),
             lambda: fl.backward_plain(lw, ls, tgt, mask, scal, c),
             bwd_bytes, bwd_ops)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        row = {"name": name, "route": "cuda",
               "source": "pacingpseudo_torch/csrc/fused_loss.cu",
               "replaces": f"pacingpseudo_tpu/ops/pallas/fused_loss.py:{line}",
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


def phase_train_eval(fl, dev, steps_warm=3, steps_timed=5):
    from pacingpseudo_torch.config import ExperimentConfig
    from pacingpseudo_torch.train.state import create_train_state
    from pacingpseudo_torch.train.step import (make_pacing_eval_step,
                                               make_pacing_train_step)

    config = ExperimentConfig(
        session="Experiment", do_loss_ent=True, do_decoder_consistency=True,
        do_aux_path=True, do_memory=True).validate()
    spec = config.spec
    state = create_train_state(config, device=dev)
    model = state.model
    n_params = sum(p.numel() for p in model.parameters())
    batch = make_batch(config.batch_size, spec.input_size[0],
                       config.num_classes, seed=config.seed, dev=dev)
    train_step = make_pacing_train_step(config, steps_per_epoch=100)
    eval_step = make_pacing_eval_step(config)
    bn = model.backbone.enc_block1.conv_block.conv_layer1.norm_op
    stats0 = (bn.running_mean.clone(), bn.running_var.clone())
    print(f"train: {n_params} parameters, batch {config.batch_size} x "
          f"{spec.input_size}, {config.compute_dtype}", flush=True)

    torch.cuda.synchronize()
    fl.reset_launch_counts()
    step_ms, losses = [], []
    for i in range(steps_warm + steps_timed):
        t0 = time.perf_counter()
        metrics = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            _check(float(state.memory_bank.abs().sum()) > 0,
                   "train: the memory bank is still zero after step 1")
    loss_pce, dice, logits = eval_step(state, batch)
    torch.cuda.synchronize()
    launches = dict(fl.LAUNCHES)

    steps = steps_warm + steps_timed
    for i, m in enumerate(losses):
        _check(all(math.isfinite(v) for v in m.values()),
               f"train: non-finite metrics at step {i}: {m}")
    _check(launches["fused_loss_fwd"] == steps
           and launches["fused_loss_bwd"] == steps,
           f"train: kernel launches {launches} over {steps} steps")
    _check(not (torch.equal(bn.running_mean, stats0[0])
                or torch.equal(bn.running_var, stats0[1])),
           "train: BatchNorm running statistics did not move")
    median_ms = statistics.median(step_ms[steps_warm:])
    print(f"train: losses step 1 {losses[0]}", flush=True)
    print(f"train: losses step {steps} {losses[-1]}", flush=True)
    print(f"train: step ms {[round(t, 3) for t in step_ms]}, median of the "
          f"{steps_timed} timed steps {median_ms:.3f} ms", flush=True)

    _check(tuple(logits.shape) == (config.batch_size, config.num_classes)
           + tuple(spec.input_size), f"eval: logits shape {tuple(logits.shape)}")
    _check(math.isfinite(float(loss_pce)), "eval: loss_pce is not finite")
    label_sum = batch["label"].sum(dim=(2, 3))
    _check(bool(torch.isfinite(dice[label_sum > 0]).all()),
           "eval: Dice is not finite for a class present in the label")
    print(f"eval: loss_pce {float(loss_pce):.6f}, mean Dice per class "
          f"{torch.nanmean(dice, dim=0).tolist()}", flush=True)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        _fail("no CUDA device: chip_smoke.py runs on a GPU only")
    from pacingpseudo_torch.ops import _build
    from pacingpseudo_torch.ops import fused_loss as fl

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

    rows = phase_kernels(fl, dev)
    phase_parity(dev)
    launches = phase_train_eval(fl, dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
