"""Experiment orchestration: run dirs, logging, TB, the epoch loop.

The port of ``pacingpseudo_tpu/train/loop.py`` for the Control,
Experiment and Upperbound sessions: ``train_driver(config, data_root)``
trains a model on one device from the dataset's fold split.  The
Upperbound session trains the bare model (no aux path, no bank, no strong
stream) with the upper-bound steps and validates with CE on the labels.

Loop structure (reference train_chaos.py:242-429): per-epoch LR decay
(inside the step), the train inner loop, TensorBoard scalars and figure
panels, full-label validation Dice, the per-epoch ``valdice`` array,
best/interval/final checkpoints -- plus resume, ``config.json`` and a
slices/s meter.

What keeps a resumed run on the uninterrupted run's path:

* the shuffle order of epoch ``e`` is ``np.random.RandomState([seed + 2,
  e])`` over the training slices, cut to ``steps_per_epoch x batch``, as
  the JAX loop's resident path draws it (``loop.py:536-539``);
* the augmentation of update ``k`` draws from a ``torch.Generator`` on the
  device that is **reseeded before every step** from ``(seed + 1, k)``
  (:func:`step_seed`), the counterpart of JAX's ``fold_in(rng,
  state.step)``; the device's default generator, which dropout draws from,
  is reseeded from ``(seed + 1, k, 1)``.  So no generator state needs to go
  into a checkpoint;
* the checkpoint holds the model (BN statistics and bank included), the
  optimizer and ``step``; ``valdice.npz``, written every epoch, gives back
  the history and the best-epoch tracker.

Metrics are accumulated on the device and read once an epoch.  Validation
walks a copy of the validation pool staged on the device once
(:class:`ValPool`), in index blocks with a validity mask for the last
partial batch, and reads five small tensors an epoch.

Not ported (``ROADMAP.md``): the mesh / spatial / multi-device branch, the
chunked and resident *training* paths (``steps_per_dispatch``,
``device_resident_data`` parse and are ignored) and ``profile_dir``'s
profiler trace.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pacingpseudo_torch.aug.engine import eval_preprocess_batch, make_train_augment_fn
from pacingpseudo_torch.aug.presets import base_params_for, strong_params_for
from pacingpseudo_torch.config import ExperimentConfig
from pacingpseudo_torch.data.npz_dataset import BatchLoader, SliceDataset, raw_batch_to_device
from pacingpseudo_torch.data.splits import read_fold_split
from pacingpseudo_torch.evals.dice import dice_per_class
from pacingpseudo_torch.losses import partial_cross_entropy_loss
from pacingpseudo_torch.train import checkpoint as ckpt_lib
from pacingpseudo_torch.train.state import TrainState, create_train_state
from pacingpseudo_torch.train.step import (eval_logits, make_pacing_eval_step,
                                           make_pacing_train_step,
                                           make_upper_bound_train_step)
from pacingpseudo_torch.utils import AvgMeter


def make_run_dir(config: ExperimentConfig) -> str:
    """Reference naming: ``<root>/<modality>/<session>/<session>-<time>-fold<k>-<tag>``
    (train_chaos.py:441-444; the modality level exists for chaos only)."""
    parts = [config.root]
    if config.dataset.startswith("chaos"):
        parts.append(config.modality)
    parts += [config.session,
              f"{config.session}-{time.strftime('%H-%M-%S-%m%d')}-fold{config.fold}-{config.tag}"]
    run_dir = os.path.join(*parts)
    os.makedirs(run_dir, exist_ok=True)
    os.makedirs(os.path.join(run_dir, "ckps"), exist_ok=True)
    return run_dir


def setup_logging(run_dir: str):
    logging.basicConfig(
        filename=os.path.join(run_dir, "log.txt"), level=logging.INFO,
        format="[%(asctime)s.%(msecs)03d] %(message)s", datefmt="%H:%M:%S",
        force=True)
    logging.getLogger().addHandler(logging.StreamHandler(sys.stdout))


def dump_config(run_dir: str, config: ExperimentConfig):
    """Reproducibility record: full config + git revision (replaces the
    reference's self-copy of the driver script)."""
    payload = dataclasses.asdict(config)
    try:
        payload["git_rev"] = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=os.path.dirname(__file__),
            stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        payload["git_rev"] = None
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(payload, f, indent=2, default=str)


def _tb_writer(run_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(log_dir=os.path.join(run_dir, "tb_summary"))
    except Exception:
        logging.info("torch.utils.tensorboard unavailable; TB logging disabled")
        return None


def _np_softmax(x, axis):
    e = np.exp(x - x.max(axis, keepdims=True))
    return e / e.sum(axis, keepdims=True)


def _tb_train_figures(tb, batch, outputs, epoch):
    """TRAINING-batch figure panels + histograms (train_chaos.py:320-360).

    ``batch``: the augmented training batch (host numpy, NCHW);
    ``outputs``: figure-forward logits (NCHW).  The full reference panel
    set: image / scribble / weak prediction / prob_weak_max histogram, plus
    the strong image+prediction+histogram and the auxiliary prediction when
    those branches run.  Two reference slips are corrected, as in the JAX
    package: the misspelled ``predicitons/image_strong`` tag, and
    ``histogram/prob_strong_max`` being fed prob_weak_max
    (train_chaos.py:352).
    """
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return

    def _fig(arr, cmap=None):
        fig = plt.figure()
        plt.imshow(arr, cmap)
        return fig

    tb.add_figure("predictions/image", _fig(batch["image"][0, 0], "gray"), epoch)
    tb.add_figure("predictions/scribble", _fig(batch["scribble"][0].argmax(0)), epoch)
    probs_w = _np_softmax(outputs["segmentation/logits"], 1)
    tb.add_figure("predictions/prediction_decoder_weak", _fig(probs_w[0].argmax(0)), epoch)
    tb.add_histogram("histogram/prob_weak_max", probs_w.max(1), epoch)
    if "segmentation/logits_strong" in outputs:
        tb.add_figure("predictions/image_strong",
                      _fig(batch["image_strong"][0, 0], "gray"), epoch)
        probs_s = _np_softmax(outputs["segmentation/logits_strong"], 1)
        tb.add_figure("predictions/prediction_decoder_strong",
                      _fig(probs_s[0].argmax(0)), epoch)
        tb.add_histogram("histogram/prob_strong_max", probs_s.max(1), epoch)
    if "aux/logits" in outputs:
        probs_a = _np_softmax(outputs["aux/logits"], 1)
        tb.add_figure("predictions/prediction_auxiliary_segmentation",
                      _fig(probs_a[0].argmax(0)), epoch)
    plt.close("all")


@torch.no_grad()
def _figure_forward(state: TrainState, batch):
    """One frozen-BN forward for the TB panels: the strong stream and the
    aux path run (``train=True``), no state changes."""
    model = state.model
    was_training = model.training
    model.eval()
    try:
        return model(batch["image"], batch.get("image_strong"), train=True)
    finally:
        model.train(was_training)


def _pad_batch(raw: Dict[str, np.ndarray], to: int):
    """Pad a partial batch to the static batch size (repeat last sample)."""
    n = raw["image"].shape[0]
    if n == to:
        return raw, n
    reps = to - n
    out = {}
    for k, v in raw.items():
        if isinstance(v, list):
            out[k] = v + [v[-1]] * reps
        else:
            out[k] = np.concatenate([v, np.repeat(v[-1:], reps, axis=0)])
    return out, n


def step_seed(seed: int, step: int, stream: int = 0) -> int:
    """The 63-bit seed of update ``step``'s draws: a pure function of
    ``(seed + 1, step, stream)`` (stream 0: the augmentation, 1: dropout)."""
    words = np.random.SeedSequence([seed + 1, step, stream]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def seed_step(generator: torch.Generator, device: torch.device, seed: int, step: int):
    """Reseed ``generator`` (the augmentation's) and the device's default
    generator (dropout's) for update ``step``."""
    generator.manual_seed(step_seed(seed, step))
    default = (torch.cuda.default_generators[device.index]
               if device.type == "cuda" else torch.default_generator)
    default.manual_seed(step_seed(seed, step, 1))


class ValState:
    """Host-side per-epoch validation aggregation (AvgMeters skipping NaN,
    train_chaos.py:372-391): the batch-by-batch path the device
    validation (:func:`make_resident_eval_fn`) must equal."""

    def __init__(self, num_classes):
        self.loss = AvgMeter()
        self.dsc = [AvgMeter() for _ in range(num_classes)]

    def update(self, loss, dice_nc, n_real, n_batch):
        self.loss.update(float(loss), n=n_batch)
        d = np.asarray(dice_nc)[:n_real]
        for row in d:
            for cls, val in enumerate(row):
                if not np.isnan(val):
                    self.dsc[cls].update(float(val))

    def summary(self):
        per_class = [m.avg for m in self.dsc]
        avg_all = float(np.mean(per_class[1:])) if len(per_class) > 1 else per_class[0]
        return per_class, avg_all


@dataclasses.dataclass
class ValPool:
    """The validation slices on the device, in the loader's order: raw
    canvases ``image/label/scribble`` (V, S, S) float32 and ``size`` (V, 2),
    with ``idx_blocks`` (B, N) of slice indices (the last block padded by
    repeating the last slice, as ``_pad_batch`` does) and ``valid_blocks``
    (B, N) masking the padding."""
    raw: Dict[str, torch.Tensor]
    idx_blocks: torch.Tensor
    valid_blocks: torch.Tensor


def stage_val_pool(val_ds: SliceDataset, batch_size: int, device) -> ValPool:
    """Load every validation slice once and stage it on ``device``."""
    loader = BatchLoader(val_ds, batch_size=256, shuffle=False, drop_last=False)
    parts = [raw_batch_to_device(b, device) for b in loader]
    raw = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    n_val = len(val_ds)
    n_blocks = -(-n_val // batch_size)
    idx = np.arange(n_blocks * batch_size)
    valid = torch.from_numpy((idx < n_val).reshape(n_blocks, batch_size)).to(device)
    idx = torch.from_numpy(np.minimum(idx, n_val - 1).reshape(n_blocks, batch_size)).to(device)
    return ValPool(raw, idx, valid)


def make_resident_eval_fn(config: ExperimentConfig):
    """The whole validation pass over a :class:`ValPool`, accumulated on
    the device (the port of ``pacingpseudo_tpu/train/step.py:341-432``):
    ``(state, pool) -> {loss_sum, n_sum, dice_sum (C,), dice_cnt (C,)}``,
    float64 device tensors.  Per index block: gather the raw batch,
    ``eval_preprocess_batch``, the eval step with ``sample_valid`` (padding
    adds no pixels to the loss); then the per-class sums of the non-NaN Dice
    of the real samples and their counts (the AvgMeter-skipping-NaN
    semantics of :class:`ValState`) and the loss weighted by the real
    samples.  The sums are float64 so that they agree with ValState's
    Python floats to float64 roundoff.

    In the Upperbound session the loss is CE on the labels
    (upper_bound_chaos.py:186-209) with JAX's resident target
    (``step.py:388-398``): the raw label where it names a class, else 0, so
    canvas padding counts as background; the padded duplicate samples are
    ignored."""
    eval_step = make_pacing_eval_step(config)
    num_classes = config.num_classes
    upper_bound = config.session == "Upperbound"

    @torch.no_grad()
    def eval_all(state: TrainState, pool: ValPool):
        dev = pool.idx_blocks.device
        acc = {"loss_sum": torch.zeros((), dtype=torch.float64, device=dev),
               "n_sum": torch.zeros((), dtype=torch.float64, device=dev),
               "dice_sum": torch.zeros(num_classes, dtype=torch.float64, device=dev),
               "dice_cnt": torch.zeros(num_classes, dtype=torch.float64, device=dev)}
        for idx, valid in zip(pool.idx_blocks, pool.valid_blocks):
            raw = {k: v[idx] for k, v in pool.raw.items()}
            batch = eval_preprocess_batch(raw, num_classes)
            batch["sample_valid"] = valid
            if upper_bound:
                logits = eval_logits(state.model, batch["image"])
                label = raw["label"].long()
                target = torch.where(label < num_classes, label, 0)
                target = torch.where(valid[:, None, None], target, config.ignored_index)
                loss = partial_cross_entropy_loss(logits, target, config.ignored_index)
                dice = dice_per_class(torch.softmax(logits, dim=1), batch["label"],
                                      region_mask=batch["region_mask"])
            else:
                loss, dice, _ = eval_step(state, batch)
            ok = ~torch.isnan(dice) & valid[:, None]
            n_real = valid.sum().double()
            acc["loss_sum"] += loss.double() * n_real
            acc["n_sum"] += n_real
            acc["dice_sum"] += torch.where(ok, dice, 0.0).double().sum(0)
            acc["dice_cnt"] += ok.double().sum(0)
        return acc

    return eval_all


def summarize_validation(acc) -> Tuple[list, float, float]:
    """``(per_class Dice, their mean over the foreground classes, loss)``
    from :func:`make_resident_eval_fn`'s sums: the one host read."""
    dice_sum, dice_cnt = acc["dice_sum"].cpu().numpy(), acc["dice_cnt"].cpu().numpy()
    per_class = [float(s / c) if c > 0 else 0.0 for s, c in zip(dice_sum, dice_cnt)]
    avg_all = float(np.mean(per_class[1:])) if len(per_class) > 1 else per_class[0]
    return per_class, avg_all, float(acc["loss_sum"]) / max(float(acc["n_sum"]), 1e-9)


def _augment_params(config: ExperimentConfig):
    base = base_params_for(config.dataset)
    if config.input_size:
        base = dataclasses.replace(base, crop_size=tuple(config.input_size))
    if config.aug_image_interp != base.image_interp:
        base = dataclasses.replace(base, image_interp=config.aug_image_interp)
    return base, strong_params_for(config.augmentations, config.strength)


def train_driver(config: ExperimentConfig, data_root: str,
                 run_dir: Optional[str] = None,
                 max_steps_per_epoch: Optional[int] = None,
                 stop_after_epoch: Optional[int] = None,
                 device="cuda") -> str:
    """Run a full training session on ``device``; returns the run directory.

    ``stop_after_epoch=k`` saves ``ckps/ckp_k`` and exits cleanly after
    epoch ``k`` (schedules still span ``config.epoch``): a crash-at-epoch-k
    simulator for resume-equivalence checks.
    """
    return _train_driver(config, data_root, run_dir, max_steps_per_epoch,
                         stop_after_epoch, device)[0]


def _train_driver(config: ExperimentConfig, data_root: str,
                  run_dir: Optional[str] = None,
                  max_steps_per_epoch: Optional[int] = None,
                  stop_after_epoch: Optional[int] = None,
                  device="cuda") -> Tuple[str, TrainState]:
    """:func:`train_driver`, returning ``(run_dir, final train state)``."""
    config.validate()
    upper_bound = config.session == "Upperbound"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {device}: pass the CPU explicitly")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    do_strong = config.do_decoder_consistency and not upper_bound

    if run_dir is None:
        run_dir = make_run_dir(config)
    os.makedirs(os.path.join(run_dir, "ckps"), exist_ok=True)
    setup_logging(run_dir)
    dump_config(run_dir, config)
    logging.info("config: %s", json.dumps(dataclasses.asdict(config), default=str))

    # ---- data
    train_files, val_files = read_fold_split(
        data_root, config.dataset, config.fold,
        config.modality if config.dataset.startswith("chaos") else None)
    train_ds = SliceDataset(train_files, config.num_classes, config.ignored_index)
    val_ds = SliceDataset(val_files, config.num_classes, config.ignored_index,
                          canvas_size=train_ds.canvas_size)
    train_loader = BatchLoader(train_ds, config.batch_size, drop_last=True)
    steps_per_epoch = len(train_loader)
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    logging.info("train slices=%d val slices=%d steps/epoch=%d canvas=%d device=%s",
                 len(train_ds), len(val_ds), steps_per_epoch, train_ds.canvas_size,
                 device)

    # ---- model / state / steps
    base_params, strong_params = _augment_params(config)
    augment_fn = make_train_augment_fn(base_params, strong_params, do_strong)
    state = create_train_state(config, device=device)
    start_epoch = 0
    if config.resume:
        latest = ckpt_lib.latest_checkpoint(run_dir)
        if latest:
            ckpt_lib.restore_checkpoint(latest, state)
            start_epoch = state.step // steps_per_epoch
            logging.info("resumed from %s at epoch %d", latest, start_epoch)

    make_train = make_upper_bound_train_step if upper_bound else make_pacing_train_step
    train_step = make_train(config, steps_per_epoch, augment_fn=augment_fn)
    train_step_frozen = None
    if config.ref_quirk_bn_eval_after_first_epoch:
        train_step_frozen = make_train(config, steps_per_epoch, module_train=False,
                                       augment_fn=augment_fn)
    val_pool = stage_val_pool(val_ds, config.batch_size, device)
    resident_eval = make_resident_eval_fn(config)
    generator = torch.Generator(device=device)

    tb = _tb_writer(run_dir)
    valdice = np.zeros(config.epoch)
    best_avg, best_epoch = 0.0, 0
    if start_epoch > 0:
        # keep pre-resume history in valdice.npz (reference artifact parity)
        # and restore the best tracker so a resumed run cannot overwrite
        # best_ckp with a worse epoch
        prev = os.path.join(run_dir, "valdice.npz")
        if os.path.isfile(prev):
            old_vd = np.load(prev)["valdice"]
            n = min(len(old_vd), start_epoch, config.epoch)
            valdice[:n] = old_vd[:n]
        hist = valdice[:start_epoch]
        if hist.size and hist.max() > 0:
            best_epoch = int(hist.argmax())
            best_avg = float(hist.max())

    for epoch in range(start_epoch, config.epoch):
        tic = time.time()
        step_fn = train_step
        if train_step_frozen is not None and epoch >= 1:
            step_fn = train_step_frozen
            if epoch == max(start_epoch, 1):
                logging.info("epoch %03d on: frozen-BN step (module_train=False, "
                             "ref_quirk_bn_eval_after_first_epoch)", epoch)

        # The order is a pure function of (seed, epoch): resume at epoch k
        # replays the uninterrupted run's shuffle exactly.
        order = np.arange(len(train_ds))
        np.random.RandomState([config.seed + 2, epoch]).shuffle(order)
        blocks = order[:steps_per_epoch * config.batch_size].reshape(
            steps_per_epoch, config.batch_size)
        acc, lr_sum, n_steps, last_raw = None, 0.0, 0, None
        for raw in train_loader.batches(blocks):
            raw.pop("uid", None)
            last_raw = raw_batch_to_device(raw, device)
            seed_step(generator, device, config.seed, state.step)
            metrics = step_fn(state, last_raw, generator)
            lr_sum += metrics.pop("lr")
            acc = metrics if acc is None else {k: acc[k] + v for k, v in metrics.items()}
            n_steps += 1
        if n_steps == 0:
            raise RuntimeError(
                f"empty train epoch: loader yielded no full batch "
                f"(train slices < batch_size {config.batch_size}?)")
        # Read the accumulated device metrics BEFORE stopping the epoch
        # timer: launches are asynchronous and only this host read waits.
        names = list(acc)
        values = torch.stack([acc[k].float() for k in names]).cpu().tolist()
        means = {"lr": lr_sum / n_steps,
                 **{k: v / n_steps for k, v in zip(names, values)}}
        toc = time.time()
        slices_per_sec = n_steps * config.batch_size / max(toc - tic, 1e-9)
        logging.info(
            "epoch: %03d, lr: %.6f, %s, %.2f s/epoch, %.2f slices/s",
            epoch, means["lr"],
            ", ".join(f"{k}: {v:.6f}" for k, v in means.items() if k != "lr"),
            toc - tic, slices_per_sec)
        if epoch == start_epoch:
            # First-epoch wall-clock sanity line: a doomed run is visible in
            # ONE log line at launch.
            left = (config.epoch - epoch - 1) * (toc - tic)
            logging.info(
                "first epoch took %.1f s -> projected finish %s (%.2f h "
                "for the remaining %d epochs)",
                toc - tic,
                time.strftime("%Y-%m-%d %H:%M:%S",
                              time.localtime(time.time() + left)),
                left / 3600.0, config.epoch - epoch - 1)
        if tb:
            for k, v in means.items():
                tag = "lr/current_lr" if k == "lr" else f"losses/{k}_train"
                tb.add_scalar(tag, v, epoch)
            tb.add_scalar("perf/slices_per_sec", slices_per_sec, epoch)

            # TB figure panels from the LAST training batch
            # (train_chaos.py:320-360); the augmentation is drawn again
            # with an epoch-keyed seed and one frozen-BN forward.  The
            # upper-bound session draws none, as in JAX (loop.py:487).
            if config.tb_figures and last_raw is not None and not upper_bound:
                generator.manual_seed(step_seed(config.seed, 1_000_000 + epoch))
                fig_batch = augment_fn(last_raw, generator)
                fig_out = _figure_forward(state, fig_batch)
                _tb_train_figures(
                    tb, {k: v.float().cpu().numpy() for k, v in fig_batch.items()},
                    {k: v.float().cpu().numpy() for k, v in fig_out.items()
                     if k.endswith("logits") or k.endswith("logits_strong")},
                    epoch)

        # ---- validation (full labels, masked to the live region), on the
        # device; one host read
        per_class, avg_all, val_loss_avg = summarize_validation(
            resident_eval(state, val_pool))
        valdice[epoch] = avg_all
        # persist every epoch (cheap) so crash+resume keeps the history;
        # the reference wrote it once at the end (train_chaos.py:428)
        np.savez(os.path.join(run_dir, "valdice"), valdice=valdice)
        spec_names = list(config.spec.classnames)
        logging.info("val: %03d, loss: %.6f, [%s, All: %.4f]",
                     epoch, val_loss_avg,
                     ", ".join(f"{n}: {d:.4f}" for n, d in zip(spec_names, per_class)),
                     avg_all)
        if tb:
            tb.add_scalar("losses/loss_val", val_loss_avg, epoch)
            for n_, d in zip(spec_names, per_class):
                # TB rejects spaces in summary names ("right kidney").
                tb.add_scalar(f"DSC/{n_.replace(' ', '_')}", d, epoch)
            tb.add_scalar("DSC/All", avg_all, epoch)
            tb.add_scalar("DSC/Best", max(best_avg, avg_all), epoch)

        # ---- checkpoints (fixed interval precedence + final epoch,
        # reference: train_chaos.py:405-413)
        save_interval = ((epoch + 1) % config.ckp_interval == 0
                         or (epoch + 1) == config.epoch)
        stop = stop_after_epoch is not None and epoch >= stop_after_epoch
        if save_interval or stop:
            _save(os.path.join(run_dir, "ckps", f"ckp_{epoch}"), state)
        if avg_all > best_avg:
            best_epoch, best_avg = epoch, avg_all
            _save(os.path.join(run_dir, "best_ckp"), state)
        if stop:
            logging.info("stop_after_epoch=%d: exiting", stop_after_epoch)
            break

    logging.info("The best at epoch: %d, All: %.4f", best_epoch, best_avg)
    np.savez(os.path.join(run_dir, "valdice"), valdice=valdice)
    if tb:
        tb.close()
    return run_dir, state


def _save(path: str, state: TrainState) -> None:
    tic = time.time()
    ckpt_lib.save_checkpoint(path, state)
    logging.info("checkpoint %s saved in %.3f s", os.path.basename(path), time.time() - tic)
