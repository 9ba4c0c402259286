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
  (``step.step_seed``), the counterpart of JAX's ``fold_in(rng,
  state.step)``; the device's default generator, which dropout draws from,
  is reseeded from ``(seed + 1, k, 1)``.  So no generator state needs to go
  into a checkpoint, and every dispatch path draws the same;
* the checkpoint holds the model (BN statistics and bank included), the
  optimizer and ``step``; ``valdice.npz``, written every epoch, gives back
  the history and the best-epoch tracker.

How a step reaches the device (JAX's ``loop.py:407-479,531-582``):

* ``device_resident_data``: ``on``, or ``auto`` with a pool under 6 GiB
  (``data/resident.py``), stages every training slice on the device once,
  rounded to float16 image and uint8 label/scribble; a dispatch then sends
  an int32 index block and the step gathers its batch on the device.
  ``off`` streams the loader's batches, rounded the same way
  (``npz_dataset.shrink_raw``) and stacked into one upload a dispatch;
* ``steps_per_dispatch``: a dispatch runs ``chunk = min(steps_per_dispatch,
  steps_per_epoch)`` updates, the epoch's last one ``steps_per_epoch %
  chunk``.  On a card with ``chunk > 1`` (alone, or on NCCL ranks) each
  update is a replay of the step captured as a CUDA graph
  (``train/graph.py``); with ``chunk == 1``, on the CPU and on gloo ranks
  the eager step runs.  Every setting walks the same
  batches with the same draws: on the CPU the final state and the metric
  lines are equal bit for bit.

Metrics are accumulated on the device and read once an epoch.  Validation
walks a copy of the validation pool staged on the device once
(:class:`ValPool`), in index blocks with a validity mask for the last
partial batch, and reads five small tensors an epoch; its pool is rounded
like the training pool when the run is resident, and float32 when it
streams, as JAX's streaming validation is.  ``profile_dir``: a
``torch.profiler`` trace of epoch ``start + 1`` (with its validation),
as JAX traces it.

Measurements (``utils/trace.py``), always on: host spans around the
dispatch's index upload (``loop.upload``), the streamed loader's wait
(``loop.loader_wait``), the epoch's metric read (``loop.metrics_read``),
the figure panels (``loop.figures``), the validation (``loop.validation``,
its host read ``loop.val_read``, its device time ``loop.val_device``) and
each checkpoint save (``loop.checkpoint``); under ``profile_dir`` they lie
in the trace beside the kernels.  Each epoch logs one ``trace:`` line: the
device phases of the last sampled replayed update, the last capture's
parts, and the epoch's upload and loader wait.

Several devices (JAX's ``loop.py:254-285,319-364``): ``device`` may list
devices (``--gpu 0,1``; on the CPU ``config.num_devices`` ranks share it),
``config.num_devices`` takes the first k of them (0: all), and
``parallel.mesh.plan_data_parallel`` splits them as JAX does into ``n_data
x n_space`` (``--spatial_shards``; 0 is JAX's AUTO split, which puts the
devices that a pure data mesh would idle on a ``space`` axis).  A split of
``W > 1`` ranks runs one process a rank (``spawn``; rendezvous through a
``FileStore`` in the run directory; NCCL across cards, gloo on the CPU or
on a shared card), each with its replica of the state and its block of
each global batch: the rows of its data index and, with a space axis, the
heights of its space index (``train/step.py``, ``parallel/spatial.py``).
The training pool is sharded over the data axis and replicated across the
space axis (``parallel.mesh.stage_resident_pool``), its budget ``n_data x
6 GiB``; validation splits each block's rows over the data axis and its
heights over the space axis and sums the results, each sample counted
once.  ``steps_per_dispatch`` holds on ranks as on one device: on NCCL
ranks with ``chunk > 1`` each update is a replay of the step captured with
its collectives, on gloo ranks the eager step runs (``train.step.
uses_graph``; the log says which).  The fused ConvLayer is off for the run
on every rank, as in JAX, because its kernels' BN statistics are the
rank's own.  Rank 0 alone writes ``log.txt``, ``config.json``,
``valdice.npz``, TensorBoard and the checkpoints, whose layout is the
single-device one: a checkpoint of any split resumes in a single-device run
and the other way round.
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
from pacingpseudo_torch.data.npz_dataset import (BatchLoader, SliceDataset,
                                                 raw_batch_to_device, stack_to_device)
from pacingpseudo_torch.data.resident import (gather, pool_bytes, stage_pool,
                                              stage_train_pool, use_resident)
from pacingpseudo_torch.data.splits import read_fold_split
from pacingpseudo_torch.evals.dice import dice_per_class
from pacingpseudo_torch.losses import partial_cross_entropy_loss
from pacingpseudo_torch.parallel import mesh, spatial
from pacingpseudo_torch.parallel.mesh import resolve_devices
from pacingpseudo_torch.train import checkpoint as ckpt_lib
from pacingpseudo_torch.train.graph import StepGraph
from pacingpseudo_torch.train.state import TrainState, create_train_state
from pacingpseudo_torch.train.step import (eval_logits, make_chunked_train_step,
                                           make_pacing_eval_step, make_pacing_train_step,
                                           make_resident_chunked_train_step,
                                           make_upper_bound_train_step, step_seed,
                                           uses_graph)
from pacingpseudo_torch.utils import AvgMeter, trace


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
    canvases ``image/label/scribble`` (V, S, S) (float32, or float16/uint8
    when rounded) and ``size`` (V, 2), with ``idx_blocks`` (B, N) of slice
    indices (the last block padded by repeating the last slice, as
    ``_pad_batch`` does) and ``valid_blocks`` (B, N) masking the padding."""
    raw: Dict[str, torch.Tensor]
    idx_blocks: torch.Tensor
    valid_blocks: torch.Tensor


def stage_val_pool(val_ds: SliceDataset, batch_size: int, device,
                   shrink: bool = False) -> ValPool:
    """Load every validation slice once and stage it on ``device``; with
    ``shrink`` rounded as the training batches are (``shrink_raw``), as the
    JAX loop stages its resident validation pool (loop.py:439-445)."""
    raw = stage_pool(val_ds, device, shrink)
    n_val = len(val_ds)
    n_blocks = -(-n_val // batch_size)
    idx = np.arange(n_blocks * batch_size)
    valid = torch.from_numpy((idx < n_val).reshape(n_blocks, batch_size)).to(device)
    idx = torch.from_numpy(np.minimum(idx, n_val - 1).reshape(n_blocks, batch_size)).to(device)
    return ValPool(raw, idx, valid)


def make_resident_eval_fn(config: ExperimentConfig, ranks: Optional[mesh.RankGroup] = None):
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
    ignored.

    With ``ranks`` each rank evaluates its block of every index block (its
    rows, its heights on a space axis; the loss as its share of the block's
    global count) and the sums are summed over the ranks at the end: every
    rank returns the single-device sums.  A sample's Dice and validity come
    from the first rank of its space group alone, so that each sample
    counts once."""
    eval_step = make_pacing_eval_step(config, ranks)
    num_classes = config.num_classes
    upper_bound = config.session == "Upperbound"
    counts = ranks is None or ranks.space_index == 0

    @torch.no_grad()
    def eval_all(state: TrainState, pool: ValPool):
        with trace.device_pair("loop.val_device", pool.idx_blocks.device):
            return eval_blocks(state, pool)

    def eval_blocks(state: TrainState, pool: ValPool):
        dev = pool.idx_blocks.device
        acc = {"loss_sum": torch.zeros((), dtype=torch.float64, device=dev),
               "n_sum": torch.zeros((), dtype=torch.float64, device=dev),
               "dice_sum": torch.zeros(num_classes, dtype=torch.float64, device=dev),
               "dice_cnt": torch.zeros(num_classes, dtype=torch.float64, device=dev)}
        for idx, valid in zip(pool.idx_blocks, pool.valid_blocks):
            n_real = valid.sum().double()
            if ranks is not None:
                idx, valid = ranks.local_rows(idx), ranks.local_rows(valid)
            raw = {k: v[idx] for k, v in pool.raw.items()}
            batch = eval_preprocess_batch(raw, num_classes)
            batch["sample_valid"] = valid
            batch["raw_label"] = raw["label"]
            shard = None
            if ranks is not None:
                batch, shard = spatial.shard_batch(batch, ranks, config.output_stride,
                                                   rows=False)
                mesh.attach_ranks(state.model, ranks, shard)
            if upper_bound:
                logits = eval_logits(state.model, batch["image"])
                label = batch["raw_label"].long()
                target = torch.where(label < num_classes, label, 0)
                target = torch.where(valid[:, None, None], target, config.ignored_index)
                loss = partial_cross_entropy_loss(logits, target, config.ignored_index,
                                                  ranks)
                dice = dice_per_class(torch.softmax(logits, dim=1), batch["label"],
                                      region_mask=batch["region_mask"], ranks=ranks)
            else:
                loss, dice, _ = eval_step(state, batch, shard)
            acc["loss_sum"] += loss.double() * n_real
            if counts:
                ok = ~torch.isnan(dice) & valid[:, None]
                acc["n_sum"] += valid.sum().double()
                acc["dice_sum"] += torch.where(ok, dice, 0.0).double().sum(0)
                acc["dice_cnt"] += ok.double().sum(0)
        if ranks is not None:
            flat = ranks.sum_(torch.cat([v.reshape(-1) for v in acc.values()]))
            acc = dict(zip(acc, flat.split([v.numel() for v in acc.values()])))
            acc["loss_sum"], acc["n_sum"] = acc["loss_sum"][0], acc["n_sum"][0]
        return acc

    return eval_all


def summarize_validation(acc) -> Tuple[list, float, float]:
    """``(per_class Dice, their mean over the foreground classes, loss)``
    from :func:`make_resident_eval_fn`'s sums: the one host read (the span
    ``loop.val_read``, which waits for the pass)."""
    with trace.span("loop.val_read"):
        dice_sum, dice_cnt = acc["dice_sum"].cpu().numpy(), acc["dice_cnt"].cpu().numpy()
        loss_sum, n_sum = float(acc["loss_sum"]), float(acc["n_sum"])
    per_class = [float(s / c) if c > 0 else 0.0 for s, c in zip(dice_sum, dice_cnt)]
    avg_all = float(np.mean(per_class[1:])) if len(per_class) > 1 else per_class[0]
    return per_class, avg_all, loss_sum / max(n_sum, 1e-9)


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
    """Run a full training session; returns the run directory.

    ``device``: one device or a list of cards, of which
    ``config.num_devices`` are used (:func:`resolve_devices`); a data mesh
    of more than one runs one process a rank (the module docstring).
    ``stop_after_epoch=k`` saves ``ckps/ckp_k`` and exits cleanly after
    epoch ``k`` (schedules still span ``config.epoch``): a crash-at-epoch-k
    simulator for resume-equivalence checks.
    """
    devices = resolve_devices(device, config.num_devices)
    n_data, n_space, split = mesh.plan_data_parallel(len(devices), config.batch_size,
                                                     int(config.spatial_shards))
    world = n_data * n_space
    if world == 1:
        return _train_driver(config, data_root, run_dir, max_steps_per_epoch,
                             stop_after_epoch, devices[0], split=split)[0]
    if n_space > 1:
        # A split that cannot run exits here, before any rank starts.
        spatial.check_split(_augment_params(config)[0].crop_size[0], config.output_stride,
                            n_space)
    if run_dir is None:
        run_dir = make_run_dir(config)
    os.makedirs(run_dir, exist_ok=True)
    devices = devices[:world]
    split = (f"{split}, ranks on {', '.join(map(str, devices))} over "
             f"{mesh.backend_for(devices)}")
    store = os.path.join(run_dir, f".ranks-{os.getpid()}-{time.time_ns()}")
    threads = max(1, torch.get_num_threads() // world)
    try:
        mesh.spawn_ranks(_rank_main, world, (devices, n_space, split, store, threads, config,
                                             data_root, run_dir, max_steps_per_epoch,
                                             stop_after_epoch))
    finally:
        if os.path.exists(store):
            os.remove(store)
    return run_dir


def _rank_main(rank: int, devices, n_space: int, split: str, store: str, threads: int,
               config: ExperimentConfig, data_root: str, run_dir: str,
               max_steps_per_epoch, stop_after_epoch) -> None:
    """One rank of a run over several devices (a spawned process)."""
    if devices[rank].type == "cpu":
        torch.set_num_threads(threads)
    ranks = mesh.init_rank_group(rank, devices, store, n_space)
    # The fused ConvLayer's kernels would take the rank's own BN statistics:
    # a layer whose BatchNorm has ranks takes the unfused path
    # (``ConvLayer.is_fused``), in every rank whatever the conv impl.
    _train_driver(config, data_root, run_dir, max_steps_per_epoch, stop_after_epoch,
                  devices[rank], ranks=ranks, split=split)
    mesh.close_rank_group(ranks)


def _train_driver(config: ExperimentConfig, data_root: str,
                  run_dir: Optional[str] = None,
                  max_steps_per_epoch: Optional[int] = None,
                  stop_after_epoch: Optional[int] = None,
                  device="cuda", ranks: Optional[mesh.RankGroup] = None,
                  split: str = "one device") -> Tuple[str, TrainState]:
    """:func:`train_driver` on one device, or as one rank of ``ranks``;
    returns ``(run_dir, final train state)``.  ``split``: what the device
    split decided, for the log."""
    config.validate()
    upper_bound = config.session == "Upperbound"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {device}: pass the CPU explicitly")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    do_strong = config.do_decoder_consistency and not upper_bound
    lead = ranks is None or ranks.rank == 0      # writes the run's files
    n_data = 1 if ranks is None else ranks.n_data

    if run_dir is None:
        run_dir = make_run_dir(config)
    os.makedirs(os.path.join(run_dir, "ckps"), exist_ok=True)
    if lead:
        setup_logging(run_dir)
        dump_config(run_dir, config)
    logging.info("config: %s", json.dumps(dataclasses.asdict(config), default=str))
    if ranks is None:
        logging.info("devices: %s", split)
    else:
        logging.info("data-parallel: %s; rank 0 writes the run", split)

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
    if steps_per_epoch == 0:
        raise RuntimeError(
            f"empty train epoch: loader yielded no full batch "
            f"(train slices < batch_size {config.batch_size}?)")

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
    if ranks is not None:
        mesh.replicate(state.model, ranks)

    # Dispatch: `chunk` updates a call; the resident pool or the loader's
    # stream (JAX's loop.py:407-437), on ranks as on one device.
    chunk = min(max(1, int(config.steps_per_dispatch)), steps_per_epoch)
    resident = use_resident(config.device_resident_data, len(train_ds),
                            train_ds.canvas_size, n_data)
    train_pool, pool_gather = None, gather
    if resident:
        logging.info("staging %d slices (%.2f GB, /%d devices) in device memory",
                     len(train_ds), pool_bytes(len(train_ds), train_ds.canvas_size) / 2 ** 30,
                     n_data)
        if ranks is None:
            train_pool = stage_train_pool(train_ds, device)
        else:
            train_pool = mesh.stage_resident_pool(train_ds, ranks)
            pool_gather = mesh.make_resident_gather(ranks)
    logging.info("steps per dispatch %d (%s), training data %s", chunk,
                 "CUDA graph replays"
                 if uses_graph(device, chunk, None if ranks is None else ranks.backend)
                 else "eager steps",
                 "resident on the device" if resident else "streamed")

    # One StepGraph for both steps: it holds the graph of the step that runs.
    graph = StepGraph()
    make_train = make_upper_bound_train_step if upper_bound else make_pacing_train_step

    def make_chunked(step):
        if resident:
            return make_resident_chunked_train_step(step, chunk, train_pool, graph,
                                                    pool_gather)
        return make_chunked_train_step(step, chunk, graph)

    train_step = make_chunked(make_train(config, steps_per_epoch, augment_fn=augment_fn,
                                         ranks=ranks))
    train_step_frozen = None
    if config.ref_quirk_bn_eval_after_first_epoch:
        train_step_frozen = make_chunked(
            make_train(config, steps_per_epoch, module_train=False, augment_fn=augment_fn,
                       ranks=ranks))
    val_pool = stage_val_pool(val_ds, config.batch_size, device, shrink=resident)
    resident_eval = make_resident_eval_fn(config, ranks)
    generator = torch.Generator(device=device)

    tb = _tb_writer(run_dir) if lead else None
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

    profiler = None
    for epoch in range(start_epoch, config.epoch):
        if config.profile_dir and epoch == start_epoch + 1 and lead:
            # one trace, after the first epoch's warm-up (JAX's
            # loop.py:510-519)
            profiler = _start_profiler(device)
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
        # `last`: the epoch's last batch, for the figure panels (an index
        # block into the pool, or the loader's host batch)
        acc, last = None, None
        waits = {name: trace.total(name) for name in ("loop.upload", "loop.loader_wait")}
        if resident:
            for pos in range(0, steps_per_epoch, chunk):
                with trace.span("loop.upload"):
                    idx = torch.from_numpy(blocks[pos:pos + chunk].astype(np.int32)).to(device)
                acc = step_fn(state, idx, generator, config.seed, acc)
            last = idx[-1]
        else:
            pending = []
            for raw in _timed(train_loader.batches(blocks), "loop.loader_wait"):
                raw.pop("uid", None)
                pending.append(raw)
                if len(pending) == chunk:
                    with trace.span("loop.upload"):
                        xs = stack_to_device(pending, device)
                    acc = step_fn(state, xs, generator, config.seed, acc)
                    last, pending = pending[-1], []
            if pending:
                with trace.span("loop.upload"):
                    xs = stack_to_device(pending, device)
                acc = step_fn(state, xs, generator, config.seed, acc)
                last = pending[-1]
        # Read the accumulated device metrics BEFORE stopping the epoch
        # timer: launches are asynchronous and only this host read waits.
        with trace.span("loop.metrics_read"):
            names = [k for k in acc if k != "lr"]
            values = torch.stack([acc[k].float() for k in names]).cpu().tolist()
        means = {"lr": acc["lr"] / steps_per_epoch,
                 **{k: v / steps_per_epoch for k, v in zip(names, values)}}
        toc = time.time()
        slices_per_sec = steps_per_epoch * config.batch_size / max(toc - tic, 1e-9)
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
        # (train_chaos.py:320-360); the augmentation is drawn again with an
        # epoch-keyed seed and one frozen-BN forward.  The upper-bound
        # session draws none, as in JAX (loop.py:487).  A sharded pool's
        # gather is a collective, so every rank joins it.
        if config.tb_figures and not upper_bound and (tb or (n_data > 1 and resident)):
            with trace.span("loop.figures"):
                fig_raw = (pool_gather(train_pool, last) if resident else
                           raw_batch_to_device(last, device, shrink=True))
                if tb:
                    generator.manual_seed(step_seed(config.seed, 1_000_000 + epoch))
                    fig_batch = augment_fn(fig_raw, generator)
                    # Rank 0's forward of the whole batch, alone: no halo
                    # exchange (the next step attaches the ranks again).
                    mesh.attach_ranks(state.model, None)
                    fig_out = _figure_forward(state, fig_batch)
                    _tb_train_figures(
                        tb, {k: v.float().cpu().numpy() for k, v in fig_batch.items()},
                        {k: v.float().cpu().numpy() for k, v in fig_out.items()
                         if k.endswith("logits") or k.endswith("logits_strong")},
                        epoch)

        # ---- validation (full labels, masked to the live region), on the
        # device; one host read
        with trace.span("loop.validation"):
            per_class, avg_all, val_loss_avg = summarize_validation(
                resident_eval(state, val_pool))
        valdice[epoch] = avg_all
        # persist every epoch (cheap) so crash+resume keeps the history;
        # the reference wrote it once at the end (train_chaos.py:428)
        if lead:
            np.savez(os.path.join(run_dir, "valdice"), valdice=valdice)
        spec_names = list(config.spec.classnames)
        logging.info("val: %03d, loss: %.6f, [%s, All: %.4f]",
                     epoch, val_loss_avg,
                     ", ".join(f"{n}: {d:.4f}" for n, d in zip(spec_names, per_class)),
                     avg_all)
        logging.info("trace: %03d, %s", epoch, _trace_line(waits))
        if tb:
            tb.add_scalar("losses/loss_val", val_loss_avg, epoch)
            for n_, d in zip(spec_names, per_class):
                # TB rejects spaces in summary names ("right kidney").
                tb.add_scalar(f"DSC/{n_.replace(' ', '_')}", d, epoch)
            tb.add_scalar("DSC/All", avg_all, epoch)
            tb.add_scalar("DSC/Best", max(best_avg, avg_all), epoch)
        if profiler is not None:
            _stop_profiler(profiler, config.profile_dir, epoch)
            profiler = None

        # ---- checkpoints (fixed interval precedence + final epoch,
        # reference: train_chaos.py:405-413)
        save_interval = ((epoch + 1) % config.ckp_interval == 0
                         or (epoch + 1) == config.epoch)
        stop = stop_after_epoch is not None and epoch >= stop_after_epoch
        if (save_interval or stop) and lead:
            _save(os.path.join(run_dir, "ckps", f"ckp_{epoch}"), state)
        if avg_all > best_avg:
            best_epoch, best_avg = epoch, avg_all
            if lead:
                _save(os.path.join(run_dir, "best_ckp"), state)
        if stop:
            logging.info("stop_after_epoch=%d: exiting", stop_after_epoch)
            break

    if graph.captures:
        logging.info("CUDA graph: %d captures, %d replays", graph.captures, graph.replays)
        # the last replay's gradients live in the graph's pool
        state.optimizer.zero_grad(set_to_none=True)
        graph.reset()
    logging.info("The best at epoch: %d, All: %.4f", best_epoch, best_avg)
    if lead:
        np.savez(os.path.join(run_dir, "valdice"), valdice=valdice)
    if tb:
        tb.close()
    return run_dir, state


def _start_profiler(device: torch.device):
    """A running ``torch.profiler`` session: the host, and the card's
    kernels when ``device`` is one."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str, epoch: int) -> None:
    """End the session and write its Chrome trace into ``profile_dir``."""
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_epoch{epoch:03d}.json")
    profiler.export_chrome_trace(path)
    logging.info("profiler trace written to %s", path)


def _timed(items, name: str):
    """``items``, each wait for the next one (the last, which finds the end,
    too) timed as the span ``name``."""
    items = iter(items)
    while True:
        with trace.span(name):
            item = next(items, None)
        if item is None:
            return
        yield item


def _save(path: str, state: TrainState) -> None:
    with trace.span("loop.checkpoint"):
        ckpt_lib.save_checkpoint(path, state)
    logging.info("checkpoint %s saved in %.3f s", os.path.basename(path),
                 trace.latest("loop.checkpoint") / 1e3)


def _trace_line(waits: Dict[str, float]) -> str:
    """The epoch log's line of measurements: the device phases of the last
    sampled replayed update, the last capture and its four parts (host ms),
    and the epoch's upload and loader wait (``waits``: their totals when
    the epoch began)."""
    update = trace.latest("phase.update")
    parts = ["update not sampled" if update is None else
             f"update {update:.2f} ms on the device ("
             + ", ".join(f"{p} {trace.latest('phase.' + p):.2f}" for p in trace.PHASES) + ")"]
    capture = trace.latest("graph.capture")
    if capture is not None:
        parts.append(f"capture {capture:.1f} ms (" + ", ".join(
            f"{p} {trace.latest('graph.' + p):.1f}"
            for p in ("drain", "empty_cache", "eager_update", "record")) + ")")
    parts += [f"{name[5:].replace('_', ' ')} {trace.total(name) - before:.2f} ms"
              for name, before in waits.items()]
    return ", ".join(parts)
