"""Pacing and upper-bound train and eval steps.

The port of ``pacingpseudo_tpu/train/step.py:45-232,308-338,439-522``
(reference train_chaos.py:263-315, consistency_reglur_memory.py:24-102,
upper_bound_chaos.py:152-209).  One pacing train step runs the siamese
forward, every enabled loss, the backward, the optimizer update with the
per-epoch learning rate, and the memory-bank EMA; an upper-bound step the
bare model's forward, CE and Dice on the full labels, the backward and the
update.  With an ``augment_fn`` (aug/engine.py ``make_train_augment_fn``) the
step takes a raw canvas batch and augments it first, on the device, as the
JAX step does with its ``augment_fn``; without one it takes an already
augmented batch.

Augmented batches are NCHW dicts: ``image`` and ``image_strong`` ``(N, 1, H, W)``,
``scribble`` one-hot ``(N, C+1, H, W)`` (last channel = ignore),
``label`` one-hot ``(N, C, H, W)``, ``valid_mask`` ``(N, 1, H, W)``.

Metrics are the **weighted** loss values, as the reference meters record
them (train_chaos.py:274-310), returned as device tensors: reading them is
the caller's sync.  The step itself never syncs with the host.

Chunked dispatch (``step.py:235-305`` of the JAX package):
:func:`make_chunked_train_step` and :func:`make_resident_chunked_train_step`
run up to ``chunk`` updates a call, on stacked raw batches or on index
blocks into a resident pool, and add their metrics on the device.  On a
card with ``chunk > 1``, alone or as one of NCCL ranks, each update is a
replay of one captured CUDA graph of the step (``train/graph.py``), its
collectives included; elsewhere, ranks on gloo included, the eager step
runs (:func:`uses_graph`).

Data-parallel and height-sharded steps (``ranks``, a ``parallel.mesh.
RankGroup`` of ``n_data x n_space`` ranks): every rank takes the **global**
batch, augments all of it with the generators seeded as the single-device
step seeds them, and keeps its block, the rows of its data index and, with
a space axis, the heights of its space index (``parallel.spatial.
shard_batch``, where JAX's step applies ``make_spatial_constraint``); the
forward runs on that block with synchronised BatchNorm and halo-exchanged
convs and resizes, each loss is the rank's sum over the global count, the
bank folds the global batch in order (its features gathered over both
axes, the scribble kept whole from before the cut), and the gradients and
metrics are summed over the ranks before the update, which is then the
same on every rank.  So one update is the single-device update on the
global batch (the JAX package's sharded step, ``pacingpseudo_tpu/parallel/
mesh.py`` and ``spatial.py``).  The chunked steps take them as they take
the single-device step.

Device phases (``utils/trace.py``): a train step is one update region,
its boundaries marked where the work happens: the start, the end of the
augmentation (the gather too, where ``StepGraph``'s region opens before
it), the end of the model's forward (in ``_pacing_losses`` and
``_upper_bound_losses``, right after ``model(...)``), the start and the
end of ``backward()``, and the end of the step.  So the phases are
``augment``, ``forward`` (both streams and the aux path's forward; with
ranks the cut of the batch too), ``losses`` (every loss term, the bank's
new prototypes and their CE), ``backward`` and ``optimizer`` (with ranks
the gradients' sum; Adam, the bank's write, the metrics).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pacingpseudo_torch.evals.dice import dice_per_class
from pacingpseudo_torch.losses import (
    cross_entropy_loss,
    dice_loss_fn,
    entropy_minimization_loss,
    kl_loss,
    l1_loss,
    l2_loss,
    partial_cross_entropy_loss,
    soft_label_cross_entropy_loss,
)
from pacingpseudo_torch.data.resident import gather
from pacingpseudo_torch.models.aux_path import memory_update
from pacingpseudo_torch.ops.fused_loss import fused_pacing_losses
from pacingpseudo_torch.parallel import spatial
from pacingpseudo_torch.parallel.mesh import attach_ranks
from pacingpseudo_torch.train.graph import StepGraph
from pacingpseudo_torch.train.optim import lr_at, set_lr
from pacingpseudo_torch.train.schedules import gaussian_ramp_up
from pacingpseudo_torch.train.state import TrainState
from pacingpseudo_torch.utils import trace


def _use_fused_loss_kernel(config, logits, valid_mask) -> bool:
    """Whether the fused loss (``ops/fused_loss.py``) applies.

    ``on`` takes it wherever the config allows (on the CPU it runs the
    kernel's plain version), ``auto`` only for CUDA tensors, ``off`` never.
    """
    if config.use_pallas_loss == "off":
        return False
    if config.use_pallas_loss == "auto" and logits.device.type != "cuda":
        return False
    # The kernel covers: pce + masked ent + non-detached soft-CE consistency.
    return (valid_mask is not None
            and config.do_decoder_consistency
            and config.loss_cr_variants == "ce_loss"
            and not config.detach_weak_cr)


def _ramp(config, epoch, weight, ramp):
    return (gaussian_ramp_up(epoch, weight, scale=config.ramp_up_scale)
            if ramp else weight)


def _pacing_losses(config, model, batch, epoch, ranks=None, shard=None):
    """Forward and loss assembly of one pacing step: ``(total, metrics,
    new_bank)``; ``new_bank`` is None without the memory bank.  With
    ``ranks`` the batch is this rank's block (``shard`` its height shard,
    None where it is whole in height) and every loss its share;
    ``scribble_global`` in the batch is the whole scribble, for the bank."""
    scribble = batch["scribble"]
    bank_scribble = batch.get("scribble_global", scribble)
    valid_mask = batch.get("valid_mask")
    image_strong = (batch.get("image_strong")
                    if config.do_decoder_consistency else None)
    outputs = model(batch["image"], image_strong, train=True)
    logits_weak = outputs["segmentation/logits"]
    trace.mark("forward", logits_weak.device)
    scb_target = scribble.argmax(dim=1)

    if _use_fused_loss_kernel(config, logits_weak, valid_mask):
        loss_pce, ent_raw, sce_raw = fused_pacing_losses(
            logits_weak, outputs["segmentation/logits_strong"], scb_target,
            valid_mask[:, 0], config.ignored_index, ranks)
        total = loss_pce
        metrics = {"loss_pce": loss_pce}
        if config.do_loss_ent:
            loss_ent = ent_raw * _ramp(config, epoch, config.loss_ent_weight,
                                       config.ramp_up_loss_ent)
            total = total + loss_ent
            metrics["loss_ent"] = loss_ent
        loss_cr = sce_raw * _ramp(config, epoch, config.loss_cr_weight,
                                  config.ramp_up_loss_cr)
        total = total + loss_cr
        metrics["loss_cr"] = loss_cr
        return _pacing_aux_losses(config, model, outputs, bank_scribble,
                                  scb_target, epoch, total, metrics, ranks, shard)

    # Reference: consistency_reglur_memory.py:29-36
    loss_pce = partial_cross_entropy_loss(logits_weak, scb_target,
                                          config.ignored_index, ranks)
    total = loss_pce
    metrics = {"loss_pce": loss_pce}

    if config.do_loss_ent:
        # Reference: consistency_reglur_memory.py:39-44, train_chaos.py:277-283
        loss_ent = entropy_minimization_loss(logits_weak, valid_mask, ranks) * _ramp(
            config, epoch, config.loss_ent_weight, config.ramp_up_loss_ent)
        total = total + loss_ent
        metrics["loss_ent"] = loss_ent

    if config.do_decoder_consistency:
        # Reference: consistency_reglur_memory.py:47-70, train_chaos.py:285-291
        logits_strong = outputs["segmentation/logits_strong"]
        prob_weak = F.softmax(logits_weak, dim=1)
        if config.detach_weak_cr:
            prob_weak = prob_weak.detach()
        if config.loss_cr_variants == "ce_loss":
            loss_cr = soft_label_cross_entropy_loss(logits_strong, prob_weak,
                                                    valid_mask, ranks)
        elif config.loss_cr_variants == "l1_loss":
            loss_cr = l1_loss(F.softmax(logits_strong, dim=1), prob_weak,
                              valid_mask, ranks)
        elif config.loss_cr_variants == "l2_loss":
            loss_cr = l2_loss(F.softmax(logits_strong, dim=1), prob_weak,
                              valid_mask, ranks)
        elif config.loss_cr_variants == "kl_loss":
            # The reference feeds raw weak logits here: detach_weak_cr does
            # not apply to the kl variant (consistency_reglur_memory.py:63).
            loss_cr = kl_loss(logits_strong, logits_weak, valid_mask, ranks)
        else:
            raise ValueError("The loss is not implemented.")
        loss_cr = loss_cr * _ramp(config, epoch, config.loss_cr_weight,
                                  config.ramp_up_loss_cr)
        total = total + loss_cr
        metrics["loss_cr"] = loss_cr

    return _pacing_aux_losses(config, model, outputs, bank_scribble, scb_target,
                              epoch, total, metrics, ranks, shard)


def _pacing_aux_losses(config, model, outputs, scribble, scb_target, epoch,
                       total, metrics, ranks=None, shard=None):
    """Aux-path and memory-bank tail shared by both loss paths.  With
    ``ranks`` the bank folds the global batch (every rank's aux features,
    gathered in order over the data axis and then over ``shard``'s space
    axis, and
    ``scribble``, which is the whole global scribble), so it stays equal on
    every rank, and the memory loss, which every rank computes whole,
    counts ``1/world`` on each."""
    new_bank = None
    if config.do_aux_path:
        # Reference: consistency_reglur_memory.py:73-90, train_chaos.py:294-301
        loss_aux = partial_cross_entropy_loss(
            outputs["aux/logits"], scb_target,
            config.ignored_index, ranks) * config.loss_aux_weight
        total = total + loss_aux
        metrics["loss_aux_cls"] = loss_aux

        if config.do_memory:
            # Reference: aux_path_memory.py:59-65 -- the bank is updated
            # first, then the shared classifier scores the fresh prototypes.
            features = outputs["aux/features"]
            if ranks is not None:
                features = spatial.gather_heights(ranks.gather_rows(features), shard)
            new_bank = memory_update(
                model.aux_path.memory_bank[:, :, 0, 0],
                features, scribble,
                step=epoch, max_step=config.epoch,
                momentum=config.update_momentum,
                ensemble_mode=config.ensemble_mode,
                update_mode=config.memory_update_mode)
            logits_memory = model.classify_bank(new_bank)
            loss_memory = cross_entropy_loss(
                logits_memory,
                torch.arange(config.num_classes, device=logits_memory.device))
            loss_memory = loss_memory * config.loss_memory_weight
            if ranks is not None:
                loss_memory = loss_memory / ranks.world
            total = total + loss_memory
            metrics["loss_memory"] = loss_memory

    metrics["loss_total"] = total
    return total, metrics, new_bank


class StepScalars(NamedTuple):
    """The host values an update reads: its epoch, from which the loss
    ramps and the bank's momentum follow, and its learning rate.  Both are
    fixed for an epoch, so one captured step serves the whole epoch."""
    epoch: float
    lr: float


def step_scalars(config, step: int, steps_per_epoch: int) -> StepScalars:
    """The :class:`StepScalars` of update number ``step`` (0-based)."""
    return StepScalars(float(step // steps_per_epoch), lr_at(config, step, steps_per_epoch))


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


def _make_train_step(config, steps_per_epoch: int, losses: Callable,
                     module_train: bool, augment_fn: Optional[Callable], ranks=None):
    """The step skeleton both sessions share: augment, forward and losses
    (``losses(config, model, batch, epoch) -> (total, metrics, new_bank)``),
    backward, the optimizer update with the per-epoch learning rate, the
    bank's EMA when ``new_bank`` is not None.  The step's ``scalars(step)``
    gives the :class:`StepScalars` of an update.  With ``ranks`` the
    (augmented) global batch is cut to this rank's block
    (``spatial.shard_batch``; the whole scribble rides along as
    ``scribble_global``), ``losses`` gets ``ranks`` and the block's
    ``shard``, and the gradients and metrics are summed over the ranks."""

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None):
        device = batch["image"].device
        with trace.update(device):
            model, opt = state.model, state.optimizer
            epoch, lr = step_scalars(config, state.step, steps_per_epoch)
            if augment_fn is not None:
                if generator is None:
                    raise ValueError("a step with an augment_fn needs a generator")
                with torch.no_grad():
                    batch = augment_fn(batch, generator)
            trace.mark("augmented", device)
            extra = {}
            if ranks is not None:
                whole = batch.get("scribble")
                batch, shard = spatial.shard_batch(batch, ranks, config.output_stride)
                if whole is not None:
                    batch["scribble_global"] = whole
                attach_ranks(model, ranks, shard)
                extra = {"ranks": ranks, "shard": shard}
            model.train(module_train)
            opt.zero_grad(set_to_none=True)
            total, metrics, new_bank = losses(config, model, batch, epoch, **extra)
            trace.mark("backward", device)
            total.backward()
            trace.mark("backward_end", device)
            if ranks is not None:
                ranks.sum_grads(model.parameters())
                metrics = ranks.sum_metrics(metrics)
            set_lr(opt, lr)
            opt.step()
            if new_bank is not None:
                model.aux_path.memory_bank.copy_(new_bank[:, :, None, None])
            state.step += 1
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["lr"] = lr
            return metrics

    train_step.scalars = lambda step: step_scalars(config, step, steps_per_epoch)
    train_step.ranks = ranks
    return train_step


def _accumulate(acc, metrics):
    """``acc + metrics`` key by key, in update order (``acc`` None: a copy of
    ``metrics``, which a graph replay would overwrite)."""
    if acc is None:
        return {k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in metrics.items()}
    return {k: acc[k] + v for k, v in metrics.items()}


def uses_graph(device, chunk: int, backend: Optional[str] = None) -> bool:
    """Whether a chunked step replays a CUDA graph: on a card, ``chunk > 1``,
    and either no ranks (``backend`` None) or ranks on NCCL, whose
    collectives a graph captures.  Gloo copies CUDA tensors through the
    host and cannot be captured: its ranks run the eager step, as the CPU
    does, and so does ``chunk == 1`` (JAX's plain single step).  A rule,
    not a fallback: where it says graph, a capture that fails raises."""
    return (torch.device(device).type == "cuda" and chunk > 1
            and backend in (None, "nccl"))


def _chunk_runner(step, chunk: int, to_batch: Callable, graph: Optional[StepGraph]):
    """``run(state, xs, generator, seed, acc) -> acc`` over the ``K <=
    chunk`` leading entries of ``xs`` (a dict of stacked device tensors):
    update ``k`` reseeds the generators from ``(seed, state.step)``
    (:func:`seed_step`) and steps on ``to_batch({key: xs[key][k]})``, as
    a replay of ``graph`` (a new one when None) where :func:`uses_graph`
    for the step's ranks; a call is the host span ``step.dispatch``."""
    graph = StepGraph() if graph is None else graph
    ranks = getattr(step, "ranks", None)
    backend = None if ranks is None else ranks.backend

    def run(state, xs: Dict[str, torch.Tensor], generator: torch.Generator, seed: int,
            acc: Optional[Dict] = None):
        first = next(iter(xs.values()))
        k_steps, device = first.shape[0], first.device
        if not 1 <= k_steps <= chunk:
            raise ValueError(f"a chunk of {k_steps} steps; this step takes 1 to {chunk}")

        def reseed(n):
            seed_step(generator, device, seed, n)

        graphed = uses_graph(device, chunk, backend)
        with trace.span("step.dispatch"):
            for k in range(k_steps):
                inputs = {key: v[k] for key, v in xs.items()}
                if graphed:
                    metrics = graph.run(step, state, inputs, to_batch, generator, reseed)
                else:
                    reseed(state.step)
                    metrics = step(state, to_batch(inputs), generator)
                acc = _accumulate(acc, metrics)
        return acc

    return run


def make_chunked_train_step(step: Callable, chunk: int, graph: Optional[StepGraph] = None):
    """Up to ``chunk`` train steps a call on stacked raw batches: the
    counterpart of JAX's ``make_chunked_train_step`` (``step.py:235-270``).

    Returns ``(state, raw_stack, generator, seed, acc=None) -> acc``:
    ``raw_stack`` holds ``K <= chunk`` raw batches on a leading axis
    (``npz_dataset.stack_to_device``), update ``k`` draws from
    ``generator`` and the device's default generator reseeded from
    ``(seed, state.step)``, and ``acc`` comes back with the updates'
    metrics added in order (``lr`` as a host float).  Where
    :func:`uses_graph` (a card, ``chunk > 1``, no ranks or NCCL ranks)
    each update replays the step's CUDA graph (``graph``, a
    :class:`~pacingpseudo_torch.train.graph.StepGraph` that other chunked
    steps may share; a new one when None); otherwise the eager step runs.
    A step with ranks takes its rank's block of each global batch itself.
    """
    return _chunk_runner(step, chunk, lambda raw: raw, graph)


def make_resident_chunked_train_step(step: Callable, chunk: int,
                                     pool: Dict[str, torch.Tensor],
                                     graph: Optional[StepGraph] = None,
                                     pool_gather: Callable = gather):
    """Up to ``chunk`` train steps a call on the resident ``pool``: the
    counterpart of JAX's ``make_resident_chunked_train_step``
    (``step.py:273-305``), on one device or, for a step with ranks, on a
    rank's shard of the pool (JAX's ``mesh=``).  The pool is bound here, where
    JAX's step takes it with each call: a captured step gathers from the
    tensors it was captured with.

    Returns ``(state, idx_block, generator, seed, acc=None) -> acc``:
    ``idx_block`` (K, N) int32 on the pool's device, ``K <= chunk``; update
    ``k`` steps on ``pool_gather(pool, idx_block[k])`` (``data.resident.
    gather``; a rank's shard takes ``parallel.mesh.make_resident_gather``).
    The rest as :func:`make_chunked_train_step`; in a graph the gather is
    captured too, so a replay reads only the index block."""
    run = _chunk_runner(step, chunk, lambda x: pool_gather(pool, x["idx"]), graph)

    def chunked(state, idx_block, generator, seed, acc=None):
        return run(state, {"idx": idx_block}, generator, seed, acc)

    return chunked


def make_pacing_train_step(config, steps_per_epoch: int,
                           module_train: bool = True,
                           augment_fn: Optional[Callable] = None,
                           ranks=None) -> Callable[..., Dict]:
    """The pacing train step ``(state, batch, generator=None) -> metrics``.

    It updates ``state`` in place (see train/state.py) and leaves this
    step's gradients in the parameters' ``.grad``.  ``module_train=False``
    is the frozen-BN variant of ``ref_quirk_bn_eval_after_first_epoch``:
    BatchNorm normalises with its running statistics and does not update
    them, dropout is off.

    ``augment_fn``: optional on-device augmentation ``(raw_batch,
    generator) -> batch``.  With it the step's ``batch`` is a raw canvas
    batch (``image/label/scribble`` (N, S, S), ``size`` (N, 2)) and
    ``generator`` a ``torch.Generator`` on the batch's device, from which
    the augmentation draws; it runs under ``torch.no_grad()``.

    ``ranks``: a ``parallel.mesh.RankGroup`` for a data-parallel step (see
    the module docstring): ``batch`` is then the global batch on every
    rank, and ``state`` the rank's replica.
    """
    return _make_train_step(config, steps_per_epoch, _pacing_losses,
                            module_train, augment_fn, ranks)


@torch.no_grad()
def eval_logits(model, image):
    """The weak-stream logits of an eval-mode forward (running BatchNorm
    statistics, no dropout); the model's train/eval mode is restored."""
    was_training = model.training
    model.eval()
    try:
        return model(image, None, train=False)["segmentation/logits"]
    finally:
        model.train(was_training)


def make_pacing_eval_step(config, ranks=None):
    """Validation step ``(state, batch, shard=None) -> (loss_pce, dice (N,
    C), logits)``.

    Weak forward with the running BN statistics, PCE on the scribbles and
    per-class Dice against the **full** labels (train_chaos.py:369-391).
    With ``sample_valid`` (N,) in the batch, padded samples' targets become
    ``ignored_index`` and add no pixels to the loss.  The model's
    train/eval mode is restored afterwards.  With ``ranks`` the batch is
    this rank's block (its rows, and its heights on a space axis: the
    ``shard`` that ``spatial.shard_batch`` returned with it), the loss its
    share (the global count), and the Dice each sample's whole (summed
    over the space group).
    """

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any], shard=None):
        if ranks is not None:
            attach_ranks(state.model, ranks, shard)
        logits = eval_logits(state.model, batch["image"])
        scb_target = _ignore_padded(config, batch["scribble"].argmax(dim=1),
                                    batch.get("sample_valid"))
        loss_pce = partial_cross_entropy_loss(logits, scb_target,
                                              config.ignored_index, ranks)
        dice = dice_per_class(F.softmax(logits, dim=1), batch["label"],
                              region_mask=batch.get("region_mask"), ranks=ranks)
        return loss_pce, dice, logits

    return eval_step


def _ignore_padded(config, target, sample_valid):
    """``target`` with the samples ``sample_valid`` masks out (the loop's
    padding of a partial batch) set to ``ignored_index``."""
    if sample_valid is None:
        return target
    return torch.where(sample_valid[:, None, None], target,
                       torch.full_like(target, config.ignored_index))


# ---------------------------------------------------------------------------
# Upper-bound (fully supervised) steps -- reference upper_bound_chaos.py
# ---------------------------------------------------------------------------

def _upper_bound_losses(config, model, batch, epoch, ranks=None, shard=None):
    """Forward and losses of one upper-bound step on the bare model
    (``pacingpseudo_tpu/train/step.py:439-460``, reference
    upper_bound_chaos.py:157-167): CE on the argmax of the one-hot label,
    plus the soft Dice loss with ``loss_dice``.  A crop-padded pixel's label
    row is all zero and its argmax 0 (``torch.argmax`` takes the first
    maximum, as JAX's does), so padding trains as background."""
    logits = model(batch["image"], None, train=True)["segmentation/logits"]
    trace.mark("forward", logits.device)
    loss_ce = partial_cross_entropy_loss(logits, batch["label"].argmax(dim=1),
                                         config.ignored_index, ranks)
    total = loss_ce
    metrics = {"loss_ce": loss_ce}
    if config.loss_dice:
        loss_dice = dice_loss_fn(logits, batch["label"], ranks)
        total = total + loss_dice
        metrics["loss_dice"] = loss_dice
    metrics["loss_total"] = total
    return total, metrics, None


def make_upper_bound_train_step(config, steps_per_epoch: int,
                                module_train: bool = True,
                                augment_fn: Optional[Callable] = None,
                                ranks=None) -> Callable[..., Dict]:
    """The upper-bound train step ``(state, batch, generator=None) ->
    metrics`` (``loss_ce``, ``loss_dice`` with ``config.loss_dice``,
    ``loss_total``, ``lr``) on a state whose model has no aux path
    (:func:`create_train_state` of an Upperbound config).  ``module_train``,
    ``augment_fn`` and ``ranks`` as in :func:`make_pacing_train_step`; the
    augmentation runs without the strong stream."""
    return _make_train_step(config, steps_per_epoch, _upper_bound_losses,
                            module_train, augment_fn, ranks)


def make_upper_bound_eval_step(config, ranks=None):
    """Validation step ``(state, batch, shard=None) -> (loss_ce, loss_dice,
    dice (N, C), logits)`` (upper_bound_chaos.py:186-209): CE on the argmax of the
    label (padded samples of ``sample_valid`` ignored), the soft Dice loss
    and the per-class Dice of :func:`make_pacing_eval_step`, whose
    ``ranks`` and ``shard`` this takes too (the losses are the rank's
    shares)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any], shard=None):
        if ranks is not None:
            attach_ranks(state.model, ranks, shard)
        logits = eval_logits(state.model, batch["image"])
        target = _ignore_padded(config, batch["label"].argmax(dim=1),
                                batch.get("sample_valid"))
        loss_ce = partial_cross_entropy_loss(logits, target, config.ignored_index, ranks)
        loss_dice = dice_loss_fn(logits, batch["label"], ranks)
        dice = dice_per_class(F.softmax(logits, dim=1), batch["label"],
                              region_mask=batch.get("region_mask"), ranks=ranks)
        return loss_ce, loss_dice, dice, logits

    return eval_step
