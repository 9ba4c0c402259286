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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

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
from pacingpseudo_torch.models.aux_path import memory_update
from pacingpseudo_torch.ops.fused_loss import fused_pacing_losses
from pacingpseudo_torch.train.optim import lr_at, set_lr
from pacingpseudo_torch.train.schedules import gaussian_ramp_up
from pacingpseudo_torch.train.state import TrainState


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


def _pacing_losses(config, model, batch, epoch):
    """Forward and loss assembly of one pacing step: ``(total, metrics,
    new_bank)``; ``new_bank`` is None without the memory bank."""
    scribble = batch["scribble"]
    valid_mask = batch.get("valid_mask")
    image_strong = (batch.get("image_strong")
                    if config.do_decoder_consistency else None)
    outputs = model(batch["image"], image_strong, train=True)
    logits_weak = outputs["segmentation/logits"]
    scb_target = scribble.argmax(dim=1)

    if _use_fused_loss_kernel(config, logits_weak, valid_mask):
        loss_pce, ent_raw, sce_raw = fused_pacing_losses(
            logits_weak, outputs["segmentation/logits_strong"], scb_target,
            valid_mask[:, 0], config.ignored_index)
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
        return _pacing_aux_losses(config, model, outputs, scribble,
                                  scb_target, epoch, total, metrics)

    # Reference: consistency_reglur_memory.py:29-36
    loss_pce = partial_cross_entropy_loss(logits_weak, scb_target,
                                          config.ignored_index)
    total = loss_pce
    metrics = {"loss_pce": loss_pce}

    if config.do_loss_ent:
        # Reference: consistency_reglur_memory.py:39-44, train_chaos.py:277-283
        loss_ent = entropy_minimization_loss(logits_weak, valid_mask) * _ramp(
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
                                                    valid_mask)
        elif config.loss_cr_variants == "l1_loss":
            loss_cr = l1_loss(F.softmax(logits_strong, dim=1), prob_weak,
                              valid_mask)
        elif config.loss_cr_variants == "l2_loss":
            loss_cr = l2_loss(F.softmax(logits_strong, dim=1), prob_weak,
                              valid_mask)
        elif config.loss_cr_variants == "kl_loss":
            # The reference feeds raw weak logits here: detach_weak_cr does
            # not apply to the kl variant (consistency_reglur_memory.py:63).
            loss_cr = kl_loss(logits_strong, logits_weak, valid_mask)
        else:
            raise ValueError("The loss is not implemented.")
        loss_cr = loss_cr * _ramp(config, epoch, config.loss_cr_weight,
                                  config.ramp_up_loss_cr)
        total = total + loss_cr
        metrics["loss_cr"] = loss_cr

    return _pacing_aux_losses(config, model, outputs, scribble, scb_target,
                              epoch, total, metrics)


def _pacing_aux_losses(config, model, outputs, scribble, scb_target, epoch,
                       total, metrics):
    """Aux-path and memory-bank tail shared by both loss paths."""
    new_bank = None
    if config.do_aux_path:
        # Reference: consistency_reglur_memory.py:73-90, train_chaos.py:294-301
        loss_aux = partial_cross_entropy_loss(
            outputs["aux/logits"], scb_target,
            config.ignored_index) * config.loss_aux_weight
        total = total + loss_aux
        metrics["loss_aux_cls"] = loss_aux

        if config.do_memory:
            # Reference: aux_path_memory.py:59-65 -- the bank is updated
            # first, then the shared classifier scores the fresh prototypes.
            new_bank = memory_update(
                model.aux_path.memory_bank[:, :, 0, 0],
                outputs["aux/features"], scribble,
                step=epoch, max_step=config.epoch,
                momentum=config.update_momentum,
                ensemble_mode=config.ensemble_mode,
                update_mode=config.memory_update_mode)
            logits_memory = model.classify_bank(new_bank)
            loss_memory = cross_entropy_loss(
                logits_memory,
                torch.arange(config.num_classes, device=logits_memory.device))
            loss_memory = loss_memory * config.loss_memory_weight
            total = total + loss_memory
            metrics["loss_memory"] = loss_memory

    metrics["loss_total"] = total
    return total, metrics, new_bank


def _make_train_step(config, steps_per_epoch: int, losses: Callable,
                     module_train: bool, augment_fn: Optional[Callable]):
    """The step skeleton both sessions share: augment, forward and losses
    (``losses(config, model, batch, epoch) -> (total, metrics, new_bank)``),
    backward, the optimizer update with the per-epoch learning rate, the
    bank's EMA when ``new_bank`` is not None."""

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None):
        model, opt = state.model, state.optimizer
        epoch = float(state.step // steps_per_epoch)
        if augment_fn is not None:
            if generator is None:
                raise ValueError("a step with an augment_fn needs a generator")
            with torch.no_grad():
                batch = augment_fn(batch, generator)
        model.train(module_train)
        opt.zero_grad(set_to_none=True)
        total, metrics, new_bank = losses(config, model, batch, epoch)
        total.backward()
        lr = lr_at(config, state.step, steps_per_epoch)
        set_lr(opt, lr)
        opt.step()
        if new_bank is not None:
            model.aux_path.memory_bank.copy_(new_bank[:, :, None, None])
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["lr"] = lr
        return metrics

    return train_step


def make_pacing_train_step(config, steps_per_epoch: int,
                           module_train: bool = True,
                           augment_fn: Optional[Callable] = None
                           ) -> Callable[..., Dict]:
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
    """
    return _make_train_step(config, steps_per_epoch, _pacing_losses,
                            module_train, augment_fn)


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


def make_pacing_eval_step(config):
    """Validation step ``(state, batch) -> (loss_pce, dice (N, C), logits)``.

    Weak forward with the running BN statistics, PCE on the scribbles and
    per-class Dice against the **full** labels (train_chaos.py:369-391).
    With ``sample_valid`` (N,) in the batch, padded samples' targets become
    ``ignored_index`` and add no pixels to the loss.  The model's
    train/eval mode is restored afterwards.
    """

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any]):
        logits = eval_logits(state.model, batch["image"])
        scb_target = _ignore_padded(config, batch["scribble"].argmax(dim=1),
                                    batch.get("sample_valid"))
        loss_pce = partial_cross_entropy_loss(logits, scb_target,
                                              config.ignored_index)
        dice = dice_per_class(F.softmax(logits, dim=1), batch["label"],
                              region_mask=batch.get("region_mask"))
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

def _upper_bound_losses(config, model, batch, epoch):
    """Forward and losses of one upper-bound step on the bare model
    (``pacingpseudo_tpu/train/step.py:439-460``, reference
    upper_bound_chaos.py:157-167): CE on the argmax of the one-hot label,
    plus the soft Dice loss with ``loss_dice``.  A crop-padded pixel's label
    row is all zero and its argmax 0 (``torch.argmax`` takes the first
    maximum, as JAX's does), so padding trains as background."""
    logits = model(batch["image"], None, train=True)["segmentation/logits"]
    loss_ce = partial_cross_entropy_loss(logits, batch["label"].argmax(dim=1),
                                         config.ignored_index)
    total = loss_ce
    metrics = {"loss_ce": loss_ce}
    if config.loss_dice:
        loss_dice = dice_loss_fn(logits, batch["label"])
        total = total + loss_dice
        metrics["loss_dice"] = loss_dice
    metrics["loss_total"] = total
    return total, metrics, None


def make_upper_bound_train_step(config, steps_per_epoch: int,
                                module_train: bool = True,
                                augment_fn: Optional[Callable] = None
                                ) -> Callable[..., Dict]:
    """The upper-bound train step ``(state, batch, generator=None) ->
    metrics`` (``loss_ce``, ``loss_dice`` with ``config.loss_dice``,
    ``loss_total``, ``lr``) on a state whose model has no aux path
    (:func:`create_train_state` of an Upperbound config).  ``module_train``
    and ``augment_fn`` as in :func:`make_pacing_train_step`; the
    augmentation runs without the strong stream."""
    return _make_train_step(config, steps_per_epoch, _upper_bound_losses,
                            module_train, augment_fn)


def make_upper_bound_eval_step(config):
    """Validation step ``(state, batch) -> (loss_ce, loss_dice, dice (N, C),
    logits)`` (upper_bound_chaos.py:186-209): CE on the argmax of the
    label (padded samples of ``sample_valid`` ignored), the soft Dice loss
    and the per-class Dice of :func:`make_pacing_eval_step`."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any]):
        logits = eval_logits(state.model, batch["image"])
        target = _ignore_padded(config, batch["label"].argmax(dim=1),
                                batch.get("sample_valid"))
        loss_ce = partial_cross_entropy_loss(logits, target, config.ignored_index)
        loss_dice = dice_loss_fn(logits, batch["label"])
        dice = dice_per_class(F.softmax(logits, dim=1), batch["label"],
                              region_mask=batch.get("region_mask"))
        return loss_ce, loss_dice, dice, logits

    return eval_step
