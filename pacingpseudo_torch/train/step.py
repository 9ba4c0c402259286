"""Pacing train and eval steps.

The port of ``pacingpseudo_tpu/train/step.py:45-232,308-338`` (reference
train_chaos.py:263-315, consistency_reglur_memory.py:24-102).  One train
step runs the siamese forward, every enabled loss, the backward, the
optimizer update with the per-epoch learning rate, and the memory-bank
EMA.  It takes an already augmented batch: the JAX step's
``augment_fn=None`` form.

Batches are NCHW dicts: ``image`` and ``image_strong`` ``(N, 1, H, W)``,
``scribble`` one-hot ``(N, C+1, H, W)`` (last channel = ignore),
``label`` one-hot ``(N, C, H, W)``, ``valid_mask`` ``(N, 1, H, W)``.

Metrics are the **weighted** loss values, as the reference meters record
them (train_chaos.py:274-310), returned as device tensors: reading them is
the caller's sync.  The step itself never syncs with the host.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from pacingpseudo_torch.evals.dice import dice_per_class
from pacingpseudo_torch.losses import (
    cross_entropy_loss,
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


def make_pacing_train_step(config, steps_per_epoch: int,
                           module_train: bool = True
                           ) -> Callable[[TrainState, Dict[str, Any]], Dict]:
    """The pacing train step ``(state, batch) -> metrics``.

    It updates ``state`` in place (see train/state.py) and leaves this
    step's gradients in the parameters' ``.grad``.  ``module_train=False``
    is the frozen-BN variant of ``ref_quirk_bn_eval_after_first_epoch``:
    BatchNorm normalises with its running statistics and does not update
    them, dropout is off.
    """

    def train_step(state: TrainState, batch: Dict[str, Any]):
        model, opt = state.model, state.optimizer
        epoch = float(state.step // steps_per_epoch)
        model.train(module_train)
        opt.zero_grad(set_to_none=True)
        total, metrics, new_bank = _pacing_losses(config, model, batch, epoch)
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
        model = state.model
        was_training = model.training
        model.eval()
        try:
            logits = model(batch["image"], None, train=False)[
                "segmentation/logits"]
        finally:
            model.train(was_training)
        scb_target = batch["scribble"].argmax(dim=1)
        sample_valid = batch.get("sample_valid")
        if sample_valid is not None:
            scb_target = torch.where(sample_valid[:, None, None], scb_target,
                                     torch.full_like(scb_target,
                                                     config.ignored_index))
        loss_pce = partial_cross_entropy_loss(logits, scb_target,
                                              config.ignored_index)
        dice = dice_per_class(F.softmax(logits, dim=1), batch["label"],
                              region_mask=batch.get("region_mask"))
        return loss_pce, dice, logits

    return eval_step
