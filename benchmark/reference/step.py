"""One training update and one validation pass, plain.

A frozen copy of what the port's train step does for the CHAOS sessions
(``pacingpseudo_torch/train/step.py``, ``losses/losses.py``,
``models/aux_path.py::memory_update``, ``train/schedules.py``,
``train/optim.py``, ``evals/dice.py``), written with the loss library's
formulas where the program runs its fused loss kernel, and ``torch.optim.
Adam`` (eager, coupled L2) where the program replays a capturable Adam.
It imports nothing of the port.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from reference import aug as A
from reference.model import PacingModel, resize

_EPS_MASK = 1e-8


# ---- schedules (train/schedules.py, train/optim.py)

def poly_lr(epoch: int, epochs: int, base_lr: float, gamma: float = 0.9) -> float:
    return base_lr * (1.0 - epoch / epochs) ** gamma


def gaussian_ramp_up(t, base_value, max_t=80, scale=5.0):
    if t < max_t:
        return base_value * math.exp(-scale * (1.0 - t / max_t))
    return base_value


def memory_momentum(step, max_step, base_mo=0.9, gamma=0.9):
    return (1.0 - step / max_step) ** gamma * base_mo


def step_seed(seed: int, step: int, stream: int = 0) -> int:
    """The seed of update ``step``'s augmentation draws (stream 0)."""
    words = np.random.SeedSequence([seed + 1, step, stream]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


# ---- losses (losses/losses.py)

def _one_hot(target, num_classes):
    classes = torch.arange(num_classes, device=target.device).view(1, -1, *[1] * (target.dim() - 1))
    return (target.unsqueeze(1) == classes).float()


def partial_cross_entropy(logits, target, ignore_index):
    log_p = F.log_softmax(logits.float(), dim=1)
    valid = target != ignore_index
    safe = torch.where(valid, target, torch.zeros_like(target))
    nll = -(log_p * _one_hot(safe, logits.shape[1])).sum(dim=1)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.float().sum().clamp_min(_EPS_MASK)


def _masked_mean(loss, valid_mask):
    valid_mask = valid_mask.float()
    return (loss * valid_mask).sum() / valid_mask.sum().clamp_min(_EPS_MASK)


def entropy(logits, valid_mask):
    log_p = F.log_softmax(logits.float(), dim=1)
    return _masked_mean(-log_p.exp() * log_p, valid_mask)


def soft_cross_entropy(logits, target, valid_mask):
    return _masked_mean(-target.float() * F.log_softmax(logits.float(), dim=1), valid_mask)


def cross_entropy(logits, target):
    log_p = F.log_softmax(logits.float(), dim=1)
    return -(log_p * _one_hot(target, logits.shape[1])).sum(dim=1).mean()


def dice_loss(logits, target_one_hot):
    p = F.softmax(logits.float(), dim=1)
    t = target_one_hot.float()
    inter, ps, ts = (p * t).sum(dim=(2, 3)), p.sum(dim=(2, 3)), t.sum(dim=(2, 3))
    return -(2.0 * inter / (ps + ts + 1e-5)).mean()


# ---- the bank (models/aux_path.py)

def _update_bank_one_sample(bank, feats, scb_one_hot, m):
    num_classes = bank.shape[0]
    mask = scb_one_hot[:, :num_classes].float()
    counts = mask.sum(dim=0)
    raw_mean = (mask.T @ feats) / counts.clamp_min(1.0)[:, None]
    feats_n = feats / (feats.norm(dim=-1, keepdim=True) + 1e-8)
    bank_n = bank / (bank.norm(dim=-1, keepdim=True) + 1e-8)
    w = mask * (1.0 - feats_n @ bank_n.T)
    w = w / (w.sum(dim=0, keepdim=True) + 1e-8)
    blended = (1.0 - m) * bank_n + m * (w.T @ feats_n)
    cold = (bank == 0.0).all(dim=-1, keepdim=True)
    new = torch.where(cold, raw_mean, blended)
    return torch.where((counts > 0)[:, None], new, bank)


@torch.no_grad()
def memory_update(bank, features, scribble_one_hot, epoch, epochs, momentum, first_only):
    """The new ``(C, D)`` bank (cosine-similarity ensemble): sample 0 alone
    with ``first_only``, else every sample in order."""
    if first_only:
        features, scribble_one_hot = features[:1], scribble_one_hot[:1]
    big_h, big_w = scribble_one_hot.shape[-2:]
    feats = resize(features.float(), big_h, big_w).flatten(2).transpose(1, 2)
    scb = scribble_one_hot.flatten(2).transpose(1, 2)
    m = memory_momentum(epoch, epochs, momentum)
    bank = bank.float()
    for f, s in zip(feats, scb):
        bank = _update_bank_one_sample(bank, f, s, m)
    return bank


# ---- the model and its optimizer

def build_model(f: Dict, precision: str, device) -> PacingModel:
    """The reference model of a configuration's ``flags``."""
    return PacingModel(num_classes=f["num_classes"], init_ch=f["init_ch"],
                       max_ch=f["max_ch"], output_stride=f["output_stride"],
                       do_aux_path=f["session"] == "Experiment" and f["do_aux_path"],
                       feat_stage=tuple(f["feat_stage"]), hid_ch=f["hid_ch"],
                       input_ch=f["input_ch"], precision=precision, device=device)


def make_adam(f: Dict, model) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=f["lr"], betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=f["wd"])


def augment_params(f: Dict):
    base = A.BaseAugParams(crop_size=tuple(f["input_size"]), num_classes=f["num_classes"],
                           ignored_index=f["ignored_index"])
    s = 0.8 * f["strength"]
    strong = A.StrongAugParams(brightness_range=(-s, s),
                               contrast_range=(max(0.0, 1 - s), 1 + s),
                               gamma_range=(max(0.0, 1 - s), 1 + s))
    return base, strong


def _losses(f, model, batch, epoch, keep: Optional[int] = None):
    """``(total, {term: weighted loss}, new bank or None, outputs)`` of one
    batch; with ``keep`` the model runs on the whole batch and the losses
    take its first ``keep`` samples alone (the outputs stay whole)."""
    ign = f["ignored_index"]
    upper = f["session"] == "Upperbound"
    whole = model(batch["image"]) if upper else model(batch["image"], batch["image_strong"])
    out = whole if keep is None else {k: v[:keep] for k, v in whole.items()}
    if keep is not None:
        batch = {k: v[:keep] for k, v in batch.items()}
    if upper:
        logits = out["segmentation/logits"]
        terms = {"loss_ce": partial_cross_entropy(logits, batch["label"].argmax(dim=1), ign)}
        if f["loss_dice"]:
            terms["loss_dice"] = dice_loss(logits, batch["label"])
        return sum(terms.values()), terms, None, whole
    weak, strong = out["segmentation/logits"], out["segmentation/logits_strong"]
    target = batch["scribble"].argmax(dim=1)
    valid = batch["valid_mask"]
    ramp = lambda w, on: (gaussian_ramp_up(epoch, w, scale=f["ramp_up_scale"]) if on else w)
    terms = {"loss_pce": partial_cross_entropy(weak, target, ign),
             "loss_ent": entropy(weak, valid) * ramp(f["loss_ent_weight"],
                                                     f["ramp_up_loss_ent"]),
             "loss_cr": soft_cross_entropy(strong, F.softmax(weak, dim=1), valid)
             * ramp(f["loss_cr_weight"], f["ramp_up_loss_cr"])}
    new_bank = None
    if model.do_aux_path:
        terms["loss_aux_cls"] = partial_cross_entropy(out["aux/logits"], target, ign) \
            * f["loss_aux_weight"]
        new_bank = memory_update(model.aux_path.memory_bank[:, :, 0, 0], out["aux/features"],
                                 batch["scribble"], epoch, f["epoch"], f["update_momentum"],
                                 f["memory_update_mode"] == "first")
        logits_memory = model.aux_path.classify_bank(new_bank)
        terms["loss_memory"] = cross_entropy(
            logits_memory, torch.arange(f["num_classes"], device=logits_memory.device)) \
            * f["loss_memory_weight"]
    return sum(terms.values()), terms, new_bank, whole


def train_update(f: Dict, model, optimizer, raw: Dict[str, torch.Tensor], step: int,
                 seed: int, steps_per_epoch: int, module_train: bool,
                 generator: torch.Generator, drop: Optional[str] = None):
    """One update of ``model`` on the raw canvas batch ``raw`` (float32
    canvases as the program's pool rounds them): augment with ``generator``
    seeded for ``step``, forward, losses, backward, Adam, the bank.

    ``drop="half"`` is a planted fault (half of the batch left out, the
    mean taken over the rest): the model runs on the whole batch, and the
    losses, so the backward and the update, take its first half alone.

    Returns ``(augmented batch, outputs, {term: float})``."""
    epoch = step // steps_per_epoch
    base, strong = augment_params(f)
    generator.manual_seed(step_seed(seed, step))
    batch = A.augment_batch(raw, generator, base, strong,
                            do_strong=f["session"] == "Experiment")
    keep = batch["image"].shape[0] // 2 if drop == "half" else None
    model.train(module_train)
    optimizer.zero_grad(set_to_none=True)
    total, terms, new_bank, out = _losses(f, model, batch, epoch, keep)
    total.backward()
    for group in optimizer.param_groups:
        group["lr"] = poly_lr(epoch, f["epoch"], f["lr"])
    optimizer.step()
    if new_bank is not None:
        model.aux_path.memory_bank.copy_(new_bank[:, :, None, None])
    terms["loss_total"] = total
    return batch, {k: v.detach() for k, v in out.items()}, \
        {k: float(v.detach()) for k, v in terms.items()}


@torch.no_grad()
def validation_sums(f: Dict, model, pool: Dict[str, torch.Tensor], batch_size: int):
    """The loop's validation over ``pool`` (every slice once, blocks of
    ``batch_size``): ``{loss_sum, n_sum, dice_sum (C,), dice_cnt (C,)}`` in
    float64, as the program's resident evaluation sums them."""
    c, ign = f["num_classes"], f["ignored_index"]
    was = model.training
    model.eval()
    n_val = pool["image"].shape[0]
    dev = pool["image"].device
    acc = {"loss_sum": torch.zeros((), dtype=torch.float64, device=dev),
           "n_sum": torch.zeros((), dtype=torch.float64, device=dev),
           "dice_sum": torch.zeros(c, dtype=torch.float64, device=dev),
           "dice_cnt": torch.zeros(c, dtype=torch.float64, device=dev)}
    for lo in range(0, n_val, batch_size):
        raw = {k: v[lo:lo + batch_size] for k, v in pool.items()}
        batch = A.eval_preprocess_batch(raw, c)
        logits = model(batch["image"])["segmentation/logits"]
        if f["session"] == "Upperbound":
            label = raw["label"].long()
            loss = partial_cross_entropy(logits, torch.where(label < c, label, 0), ign)
        else:
            loss = partial_cross_entropy(logits, batch["scribble"].argmax(dim=1), ign)
        pred = F.one_hot(F.softmax(logits, dim=1).argmax(dim=1), c).permute(0, 3, 1, 2).float()
        t = batch["label"].float()
        region = batch["region_mask"]
        pred, t = pred * region, t * region
        inter, p_sum, t_sum = (pred * t).sum(dim=(2, 3)), pred.sum(dim=(2, 3)), t.sum(dim=(2, 3))
        dice = 2.0 * inter / (p_sum + t_sum + 1e-5)
        ok = ~((p_sum == 0) & (t_sum == 0))
        n = raw["image"].shape[0]
        acc["loss_sum"] += loss.double() * n
        acc["n_sum"] += n
        acc["dice_sum"] += torch.where(ok, dice, 0.0).double().sum(0)
        acc["dice_cnt"] += ok.double().sum(0)
    model.train(was)
    return acc
