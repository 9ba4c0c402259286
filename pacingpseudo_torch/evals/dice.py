"""Per-class Dice in the reference's two conventions (NCHW, on the device).

* Validation Dice (reference utils/metrics.py:7-34), the port of
  ``pacingpseudo_tpu/evals/dice.py::dice_per_class_jax``:
  ``2·Σpq / (Σp + Σq + 1e-5)`` on the argmax of the softmax.
* Inference Dice (reference inference.py:196-216), the batched form of
  ``compute_dice_hard``: ``2·Σpq / max(Σp + Σq, 1e-8)`` on hard labels.

Both give NaN for a class that is absent from prediction and target
alike, so that averaging can skip it (train_chaos.py:388-391).  The host
functions :func:`compute_dice` and :func:`compute_dice_hard` are the
per-slice numpy forms (``pacingpseudo_tpu/evals/dice.py:53-103``); the two
eps conventions stay apart: ``+ 1e-5`` and ``max(·, 1e-8)``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def dice_per_class(probs, target_one_hot, eps=1e-5, region_mask=None):
    """Validation Dice, ``(N, C)`` float32.

    Args:
      probs: ``(N, C, H, W)`` softmax values.
      target_one_hot: ``(N, C, H, W)`` one-hot labels.
      region_mask: optional ``(N, 1, H, W)`` live-region mask: the metric
        covers the unpadded part of a padded canvas only.
    """
    num_classes = probs.shape[1]
    pred = F.one_hot(probs.argmax(dim=1), num_classes).permute(0, 3, 1, 2).float()
    t = target_one_hot.float()
    if region_mask is not None:
        pred = pred * region_mask
        t = t * region_mask
    inter = (pred * t).sum(dim=(2, 3))
    p_sum = pred.sum(dim=(2, 3))
    t_sum = t.sum(dim=(2, 3))
    dice = 2.0 * inter / (p_sum + t_sum + eps)
    both_empty = (p_sum == 0) & (t_sum == 0)
    return torch.where(both_empty, torch.full_like(dice, float("nan")), dice)


def dice_per_class_hard(pred, label, num_classes: int):
    """Inference Dice of integer maps ``(N, H, W)``, ``(N, C)`` float32."""
    classes = torch.arange(num_classes, device=pred.device).view(1, -1, 1, 1)
    p = (pred.unsqueeze(1) == classes).float()
    t = (label.unsqueeze(1) == classes).float()
    inter = (p * t).sum(dim=(2, 3))
    den = p.sum(dim=(2, 3)) + t.sum(dim=(2, 3))
    dice = 2.0 * inter / den.clamp_min(1e-8)
    return torch.where(den == 0, torch.full_like(dice, float("nan")), dice)


def compute_dice(softmax_chw, target_chw):
    """Validation Dice of one sample on the host (reference
    utils/metrics.py:7-34, CHW as there): ``(C, H, W)`` softmax values and
    one-hot label -> per-class list, NaN where both sides are empty."""
    if softmax_chw.shape != target_chw.shape:
        raise ValueError(f"shapes differ: {softmax_chw.shape} {target_chw.shape}")
    eps = 1e-5
    hard = np.argmax(softmax_chw, axis=0)
    dice_ls = []
    for c in range(softmax_chw.shape[0]):
        p = (hard == c).astype(np.float64).reshape(-1)
        t = np.asarray(target_chw[c], np.float64).reshape(-1)
        if not p.any() and not t.any():
            dice_ls.append(np.nan)
        else:
            dice_ls.append(2.0 * np.sum(p * t) / (np.sum(p) + np.sum(t) + eps))
    return dice_ls


def compute_dice_hard(pred_hard, label, num_classes):
    """Inference Dice of one slice on the host (reference
    inference.py:196-216): ``(H, W)`` integer prediction and label ->
    per-class list, ``2·Σpq / max(Σp + Σq, 1e-8)``, NaN where both sides
    are empty."""
    out = []
    for cls in range(num_classes):
        p = pred_hard == cls
        t = label == cls
        if not np.any(p) and not np.any(t):
            out.append(np.nan)
        else:
            out.append(2.0 * np.sum(p & t) / max(p.sum() + t.sum(), 1e-8))
    return out
