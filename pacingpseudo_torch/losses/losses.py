"""Weak-supervision loss library (plain functions on NCHW tensors).

The port of ``pacingpseudo_tpu/losses/losses.py`` (reference:
losses/losses.py:9-171).  The class axis is dim 1 (NCHW, PyTorch's
layout); ``valid_mask`` is ``(N, 1, H, W)``.  All reductions run in
float32 whatever the input dtype.

Masked-normalisation semantics are the reference's: with a ``valid_mask``
the loss is ``sum(loss * mask) / max(sum(mask), 1e-8)``, without one the
plain mean.  The reference asymmetry is kept on purpose: for losses that
are element-wise over the class axis (soft CE, entropy, KL) the numerator
sums over classes while the denominator counts only ``N*H*W`` mask
entries.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS_MASK = 1e-8


def _masked_mean(loss, valid_mask):
    """``sum(loss*mask)/max(sum(mask),1e-8)``, or the plain mean without a mask.

    ``loss`` may have more channels than ``valid_mask``; the mask
    broadcasts over the class axis (reference losses/losses.py:19-23).
    """
    if valid_mask is None:
        return loss.mean()
    valid_mask = valid_mask.float()
    return (loss * valid_mask).sum() / valid_mask.sum().clamp_min(_EPS_MASK)


def entropy_minimization_loss(logits, valid_mask=None):
    """Shannon entropy of the per-pixel class distribution (losses.py:9-24).

    Args:
      logits: ``(N, C, H, W)``.
      valid_mask: optional ``(N, 1, H, W)``.
    """
    log_p = F.log_softmax(logits.float(), dim=1)
    return _masked_mean(-log_p.exp() * log_p, valid_mask)


def cross_entropy_loss(logits, target):
    """Mean cross entropy with integer targets (losses.py:26-33).

    ``logits``: ``(N, C, ...)``; ``target``: ``(N, ...)`` integers in
    ``[0, C)``.  Out-of-range targets select no class and add 0 while still
    counted in the mean, as in the JAX package's one-hot form; callers with
    ignore semantics use :func:`partial_cross_entropy_loss`.
    """
    log_p = F.log_softmax(logits.float(), dim=1)
    one_hot = _one_hot(target, logits.shape[1], dim=1)
    return -(log_p * one_hot).sum(dim=1).mean()


def partial_cross_entropy_loss(logits, target, ignore_index):
    """Cross entropy over the pixels whose target is not ``ignore_index``.

    Reference losses/losses.py:35-43.  A batch whose pixels are all ignored
    gives 0, where ``F.cross_entropy`` gives NaN (PARITY.md:89-90).

    Args:
      logits: ``(N, C, H, W)``.
      target: integer ``(N, H, W)``.
    """
    log_p = F.log_softmax(logits.float(), dim=1)
    valid = target != ignore_index
    safe_target = torch.where(valid, target, torch.zeros_like(target))
    nll = -(log_p * _one_hot(safe_target, logits.shape[1], dim=1)).sum(dim=1)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.float().sum().clamp_min(_EPS_MASK)


def soft_label_cross_entropy_loss(logits, target, valid_mask=None):
    """Cross entropy against a soft target (losses.py:45-62).

    Args:
      logits: ``(N, C, H, W)`` student logits.
      target: ``(N, C, H, W)`` probabilities (the teacher stream).
      valid_mask: optional ``(N, 1, H, W)``.
    """
    log_p = F.log_softmax(logits.float(), dim=1)
    return _masked_mean(-target.float() * log_p, valid_mask)


def l1_loss(probs, target, valid_mask=None):
    """L1 distance of probability maps, summed over classes (losses.py:64-79)."""
    diff = (probs.float() - target.float()).abs().sum(dim=1, keepdim=True)
    return _masked_mean(diff, valid_mask)


def l2_loss(probs, target, valid_mask=None):
    """Squared distance of probability maps, summed over classes (losses.py:81-96)."""
    diff = (probs.float() - target.float()).square().sum(dim=1, keepdim=True)
    return _masked_mean(diff, valid_mask)


def kl_loss(logits, target_logits, valid_mask=None):
    """KL(target || input) from two logit maps (losses.py:98-116).

    ``F.kl_div(input_ll, target_ll, log_target=True)`` element-wise:
    ``exp(t) * (t - i)``.
    """
    input_ll = F.log_softmax(logits.float(), dim=1)
    target_ll = F.log_softmax(target_logits.float(), dim=1)
    return _masked_mean(target_ll.exp() * (target_ll - input_ll), valid_mask)


def bidirectional_kl_loss(logits, target_logits, valid_mask=None):
    """``(KL(t||i) + KL(i||t)) / 2`` (losses.py:118-145)."""
    p = kl_loss(logits, target_logits, valid_mask)
    q = kl_loss(target_logits, logits, valid_mask)
    return (p + q) / 2.0


def dice_loss_fn(logits, target_one_hot):
    """Soft Dice objective; returns the **negative** mean Dice (losses.py:147-162).

    Args:
      logits: ``(N, C, H, W)``.
      target_one_hot: ``(N, C, H, W)``.
    """
    eps = 1e-5
    p = F.softmax(logits.float(), dim=1)
    t = target_one_hot.float()
    inter = 2.0 * (p * t).sum(dim=(2, 3))                      # (N, C)
    denom = p.sum(dim=(2, 3)) + t.sum(dim=(2, 3)) + eps
    return -(inter / denom).mean()


def multi_label_soft_margin_loss(logits, target):
    """One-vs-all logistic loss, mean over classes then batch (losses.py:164-171).

    ``logits``, ``target``: ``(N, C)``.
    """
    x = logits.float()
    y = target.float()
    loss = -(y * F.logsigmoid(x) + (1.0 - y) * F.logsigmoid(-x))
    return loss.mean(dim=-1).mean()


def _one_hot(target, num_classes, dim):
    """Float one-hot of ``target`` along ``dim``; out-of-range rows are zero."""
    classes = torch.arange(num_classes, device=target.device)
    shape = [1] * (target.dim() + 1)
    shape[dim] = num_classes
    return (target.unsqueeze(dim) == classes.view(shape)).float()
