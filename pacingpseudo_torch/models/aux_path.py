"""Auxiliary deep-supervision path and class-prototype memory bank (NCHW).

The port of ``pacingpseudo_tpu/models/aux_path.py`` (reference
models/aux_path_memory.py:10-120).  Module names follow the reference's
``nn.Sequential`` indices, so the state_dict keys are
``aux_path.layer_bottleneck.{1,2}.*``, ``aux_path.fc_cls.1.weight`` and
``aux_path.memory_bank`` ``(C, D, 1, 1)``.

The bank is a buffer of the module, updated in place by the train step
from the pure function :func:`memory_update`.  Reference quirks kept:

* ``fc_cls`` (no bias) is shared between the auxiliary head and the
  classification of the bank prototypes (aux_path_memory.py:51,61);
* ``update_mode='first'``: only the first sample of each batch updates the
  bank (the ``return`` inside the loop, aux_path_memory.py:116); ``'all'``
  folds every sample in, in order;
* in ``cosine_similarity`` mode the stored row is L2-normalised before the
  EMA blend (aux_path_memory.py:106);
* an all-zero row takes the raw masked mean with no momentum (cold start,
  aux_path_memory.py:92-95).

In data-parallel training the step folds the gathered global batch into
the bank (``train/step.py``: rows over the data axis, heights over the
space axis), and :class:`Dropout2d` draws the global batch's channel mask
on every rank and keeps the rank's rows, so both are the single-device
functions.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from pacingpseudo_torch.models.norm import BatchNorm2d
from pacingpseudo_torch.models.unet import Conv2d
from pacingpseudo_torch.ops.resize import bilinear_resize_align_corners
from pacingpseudo_torch.train.schedules import memory_momentum


class Dropout2d(nn.Dropout2d):
    """``nn.Dropout2d`` that, with a rank group (``ranks``), draws the
    ``(N·n_data, C, 1, 1)`` mask of the global batch as ``F.dropout2d``
    draws it (``bernoulli_(1 - p)`` in the input's dtype, divided by ``1 -
    p``) and applies the rows of this rank's data index: every height
    shard of a sample takes the same mask."""

    def __init__(self, p: float = 0.5):
        super().__init__(p)
        self.ranks = None

    def forward(self, x):
        if self.ranks is None or not self.training or self.p == 0.0:
            return super().forward(x)
        noise = x.new_empty((x.shape[0] * self.ranks.n_data, x.shape[1], 1, 1))
        noise.bernoulli_(1.0 - self.p).div_(1.0 - self.p)
        return x * self.ranks.local_rows(noise)


class AuxPath(nn.Module):
    """Bottleneck projection of the chosen encoder stages + shared classifier.

    ``forward`` concatenates ``feat_stage`` of the end-points dict (default
    ``encoder/stage6, encoder/stage5``), projects to ``hid_ch`` (conv in
    ``dtype``, BN and LeakyReLU in float32) and returns
    ``(aux_features, aux logits resized to out_hw)``, both float32.  On a
    height shard (``shard``) ``out_hw`` is the shard's and the resize the
    sharded one.
    """

    def __init__(self, num_classes: int, in_ch: int,
                 feat_stage: Sequence[str] = ("encoder/stage6", "encoder/stage5"),
                 hid_ch: int = 64, aux_drop_prob: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.feat_stage = tuple(feat_stage)
        self.dtype = dtype
        self.layer_bottleneck = nn.Sequential(
            Dropout2d(aux_drop_prob),
            Conv2d(in_ch, hid_ch, 3, padding=1, compute_dtype=dtype,
                   device=device),
            BatchNorm2d(hid_ch, device=device),
            nn.LeakyReLU(1e-2),
        )
        # JAX's conv_bottleneck takes Flax's default zero bias
        # (pacingpseudo_tpu/models/aux_path.py:63-67).
        self.layer_bottleneck[1].zero_bias_init = True
        self.fc_cls = nn.Sequential(
            Dropout2d(aux_drop_prob),
            Conv2d(hid_ch, num_classes, 1, bias=False, device=device),
        )
        self.register_buffer("memory_bank", init_memory_bank(
            num_classes, hid_ch, device)[:, :, None, None])
        self.shard = None

    def forward(self, end_points, out_hw):
        feat = torch.cat([end_points[s] for s in self.feat_stage], dim=1)
        aux_features = self.layer_bottleneck(feat.to(self.dtype))
        logits = bilinear_resize_align_corners(self.fc_cls(aux_features),
                                               out_hw[0], out_hw[1], self.shard)
        return aux_features, logits.float()

    def classify_bank(self, bank):
        """``fc_cls`` applied to the ``(C, D)`` prototypes: ``(C, C)`` logits."""
        return self.fc_cls[1](bank[:, :, None, None])[:, :, 0, 0]


def _update_bank_one_sample(bank, feats, scb_one_hot, m, ensemble_mode):
    """Fold one sample's pixel embeddings into the bank.

    Args:
      bank: ``(C, D)``.
      feats: ``(HW, D)`` float32 embeddings at the scribble's resolution.
      scb_one_hot: ``(HW, C+1)`` one-hot scribble (last channel = ignore).
      m: weight of the fresh estimate.
    """
    num_classes = bank.shape[0]
    mask = scb_one_hot[:, :num_classes].float()                   # (HW, C)
    counts = mask.sum(dim=0)
    raw_mean = (mask.T @ feats) / counts.clamp_min(1.0)[:, None]  # (C, D)
    if ensemble_mode == "mean":
        warm_update, old_for_ema = raw_mean, bank
    elif ensemble_mode == "cosine_similarity":
        feats_n = feats / (feats.norm(dim=-1, keepdim=True) + 1e-8)
        bank_n = bank / (bank.norm(dim=-1, keepdim=True) + 1e-8)
        w = mask * (1.0 - feats_n @ bank_n.T)                     # (HW, C)
        w = w / (w.sum(dim=0, keepdim=True) + 1e-8)
        warm_update, old_for_ema = w.T @ feats_n, bank_n
    else:
        raise ValueError(f"Unknown ensemble_mode: {ensemble_mode!r}")
    blended = (1.0 - m) * old_for_ema + m * warm_update
    cold = (bank == 0.0).all(dim=-1, keepdim=True)
    new = torch.where(cold, raw_mean, blended)
    return torch.where((counts > 0)[:, None], new, bank)


@torch.no_grad()
def memory_update(bank, aux_features, scribble_one_hot, step, max_step,
                  momentum=0.9, ensemble_mode="cosine_similarity",
                  update_mode="all"):
    """The new ``(C, D)`` bank (reference aux_path_memory.py:68-116).

    Args:
      bank: ``(C, D)``.
      aux_features: ``(N, D, h, w)`` bottleneck features.
      scribble_one_hot: ``(N, C+1, H, W)``.
      step, max_step: epoch index and total epochs (momentum ramp).
      update_mode: ``'all'`` or ``'first'`` (only sample 0 updates, and
        only sample 0 is resized).

    No gradient: the reference update runs under ``torch.no_grad()``.
    """
    if update_mode == "first":
        aux_features, scribble_one_hot = aux_features[:1], scribble_one_hot[:1]
    elif update_mode != "all":
        raise ValueError(f"Unknown update_mode: {update_mode!r}")
    big_h, big_w = scribble_one_hot.shape[-2:]
    feats = bilinear_resize_align_corners(aux_features.float(), big_h, big_w)
    feats = feats.flatten(2).transpose(1, 2)                      # (n, HW, D)
    scb = scribble_one_hot.flatten(2).transpose(1, 2)             # (n, HW, C+1)
    m = memory_momentum(step, max_step, momentum)
    bank = bank.float()
    for f, s in zip(feats, scb):
        bank = _update_bank_one_sample(bank, f, s, m, ensemble_mode)
    return bank


def init_memory_bank(num_classes: int, hid_ch: int, device=None):
    """Zero-initialised ``(C, D)`` bank (reference aux_path_memory.py:40-43)."""
    return torch.zeros((num_classes, hid_ch), dtype=torch.float32, device=device)
