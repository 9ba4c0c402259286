"""Align-corners bilinear resize (NCHW).

The reference decoder upsamples with ``nn.Upsample(mode='bilinear',
align_corners=True)`` (reference models/unet.py:144) and the aux path with
``F.interpolate(..., align_corners=True)`` (aux_path_memory.py:52,75).  The
JAX package builds the same map from interpolation matrices
(``pacingpseudo_tpu/ops/resize.py``); on the GPU PyTorch's own
``interpolate`` computes it directly.
"""
from __future__ import annotations

import torch.nn.functional as F


def bilinear_resize_align_corners(x, out_h: int, out_w: int):
    """Resize ``(N, C, H, W)`` to ``(N, C, out_h, out_w)``, align_corners=True."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def upsample2x_align_corners(x):
    """2x bilinear upsample, align_corners=True (the decoder's upsample)."""
    h, w = x.shape[-2:]
    return bilinear_resize_align_corners(x, 2 * h, 2 * w)
