"""Align-corners bilinear resize (NCHW).

The reference decoder upsamples with ``nn.Upsample(mode='bilinear',
align_corners=True)`` (reference models/unet.py:144) and the aux path with
``F.interpolate(..., align_corners=True)`` (aux_path_memory.py:52,75).  The
JAX package builds the same map from interpolation matrices
(``pacingpseudo_tpu/ops/resize.py``); on the GPU PyTorch's own
``interpolate`` computes it directly.  On a height shard (a
``parallel.spatial.Shard``) the sizes are the shard's, and the resize is
``parallel.spatial.resize_align_corners``: one halo row each side and the
shard's rows of the global interpolation matrix, since ``interpolate`` on
the shard would resize in the shard's coordinates.
"""
from __future__ import annotations

import torch.nn.functional as F


def bilinear_resize_align_corners(x, out_h: int, out_w: int, shard=None):
    """Resize ``(N, C, H, W)`` to ``(N, C, out_h, out_w)``, align_corners=True."""
    if shard is not None:
        from pacingpseudo_torch.parallel.spatial import resize_align_corners
        return resize_align_corners(x, out_h, out_w, shard)
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)

