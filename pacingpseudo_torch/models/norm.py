"""Batch norm with the JAX package's semantics (NCHW).

``nn.BatchNorm2d`` updates its running variance with the *unbiased* batch
variance; the JAX package (``pacingpseudo_tpu/models/norm.py:90-124`` and
``ops/fused_bn.py``, groups=1) and flax's ``nn.BatchNorm`` use the
*population* variance.  This module keeps theirs:

* statistics in float32 whatever the input dtype, as ``E[x²] − E[x]²``,
  clamped at 0 as flax's ``nn.BatchNorm`` does (the JAX ConvLayer's
  reduce path does not clamp; the two differ only where roundoff makes
  the difference negative, a channel constant over the batch);
* ``y = (x − mean)·rsqrt(var + eps)·weight + bias``, returned in float32;
  the caller casts to its compute dtype;
* running stats ``r ← (1 − momentum)·r + momentum·stat`` with torch's
  ``momentum=0.1`` (flax's 0.9), updated in place in training mode by
  :meth:`BatchNorm2d.update_running_stats`, which the fused ConvLayer
  (``ops/fused_convbn.py``) calls too, as the JAX package's
  ``BNParamsOnly.__call__`` serves both of its paths.

With a rank group (``ranks``, set by ``parallel.mesh.attach_ranks``) the
training statistics are the **global** batch's (sync BN, as the JAX
package's sharded step computes them): each rank's per-channel sum, sum of
squares and count are summed over the ranks by
``parallel.mesh.sum_over_ranks`` (height shards may be unequal: the count
is summed, not taken as the rank's times the world), whose backward sums the statistics'
gradients (the channel sums Σdy and Σdy·x̂ of the BN backward) over the
ranks in turn.  The running statistics then update identically on every
rank.

Parameter and buffer names are ``nn.BatchNorm2d``'s (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``), so the
state_dict has the reference layout.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from pacingpseudo_torch.parallel.mesh import sum_over_ranks


class BatchNorm2d(nn.Module):

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(num_features, **f32))
        self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))
        self.ranks = None     # a parallel.mesh.RankGroup: sync BN over its ranks

    def forward(self, x):
        x32 = x.float()
        if self.training:
            if self.ranks is None:
                mean = x32.mean(dim=(0, 2, 3))
                mean_sq = x32.square().mean(dim=(0, 2, 3))
            else:
                count = x32.new_full((x32.shape[1],), x32.numel() // x32.shape[1])
                sums = sum_over_ranks(torch.stack([x32.sum(dim=(0, 2, 3)),
                                                   x32.square().sum(dim=(0, 2, 3)), count]),
                                      self.ranks)
                mean, mean_sq = sums[:2] / sums[2]
            var = (mean_sq - mean.square()).clamp_min(0.0)
            self.update_running_stats(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x32 - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]

    @torch.no_grad()
    def update_running_stats(self, mean, var):
        """The running-statistics update of one training batch, outside the
        gradient: both ConvLayer paths call it (the fused one with the
        statistics its conv kernel took)."""
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)
        self.num_batches_tracked.add_(1)
