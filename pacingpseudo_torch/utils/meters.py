"""Running-average meters (reference: utils/utils.py:67-84).

The port's own copy of ``pacingpseudo_tpu/utils/meters.py``.
"""
from __future__ import annotations


class AvgMeter:
    """Accumulates a weighted running average of scalar values."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
