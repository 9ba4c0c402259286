"""Learning-rate schedules and loss ramp-ups (plain functions of numbers).

The port of ``pacingpseudo_tpu/train/schedules.py`` (reference
utils/utils.py:7-65 and models/aux_path_memory.py:118-120).  The step
takes the epoch from its host-side step counter, so these take and return
Python floats: no device work and no host sync.
"""
from __future__ import annotations

import math


def linear_lr_decay(step, num_steps, base_lr):
    """``(1 - step/num_steps) * base_lr`` (reference utils/utils.py:7-21)."""
    return (1.0 - step / num_steps) * base_lr


def cosine_lr_decay(step, num_steps, base_lr):
    """``0.5*(1+cos(step*pi/num_steps))*base_lr`` (utils/utils.py:23-36)."""
    return 0.5 * (1.0 + math.cos(step * math.pi / num_steps)) * base_lr


def poly_lr_decay(step, num_steps, base_lr, gamma=0.9):
    """``base_lr * (1 - step/num_steps)**gamma`` (utils/utils.py:38-51)."""
    return base_lr * (1.0 - step / num_steps) ** gamma


_SCHEDULES = {
    "linear": linear_lr_decay,
    "cosine": cosine_lr_decay,
    "poly": poly_lr_decay,
}


def make_lr_schedule(policy: str, num_steps: int, base_lr: float):
    """``fn(epoch) -> lr`` for ``policy`` in {linear, cosine, poly}.

    The reference decays per **epoch** (train_chaos.py:253-258).
    """
    try:
        fn = _SCHEDULES[policy]
    except KeyError:
        raise ValueError(f"Unimplemented learning rate decay policy: {policy!r}")
    return lambda step: fn(step, num_steps, base_lr)


def gaussian_ramp_up(t, base_value, max_t=80, scale=5.0):
    """``base * exp(-scale * (1 - t/max_t))`` for ``t < max_t``, else ``base``.

    Reference utils/utils.py:53-65; ``max_t=80`` is hard-coded there even
    for 400-epoch runs, and kept.
    """
    if t < max_t:
        return base_value * math.exp(-scale * (1.0 - t / max_t))
    return base_value


def memory_momentum(step, max_step, base_mo=0.9, gamma=0.9):
    """Weight of the *new* bank estimate; ramps down from ``base_mo`` to 0.

    ``(1 - step/max_step)**gamma * base_mo`` (reference
    models/aux_path_memory.py:118-120).
    """
    return (1.0 - step / max_step) ** gamma * base_mo
