"""Optimizers with the reference's semantics.

The reference uses ``torch.optim.Adam(lr, weight_decay)`` and
``torch.optim.SGD(lr, momentum, weight_decay)`` (train_chaos.py:218-221):
coupled L2 on every parameter, BN affine and biases included.  The JAX
package rebuilds exactly that from optax (``train/optim.py:30-41``); here it
is the torch optimizer itself.

The learning rate decays per epoch: :func:`set_lr` writes
``schedule(step // steps_per_epoch)`` into every parameter group, and the
train step calls it before each update.
"""
from __future__ import annotations

import torch

from pacingpseudo_torch.train.schedules import make_lr_schedule


def make_optimizer(config, params) -> torch.optim.Optimizer:
    """The optimizer of an :class:`ExperimentConfig` over ``params``."""
    if config.optimizer == "adam":
        return torch.optim.Adam(params, lr=config.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=config.wd)
    if config.optimizer == "momentum":
        return torch.optim.SGD(params, lr=config.lr, momentum=config.momentum,
                               weight_decay=config.wd)
    raise ValueError(f"Unimplemented optimizer: {config.optimizer!r}")


def lr_at(config, step: int, steps_per_epoch: int) -> float:
    """The learning rate of update number ``step`` (0-based)."""
    lr_by_epoch = make_lr_schedule(config.lr_decay, config.epoch, config.lr)
    return lr_by_epoch(step // steps_per_epoch)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def make_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Let ``optimizer.step()`` be captured in a CUDA graph: Adam's groups
    get ``capturable=True`` and their ``step`` counts move to the
    parameters' device (as float32 tensors), so the bias correction is
    computed on the device at each replay.  SGD reads nothing from the
    host and is left as it is.  :func:`~pacingpseudo_torch.train.
    checkpoint.save_checkpoint` writes such a state in the eager layout."""
    for group in optimizer.param_groups:
        if "capturable" not in group or group["capturable"]:
            continue
        group["capturable"] = True
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                state["step"] = state["step"].to(device=p.device, dtype=torch.float32)
