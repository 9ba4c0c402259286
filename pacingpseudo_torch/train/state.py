"""Train state: the model, its optimizer, the memory bank and the step count.

The port of ``pacingpseudo_tpu/train/state.py``.  The JAX state is one
immutable pytree that each step replaces; here the state holds live
objects that the step **updates in place**: the optimizer steps the
model's parameters, BatchNorm updates its running statistics during the
forward, the bank (the model's ``aux_path.memory_bank`` buffer) is
overwritten, and ``step`` is incremented.  ``step`` is a host integer, so
the schedules read it without a device sync.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pacingpseudo_torch.models.pacing import PacingPseudoModel
from pacingpseudo_torch.models.unet import torch_default_init_
from pacingpseudo_torch.train.optim import make_optimizer


@dataclasses.dataclass
class TrainState:
    model: PacingPseudoModel
    optimizer: torch.optim.Optimizer
    step: int = 0                 # optimizer updates done so far

    @property
    def memory_bank(self) -> Optional[torch.Tensor]:
        """The ``(C, D)`` view of the bank, or None without an aux path."""
        if not self.model.do_aux_path:
            return None
        return self.model.aux_path.memory_bank[:, :, 0, 0]


def build_model(config, device="cuda") -> PacingPseudoModel:
    """The :class:`PacingPseudoModel` an :class:`ExperimentConfig` describes.

    The Upperbound session's model is bare: the aux path (and with it the
    bank) is off whatever ``config.do_aux_path`` says, as in the JAX loop's
    ``_build_model`` (``do_aux_path and siamese``).
    """
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        config.compute_dtype]
    return PacingPseudoModel(
        input_ch=config.input_ch, init_ch=config.init_ch,
        max_ch=config.max_ch, num_classes=config.num_classes,
        output_stride=config.output_stride,
        is_stride_conv=config.is_stride_conv,
        is_trans_conv=config.is_trans_conv,
        do_aux_path=config.do_aux_path and config.session != "Upperbound",
        feat_stage=config.feat_stage, hid_ch=config.hid_ch,
        aux_drop_prob=config.aux_drop_prob, aux_on_strong=config.aux_on_strong,
        fuse_streams=config.fuse_streams, dtype=dtype, device=device)


def create_train_state(config, device="cuda", model=None,
                       seed: Optional[int] = None) -> TrainState:
    """A fresh state on ``device``.

    Without ``model`` the model of ``config`` is built and its weights are
    drawn with PyTorch's default conv init from a ``torch.Generator`` on
    ``device`` seeded with ``seed`` (``config.seed`` by default); the
    backbone draws first, so the Upperbound session's bare model of a seed
    has the siamese model's backbone.  A given ``model`` (weights loaded by
    the caller) is used as it is.  The bank starts at zero.
    """
    if model is None:
        model = build_model(config, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(config.seed if seed is None else seed)
        torch_default_init_(model, gen)
    model.train()
    return TrainState(model=model,
                      optimizer=make_optimizer(config, model.parameters()))
