"""Per-dataset augmentation presets.

The port's own copy of ``pacingpseudo_tpu/aug/presets.py``, reading the
port's ``config.DATASETS``.

Mirrors the reference preset classes ``TransformsColor`` /
``TransformsColorBlur`` / ``TransformsColorMixup`` / ``TransformsColorLow``
(chaos_aug_configs.py:63-186; identical bodies in acdc/lvsc configs) over
the three dataset constant sets (chaos 5/5/256², acdc 4/4/224², lvsc
2/2/224²).  The reference's duplicated ``TransformsColorMixup`` definition
(chaos_aug_configs.py:113,138 — the second shadows the first with an
identical body) collapses to one entry here.
"""
from __future__ import annotations

from pacingpseudo_torch.aug.params import BaseAugParams, StrongAugParams
from pacingpseudo_torch.config import DATASETS

PRESETS = ("TransformsColor", "TransformsColorBlur",
           "TransformsColorMixup", "TransformsColorLow")


def base_params_for(dataset: str) -> BaseAugParams:
    spec = DATASETS[dataset]
    return BaseAugParams(
        crop_size=spec.input_size,
        num_classes=spec.num_classes,
        ignored_index=spec.ignored_index,
    )


def strong_params_for(preset: str, strength: float = 1.0) -> StrongAugParams:
    """Build the strong-stream params for a preset name + strength
    (reference --augmentations / --strength flags, train_chaos.py:59-61,141)."""
    if preset == "TransformsColor":
        return StrongAugParams.color(strength)
    if preset == "TransformsColorBlur":
        # blur sigma U(1, 1.5) p=0.8 (chaos_aug_configs.py:110)
        return StrongAugParams.color(strength, p_blur=0.8,
                                     blur_sigma_range=(1.0, 1.5))
    if preset == "TransformsColorMixup":
        return StrongAugParams.color(strength, p_mixup=0.8,
                                     mixup_lam_range=(0.8, 1.0))
    if preset == "TransformsColorLow":
        # downscale U(1.5, 2) p=0.8 (chaos_aug_configs.py:184)
        return StrongAugParams.color(strength, p_lowres=0.8,
                                     lowres_scale_range=(1.5, 2.0))
    raise ValueError(f"Unknown augmentation preset: {preset!r}")
