"""Static augmentation parameter bundles.

The port's own copy of ``pacingpseudo_tpu/aug/params.py``: the same fields
and defaults.  Only the values of ``warp_table_impl`` differ (``auto`` |
``kernel`` | ``plain``, see ``ops/warp_table.py``).

These replace the reference's transform-object lists + per-dataset config
modules (reference: datasets/augmentations.py:11-446,
datasets/chaos/chaos_aug_configs.py:16-186 and the acdc/lvsc twins).  Every
field is static; the random draws happen on the device from a
``torch.Generator`` (aug/engine.py).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BaseAugParams:
    """The shared geometric + noise 'base_transforms' pipeline.

    Defaults mirror chaos_aug_configs.py:16-61 (identical in the acdc/lvsc
    configs apart from the dataset constants).
    """

    crop_size: Tuple[int, int] = (256, 256)
    num_classes: int = 5
    ignored_index: int = 5

    # Scaling (augmentations.py:191-230)
    p_scale: float = 0.2
    scale_range: Tuple[float, float] = (0.7, 1.4)

    # ElasticTransform (augmentations.py:232-277).  The displacement field
    # is band-limited by the sigma>=9px Gaussian, so it is generated at
    # 1/``elastic_field_downscale`` resolution, blurred with sigma/downscale,
    # bilinearly upsampled and amplitude-corrected by 1/downscale —
    # identical field statistics without a 105-tap blur per axis per sample
    # at full resolution.
    p_elastic: float = 0.2
    sigma_range: Tuple[float, float] = (9.0, 13.0)
    alpha_range: Tuple[float, float] = (0.0, 200.0)
    elastic_field_downscale: int = 8
    elastic_blur_radius: int = 7         # = round(4 * sigma_max / downscale)

    # RandomRotation (augmentations.py:279-317); chaos config uses (-30, 30)
    p_rotate: float = 0.2
    degree_range: Tuple[float, float] = (-30.0, 30.0)

    # Mirroring per axis (augmentations.py:337-351)
    p_mirror_y: float = 0.5
    p_mirror_x: float = 0.5

    # GaussianNoise (augmentations.py:353-366)
    p_noise: float = 0.15
    noise_scale_range: Tuple[float, float] = (0.0, 0.1)

    # Rotation90 (augmentations.py:319-335).  Part of the reference's
    # transform library but used by none of its shipped configs — default
    # off to match; composes into the same fused inverse map (exact k·90°
    # label permutation, no resampling blur).
    p_rot90: float = 0.0
    rot90_choices: Tuple[int, ...] = (1, 2, 3)

    # Image resampling kernel for the fused warp.  "bicubic" (default)
    # samples the image with the 4x4 Keys kernel, matching the reference's
    # order-3 resamples (augmentations.py:214/:270/:307) in measured
    # gradient statistics (AUG_PARITY.json geometry_only); "bilinear" is
    # the single-tap kernel (slightly smoother output).  Labels/scribbles always use the exact 4-tap class vote.
    image_interp: str = "bicubic"

    # Warp gather-table construction (ops/warp_table.py): "auto" (the CUDA
    # kernel for CUDA tensors, the plain version for CPU tensors), "kernel"
    # (the CUDA kernel; raises on CPU tensors) or "plain" (rolled planes;
    # for tests and the on-card comparison).
    warp_table_impl: str = "auto"

    # Storage dtype of the (H*W, 24) gather table: "f32", "bf16", or
    # "auto" (= f32).  bf16 halves the bytes the row gather reads;
    # label/scribble class votes stay BIT-EXACT (small-int class ids are
    # exact in bf16 and the vote weights are computed in f32 from
    # coordinates), only the image taps round to bf16 before the f32 cubic
    # accumulation.  The table is built in f32 and cast afterwards.
    warp_table_dtype: str = "auto"


@dataclasses.dataclass(frozen=True)
class StrongAugParams:
    """Intensity-only strong-stream transforms.

    Defaults mirror the ``TransformsColor`` preset at strength 1
    (chaos_aug_configs.py:63-89): Brightness/Contrast/Gamma each p=0.8 with
    ranges scaled by ``strength * 0.8``.  The optional extras select the
    ColorBlur / ColorMixup / ColorLow variants (:91-186).
    """

    p_brightness: float = 0.8
    brightness_range: Tuple[float, float] = (-0.8, 0.8)

    p_contrast: float = 0.8
    contrast_range: Tuple[float, float] = (0.2, 1.8)

    p_gamma: float = 0.8
    gamma_range: Tuple[float, float] = (0.2, 1.8)
    gamma_retain_stats: bool = True
    gamma_invert: bool = False

    # Variant extras (exactly one of these is enabled per preset)
    p_blur: float = 0.0                      # ColorBlur: 0.8, sigma U(1, 1.5)
    blur_sigma_range: Tuple[float, float] = (1.0, 1.5)
    blur_radius: int = 6                     # = round(4 * sigma_max)

    p_mixup: float = 0.0                     # ColorMixup: 0.8, lam U(0.8, 1)
    mixup_lam_range: Tuple[float, float] = (0.8, 1.0)

    p_lowres: float = 0.0                    # ColorLow: 0.8, scale U(1.5, 2)
    lowres_scale_range: Tuple[float, float] = (1.5, 2.0)

    # Cutout (augmentations.py:23-49): zero a length×length box at a
    # uniform centre, clipped to the canvas.  Library surface only — no
    # shipped reference config enables it (default p=0.2 there).
    p_cutout: float = 0.0
    cutout_length: int = 32

    @staticmethod
    def color(strength: float = 1.0, **extra) -> "StrongAugParams":
        """Build the color triple at a given strength (chaos_aug_configs.py:70-88)."""
        s = strength * 0.8
        return StrongAugParams(
            brightness_range=(-s, s),
            contrast_range=(max(0.0, 1 - s), 1 + s),
            gamma_range=(max(0.0, 1 - s), 1 + s),
            **extra,
        )
