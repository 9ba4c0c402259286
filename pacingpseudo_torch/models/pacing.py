"""Siamese pacing-pseudo model: shared-weight UNet + AuxPath (NCHW).

The port of ``pacingpseudo_tpu/models/pacing.py`` (reference
models/consistency_reglur_memory.py:13-102).  The module runs the
network(s) and returns named logits and features; the losses live in
``train/step.py``.

``fuse_streams=True`` stacks the weak and strong images into one 2N batch
and runs the backbone once, so BatchNorm takes its batch statistics over
both streams together (a documented deviation from the reference's two
sequential passes, PARITY.md:85-88); ``False`` runs two passes, weak
first.  ``aux_on_strong=True`` feeds the aux path the strong stream's
encoder features, as the reference's shared end-points dict does.

``forward``'s ``train`` selects the *mode* (strong stream and aux path
run); BatchNorm and dropout follow the module's own ``train()``/``eval()``
state, which is what the JAX package calls ``module_train``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from pacingpseudo_torch.models.aux_path import AuxPath
from pacingpseudo_torch.models.unet import UNet


class PacingPseudoModel(nn.Module):
    """One shared backbone (``backbone``) and one auxiliary path (``aux_path``).

    ``forward(image, image_strong, train)`` returns a dict:
      ``segmentation/logits``         weak-stream logits (N, C, H, W) f32
      ``segmentation/logits_strong``  strong-stream logits (when given)
      ``aux/features``                bottleneck features (train, aux path)
      ``aux/logits``                  full-resolution aux logits
    """

    def __init__(self, input_ch=1, init_ch=32, max_ch=512, num_classes=5,
                 output_stride=8, is_stride_conv=False, is_trans_conv=False,
                 do_aux_path=False,
                 feat_stage: Sequence[str] = ("encoder/stage6", "encoder/stage5"),
                 hid_ch=64, aux_drop_prob=0.0, aux_on_strong=True,
                 fuse_streams=True, dtype=torch.float32, device=None):
        super().__init__()
        self.do_aux_path = do_aux_path
        self.aux_on_strong = aux_on_strong
        self.fuse_streams = fuse_streams
        self.backbone = UNet(input_ch, init_ch, max_ch, num_classes,
                             output_stride, is_stride_conv, is_trans_conv,
                             elab_end_points=True, dtype=dtype, device=device)
        if do_aux_path:
            in_ch = sum(self.backbone.end_point_channels[s] for s in feat_stage)
            self.aux_path = AuxPath(num_classes, in_ch, feat_stage, hid_ch,
                                    aux_drop_prob, dtype, device)

    def forward(self, image, image_strong=None, train: bool = False):
        n, _, h, w = image.shape
        outputs = {}
        use_strong_aux = self.aux_on_strong and image_strong is not None
        if image_strong is not None and self.fuse_streams:
            end_points = self.backbone(torch.cat([image, image_strong], dim=0))
            logits = end_points["segmentation/logits"]
            outputs["segmentation/logits"] = logits[:n]
            outputs["segmentation/logits_strong"] = logits[n:]
            sl = slice(n, None) if use_strong_aux else slice(None, n)
            aux_end_points = {s: end_points[s][sl]
                              for s in self.aux_path.feat_stage} \
                if self.do_aux_path else None
        else:
            end_points = self.backbone(image)
            outputs["segmentation/logits"] = end_points["segmentation/logits"]
            aux_end_points = end_points
            if image_strong is not None:
                end_points_strong = self.backbone(image_strong)
                outputs["segmentation/logits_strong"] = (
                    end_points_strong["segmentation/logits"])
                if use_strong_aux:
                    aux_end_points = end_points_strong
        if self.do_aux_path and train:
            aux_features, logits_aux = self.aux_path(aux_end_points, (h, w))
            outputs["aux/features"] = aux_features
            outputs["aux/logits"] = logits_aux
        return outputs

    def classify_bank(self, bank):
        """Shared-classifier logits of the ``(C, D)`` prototypes: ``(C, C)``."""
        return self.aux_path.classify_bank(bank)
