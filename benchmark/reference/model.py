"""The PacingPseudo model, plain: UNet backbone, aux path and memory bank.

A frozen copy of the port's unfused path (``pacingpseudo_torch/models/
unet.py``, ``norm.py``, ``aux_path.py``, ``pacing.py``), cut to one device
and to the layout the CHAOS sessions run (max-pool and align-corners
upsample, the siamese streams stacked into one 2N batch).  Module names are
the port's, so a state dict made for one loads into the other.

``precision`` is what every convolution computes in: ``"float32"`` (the
reference; the harness turns TF32 off), ``"bfloat16"`` (the configuration's
compute dtype, as the program computes), or ``"fp8"`` (the control: each
conv's input and weight rounded to float8 e4m3 under a per-tensor scale,
the gradients flowing back to them to e5m2, the products summed in
float32).  BatchNorm statistics, the losses and the
bank are float32 in every precision, as in the program.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

NEGATIVE_SLOPE = 1e-2
PRECISIONS = ("float32", "bfloat16", "fp8")
_FP8_MAX = 448.0          # the largest float8 e4m3 (fn) value
_FP8_E5M2_MAX = 57344.0   # the largest float8 e5m2 value


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under the scale that maps its
    largest magnitude to ``top``, returned in float32."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _FP8(torch.autograd.Function):
    """Float8 on the way in and on the way back: the operand in e4m3, the
    gradient that reaches it in e5m2 (each under its own per-tensor scale),
    as float8 training rounds them."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _FP8_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, _FP8_E5M2_MAX)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 (its gradient to e5m2), in float32."""
    return _FP8.apply(x)


def compute_cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A conv operand in ``precision``."""
    if precision == "bfloat16":
        return x.to(torch.bfloat16)
    if precision == "fp8":
        return fp8_round(x)
    return x.float()


def act_dtype(precision: str) -> torch.dtype:
    """The activations' dtype between layers."""
    return torch.bfloat16 if precision == "bfloat16" else torch.float32


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters, computing in ``precision``."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, dilation=1,
                 bias=True, precision="float32", device=None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                         dilation=dilation, bias=bias, device=device, dtype=torch.float32)
        self.precision = precision

    def forward(self, x):
        p = self.precision
        bias = None if self.bias is None else self.bias.to(act_dtype(p))
        out = F.conv2d(compute_cast(x, p), compute_cast(self.weight, p), bias,
                       self.stride, self.padding, self.dilation)
        return out.to(act_dtype(p))


class BatchNorm2d(nn.Module):
    """Batch norm with population variance, statistics in float32, running
    statistics ``r <- (1 - m) r + m stat`` with ``m = 0.1``."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 device=None):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(num_features, **f32))
        self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x):
        x32 = x.float()
        if self.training:
            mean = x32.mean(dim=(0, 2, 3))
            var = (x32.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x32 - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


class ConvLayer(nn.Module):
    """Conv -> BatchNorm -> LeakyReLU(0.01)."""

    def __init__(self, in_ch, out_ch, dilation=1, precision="float32", device=None):
        super().__init__()
        self.precision = precision
        self.conv = Conv2d(in_ch, out_ch, 3, 1, dilation, dilation, precision=precision,
                           device=device)
        self.norm_op = BatchNorm2d(out_ch, device=device)

    def forward(self, x):
        return F.leaky_relu(self.norm_op(self.conv(x)).to(act_dtype(self.precision)),
                            NEGATIVE_SLOPE)


class DoubleConv(nn.Module):
    def __init__(self, in_ch, out_ch, dilation=1, precision="float32", device=None):
        super().__init__()
        self.conv_layer1 = ConvLayer(in_ch, out_ch, dilation, precision, device)
        self.conv_layer2 = ConvLayer(out_ch, out_ch, dilation, precision, device)

    def forward(self, x):
        return self.conv_layer2(self.conv_layer1(x))


class EncBlock(nn.Module):
    def __init__(self, in_ch, out_ch, do_subsamp=True, dilation=1, precision="float32",
                 device=None):
        super().__init__()
        self.subsamp = do_subsamp
        self.conv_block = DoubleConv(in_ch, out_ch, dilation, precision, device)

    def forward(self, x):
        if self.subsamp:
            x = F.max_pool2d(x, 2, 2)
        return self.conv_block(x)


def resize(x, out_h: int, out_w: int):
    """Align-corners bilinear resize of ``(N, C, H, W)``."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


class DecBlock(nn.Module):
    def __init__(self, in_ch, skip_ch, out_ch, up_factor=2, precision="float32",
                 device=None):
        super().__init__()
        self.up_factor = up_factor
        self.conv_block = DoubleConv(in_ch + skip_ch, out_ch, precision=precision,
                                     device=device)

    def forward(self, x, skip):
        if self.up_factor != 1:
            x = resize(x, skip.shape[-2], skip.shape[-1])
        return self.conv_block(torch.cat([x, skip.to(x.dtype)], dim=1))


class UNet(nn.Module):
    """Six encoder and five decoder stages; at output stride 8 and 16 the
    deep stages keep their resolution and dilate instead."""

    def __init__(self, input_ch=1, init_ch=32, max_ch=512, num_classes=5, output_stride=8,
                 precision="float32", device=None):
        super().__init__()
        ch = [min(max_ch, (2 ** k) * init_ch) for k in range(6)]
        deep, up5, up4 = {32: (((True, 1), (True, 1)), 2, 2),
                          16: (((True, 1), (False, 2)), 1, 2),
                          8: (((False, 2), (False, 4)), 1, 1)}[output_stride]
        self.precision = precision
        kw = dict(precision=precision, device=device)
        self.enc_block1 = EncBlock(input_ch, ch[0], do_subsamp=False, **kw)
        self.enc_block2 = EncBlock(ch[0], ch[1], **kw)
        self.enc_block3 = EncBlock(ch[1], ch[2], **kw)
        self.enc_block4 = EncBlock(ch[2], ch[3], **kw)
        self.enc_block5 = EncBlock(ch[3], ch[4], deep[0][0], deep[0][1], **kw)
        self.enc_block6 = EncBlock(ch[4], ch[5], deep[1][0], deep[1][1], **kw)
        self.dec_block5 = DecBlock(ch[5], ch[4], ch[4], up5, **kw)
        self.dec_block4 = DecBlock(ch[4], ch[3], ch[3], up4, **kw)
        self.dec_block3 = DecBlock(ch[3], ch[2], ch[2], 2, **kw)
        self.dec_block2 = DecBlock(ch[2], ch[1], ch[1], 2, **kw)
        self.dec_block1 = DecBlock(ch[1], ch[0], ch[0], 2, **kw)
        self.final_conv = Conv2d(ch[0], num_classes, 1, **kw)
        self.channels = ch

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = x.to(act_dtype(self.precision))
        enc1 = self.enc_block1(x)
        enc2 = self.enc_block2(enc1)
        enc3 = self.enc_block3(enc2)
        enc4 = self.enc_block4(enc3)
        enc5 = self.enc_block5(enc4)
        enc6 = self.enc_block6(enc5)
        dec5 = self.dec_block5(enc6, enc5)
        dec4 = self.dec_block4(dec5, enc4)
        dec3 = self.dec_block3(dec4, enc3)
        dec2 = self.dec_block2(dec3, enc2)
        dec1 = self.dec_block1(dec2, enc1)
        return {"encoder/stage5": enc5, "encoder/stage6": enc6,
                "segmentation/logits": self.final_conv(dec1).float()}


class AuxPath(nn.Module):
    """Bottleneck projection of the deep encoder stages, the shared classifier
    ``fc_cls`` (no bias) and the ``(C, D, 1, 1)`` prototype bank."""

    def __init__(self, num_classes, in_ch, feat_stage: Sequence[str], hid_ch=64,
                 precision="float32", device=None):
        super().__init__()
        self.feat_stage = tuple(feat_stage)
        self.precision = precision
        # Indices 1 and 2 as in the port (index 0 is a dropout at p = 0).
        self.layer_bottleneck = nn.Sequential(
            nn.Identity(),
            Conv2d(in_ch, hid_ch, 3, padding=1, precision=precision, device=device),
            BatchNorm2d(hid_ch, device=device),
            nn.LeakyReLU(NEGATIVE_SLOPE))
        self.fc_cls = nn.Sequential(
            nn.Identity(),
            Conv2d(hid_ch, num_classes, 1, bias=False, precision="float32", device=device))
        self.register_buffer("memory_bank", torch.zeros(
            (num_classes, hid_ch, 1, 1), dtype=torch.float32, device=device))

    def forward(self, end_points, out_hw):
        feat = torch.cat([end_points[s] for s in self.feat_stage], dim=1)
        features = self.layer_bottleneck(feat.to(act_dtype(self.precision)))
        logits = resize(self.fc_cls(features), out_hw[0], out_hw[1])
        return features, logits.float()

    def classify_bank(self, bank):
        return self.fc_cls[1](bank[:, :, None, None])[:, :, 0, 0]


class PacingModel(nn.Module):
    """Shared backbone over the weak and strong streams stacked into one
    2N batch, and, with ``do_aux_path``, the aux path on the strong stream's
    encoder features."""

    def __init__(self, num_classes=5, init_ch=32, max_ch=512, output_stride=8,
                 do_aux_path=False, feat_stage=("encoder/stage6", "encoder/stage5"),
                 hid_ch=64, input_ch=1, precision="float32", device=None):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.do_aux_path = do_aux_path
        self.backbone = UNet(input_ch, init_ch, max_ch, num_classes, output_stride,
                             precision, device)
        if do_aux_path:
            ch = self.backbone.channels
            in_ch = sum({"encoder/stage5": ch[4], "encoder/stage6": ch[5]}[s]
                        for s in feat_stage)
            self.aux_path = AuxPath(num_classes, in_ch, feat_stage, hid_ch, precision,
                                    device)

    def forward(self, image, image_strong=None):
        n, _, h, w = image.shape
        if image_strong is None:
            return {"segmentation/logits":
                    self.backbone(image)["segmentation/logits"]}
        ends = self.backbone(torch.cat([image, image_strong], dim=0))
        logits = ends["segmentation/logits"]
        out = {"segmentation/logits": logits[:n], "segmentation/logits_strong": logits[n:]}
        if self.do_aux_path:
            features, aux_logits = self.aux_path(
                {s: ends[s][n:] for s in self.aux_path.feat_stage}, (h, w))
            out["aux/features"] = features
            out["aux/logits"] = aux_logits
        return out
