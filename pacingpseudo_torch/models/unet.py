"""UNet backbone (NCHW), the port of ``pacingpseudo_tpu/models/unet.py``.

The logical network of the JAX package (reference models/unet.py:10-193);
the JAX package's space-to-depth and layout-v2 forms are TPU execution
layouts of the same parameters and are not ported.

* 6 encoder and 5 decoder stages with channels
  ``[min(max_ch, init_ch * 2**k) for k in range(6)]``;
* ``output_stride`` 8/16/32: at 16 and 8 the deep stages keep their
  resolution and dilate by 2 and 4 instead (unet.py:449-469);
* EncBlock = 2x2 max-pool (or a stride-2 first conv) + DoubleConv;
  DecBlock = 2x align-corners upsample (or a transposed conv) + skip
  concat + DoubleConv; ConvLayer = Conv -> BatchNorm -> LeakyReLU(0.01);
* returns the named end-points dict (``encoder/stage1..6``,
  ``decoder/stage5..1``, ``segmentation/logits``).

Compute dtype as in the JAX package (unet.py:417-418,510): activations in
``dtype`` (bf16 on the main path), parameters and BN statistics float32,
logits cast to float32.  Convolutions are ``F.conv2d``: the JAX package
leaves them to XLA, outside its Pallas kernels, except in the training-mode
ConvLayers that ``PACING_CONV_IMPL=fused`` sends through the fused kernels
of ``ops/fused_convbn.py`` (see :class:`ConvLayer`).  Module names follow the
reference state_dict (``enc_blockK.conv_block.conv_layerJ.{conv,norm_op}``,
``dec_blockK.up_samp``, ``final_conv``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from pacingpseudo_torch.models.norm import BatchNorm2d
from pacingpseudo_torch.ops.fused_convbn import (conv_bn_lrelu_train, fusable,
                                                 get_conv_impl)
from pacingpseudo_torch.ops.resize import bilinear_resize_align_corners
from pacingpseudo_torch.parallel import spatial

NEGATIVE_SLOPE = 1e-2   # LeakyReLU of every ConvLayer (reference unet.py:193)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype``: input, weight and
    bias are cast, the parameters stay float32.  On a height shard
    (``shard``, set by ``parallel.mesh.attach_ranks``) a padded conv takes
    its rows beyond the shard's edge from the neighbouring shards
    (``parallel.spatial.conv2d``) and pads only the width with zeros; a
    replicated input (below the split level) is convolved whole."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 dilation=1, bias=True, compute_dtype=torch.float32,
                 device=None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, bias=bias,
                         device=device, dtype=torch.float32)
        self.compute_dtype = compute_dtype
        self.shard = None

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        shard = spatial.local_shard(x, self.shard)
        if shard is not None:
            return spatial.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                                  self.padding, self.dilation, shard)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (no bias) computing in ``compute_dtype``."""

    def __init__(self, in_ch, out_ch, factor, compute_dtype=torch.float32,
                 device=None):
        super().__init__(in_ch, out_ch, factor, stride=factor, bias=False,
                         device=device, dtype=torch.float32)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  stride=self.stride)


class ConvLayer(nn.Module):
    """Conv2d -> BatchNorm -> LeakyReLU(1e-2) (reference unet.py:178-193).

    In training mode, under ``get_conv_impl() == "fused"`` and where the
    JAX package's gate ``fusable`` admits the shape, the layer runs the
    fused kernels of ``ops/fused_convbn.py`` with the same parameters and
    buffers; otherwise (eval mode, frozen BatchNorm, strided or dilated
    convs) the unfused path.  ``padded_in``/``padded_out`` select the fused
    path's padded-canvas convention (JAX ``models/unet.py:101-168``): a
    canvas is an NCHW ``(N, C, H+2, W+2)`` tensor with a zero border whose
    ``permute(0, 2, 3, 1)`` is the kernels' contiguous NHWC array, so
    chained layers (DoubleConv) hand it through with no copy.  Only a layer
    that takes the fused path accepts the flags.
    """

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, dilation=1,
                 dtype=torch.float32, device=None):
        super().__init__()
        pad = dilation if kernel_size == 3 else 0
        self.dtype = dtype
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride, pad, dilation,
                           compute_dtype=dtype, device=device)
        self.norm_op = BatchNorm2d(out_ch, device=device)

    def fusable(self, h: int, w: int) -> bool:
        """Whether the JAX gate admits this conv on an ``h`` x ``w`` input."""
        c = self.conv
        return fusable(h, w, c.kernel_size[0], c.stride[0], c.dilation[0])

    def is_fused(self, h: int, w: int) -> bool:
        """Whether an ``h`` x ``w`` input takes the fused path now."""
        # The kernels' BN statistics are the rank's own: a synchronised
        # BatchNorm (data-parallel training) takes the unfused path.
        return (self.training and get_conv_impl() == "fused" and self.norm_op.ranks is None
                and self.fusable(h, w))

    def forward(self, x, padded_in: bool = False, padded_out: bool = False):
        edge = 2 if padded_in else 0
        if self.is_fused(x.shape[2] - edge, x.shape[3] - edge):
            xp = x.to(self.dtype).permute(0, 2, 3, 1)
            if not padded_in:
                xp = F.pad(xp, (0, 0, 1, 1, 1, 1))
            bn = self.norm_op
            zp, mean, var = conv_bn_lrelu_train(
                xp, self.conv.weight.permute(2, 3, 1, 0), self.conv.bias,
                bn.weight, bn.bias, bn.eps, 1, NEGATIVE_SLOPE)
            bn.update_running_stats(mean, var)
            if not padded_out:
                zp = zp[:, 1:-1, 1:-1, :]
            return zp.permute(0, 3, 1, 2)
        if padded_in or padded_out:
            raise ValueError("padded canvases are the fused path's; this "
                             "layer takes the unfused path")
        return F.leaky_relu(self.norm_op(self.conv(x)).to(self.dtype),
                            NEGATIVE_SLOPE)


class DoubleConv(nn.Module):
    """Two ConvLayers (reference unet.py:154-176).  When both take the fused
    path the padded canvas goes from the first to the second as it is
    (JAX ``models/unet.py:179-193``); otherwise neither sees a canvas."""

    def __init__(self, in_ch, out_ch, stride1=1, dilation=1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.conv_layer1 = ConvLayer(in_ch, out_ch, 3, stride1, dilation,
                                     dtype, device)
        self.conv_layer2 = ConvLayer(out_ch, out_ch, 3, 1, dilation, dtype,
                                     device)

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        chain = self.conv_layer1.is_fused(h, w) and self.conv_layer2.is_fused(h, w)
        x = self.conv_layer1(x, padded_out=chain)
        return self.conv_layer2(x, padded_in=chain)


class EncBlock(nn.Module):
    """Encoder block (reference unet.py:100-127).  On a height shard
    (``shard``) a block whose pool or stride-2 conv goes below the split
    level takes the whole height first (``parallel.spatial.gather_whole``):
    the levels below it are replicated."""

    def __init__(self, in_ch, out_ch, do_subsamp=True, is_stride_conv=False,
                 dilation=1, dtype=torch.float32, device=None):
        super().__init__()
        self.subsamp = do_subsamp
        self.max_pool = do_subsamp and not is_stride_conv
        stride1 = 2 if do_subsamp and is_stride_conv else 1
        self.conv_block = DoubleConv(in_ch, out_ch, stride1, dilation, dtype,
                                     device)
        self.shard = None

    def forward(self, x):
        shard = spatial.local_shard(x, self.shard)
        if (self.subsamp and shard is not None
                and shard.split.replicated(x.shape[-1] // 2)):
            x = spatial.gather_whole(x, shard)
        if self.max_pool:
            x = F.max_pool2d(x, 2, 2)
        return self.conv_block(x)


class DecBlock(nn.Module):
    """Decoder block (reference unet.py:129-152).

    ``up_factor`` 1 skips the upsample (the stride-1 stages of output
    stride 8/16); the transposed-conv variant maps ``in_ch`` to
    ``skip_ch`` with a ``up_factor`` kernel and stride.  On a height shard
    (``shard``) the upsample is the sharded resize of ``ops/resize.py``
    to the skip's rows; the transposed conv, whose kernel equals its stride,
    stays local.  Where the input is replicated and the skip a shard (the
    decoder reaching the split level again), the upsampled input is cut to
    the shard's rows (``parallel.spatial.own_rows``).
    """

    def __init__(self, in_ch, skip_ch, out_ch, up_factor=2,
                 is_trans_conv=False, dtype=torch.float32, device=None):
        super().__init__()
        self.up_factor = up_factor
        if is_trans_conv:
            self.up_samp = ConvTranspose2d(in_ch, skip_ch, up_factor, dtype,
                                           device)
            in_ch = skip_ch
        else:
            self.up_samp = None
        self.conv_block = DoubleConv(in_ch + skip_ch, out_ch, dtype=dtype,
                                     device=device)
        self.shard = None

    def forward(self, x, skip):
        if self.up_samp is not None:
            x = self.up_samp(x)
            if x.shape[-2] != skip.shape[-2]:
                x = spatial.own_rows(x, self.shard)
        elif self.up_factor != 1:
            x = bilinear_resize_align_corners(x, skip.shape[-2], skip.shape[-1], self.shard)
        return self.conv_block(torch.cat([x, skip.to(x.dtype)], dim=1))


class UNet(nn.Module):
    """The segmentation backbone; returns a dict of named end-points.

    Arguments mirror the reference (models/unet.py:10-20).  ``dtype`` is
    the activation compute dtype.
    """

    def __init__(self, input_ch=1, init_ch=32, max_ch=512, num_classes=4,
                 output_stride=32, is_stride_conv=False, is_trans_conv=False,
                 elab_end_points=False, dtype=torch.float32, device=None):
        super().__init__()
        if is_trans_conv != is_stride_conv:
            raise ValueError("Only combo of stride_conv and trans_conv or "
                             "maxpool and upsample is allowed.")
        if output_stride not in (8, 16, 32):
            raise ValueError(f"output_stride must be 8, 16 or 32, got {output_stride}")
        ch = [min(max_ch, (2 ** k) * init_ch) for k in range(6)]
        # (do_subsamp, dilation) of encoder stages 5 and 6; the decoder's
        # upsample factors of stages 5 and 4 (unet.py:449-469).
        deep, up5, up4 = {32: (((True, 1), (True, 1)), 2, 2),
                          16: (((True, 1), (False, 2)), 1, 2),
                          8: (((False, 2), (False, 4)), 1, 1)}[output_stride]
        self.dtype = dtype
        self.output_stride = output_stride
        self.elab_end_points = elab_end_points
        kw = dict(dtype=dtype, device=device)
        enc = dict(is_stride_conv=is_stride_conv, **kw)
        self.enc_block1 = EncBlock(input_ch, ch[0], do_subsamp=False, **enc)
        self.enc_block2 = EncBlock(ch[0], ch[1], **enc)
        self.enc_block3 = EncBlock(ch[1], ch[2], **enc)
        self.enc_block4 = EncBlock(ch[2], ch[3], **enc)
        self.enc_block5 = EncBlock(ch[3], ch[4], deep[0][0], dilation=deep[0][1], **enc)
        self.enc_block6 = EncBlock(ch[4], ch[5], deep[1][0], dilation=deep[1][1], **enc)
        dec = dict(is_trans_conv=is_trans_conv, **kw)
        self.dec_block5 = DecBlock(ch[5], ch[4], ch[4], up5, **dec)
        self.dec_block4 = DecBlock(ch[4], ch[3], ch[3], up4, **dec)
        self.dec_block3 = DecBlock(ch[3], ch[2], ch[2], 2, **dec)
        self.dec_block2 = DecBlock(ch[2], ch[1], ch[1], 2, **dec)
        self.dec_block1 = DecBlock(ch[1], ch[0], ch[0], 2, **dec)
        self.final_conv = Conv2d(ch[0], num_classes, 1, compute_dtype=dtype,
                                 device=device)
        self.end_point_channels = {
            **{f"encoder/stage{k + 1}": ch[k] for k in range(6)},
            **{f"decoder/stage{k + 1}": ch[k] for k in range(5)},
            "segmentation/logits": num_classes,
        }

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = x.to(self.dtype)
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
        # NCHW-contiguous logits on both conv paths: the fused ConvLayer's
        # output is channels-last, and the 1x1 conv keeps that layout.
        logits = self.final_conv(dec1).float().contiguous()
        if not self.elab_end_points:
            return {"segmentation/logits": logits}
        return {
            "encoder/stage1": enc1, "encoder/stage2": enc2,
            "encoder/stage3": enc3, "encoder/stage4": enc4,
            "encoder/stage5": enc5, "encoder/stage6": enc6,
            "decoder/stage5": dec5, "decoder/stage4": dec4,
            "decoder/stage3": dec3, "decoder/stage2": dec2,
            "decoder/stage1": dec1, "segmentation/logits": logits,
        }


@torch.no_grad()
def torch_default_init_(module: nn.Module, generator: torch.Generator):
    """Draw every conv weight and bias anew from ``generator``.

    PyTorch's default conv init, ``kaiming_uniform(a=sqrt(5))`` for the
    weight and ``U(±1/sqrt(fan_in))`` for the bias, both come to
    ``U(±1/sqrt(fan_in))`` with ``fan_in = weight.size(1) * kh * kw`` (for a
    transposed conv that is its out-channels, as in torch).  BatchNorm
    keeps ones and zeros.  A conv marked ``zero_bias_init`` (Flax's default
    zero bias, where the JAX package gives no ``bias_init``) still draws its
    bias, so that every later leaf keeps its draw, and then zeroes it.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight.shape[1] * m.weight[0, 0].numel()
            bound = fan_in ** -0.5
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
            if m.bias is not None:
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
                if getattr(m, "zero_bias_init", False):
                    m.bias.zero_()
    return module
