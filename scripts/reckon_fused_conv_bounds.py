"""Bytes, operations and the H100's least time for the three fused-ConvLayer
kernels that are still to be ported, reckoned from the model's shapes.

    python3 scripts/reckon_fused_conv_bounds.py

Runs anywhere (the model is built on the ``meta`` device: shapes only, no
memory, no arithmetic).  It walks every ConvLayer of the full-width
Experiment UNet in the train step's fused pass (weak and strong streams
stacked: batch 24, 256x256, bf16 activations) and counts, for the port's
counterpart of each kernel of ``pacingpseudo_tpu/ops/pallas/fused_convbn.py``,
each input read once and each output written once, on the padded canvases
the kernels exchange:

* ``_conv_stats_kernel`` (:127): padded x, the 3x3 weights and the bias in;
  y and the per-channel sum and sum of squares out.  2*9*Ci*Co operations
  per output pixel on the tensor cores, 4 float32 operations per output
  value for the bias and the two statistics.
* ``_bn_sums_kernel`` (:160): y and the padded cotangent gz in, with the four
  per-channel rows (mean, rstd, gamma, beta); two per-channel sums out.
  About 9 float32 operations per value.
* ``_conv_pad_out_kernel`` (:201): padded dy and the flipped weights in, the
  padded dx out.  2*9*Ci*Co operations per pixel on the tensor cores.

The bound of a kernel is the largest of bytes over the memory rate, tensor
core operations over the bf16 peak and float32 operations over the float32
peak (H100 SXM data sheet).  Nothing here is measured: these are reckoned
numbers, for the table of kernels in PERF.md.
"""
from __future__ import annotations

import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pacingpseudo_torch.config import ExperimentConfig  # noqa: E402
from pacingpseudo_torch.models.unet import ConvLayer  # noqa: E402
from pacingpseudo_torch.train.state import build_model  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_OPS_PER_S = 989e12       # tensor cores, dense bf16
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores
ACT = 2                       # bytes of a bf16 activation or weight
F32 = 4


def conv_layer_shapes(config):
    """``(name, n, ci, co, h, w)`` of every ConvLayer call in one train
    forward of the siamese model (both streams in one batch)."""
    model = build_model(config, device="meta")
    shapes = []
    for name, module in model.named_modules():
        if isinstance(module, ConvLayer):
            module.register_forward_hook(
                lambda mod, inp, out, name=name: shapes.append(
                    (name, inp[0].shape[0], inp[0].shape[1], out.shape[1],
                     out.shape[2], out.shape[3])))
    size = config.spec.input_size
    x = torch.empty((config.batch_size, config.input_ch, *size), device="meta")
    model(x, x, train=True)
    return shapes


def kernel_costs(n, ci, co, h, w):
    """``{kernel: (bytes, tensor-core operations, float32 operations)}``."""
    padded = n * (h + 2) * (w + 2)
    pixels = n * h * w
    matmul = 2 * 9 * ci * co * pixels
    return {
        "_conv_stats_kernel": (
            padded * ci * ACT + 9 * ci * co * ACT + co * F32
            + pixels * co * ACT + 2 * co * F32,
            matmul, 4 * pixels * co),
        "_bn_sums_kernel": (
            pixels * co * ACT + padded * co * ACT + 4 * co * F32 + 2 * co * F32,
            0, 9 * pixels * co),
        "_conv_pad_out_kernel": (
            padded * co * ACT + 9 * ci * co * ACT + padded * ci * ACT,
            matmul, 0),
    }


def bound_ms(nbytes, matmul, f32):
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations (bf16)":
             matmul / BF16_OPS_PER_S, "operations (f32)": f32 / F32_OPS_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def main() -> None:
    config = ExperimentConfig(
        session="Experiment", do_loss_ent=True, do_decoder_consistency=True,
        do_aux_path=True, do_memory=True).validate()
    shapes = conv_layer_shapes(config)
    totals = {}
    print(f"{len(shapes)} ConvLayer calls in one train forward, batch "
          f"{shapes[0][1]} (weak and strong streams stacked), bf16")
    for name, n, ci, co, h, w in shapes:
        line = f"{name:50s} {ci:4d} -> {co:3d} @ {h}x{w}:"
        for kernel, cost in kernel_costs(n, ci, co, h, w).items():
            ms, by = bound_ms(*cost)
            tot = totals.setdefault(kernel, [0, 0, 0, 0.0, 0])
            for i in range(3):
                tot[i] += cost[i]
            tot[3] += ms
            tot[4] += 1
            line += f" {ms:.4f} ms ({by.split()[0]})"
        print(line)
    print("per train step (one launch per ConvLayer and kernel):")
    for kernel, (nbytes, matmul, f32, ms, count) in totals.items():
        whole, by = bound_ms(nbytes, matmul, f32)
        print(f"  {kernel}: {count} launches, {nbytes} bytes, {matmul} tensor-core "
              f"and {f32} float32 operations; sum of the layers' bounds "
              f"{ms:.4f} ms; bound of the totals {whole:.4f} ms (by {by})")


if __name__ == "__main__":
    main()
