"""Gather table of the fused cubic warp.

The port of ``pacingpseudo_tpu/ops/pallas/warp_table.py``.  For a batch of
``(N, H, W)`` image / label / scribble planes it builds the ``(N, H*W, 24)``
table that ``ops/warp.py::fused_warp_sample_cubic`` reads with one row
gather per output pixel.  The row at flat index ``y*W + x`` packs

* lanes 0..15:  ``image[(y-1+r) % H, (x-1+c) % W]`` for r, c in 0..3
  (lane ``4r+c``);
* lanes 16..19: label at (y, x), (y, x+1), (y+1, x), (y+1, x+1), wrapped;
* lanes 20..23: scribble at the same corners.

Wrapped entries are only ever read where their interpolation weight is
exactly zero (see ``fused_warp_sample_cubic``).

Kernel (``csrc/warp_table.cu``, CUDA C++ for ``sm_90a``):
``warp_table_kernel`` replaces ``_kernel``
(``pacingpseudo_tpu/ops/pallas/warp_table.py:32``).  It is a pure copy bound
by device-memory bytes (the table is 8 times the size of its inputs); one
launch builds the whole batch's table with coalesced 16-byte stores.  Its
result equals :func:`build_warp_table_plain` bit for bit.

On a CPU tensor :func:`build_warp_table` runs the plain version; on a CUDA
tensor it launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches.  No gradient: augmentation runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pacingpseudo_torch.ops import _build

LANES = 24
LAUNCHES = {"warp_table": 0}
IMPLS = ("auto", "kernel", "plain")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("warp_table")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.warp_table_build.argtypes = [p, p, p, p, i, i, i, p]
    lib.warp_table_build.restype = i
    lib.warp_table_lanes.argtypes = []
    lib.warp_table_lanes.restype = i
    lib.warp_table_error_string.argtypes = [i]
    lib.warp_table_error_string.restype = ctypes.c_char_p
    if lib.warp_table_lanes() != LANES:
        raise RuntimeError("warp_table library does not match this wrapper")
    return lib


def build_warp_table_plain(image, label, scribble, dtype=torch.float32):
    """Plain PyTorch version: rolled planes, stacked.  ``(N, H, W)`` inputs
    -> ``(N, H*W, 24)`` table in the storage ``dtype``.  The source planes
    are cast before the rolls; class ids are small integers, exact in bf16.
    """
    cols = []
    img = image.to(dtype)
    for r in range(4):
        pr = torch.roll(img, -(r - 1), dims=1)
        for c in range(4):
            cols.append(torch.roll(pr, -(c - 1), dims=2))
    for p in (label.to(dtype), scribble.to(dtype)):
        pright = torch.roll(p, -1, dims=2)
        pdown = torch.roll(p, -1, dims=1)
        cols += [p, pright, pdown, torch.roll(pdown, -1, dims=2)]
    n = image.shape[0]
    return torch.stack(cols, dim=-1).reshape(n, -1, LANES)


def _check_inputs(image, label, scribble):
    if image.dim() != 3:
        raise ValueError(f"image must be (N, H, W), got {tuple(image.shape)}")
    for name, t in (("image", image), ("label", label), ("scribble", scribble)):
        if t.shape != image.shape:
            raise ValueError(f"{name} must be {tuple(image.shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != image.device:
            raise ValueError("image, label and scribble must lie on one device")
    if image.numel() == 0:
        raise ValueError("the warp table of an empty batch is not defined")


def build_warp_table(image, label, scribble, impl: str = "auto"):
    """``(N, H, W)`` float32 image / label / scribble -> ``(N, H*W, 24)``
    float32 table.

    ``impl``: ``"auto"`` is the kernel for CUDA tensors and the plain
    version for CPU tensors; ``"kernel"`` raises on CPU tensors; ``"plain"``
    forces the plain version (tests, the on-card comparison).
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    _check_inputs(image, label, scribble)
    dev = image.device
    if impl == "plain" or (impl == "auto" and dev.type == "cpu"):
        return build_warp_table_plain(image, label, scribble)
    if dev.type != "cuda":
        raise ValueError(f"the warp-table kernel runs on cuda tensors, not {dev}")
    if not (image.is_contiguous() and label.is_contiguous()
            and scribble.is_contiguous()):
        raise ValueError("image, label and scribble must be contiguous")
    n, h, w = image.shape
    out = torch.empty((n, h * w, LANES), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.warp_table_build(
            image.data_ptr(), label.data_ptr(), scribble.data_ptr(),
            out.data_ptr(), n, h, w,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.warp_table_error_string(err).decode()
        raise RuntimeError(f"warp_table failed to launch: CUDA error {err} ({msg})")
    LAUNCHES["warp_table"] += 1
    return out
