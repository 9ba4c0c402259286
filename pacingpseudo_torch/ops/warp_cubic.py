"""Direct-read cubic warp: the whole of the fused cubic warp in one kernel.

Kernel 6 of the JAX package (``pacingpseudo_tpu/ops/pallas/warp_table.py``
``_kernel``, ``:32``) builds a 24-lane gather table so that one row gather
feeds a pixel's whole cubic tap on the TPU.  On the card that table is a
detour of eight times its inputs, and the gather, the Keys weights, the
masks, the 16 tap terms, the clip and the two class votes that follow it
are some 370 separate elementwise launches.  ``warp_cubic_kernel``
(``csrc/warp_cubic.cu``) reads the three planes directly, one thread per
output pixel, and does all of it in one launch.

:func:`warp_sample_cubic` returns what ``ops/warp.py::fused_warp_sample_cubic``
returns on its table routes: the image float32 and the label and scribble
class ids int32, each ``(N, h, w)``, equal to them bit for bit (the kernel
keeps the plain version's order of operations, each product and sum
rounded on its own).  The live region's value range (the clip) is two
PyTorch reductions before the launch (:func:`ops.warp.live_range`).

On a CPU tensor :func:`warp_sample_cubic` runs the plain version,
:func:`warp_sample_cubic_plain`, which fetches the same wrapped taps from
the planes with ``_flat_take`` and repeats the table route's arithmetic; on
a CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches.  No gradient: augmentation runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pacingpseudo_torch.ops import _build
from pacingpseudo_torch.ops.warp import (_flat_take, _per_sample, cubic_taps_and_votes,
                                         live_range, warp_anchor)

LAUNCHES = {"warp_cubic": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("warp_cubic")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.warp_cubic.argtypes = [p] * 12 + [i] * 6 + [f, f, f, p]
    lib.warp_cubic.restype = i
    lib.warp_cubic_error_string.argtypes = [i]
    lib.warp_cubic_error_string.restype = ctypes.c_char_p
    return lib


def _lanes(image, label, scribble, y0, x0):
    """The 24 taps of each output pixel in the table's lane order, read from
    the planes at the table's wrapped indices: ``lanes[k]`` (N, h, w)."""
    _, h, w = image.shape
    lanes = []
    for r in range(4):
        iy = (y0 - 1 + r) % h
        lanes += [_flat_take(image, iy, (x0 - 1 + c) % w) for c in range(4)]
    y1, x1 = (y0 + 1) % h, (x0 + 1) % w
    for plane in (label, scribble):
        lanes += [_flat_take(plane, y0 % h, x0 % w), _flat_take(plane, y0 % h, x1),
                  _flat_take(plane, y1, x0 % w), _flat_take(plane, y1, x1)]
    return lanes


def warp_sample_cubic_plain(image, label, scribble, sy, sx, num_values,
                            bound_h, bound_w, cubic_a: float = -0.5):
    """Plain PyTorch version of :func:`warp_sample_cubic`: the taps straight
    from the planes, then the table route's arithmetic."""
    y0, x0, fy, fx = warp_anchor(sy, sx, bound_h, bound_w)
    lanes = _lanes(image, label, scribble, y0, x0)
    return cubic_taps_and_votes(lanes.__getitem__, image, y0, x0, fy, fx,
                                num_values, bound_h, bound_w, cubic_a)


def _check_inputs(image, label, scribble, sy, sx):
    if image.dim() != 3 or sy.dim() != 3:
        raise ValueError(f"image and sy must be (N, H, W) and (N, h, w), got "
                         f"{tuple(image.shape)} and {tuple(sy.shape)}")
    n = image.shape[0]
    for name, t, shape in (("label", label, image.shape), ("scribble", scribble, image.shape),
                           ("sx", sx, sy.shape)):
        if t.shape != shape:
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    for name, t in (("image", image), ("label", label), ("scribble", scribble),
                    ("sy", sy), ("sx", sx)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != image.device:
            raise ValueError("the planes and the coordinates must lie on one device")
    if sy.shape[0] != n or image.numel() == 0 or sy.numel() == 0:
        raise ValueError(f"{n} planes and {sy.shape[0]} coordinate maps: the warp of "
                         "an empty or mismatched batch is not defined")


def warp_sample_cubic(image, label, scribble, sy, sx, num_values,
                      bound_h, bound_w, cubic_a: float = -0.5):
    """Cubic image warp and bilinear class votes, read straight from the
    planes.  ``image/label/scribble`` (N, H, W) float32 canvases, ``sy/sx``
    (N, h, w) float32 source coordinates, ``bound_h/bound_w`` the live
    extents (numbers or (N,) tensors).  Returns ``(image float32, label
    int32, scribble int32)``, each (N, h, w)."""
    _check_inputs(image, label, scribble, sy, sx)
    dev = image.device
    if dev.type == "cpu":
        return warp_sample_cubic_plain(image, label, scribble, sy, sx, num_values,
                                       bound_h, bound_w, cubic_a)
    if dev.type != "cuda":
        raise ValueError(f"the direct warp runs on cpu or cuda tensors, not {dev}")
    n = image.shape[0]
    bh = _per_sample(bound_h, image).reshape(-1).expand(n).contiguous()
    bw = _per_sample(bound_w, image).reshape(-1).expand(n).contiguous()
    lo, hi = (t.reshape(n).contiguous() for t in live_range(image, bh, bw))
    return launch(image.contiguous(), label.contiguous(), scribble.contiguous(),
                  sy.contiguous(), sx.contiguous(), bh, bw, lo, hi, num_values, cubic_a)


def launch(image, label, scribble, sy, sx, bound_h, bound_w, lo, hi, num_values,
           cubic_a: float = -0.5):
    """One launch of ``warp_cubic_kernel`` on contiguous CUDA tensors: the
    planes and coordinates of :func:`warp_sample_cubic`, and the (N,)
    float32 live extents ``bound_h/bound_w`` and clip range ``lo/hi``."""
    dev = image.device
    n, hs, ws = image.shape
    _, h, w = sy.shape
    img_out = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    lab_out = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    scb_out = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    ptrs = (image, label, scribble, sy, sx, bound_h, bound_w, lo, hi,
            img_out, lab_out, scb_out)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.warp_cubic(*(t.data_ptr() for t in ptrs), n, hs, ws, h, w,
                             int(num_values), float(cubic_a), float(cubic_a + 2.0),
                             float(cubic_a + 3.0), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.warp_cubic_error_string(err).decode()
        raise RuntimeError(f"warp_cubic failed to launch: CUDA error {err} ({msg})")
    LAUNCHES["warp_cubic"] += 1
    return img_out, lab_out, scb_out
