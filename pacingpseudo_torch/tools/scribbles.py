"""Offline scribble tooling: artificial scribbles + scribble shortening.

The port's own copy of ``pacingpseudo_tpu/tools/scribbles.py`` (numpy and
scipy only), so that the port imports nothing of the JAX package.

Host-side numpy utilities mirroring the reference's offline tools:

* :func:`generate_scribble` fabricates artificial scribbles from dense
  labels by per-class skeletonisation (reference:
  utils/utils_artificial_scribbles.py:5-35, used for LVSC);
* :func:`detect_endpoints` / :func:`delete_endpoints` support the
  scribble-length ablation (reference:
  utils/utils_shorten_scribble_length.py:11-75).

skimage is unavailable in this environment, so :func:`skeletonize`
implements Zhang-Suen thinning (the same algorithm behind skimage's 2-D
``morphology.skeletonize``) with vectorised numpy neighbourhood logic.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import ndimage


def _neighbors(img: np.ndarray):
    """Return the 8 neighbours P2..P9 (N, NE, E, SE, S, SW, W, NW) of every
    pixel, zero-padded at the borders."""
    p = np.pad(img, 1)
    n = p[:-2, 1:-1]
    ne = p[:-2, 2:]
    e = p[1:-1, 2:]
    se = p[2:, 2:]
    s = p[2:, 1:-1]
    sw = p[2:, :-2]
    w = p[1:-1, :-2]
    nw = p[:-2, :-2]
    return n, ne, e, se, s, sw, w, nw


def skeletonize(mask: np.ndarray) -> np.ndarray:
    """Topology-preserving thinning of a binary mask (Zhang-Suen 1984)."""
    img = (np.asarray(mask) > 0).astype(np.uint8)
    changed = True
    while changed:
        changed = False
        for step in (0, 1):
            p2, p3, p4, p5, p6, p7, p8, p9 = _neighbors(img)
            ring = [p2, p3, p4, p5, p6, p7, p8, p9, p2]
            # A = number of 0 -> 1 transitions around the ring
            a = np.zeros_like(img, dtype=np.uint8)
            for k in range(8):
                a += ((ring[k] == 0) & (ring[k + 1] == 1)).astype(np.uint8)
            b = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9
            cond = (img == 1) & (b >= 2) & (b <= 6) & (a == 1)
            if step == 0:
                cond &= (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
            else:
                cond &= (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
            if cond.any():
                img[cond] = 0
                changed = True
    return img.astype(bool)


def generate_scribble(lab: np.ndarray, num_classes: int,
                      ignored_index: int, style: str = "skeleton",
                      dilate_iters: int = 2) -> np.ndarray:
    """Fabricate an artificial scribble map from a dense label.

    Per-class skeleton becomes the scribble; everything else is the ignored
    class.  Background-only slices get their background skeleton point
    extended into a line by 40 iterations of anti-diagonal dilation (masked
    to the background) and re-skeletonisation — reference:
    utils/utils_artificial_scribbles.py:5-35.

    ``style`` selects the scribble richness:
      * "skeleton" — the reference's 1-px per-class skeleton (the LVSC
        protocol; default).
      * "dilated" — the skeleton dilated ``dilate_iters`` times, clipped
        to the class mask.  A closer proxy for the human-drawn CHAOS/ACDC
        scribbles, which are stroke-width marks, not 1-px curves; used to
        separate "hard task" from "scribble-starved supervision" in the
        synthetic quality study.

    Args:
      lab: (H, W) integer dense label.
    Returns:
      (H, W) integer scribble map with values in {0..num_classes-1,
      ignored_index}.
    """
    assert style in ("skeleton", "dilated"), style
    h, w = lab.shape
    lab_oh = np.zeros((num_classes, h, w))
    scb_oh = np.zeros_like(lab_oh)
    for c in range(num_classes):
        lab_oh[c][lab == c] = 1
        ske = skeletonize(lab_oh[c])
        if style == "dilated":
            ske = ndimage.binary_dilation(
                ske, iterations=dilate_iters, mask=lab_oh[c] > 0)
        scb_oh[c] = ske * lab_oh[c]
    ignored_region = 1 - np.sum(scb_oh, axis=0, keepdims=True)
    scb_oh = np.concatenate([scb_oh, ignored_region], axis=0)

    # Background-only slice: extend the skeleton point into a line.
    if set(np.unique(np.argmax(scb_oh, axis=0))) == {0, ignored_index}:
        scb_bg = ndimage.binary_dilation(
            scb_oh[0], np.eye(3)[::-1], iterations=40, mask=lab_oh[0] > 0)
        scb_oh[0] = skeletonize(scb_bg)

    return np.argmax(scb_oh, axis=0)


# ---------------------------------------------------------------------------
# Scribble shortening (ablation tool)
# ---------------------------------------------------------------------------

# 8 hit-miss kernels: an endpoint is a foreground pixel with exactly one
# foreground neighbour in one of the 8 directions.  The reference encodes
# this with {1, 1000}-valued conv kernels where a response of exactly 2
# flags an endpoint (utils_shorten_scribble_length.py:9-23).
def _endpoint_kernels():
    base = np.array([[0, 0, 0], [1, 1, 0], [0, 0, 0]], np.float64)
    diag = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 0]], np.float64)
    kernels = []
    for e in (base, diag):
        for k in range(4):
            kern = np.rot90(e, k=k).copy()
            kern[kern == 0] = 1000.0
            kernels.append(kern)
    return kernels


_KERNELS = _endpoint_kernels()


def detect_endpoints(scribble: np.ndarray) -> np.ndarray:
    """Count, per pixel, how many of the 8 endpoint patterns match.

    Args:
      scribble: (H, W) binary map of one scribble class.
    Returns:
      (H, W) float array; nonzero marks endpoints.
    """
    img = np.asarray(scribble, np.float64)
    out = np.zeros_like(img)
    for kern in _KERNELS:
        # correlate == torch F.conv2d (no kernel flip), zero padding
        resp = ndimage.correlate(img, kern, mode="constant", cval=0.0)
        out += (np.abs(resp - 2.0) < 1e-9).astype(np.float64)
    return out


def delete_endpoints(scribble: np.ndarray, unknown: np.ndarray,
                     length: int, ratio: float):
    """Iteratively erode scribble endpoints until ``ceil(length*ratio)``
    pixels remain, moving removed pixels into the unknown mask.

    In-place on copies; returns (shortened_scribble, new_unknown).
    Reference: utils_shorten_scribble_length.py:32-62 (including the
    assign-first-pixel fallback when a closed curve has no endpoints).
    """
    img = np.asarray(scribble, np.float64).copy()
    unk = np.asarray(unknown, np.float64).copy()
    target = math.ceil(length * ratio)
    while True:
        endpoints = detect_endpoints(img)
        if not endpoints.sum():
            rows, cols = np.where(img == 1)
            if len(rows) == 0:
                break
            endpoints[rows[0], cols[0]] = 1.0
        done = False
        rows, cols = np.where(endpoints >= 1)
        for i, j in zip(rows, cols):
            if img.sum() > target:
                img[i, j] = 0.0
                unk[i, j] = 1.0
            else:
                done = True
                break
        if done:
            break
    return img, unk
