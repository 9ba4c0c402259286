"""Phantoms and their scribbles: frozen copies of the port's synthetic CHAOS
data (``pacingpseudo_torch/data/synthetic.py::make_phantom``, "hard", and
``tools/scribbles.py::generate_scribble``), numpy and scipy only, so that a
spawned worker imports them without torch."""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage


def _smooth_field(rng, h, w, scale, amp):
    """Band-limited random field in [-amp, amp] (coarse noise, cubic zoom)."""
    gh, gw = max(h // scale, 2), max(w // scale, 2)
    g = rng.randn(gh, gw)
    f = ndimage.zoom(g, (h / gh + 1e-9, w / gw + 1e-9), order=3)[:h, :w]
    if f.shape != (h, w):  # zoom rounding
        out = np.zeros((h, w))
        out[: f.shape[0], : f.shape[1]] = f
        f = out
    return (f / (np.abs(f).max() + 1e-6)) * amp


def _ellipse_mask(yy, xx, cy, cx, ry, rx, theta):
    dy = (yy - cy) * np.cos(theta) + (xx - cx) * np.sin(theta)
    dx = -(yy - cy) * np.sin(theta) + (xx - cx) * np.cos(theta)
    return (dy / ry) ** 2 + (dx / rx) ** 2 <= 1.0


def make_phantom(rng: np.random.RandomState, size: Tuple[int, int],
                 num_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """One "hard" slice: every organ draws its mean intensity from the same
    distribution, each class owns a jittered canonical position, organs carry
    texture, a bias field and noise corrupt the image, and 2-3 distractor
    blobs belong to the background."""
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    lab = np.zeros((h, w), np.int32)
    img = rng.randn(h, w) * 0.05 + _smooth_field(rng, h, w, 32, 0.25)
    n_fg = max(num_classes - 1, 1)
    for c in range(1, num_classes):
        ang = 2 * np.pi * (c - 1) / n_fg + rng.uniform(-0.35, 0.35)
        cy = h * (0.5 + 0.22 * np.sin(ang)) + rng.uniform(-0.06, 0.06) * h
        cx = w * (0.5 + 0.22 * np.cos(ang)) + rng.uniform(-0.06, 0.06) * w
        mask = _ellipse_mask(yy, xx, cy, cx,
                             rng.uniform(0.06 * h, 0.13 * h),
                             rng.uniform(0.06 * w, 0.13 * w),
                             rng.uniform(0, np.pi))
        lab[mask] = c
        mu = rng.uniform(0.25, 0.65)          # class-independent intensity
        img[mask] += mu + _smooth_field(rng, h, w, 16, 0.15)[mask]
    for _ in range(rng.randint(2, 4)):        # background distractors
        mask = _ellipse_mask(
            yy, xx, rng.uniform(0.12 * h, 0.88 * h),
            rng.uniform(0.12 * w, 0.88 * w),
            rng.uniform(0.04 * h, 0.09 * h),
            rng.uniform(0.04 * w, 0.09 * w), rng.uniform(0, np.pi))
        mask &= lab == 0
        img[mask] += rng.uniform(0.25, 0.65)
    img += rng.randn(h, w) * 0.06
    return img.astype(np.float32), lab


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


def phantom_job(job) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One phantom drawn from its own seed words and its scribble:
    ``(image float32, label uint8, scribble uint8)``."""
    words, size, num_classes, ignored_index, style = job
    img, lab = make_phantom(np.random.RandomState(words), (size, size), num_classes)
    scb = generate_scribble(lab, num_classes, ignored_index, style=style)
    return img, lab.astype(np.uint8), scb.astype(np.uint8)
