"""The augmentation, plain: a frozen copy of the port's on-device engine.

A copy of ``pacingpseudo_torch/aug/engine.py`` (draw and apply), of the
static parameters of ``aug/params.py``, and of the plain route of the cubic
warp (``ops/warp_cubic.py::warp_sample_cubic_plain`` with the helpers of
``ops/warp.py``), imported from nowhere in the port.  The train step of the
port runs the same arithmetic on the card in ``csrc/warp_cubic.cu``; here
every tap is gathered with ``torch.gather`` and every product is its own
elementwise op.  Drawn from the same ``torch.Generator`` state, in the same
order, it gives the batch the program's step augmented.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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

    # The image is sampled with the 4x4 Keys kernel (the CHAOS runs'
    # "bicubic"); labels and scribbles take the exact 4-tap class vote.


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


def bilinear_resize_align_corners(x, out_h: int, out_w: int):
    """Resize ``(N, C, H, W)`` to ``(N, C, out_h, out_w)``, align_corners=True."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def _per_sample(value, like):
    """``value`` (a number or an (N,) tensor) as a float32 tensor that
    broadcasts against the (N, h, w) tensor ``like``."""
    t = torch.as_tensor(value, dtype=torch.float32, device=like.device)
    return t.reshape(-1, 1, 1) if t.dim() else t


def _flat_take(src, iy, ix):
    """Gather ``src[n, iy, ix]`` through a flat index per sample."""
    n, _, w = src.shape
    flat = src.reshape(n, -1).gather(1, (iy * w + ix).reshape(n, -1))
    return flat.reshape(iy.shape)


def _anchor(sy, sx, bound_h, bound_w):
    """Clamp to ``[0, bound-1]`` and split into integer anchor and fraction."""
    sy = torch.minimum(sy.clamp_min(0.0), bound_h - 1.0)
    sx = torch.minimum(sx.clamp_min(0.0), bound_w - 1.0)
    y0 = torch.floor(sy).to(torch.int64)
    x0 = torch.floor(sx).to(torch.int64)
    return y0, x0, sy - y0, sx - x0


def bilinear_sample(src, sy, sx, bound_h=None, bound_w=None):
    """Bilinearly sample ``src`` (N, H, W) at real coordinates (sy, sx),
    both (N, h, w).

    Coordinates are clamped to ``[0, bound-1]`` (the reference's
    ``mode='nearest'`` / clip semantics).  ``bound_h/bound_w`` (numbers or
    (N,) tensors) default to the array size; pass the *live* region extent
    when the array is a padded canvas.
    """
    _, h, w = src.shape
    bh = _per_sample(h if bound_h is None else bound_h, src)
    bw = _per_sample(w if bound_w is None else bound_w, src)
    y0, x0, fy, fx = _anchor(sy, sx, bh, bw)
    y1 = torch.minimum(y0 + 1, (bh - 1).to(torch.int64))
    x1 = torch.minimum(x0 + 1, (bw - 1).to(torch.int64))
    v00 = _flat_take(src, y0, x0)
    v01 = _flat_take(src, y0, x1)
    v10 = _flat_take(src, y1, x0)
    v11 = _flat_take(src, y1, x1)
    return ((1 - fy) * (1 - fx) * v00 + (1 - fy) * fx * v01
            + fy * (1 - fx) * v10 + fy * fx * v11)


def _vote_argmax(taps, num_values):
    """Class with the largest summed weight over ``taps`` [(values, weight)].
    Strict ``>``: a tie keeps the lower class."""
    best_val = best_cls = None
    for v in range(num_values):
        vote = None
        for val, wt in taps:
            term = wt * (val == v)
            vote = term if vote is None else vote + term
        if best_val is None:
            best_val = vote
            best_cls = torch.zeros_like(vote, dtype=torch.int32)
        else:
            take_new = vote > best_val
            best_val = torch.where(take_new, vote, best_val)
            best_cls = torch.where(take_new, v, best_cls)
    return best_cls


def _bilinear_weights(fy, fx):
    """Weights of the corners (0,0), (0,1), (1,0), (1,1), formed in the JAX
    package's order of operations."""
    return ((1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx)


def _corner_votes(lane, bases, weights, num_values):
    """One class vote per ``base``: the four corner classes are the taps
    ``lane(base) .. lane(base+3)``."""
    return [_vote_argmax([(lane(base + k), weights[k]) for k in range(4)],
                         num_values) for base in bases]


def _keys_cubic_weights(f, a: float = -0.5):
    """Keys cubic convolution weights for the 4 taps at offsets -1..2.

    ``f`` is the fractional coordinate in [0, 1).  a=-0.75 is exactly
    cv2.INTER_CUBIC (the reference's rotation kernel, augmentations.py:307);
    a=-0.5 (Catmull-Rom) measures closest to the reference's full mixed
    chain of cubic resamples (AUG_PARITY.json ``geometry_only``).  Weights
    sum to 1 exactly.
    """
    def w_near(s):   # |s| <= 1
        return (a + 2.0) * (s * s * s) - (a + 3.0) * (s * s) + 1.0

    def w_far(s):    # 1 < |s| < 2
        return a * ((s * s * s) - 5.0 * (s * s) + 8.0 * s - 4.0)

    return (w_far(1.0 + f), w_near(f), w_near(1.0 - f), w_far(2.0 - f))


def warp_anchor(sy, sx, bound_h, bound_w):
    """The clamped anchor of the cubic warp: ``(y0, x0, fy, fx)`` for
    coordinates (N, h, w) and per-sample bounds."""
    return _anchor(sy, sx, _per_sample(bound_h, sy), _per_sample(bound_w, sy))


def live_range(image, bound_h, bound_w):
    """``(lo, hi)``, each ``(N, 1, 1)``: the smallest and largest value of
    each sample's live region ``[0, bound_h) x [0, bound_w)`` of ``image``
    (N, H, W), the range the cubic warp clips to."""
    bh_i = _per_sample(bound_h, image).to(torch.int64)
    bw_i = _per_sample(bound_w, image).to(torch.int64)
    _, h, w = image.shape
    iy = torch.arange(h, device=image.device).view(1, h, 1)
    ix = torch.arange(w, device=image.device).view(1, 1, w)
    live = (iy < bh_i) & (ix < bw_i)
    inf = float("inf")
    lo = torch.where(live, image, inf).amin(dim=(1, 2), keepdim=True)
    hi = torch.where(live, image, -inf).amax(dim=(1, 2), keepdim=True)
    return lo, hi


def cubic_taps_and_votes(lane, image, y0, x0, fy, fx, num_values,
                         bound_h, bound_w, cubic_a: float = -0.5):
    """Cubic image interpolation and bilinear class votes from the 24 taps
    of each output pixel, ``lane(k)`` (N, h, w) for k in 0..23 in the
    table's lane order (``ops/warp_table.py``), however they were fetched.
    Every product and sum is its own elementwise op, so each rounds on its
    own: ``csrc/warp_cubic.cu`` repeats this order of operations."""
    bh_i = _per_sample(bound_h, image).to(torch.int64)
    bw_i = _per_sample(bound_w, image).to(torch.int64)

    # ---- image: 16 cubic taps; live-range masked + renormalised weights.
    wy = _keys_cubic_weights(fy, cubic_a)
    wx = _keys_cubic_weights(fx, cubic_a)
    wy = [wy[r] * ((y0 - 1 + r >= 0) & (y0 - 1 + r <= bh_i - 1)) for r in range(4)]
    wx = [wx[c] * ((x0 - 1 + c >= 0) & (x0 - 1 + c <= bw_i - 1)) for c in range(4)]
    ny = wy[0] + wy[1] + wy[2] + wy[3]   # >= w(f)+w(1-f) > 0.9: taps y0 and
    nx = wx[0] + wx[1] + wx[2] + wx[3]   # y0+1 are live except when f == 0
    img_acc = None
    for r in range(4):
        for c in range(4):
            term = wy[r] * wx[c] * lane(4 * r + c)
            img_acc = term if img_acc is None else img_acc + term
    img_acc = img_acc / (ny * nx)

    # live-region range clip (reference clip=True, augmentations.py:214,:257)
    lo, hi = live_range(image, bound_h, bound_w)
    img_acc = torch.maximum(torch.minimum(img_acc, hi), lo)

    # ---- labels/scribbles: exact bilinear class vote (fixed lanes).
    lab_out, scb_out = _corner_votes(lane, (16, 20), _bilinear_weights(fy, fx),
                                     num_values)
    return img_acc, lab_out, scb_out


def separable_gaussian_blur(img, sigma, radius: int):
    """Gaussian blur of ``img`` (N, H, W) with a per-sample ``sigma`` (a
    number or an (N,) tensor) and a static kernel ``radius``.

    The tap weights are computed from sigma; taps beyond ~4*sigma get
    negligible weight.  Reflect padding approximates
    scipy.ndimage.gaussian_filter's default mode (augmentations.py:95 and
    the elastic field smoothing at :264-265).  ``radius`` must be smaller
    than H and W.  The kernel differs per sample, so each pass is a sum
    over the taps of a sliding-window view times ``kern[n, tap]``.
    """
    n = img.shape[0]
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=img.device)
    sigma = sigma.reshape(-1, 1).expand(n, 1)
    offsets = torch.arange(-radius, radius + 1, dtype=torch.float32,
                           device=img.device)
    kern = torch.exp(-0.5 * torch.square(offsets / sigma.clamp_min(1e-6)))
    kern = kern / kern.sum(dim=1, keepdim=True)                   # (N, 2r+1)
    taps = 2 * radius + 1

    # Rows then columns.
    x = F.pad(img[:, None], (0, 0, radius, radius), mode="reflect")[:, 0]
    x = (x.unfold(1, taps, 1) * kern[:, None, None, :]).sum(dim=-1)
    x = F.pad(x[:, None], (radius, radius, 0, 0), mode="reflect")[:, 0]
    x = (x.unfold(2, taps, 1) * kern[:, None, None, :]).sum(dim=-1)
    return x


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



_EPS = 1e-8


def _region_stats(x, mask):
    """Per-sample mean/std of ``x`` (N, H, W) over ``mask`` (population std,
    like np.std), each (N, 1, 1)."""
    cnt = mask.sum(dim=(1, 2), keepdim=True).clamp_min(1.0)
    mean = (x * mask).sum(dim=(1, 2), keepdim=True) / cnt
    var = (torch.square(x - mean) * mask).sum(dim=(1, 2), keepdim=True) / cnt
    return mean, torch.sqrt(var)


def _col(v):
    """(N,) -> (N, 1, 1), to broadcast against (N, H, W)."""
    return v.reshape(-1, 1, 1)


def _live_region(image, size):
    """Float mask (N, S_h, S_w) of each sample's live extent ``size`` (N, 2)
    = (h, w) on the padded canvas ``image`` (N, S_h, S_w)."""
    _, s_h, s_w = image.shape
    row = torch.arange(s_h, device=image.device).view(1, s_h, 1)
    col = torch.arange(s_w, device=image.device).view(1, 1, s_w)
    return ((row < _col(size[:, 0])) & (col < _col(size[:, 1]))).float()


# Residual amplitude factor of the low-res elastic pipeline vs the analytic
# model below, measured by the JAX package (tools/aug_parity.py
# measure_elastic_field, N=64 fields at sigma 9/11/13): the discrete-kernel
# model alone leaves a ~2.2% one-sided deficit traced to the align_corners
# upsample scale ((S-1)/(fh-1) > ds) and edge effects.  Constant across the
# sigma range to <0.3%.
_ELASTIC_RESIDUAL = 0.978


def elastic_amplitude_correction(sigma, ds: int, radius: int):
    """Amplitude calibration for the 1/``ds``-resolution elastic field,
    for an (N,) ``sigma``.

    The reference field is full-resolution white noise U(-1,1) blurred with a
    Gaussian of ``sigma`` (augmentations.py:264-265, scipy truncate=4).  Ours
    is coarse noise blurred with ``sigma/ds`` then bilinearly upsampled; both
    are linear in the noise, so their RMS ratio is the ratio of the composed
    filters' L2 norms -- computable in closed form from the discrete 1-D
    kernels.  For the bilinear phase t ~ U[0,1) between knots sharing
    blurred noise, E[((1-t)k_m + t k_{m+1})^2 summed] =
    (2*sum(k^2) + sum(k_m k_{m+1})) / 3.  Multiplying the field by this
    correction (x the measured residual) lands the RMS ratio at 1.0 across
    the sigma range (AUG_PARITY.json elastic_field).
    """
    sigma = sigma.reshape(-1, 1)
    # reference kernel: radius int(4*sigma + 0.5); static 64-tap support
    # covers sigma <= 15.9 (configs use 9..13)
    i = torch.arange(-64, 65, dtype=torch.float32, device=sigma.device)
    g = torch.exp(-0.5 * torch.square(i / sigma.clamp_min(1e-6)))
    g = torch.where(i.abs() <= torch.floor(4.0 * sigma + 0.5), g, 0.0)
    g = g / g.sum(dim=1, keepdim=True)
    ref_l2 = (g * g).sum(dim=1)      # 1-D factor; 2-D RMS factor = ref_l2

    sc = (sigma / ds).clamp_min(1e-6)
    j = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    k = torch.exp(-0.5 * torch.square(j / sc))
    k = k / k.sum(dim=1, keepdim=True)
    a = (k * k).sum(dim=1)
    b = (k[:, :-1] * k[:, 1:]).sum(dim=1)
    ours_l2 = (2.0 * a + b) / 3.0 / ds
    return ref_l2 / (ours_l2 * _ELASTIC_RESIDUAL)


def elastic_field_shape(out_h: int, out_w: int, ds: int):
    """Shape of the coarse noise field of :func:`make_elastic_field`."""
    return max(out_h // ds, 2), max(out_w // ds, 2)


def make_elastic_field(noise, out_h: int, out_w: int, sigma, alpha,
                       ds: int, radius: int):
    """Calibrated displacement-field axes on the (out_h, out_w) canvas.

    ``noise``: (N, fh, fw) uniform in [0, 1) (:func:`elastic_field_shape`);
    ``sigma``, ``alpha``: (N,).  Band-limited generation: coarse white
    noise, blur at ``sigma/ds``, bilinear upsample, amplitude ``alpha/ds`` x
    the closed-form calibration -- matching the reference full-resolution
    field's RMS and smoothness without a full-resolution blur.
    """
    fh, fw = noise.shape[-2:]
    radius = min(radius, fh - 1, fw - 1)  # reflect-pad bound
    amp = alpha / ds * elastic_amplitude_correction(sigma, ds, radius)
    low = separable_gaussian_blur(noise * 2.0 - 1.0, sigma / ds, radius)
    up = bilinear_resize_align_corners(low[:, None], out_h, out_w)
    return up[:, 0] * _col(amp)


# ---------------------------------------------------------------------------
# Draw layer
# ---------------------------------------------------------------------------

def _rand(shape, generator, device):
    return torch.rand(shape, generator=generator, device=device)


def _uniform(shape, lo, hi, generator, device):
    return _rand(shape, generator, device) * (hi - lo) + lo


def _bern(shape, p, generator, device):
    return _rand(shape, generator, device) < p


def draw_base(n: int, p: BaseAugParams, generator: torch.Generator,
              device) -> Dict[str, torch.Tensor]:
    """The random values of the base pipeline for a batch of ``n``.

    Gates are already applied: an undrawn transform holds its identity
    value (scale 1, alpha 0, theta 0, noise_scale 0, k90 0).  ``crop_u``
    holds the four crop/embed uniforms (crop y, embed y, crop x, embed x):
    the offsets depend on each sample's size, so :func:`apply_base` forms
    them.  ``elastic_noise`` is (N, 2, fh, fw) uniform in [0, 1) for the y
    and x displacement axes, ``noise`` the (N, ch, cw) Gaussian plane.
    """
    ch, cw = p.crop_size
    g, dev = generator, device
    if p.p_rot90 > 0:
        choices = torch.tensor(p.rot90_choices, dtype=torch.int32, device=dev)
        pick = torch.randint(0, len(p.rot90_choices), (n,), generator=g,
                             device=dev)
        k90 = torch.where(_bern((n,), p.p_rot90, g, dev), choices[pick], 0)
    else:
        k90 = torch.zeros((n,), dtype=torch.int32, device=dev)
    scale = torch.where(_bern((n,), p.p_scale, g, dev),
                        _uniform((n,), *p.scale_range, g, dev), 1.0)
    do_el = _bern((n,), p.p_elastic, g, dev)
    sigma = _uniform((n,), *p.sigma_range, g, dev)
    alpha = torch.where(do_el, _uniform((n,), *p.alpha_range, g, dev), 0.0)
    theta = torch.where(
        _bern((n,), p.p_rotate, g, dev),
        _uniform((n,), *p.degree_range, g, dev) * (math.pi / 180.0), 0.0)
    flip_y = _bern((n,), p.p_mirror_y, g, dev)
    flip_x = _bern((n,), p.p_mirror_x, g, dev)
    noise_scale = torch.where(_bern((n,), p.p_noise, g, dev),
                              _uniform((n,), *p.noise_scale_range, g, dev),
                              0.0)
    fh, fw = elastic_field_shape(ch, cw, p.elastic_field_downscale)
    return {
        "k90": k90, "scale": scale, "sigma": sigma, "alpha": alpha,
        "theta": theta, "flip_y": flip_y, "flip_x": flip_x,
        "noise_scale": noise_scale,
        "crop_u": _rand((n, 4), g, dev),
        "elastic_noise": _rand((n, 2, fh, fw), g, dev),
        "noise": torch.randn((n, ch, cw), generator=g, device=dev),
    }


def draw_strong(n: int, height: int, width: int, p: StrongAugParams,
                generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The random values of the strong stream for a batch of ``n`` images of
    (height, width).  Gates are applied where the transform has an identity
    value (brightness 0, contrast 1, lam 1); gamma, blur, low-res and cutout
    keep their gate beside the value.  ``mixup_shift`` is the batch's roll
    for the mixup partners, in [1, max(n, 2))."""
    g, dev = generator, device
    brightness = torch.where(_bern((n,), p.p_brightness, g, dev),
                             _uniform((n,), *p.brightness_range, g, dev), 0.0)
    contrast = torch.where(_bern((n,), p.p_contrast, g, dev),
                           _uniform((n,), *p.contrast_range, g, dev), 1.0)
    # Gamma with biased sampling (augmentations.py:131-166): ONE uniform,
    # mapped into [lo, 1) or [max(1, lo), hi).
    do_gamma = _bern((n,), p.p_gamma, g, dev)
    lo, hi = p.gamma_range
    pick_low = _bern((n,), 0.5, g, dev) & (lo < 1.0)
    u = _rand((n,), g, dev)
    top = max(1.0, lo)
    gamma = torch.where(pick_low, u * (1.0 - lo) + lo, u * (hi - top) + top)
    out = {
        "brightness": brightness, "contrast": contrast,
        "do_gamma": do_gamma, "gamma": torch.where(do_gamma, gamma, 1.0),
        "mixup_shift": torch.randint(1, max(n, 2), (), generator=g, device=dev),
    }
    if p.p_blur > 0:
        out["do_blur"] = _bern((n,), p.p_blur, g, dev)
        out["blur_sigma"] = _uniform((n,), *p.blur_sigma_range, g, dev)
    if p.p_mixup > 0:
        out["lam"] = torch.where(_bern((n,), p.p_mixup, g, dev),
                                 _uniform((n,), *p.mixup_lam_range, g, dev), 1.0)
    if p.p_lowres > 0:
        out["do_lowres"] = _bern((n,), p.p_lowres, g, dev)
        out["lowres_scale"] = _uniform((n,), *p.lowres_scale_range, g, dev)
    if p.p_cutout > 0:
        out["do_cutout"] = _bern((n,), p.p_cutout, g, dev)
        out["cut_y"] = torch.randint(0, height, (n,), generator=g, device=dev)
        out["cut_x"] = torch.randint(0, width, (n,), generator=g, device=dev)
    return out


# ---------------------------------------------------------------------------
# Apply layer
# ---------------------------------------------------------------------------

def _randint_from_uniform(u, maxval_inclusive):
    """Integer in [0, maxval_inclusive] from a uniform ``u`` in [0, 1)."""
    return torch.floor(u * (maxval_inclusive.float() + 1.0)).to(torch.int32)


def base_source_coordinates(size, draws, p: BaseAugParams):
    """The composed inverse coordinate map of the base pipeline.

    Returns ``(sy, sx, rot_valid, crop_valid)``, each (N, ch, cw): the
    source coordinates in the raw array for every canvas pixel, and the
    masks of pixels that rotation and crop/embed leave inside the image.
    """
    ch, cw = p.crop_size
    dev = size.device
    h_raw = _col(size[:, 0].float())
    w_raw = _col(size[:, 1].float())

    # ---- Rotation90 (augmentations.py:319-335): composed as the FIRST
    # forward transform -- the k*90-degree-rotated array (live size swapped
    # for odd k) is what the rest of the pipeline sees; the rotation itself
    # is inverted exactly at the end of the coordinate chain.
    k90 = _col(draws["k90"])
    odd = (k90 % 2) == 1
    h = torch.where(odd, w_raw, h_raw)
    w = torch.where(odd, h_raw, w_raw)

    scale = _col(draws["scale"])
    new_h = torch.round(scale * h)
    new_w = torch.round(scale * w)
    theta = _col(draws["theta"])
    flip_y = _col(draws["flip_y"])
    flip_x = _col(draws["flip_x"])

    # ---- Crop offsets (augmentations.py:386-398): crop when the scaled
    # image exceeds the canvas, embed (random canvas offset) otherwise.
    # ``.to(int32)`` truncates toward zero, as the reference's cast does.
    crop_u = draws["crop_u"]
    h_margin = (new_h - ch).to(torch.int32)
    w_margin = (new_w - cw).to(torch.int32)
    off_y = torch.where(
        h_margin > 0,
        _randint_from_uniform(_col(crop_u[:, 0]), h_margin.clamp_min(0)),
        -_randint_from_uniform(_col(crop_u[:, 1]), (-h_margin).clamp_min(0)))
    off_x = torch.where(
        w_margin > 0,
        _randint_from_uniform(_col(crop_u[:, 2]), w_margin.clamp_min(0)),
        -_randint_from_uniform(_col(crop_u[:, 3]), (-w_margin).clamp_min(0)))

    # ---- Compose the inverse coordinate map on the output canvas grid.
    oy = torch.arange(ch, dtype=torch.float32, device=dev).view(1, ch, 1)
    ox = torch.arange(cw, dtype=torch.float32, device=dev).view(1, 1, cw)

    # crop: canvas pixel -> scaled-image coordinate
    yc = (oy + off_y).expand(-1, ch, cw)
    xc = (ox + off_x).expand(-1, ch, cw)
    crop_valid = (yc >= 0) & (yc <= new_h - 1) & (xc >= 0) & (xc <= new_w - 1)

    # mirror on the scaled image (axis 0 = rows, axis 1 = cols)
    yc = torch.where(flip_y, new_h - 1.0 - yc, yc)
    xc = torch.where(flip_x, new_w - 1.0 - xc, xc)

    # inverse rotation about the scaled-image centre (cv2 centre convention
    # (w/2, h/2), augmentations.py:306)
    cyc = new_h / 2.0
    cxc = new_w / 2.0
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    rel_x = xc - cxc
    rel_y = yc - cyc
    qx = cos_t * rel_x - sin_t * rel_y + cxc
    qy = sin_t * rel_x + cos_t * rel_y + cyc
    rot_valid = (qy >= 0) & (qy <= new_h - 1) & (qx >= 0) & (qx <= new_w - 1)

    # elastic displacement, evaluated on the static canvas grid; generated
    # at low resolution with calibrated amplitude (make_elastic_field)
    n = size.shape[0]
    noise = draws["elastic_noise"]
    fields = make_elastic_field(
        noise.reshape(n * 2, *noise.shape[2:]), ch, cw,
        draws["sigma"].repeat_interleave(2), draws["alpha"].repeat_interleave(2),
        p.elastic_field_downscale, p.elastic_blur_radius).reshape(n, 2, ch, cw)
    qy = torch.minimum((qy + fields[:, 0]).clamp_min(0.0), new_h - 1.0)
    qx = torch.minimum((qx + fields[:, 1]).clamp_min(0.0), new_w - 1.0)

    # inverse scaling: scaled-image coordinate -> source coordinate
    # (skimage.resize half-pixel convention, augmentations.py:214)
    sy = (qy + 0.5) * (h / new_h.clamp_min(1.0)) - 0.5
    sx = (qx + 0.5) * (w / new_w.clamp_min(1.0)) - 0.5

    # invert Rotation90: (sy, sx) in the k*90-degree-rotated live array
    # (h, w) -> coordinates in the raw array (h_raw, w_raw).
    ry = torch.where(k90 == 0, sy, torch.where(
        k90 == 1, sx, torch.where(k90 == 2, h_raw - 1.0 - sy,
                                  h_raw - 1.0 - sx)))
    rx = torch.where(k90 == 0, sx, torch.where(
        k90 == 1, w_raw - 1.0 - sy, torch.where(k90 == 2, w_raw - 1.0 - sx,
                                                sy)))
    return ry, rx, rot_valid, crop_valid


def apply_base(raw: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
               p: BaseAugParams) -> Dict[str, torch.Tensor]:
    """The fused base pipeline on a raw batch, from drawn values.

    Args:
      raw: ``image/label/scribble`` (N, S, S) padded source canvases and
        ``size`` (N, 2) int32 live extents (h, w).
      draws: :func:`draw_base`'s values.

    Returns:
      dict with ``image`` (float32), ``label`` and ``scribble`` (int32) of
      shape (N,) + ``crop_size`` and ``valid_mask`` (float32) marking the
      crop-visible region (augmentations.py:368-419 RandomCrop semantics).
    """
    image = raw["image"].float()
    label = raw["label"].float()
    scribble = raw["scribble"].float()
    size = raw["size"]
    h_raw = size[:, 0].float()
    w_raw = size[:, 1].float()

    # ---- MeanStdNorm #1 over the live region (augmentations.py:11-21;
    # the reference normalises the raw loaded slice).
    mean1, std1 = _region_stats(image, _live_region(image, size))
    img = (image - mean1) / (std1 + _EPS)

    sy, sx, rot_valid, crop_valid = base_source_coordinates(size, draws, p)

    # ---- One fused gather pass for all three tensors (shared taps).
    num_vals = p.num_classes + 1
    img_out, lab_out, scb_out = warp_sample_cubic_plain(
        img, label, scribble, sy, sx, num_vals, bound_h=h_raw, bound_w=w_raw)

    # rotation padding (image 0 / labels ignored_index, augmentations.py:294-312)
    ign = p.ignored_index
    img_out = torch.where(rot_valid, img_out, 0.0)
    lab_out = torch.where(rot_valid, lab_out, ign)
    scb_out = torch.where(rot_valid, scb_out, ign)

    # noise (before the 2nd norm, augmentations.py:353-366)
    img_out = img_out + draws["noise"] * _col(draws["noise_scale"])

    # ---- MeanStdNorm #2 over the crop-visible region.
    vmask = crop_valid.float()
    mean2, std2 = _region_stats(img_out, vmask)
    img_out = (img_out - mean2) / (std2 + _EPS)

    # crop embedding pads (augmentations.py:400-418)
    img_out = torch.where(crop_valid, img_out, 0.0)
    lab_out = torch.where(crop_valid, lab_out, ign)
    scb_out = torch.where(crop_valid, scb_out, ign)

    return {"image": img_out, "label": lab_out, "scribble": scb_out,
            "valid_mask": vmask}


def apply_strong(image, partner, draws: Dict[str, torch.Tensor],
                 p: StrongAugParams):
    """Intensity-only strong transforms on base-transformed (N, H, W) images,
    from :func:`draw_strong`'s values (chaos_aug_configs.py:63-186).

    ``partner`` (N, H, W) holds another sample's normalised crop for each
    image, used by the Mixup variant (the reference mixes with a random
    dataset file, augmentations.py:51-81; on the device we mix with a batch
    peer).
    """
    dims = (1, 2)
    # Brightness (augmentations.py:98-111)
    img = image + _col(draws["brightness"])

    # Contrast (augmentations.py:113-129)
    mean_ = img.mean(dim=dims, keepdim=True)
    mn = img.amin(dim=dims, keepdim=True)
    mx = img.amax(dim=dims, keepdim=True)
    img = torch.maximum(torch.minimum(
        (img - mean_) * _col(draws["contrast"]) + mean_, mx), mn)

    # Gamma with retain-stats (augmentations.py:131-166); population std.
    do_g = _col(draws["do_gamma"])
    g_in = -img if p.gamma_invert else img
    mean_g = g_in.mean(dim=dims, keepdim=True)
    std_g = g_in.std(dim=dims, keepdim=True, correction=0)
    mn_g = g_in.amin(dim=dims, keepdim=True)
    mx_g = g_in.amax(dim=dims, keepdim=True)
    g = torch.pow(((g_in - mn_g) / (mx_g - mn_g + _EPS)).clamp(0.0, 1.0),
                  _col(draws["gamma"]))
    if p.gamma_retain_stats:
        g = (g - g.mean(dim=dims, keepdim=True)) / (
            g.std(dim=dims, keepdim=True, correction=0) + _EPS)
        g = g * std_g + mean_g
    g = -g if p.gamma_invert else g
    img = torch.where(do_g, g, img)

    # Variant extras --------------------------------------------------------
    if p.p_blur > 0:
        blurred = separable_gaussian_blur(img, draws["blur_sigma"],
                                          p.blur_radius)
        img = torch.where(_col(draws["do_blur"]), blurred, img)

    if p.p_mixup > 0:
        lam = _col(draws["lam"])
        img = img * lam + partner * (1.0 - lam)

    hh, ww = img.shape[1:]
    if p.p_lowres > 0:
        # Simulate low resolution by snapping sample coordinates to a coarse
        # grid (nearest-downsample) and bilinearly reading the fine image --
        # the static-shape equivalent of resize-down(order 0)/up(order 3)
        # (augmentations.py:168-189).
        s = _col(draws["lowres_scale"])
        oy = torch.arange(hh, dtype=torch.float32, device=img.device).view(1, hh, 1)
        ox = torch.arange(ww, dtype=torch.float32, device=img.device).view(1, 1, ww)
        cy = torch.round(torch.floor(oy / s) * s + (s - 1.0) / 2.0)
        cx = torch.round(torch.floor(ox / s) * s + (s - 1.0) / 2.0)
        low = bilinear_sample(img, cy.expand(-1, hh, ww), cx.expand(-1, hh, ww))
        img = torch.where(_col(draws["do_lowres"]), low, img)

    if p.p_cutout > 0:
        # Cutout (augmentations.py:23-49): zero a length x length box whose
        # centre is uniform over the canvas; the box clips at the borders.
        cy0 = _col(draws["cut_y"])
        cx0 = _col(draws["cut_x"])
        half = p.cutout_length // 2
        ry = torch.arange(hh, device=img.device).view(1, hh, 1)
        rx = torch.arange(ww, device=img.device).view(1, 1, ww)
        in_box = ((ry >= cy0 - half) & (ry < cy0 + half) &
                  (rx >= cx0 - half) & (rx < cx0 + half))
        img = torch.where(_col(draws["do_cutout"]) & in_box, 0.0, img)

    return img


def mixup_partners(images, shift):
    """``images`` (N, ...) rolled along the batch by the device scalar
    ``shift`` (no host sync): row i holds ``images[(i - shift) % N]``."""
    n = images.shape[0]
    return images[(torch.arange(n, device=images.device) - shift) % n]


# ---------------------------------------------------------------------------
# Batch-level entry points
# ---------------------------------------------------------------------------

def _one_hot(index, channels: int):
    """(N, H, W) integer map -> (N, channels, H, W) float32 one-hot; a value
    outside ``[0, channels)`` gives an all-zero pixel."""
    classes = torch.arange(channels, device=index.device).view(1, channels, 1, 1)
    return (index[:, None] == classes).float()


def _finalize(one_hot_classes: int, out, do_strong: bool, strong_img=None):
    """Convert hard labels to the one-hot NCHW layout the losses expect
    (ToTorchTensor semantics, augmentations.py:421-446): label one-hot over
    ``C`` channels (ignored pixels become all-zero), scribble over ``C+1``.
    """
    c = one_hot_classes
    batch = {
        "image": out["image"][:, None],
        "label": _one_hot(out["label"], c),
        "scribble": _one_hot(out["scribble"], c + 1),
        "valid_mask": out["valid_mask"][:, None],
    }
    if do_strong:
        batch["image_strong"] = strong_img[:, None]
    return batch


@torch.no_grad()
def augment_batch(raw: Dict[str, torch.Tensor], generator: torch.Generator,
                  base_params: BaseAugParams,
                  strong_params: Optional[StrongAugParams] = None,
                  do_strong: bool = False) -> Dict[str, torch.Tensor]:
    """Augment a whole raw batch on its device: draw, then apply.

    Args:
      raw: dict of host-padded canvases -- ``image/label/scribble``
        (N, S, S) and ``size`` (N, 2).
      generator: a ``torch.Generator`` on the batch's device; every sample
        gets its own draws.

    Returns:
      Training batch, NCHW: ``image`` (N, 1, H, W) f32, ``label``
      (N, C, H, W), ``scribble`` (N, C+1, H, W), ``valid_mask``
      (N, 1, H, W), and ``image_strong`` (N, 1, H, W) when ``do_strong``.
    """
    n = raw["image"].shape[0]
    dev = raw["image"].device
    base = apply_base(raw, draw_base(n, base_params, generator, dev),
                      base_params)
    strong_img = None
    if do_strong:
        ch, cw = base_params.crop_size
        draws = draw_strong(n, ch, cw, strong_params, generator, dev)
        # Mixup partners: base-normalised image of a shifted batch peer.
        partners = mixup_partners(base["image"], draws["mixup_shift"])
        strong_img = apply_strong(base["image"], partners, draws,
                                  strong_params)
    return _finalize(base_params.num_classes, base, do_strong, strong_img)


def _live_region_norm(image, size):
    """MeanStdNorm over each sample's live region on the padded canvas:
    ``(normalised image with the padding at 0, region)``, both (N, S, S)."""
    image = image.float()
    region = _live_region(image, size)
    mean, std = _region_stats(image, region)
    return (image - mean) / (std + _EPS) * region, region


@torch.no_grad()
def eval_preprocess_batch(raw: Dict[str, torch.Tensor], num_classes: int):
    """Validation/inference preprocessing: MeanStdNorm only (reference:
    train_chaos.py:234 / inference.py:127 use ``base_transforms=
    [MeanStdNorm()]``), on the padded canvas with a live-region mask.

    Returns NCHW: image (N, 1, S, S), label one-hot (N, C, S, S), scribble
    one-hot (N, C+1, S, S), and ``region_mask`` (N, 1, S, S) for masked
    metrics.
    """
    img, region = _live_region_norm(raw["image"], raw["size"])
    return {
        "image": img[:, None],
        "label": _one_hot(raw["label"].to(torch.int32), num_classes)
                 * region[:, None],
        "scribble": _one_hot(raw["scribble"].to(torch.int32), num_classes + 1),
        "region_mask": region[:, None],
    }

