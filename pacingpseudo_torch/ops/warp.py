"""Resampling primitives for the fused on-device augmentation warp.

The port of ``pacingpseudo_tpu/ops/warp.py``, batched: every function takes
a leading batch axis N where the JAX package maps a per-sample function
over the batch.

The reference augmentation chain resamples up to three times per sample on
the host (scale -> elastic -> rotate, datasets/augmentations.py:191-317).
The engine composes every geometric transform into ONE inverse coordinate
map per output pixel and samples the source exactly once:

* images: bilinear (4 taps) or bicubic (4x4 Keys kernel) interpolation;
* labels / scribbles: 4-tap **weighted class vote** -- the bilinear weights
  vote over the neighbours' classes and argmax wins.  This reproduces the
  reference's one-hot-bilinear-then-argmax label scaling
  (augmentations.py:216-227) and degrades gracefully to nearest-neighbour
  when one tap dominates.

The arithmetic keeps the JAX package's order of operations, so that from
the same coordinates the class votes are equal bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from pacingpseudo_torch.ops.warp_table import build_warp_table

TABLE_DTYPES = {"auto": torch.float32, "f32": torch.float32,
                "bf16": torch.bfloat16}
CUBIC_IMPLS = ("auto", "direct", "kernel", "plain")
# What "auto" runs on a CUDA tensor: the direct-read warp, which
# chip_smoke.py's augment phase times against the table route ("kernel")
# in the same run and fails if it is not the faster of the two.
AUTO_CUDA_ROUTE = "direct"


def _per_sample(value, like):
    """``value`` (a number or an (N,) tensor) as a float32 tensor that
    broadcasts against the (N, h, w) tensor ``like``."""
    t = torch.as_tensor(value, dtype=torch.float32, device=like.device)
    return t.reshape(-1, 1, 1) if t.dim() else t


def _take_rows(table, index):
    """``table[n, index[n]]`` for an (N, P, L) table and an (N, ...) index."""
    n = table.shape[0]
    flat = index.reshape(n, -1)
    rows = table[torch.arange(n, device=table.device)[:, None], flat]
    return rows.reshape(*index.shape, table.shape[-1])


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


def fused_warp_sample(image, label, scribble, sy, sx, num_values,
                      bound_h, bound_w):
    """Warp image (bilinear) + label/scribble (class vote) in ONE gather.

    ``image/label/scribble`` are (N, H, W) float32, ``sy/sx`` (N, h, w),
    ``bound_h/bound_w`` numbers or (N,) tensors.  The three tensors share
    the sample coordinates, and the four bilinear taps of a pixel are the
    2x2 neighbourhood of ``(y0, x0)`` -- so each source is rolled into an
    (H*W, 12) table whose row at ``y*W + x`` packs ``(v[y,x], v[y,x+1],
    v[y+1,x], v[y+1,x+1])`` for all three tensors, and ONE row gather at
    ``(y0, x0)`` fetches all twelve taps.

    Exactness: the rolled table wraps at the canvas edge, but a wrapped
    value is only ever read where its bilinear weight is EXACTLY zero --
    ``x1`` clamps only when ``sx == bound_w - 1``, which forces ``fx == 0``
    (same for y) -- so image sums and class votes match the unpacked 4-tap
    formulation bit for bit.

    Returns (image_out float32, label_out int32, scribble_out int32) with
    the shape of ``sy``.
    """
    n, _, w = image.shape
    bh = _per_sample(bound_h, image)
    bw = _per_sample(bound_w, image)
    y0, x0, fy, fx = _anchor(sy, sx, bh, bw)

    cols = []
    for p in (image, label.float(), scribble.float()):
        pr = torch.roll(p, -1, dims=2)      # v[y, x+1]
        pd = torch.roll(p, -1, dims=1)      # v[y+1, x]
        pdr = torch.roll(pd, -1, dims=2)    # v[y+1, x+1]
        cols += [p, pr, pd, pdr]
    table = torch.stack(cols, dim=-1).reshape(n, -1, 12)
    rows = _take_rows(table, y0 * w + x0)

    w00, w01, w10, w11 = weights = _bilinear_weights(fy, fx)
    img_acc = (w00 * rows[..., 0] + w01 * rows[..., 1]
               + w10 * rows[..., 2] + w11 * rows[..., 3])
    lab_out, scb_out = _corner_votes(lambda k: rows[..., k], (4, 8), weights,
                                     num_values)
    return img_acc, lab_out, scb_out


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


def gather_warp_rows(table, y0, x0, width: int):
    """The row gather of the cubic warp: ``table[n, y0*width + x0]`` as
    float32, shape ``(N, h, w, 24)``."""
    return _take_rows(table, y0 * width + x0).float()


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


def interpolate_warp_rows(rows, image, y0, x0, fy, fx, num_values,
                          bound_h, bound_w, cubic_a: float = -0.5):
    """Cubic image interpolation and bilinear class votes from gathered
    table rows (the tail of :func:`fused_warp_sample_cubic`)."""
    return cubic_taps_and_votes(lambda k: rows[..., k], image, y0, x0, fy, fx,
                                num_values, bound_h, bound_w, cubic_a)


def fused_warp_sample_cubic(image, label, scribble, sy, sx, num_values,
                            bound_h, bound_w, cubic_a: float = -0.5,
                            table_impl: str = "auto",
                            table_dtype: str = "auto"):
    """Like :func:`fused_warp_sample` but with a bicubic image tap.

    The image is sampled with the 4x4 Keys cubic kernel (matching the
    reference's order-3 resamples, augmentations.py:214/:270/:307);
    labels/scribbles keep the exact 4-tap bilinear class vote.

    Per output pixel 24 taps: the image's 4x4 neighbourhood
    ``img[y0-1+r, x0-1+c]`` (lane ``4r+c``) and the 2x2 label/scribble
    neighbourhoods of ``(y0, x0)`` (lanes 16..19 / 20..23), each index
    wrapped at the canvas edge.  ``table_impl`` says how they are fetched:

    * ``"direct"``: straight from the three planes, with nothing built
      (``ops/warp_cubic.py``: on a CUDA tensor one kernel launch that also
      does all the arithmetic below, on a CPU tensor its plain version);
    * ``"kernel"`` / ``"plain"``: ONE row gather per pixel from the 24-lane
      table of ``ops/warp_table.py``, built by its CUDA kernel (raises on a
      CPU tensor) or by its plain version;
    * ``"auto"``: ``AUTO_CUDA_ROUTE`` on a CUDA tensor whose table would be
      float32, else the table's own ``"auto"`` (the kernel on a CUDA
      tensor, the plain version on a CPU tensor).

    ``table_dtype`` is the table's storage type: it is built in float32 and
    cast, and all interpolation math stays float32.  Class ids are small
    integers, exact in bf16, so the votes do not depend on the table's
    type; only the image taps round.  The direct route reads the float32
    planes and has no table: it refuses any ``table_dtype`` but float32.
    Every route returns the same numbers for a float32 table.

    Edge handling: wrapped taps whose nominal coordinate leaves the live
    region ``[0, bound)`` get their cubic weight zeroed and the kernel is
    renormalised (boundary-kernel convention; interior pixels -- all 16
    taps live -- are exact Keys).  Out-of-range *bilinear* label taps
    (``y0+1 == bound``) carry weight exactly 0, so the class votes match
    :func:`fused_warp_sample` bit for bit.  The cubic sum can overshoot; it
    is clipped to the live region's value range, mirroring the reference's
    per-stage ``clip=True``.
    """
    if table_dtype not in TABLE_DTYPES:
        raise ValueError(f"table_dtype must be one of {tuple(TABLE_DTYPES)}, "
                         f"got {table_dtype!r}")
    if table_impl not in CUBIC_IMPLS:
        raise ValueError(f"table_impl must be one of {CUBIC_IMPLS}, got {table_impl!r}")
    f32_table = TABLE_DTYPES[table_dtype] == torch.float32
    if table_impl == "auto" and image.device.type == "cuda" and f32_table:
        table_impl = AUTO_CUDA_ROUTE
    if table_impl == "direct":
        if not f32_table:
            raise ValueError("the direct warp reads the float32 planes: "
                             f"table_dtype {table_dtype!r} has no meaning there")
        from pacingpseudo_torch.ops.warp_cubic import warp_sample_cubic  # imports this module
        return warp_sample_cubic(image, label.float(), scribble.float(), sy, sx,
                                 num_values, bound_h, bound_w, cubic_a)
    y0, x0, fy, fx = warp_anchor(sy, sx, bound_h, bound_w)
    table = build_warp_table(image, label.float(), scribble.float(),
                             impl=table_impl).to(TABLE_DTYPES[table_dtype])
    rows = gather_warp_rows(table, y0, x0, image.shape[2])
    return interpolate_warp_rows(rows, image, y0, x0, fy, fx, num_values,
                                 bound_h, bound_w, cubic_a)


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
