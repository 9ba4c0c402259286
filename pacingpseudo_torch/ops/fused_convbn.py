"""Fused training-mode ConvLayer: 3x3 conv + BatchNorm statistics + LeakyReLU.

The port of ``pacingpseudo_tpu/ops/pallas/fused_convbn.py``.  The unfused
ConvLayer is Conv2d -> BatchNorm2d (batch statistics) -> LeakyReLU; here
the statistics come out of the convolution's own pass and the LeakyReLU
backward folds into the BatchNorm-sums pass:

* forward: ``conv_stats`` computes ``y = conv3x3(xp) + b`` and the
  per-channel sum and sum of squares of the float32 accumulator (before
  the cast to the compute dtype); the normalize + LeakyReLU + zero pad is
  plain PyTorch;
* backward: ``bn_sums`` reads ``y`` and the padded cotangent once for
  ``sum(g')`` and ``sum(g'·xhat)`` (``g' = gz·LReLU'(yn)``); plain
  PyTorch forms the conv-output cotangent ``dy``; ``conv_pad_out``
  computes ``dx = conv3x3(dy, flipped kernel)`` straight into a
  zero-bordered padded canvas; ``dW`` is the library's weight-gradient
  convolution summed in float32 (:func:`weight_grad`; XLA's in the JAX
  package, not a Pallas kernel there either); the conv bias gradient has a
  closed form in the sums.

Kernels (CUDA C++ for ``sm_90a``):

* ``conv_stats`` replaces ``_conv_stats_kernel`` (``:127``): an implicit
  GEMM with a statistics epilogue, then a fixed-order reduction of the
  partial rows;
* ``bn_sums`` replaces ``_bn_sums_kernel`` (``:160``): one launch that
  walks whole output rows with 16-byte loads along the channels, as
  :func:`bn_sums_plan` partitions them, and adds its per-block partial rows
  in a fixed order in the same launch (``csrc/fused_convbn.cu``);
* ``conv_pad_out`` replaces ``_conv_pad_out_kernel`` (``:201``): the same
  GEMM into a zero-bordered padded canvas.

The two GEMMs take the route :func:`conv_plan` picks for the shape:
``"wgmma"`` (``csrc/conv_wgmma.cu``: TMA, ``wgmma``, a tile fitted to the
layer; bfloat16 whose image the 128-pixel rectangles tile exactly and whose
channels are multiples of 32) or ``"simple"`` (``conv3x3_kernel`` of
``csrc/fused_convbn.cu``: everything else, float32 included).  The plan is
made before the launch; a route that fails raises, it never falls back.

Layout of every public function here is the JAX package's: padded NHWC
canvases ``(N, H+2, W+2, C)`` in the compute dtype (bfloat16 or float32),
contiguous; weights ``(9, Cin, Cout)`` in the compute dtype; statistics
float32.  ``groups > 1`` is the space-to-depth extension: statistics and
BatchNorm parameters per logical channel, physical channel ``g*C + i``.

On a CPU tensor the wrappers run the plain PyTorch versions
(:func:`conv_stats_plain`, :func:`bn_sums_plain`,
:func:`conv_pad_out_plain`); on a CUDA tensor they launch the kernel or
raise.  ``LAUNCHES`` counts kernel launches (``conv_stats``' kernel and its
reduction count as one; ``bn_sums`` is one launch); ``ROUTES[kernel][route]``
counts the GEMMs' launches by route.

Selection: :func:`get_conv_impl` (``"fused"`` | ``"xla"``), read once from
env ``PACING_CONV_IMPL``, default ``"xla"``, as in the JAX package.  Here
``"xla"`` names the unfused path (``F.conv2d`` + ``BatchNorm2d`` +
LeakyReLU), so one variable means the same run in both packages.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import torch

from pacingpseudo_torch.ops import _build

LAUNCHES = {"conv_stats": 0, "bn_sums": 0, "conv_pad_out": 0}
ROUTES = {k: {"wgmma": 0, "simple": 0} for k in ("conv_stats", "conv_pad_out")}
IMPLS = ("fused", "xla")

_CONV_IMPL = None   # lazy: resolved from env on first use
_TH = 16            # the JAX kernels' row tile: the gate keeps its shapes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The GEMMs' tiles (csrc/fused_convbn.cu's kBM; csrc/conv_wgmma.cu's kBM,
# the wgmma widths it is built for, kSmemLimit and its stage range).
SIMPLE_TILE_M = 128
WGMMA_TILE_M = 128
WGMMA_BN = (256, 128, 96, 64, 32)
WGMMA_SMEM = 232448          # one block an SM (BN > 96)
WGMMA_SMEM_TWO_BLOCKS = 115712   # each of two blocks an SM (BN <= 96)
WGMMA_STAGES = (3, 6)

# bn_sums (csrc/fused_convbn.cu's kThreads, kBnBlocksPerSm): 256 threads a
# block, at most BN_SUMS_VECTORS channel vectors across it, two blocks an SM.
BN_SUMS_THREADS = 256
BN_SUMS_VECTORS = 8
BN_SUMS_BLOCKS_PER_SM = 2
BN_SUMS_COUNTERS = 1024      # ticket counters a device (one per channel chunk)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How one GEMM launch is tiled.  ``rows``: the launch's M tiles (the
    partial rows of ``conv_stats``).  On the ``"wgmma"`` route an M tile is
    ``box_h`` rows by ``box_w`` columns of one image, an N tile ``bn``
    channels, a K tile ``bk`` channels of one tap, ``stages`` K tiles are in
    flight, and ``grid`` blocks walk the ``rows x cout / bn`` output tiles."""
    route: str
    rows: int
    box_w: int = 0
    box_h: int = 0
    bn: int = 0
    bk: int = 0
    stages: int = 0
    grid: int = 0


@functools.lru_cache(maxsize=None)
def conv_plan(dtype, n: int, h: int, w: int, cin: int, cout: int,
              pad_out: bool, sms: int = 132) -> ConvPlan:
    """The route and tiles of a 3x3 conv over an ``(n, h+2, w+2, cin)``
    canvas into ``cout`` channels: ``conv_stats`` (``pad_out`` False, output
    ``(n, h, w, cout)``) or ``conv_pad_out`` (True, output padded), on a card
    of ``sms`` SMs.  Pure: the tests check it on the CPU."""
    out_pixels = n * (h + 2) * (w + 2) if pad_out else n * h * w
    simple = ConvPlan("simple", -(-out_pixels // SIMPLE_TILE_M))
    box_w = min(w, WGMMA_TILE_M)
    if (dtype != torch.bfloat16 or cin % 32 or cout % 32 or box_w <= 0
            or WGMMA_TILE_M % box_w or w % box_w
            or h % (WGMMA_TILE_M // box_w)):
        return simple
    box_h = WGMMA_TILE_M // box_w
    bn = next(b for b in WGMMA_BN if cout % b == 0)
    # Two blocks share an SM up to bn = 96, one above.  The ring, the staged
    # bf16 output tile, conv_stats' [2][8][bn] float32 statistics rows, two
    # barriers a stage and 1024 bytes to align the ring must fit: 64-channel
    # K tiles where the channels and the room allow, else 32.
    per_sm = 2 if bn <= 96 else 1
    smem = WGMMA_SMEM_TWO_BLOCKS if per_sm == 2 else WGMMA_SMEM
    fixed = (2 * WGMMA_TILE_M + (0 if pad_out else 64)) * bn + 1024
    for bk in (64, 32):
        stage = (WGMMA_TILE_M + bn) * bk * 2
        stages = min(WGMMA_STAGES[1], (smem - fixed) // (stage + 16))
        if cin % bk == 0 and stages >= WGMMA_STAGES[0]:
            break
    else:
        return simple
    rows = n * (h // box_h) * (w // box_w)
    return ConvPlan("wgmma", rows, box_w, box_h, bn, bk, stages,
                    min(rows * (cout // bn), per_sm * sms))


@dataclasses.dataclass(frozen=True)
class BnSumsPlan:
    """How one ``bn_sums`` launch walks ``y``.  A thread holds ``vec``
    channels (16 bytes, or 1 where Co is not a multiple of that); a block
    ``bx`` channel vectors by ``by`` pixel lanes; ``grid_y`` chunks of
    ``bx`` vectors cover the channels and ``grid_x`` blocks each take
    ``rows_per_block`` whole output rows ``(img, oh)`` of the ``n*h``
    (the last block fewer).  ``grid_x`` is also the count of partial rows
    the launch writes and adds."""
    vec: int
    bx: int
    by: int
    grid_x: int
    grid_y: int
    rows_per_block: int


@functools.lru_cache(maxsize=None)
def bn_sums_plan(dtype, n: int, h: int, w: int, co: int,
                 sm_count: int = 132) -> BnSumsPlan:
    """The row partition of ``bn_sums`` over ``y`` ``(n, h, w, co)`` on a
    card of ``sm_count`` SMs: about ``BN_SUMS_BLOCKS_PER_SM`` blocks an SM
    in one wave, each with an equal share of whole rows.  Pure: the tests
    check it on the CPU, the C entry refuses any other plan."""
    full = 16 // (2 if dtype == torch.bfloat16 else 4)
    vec = full if co % full == 0 else 1
    vectors = co // vec
    bx = min(vectors, BN_SUMS_VECTORS)
    grid_y = -(-vectors // bx)
    rows = n * h
    target = max(1, BN_SUMS_BLOCKS_PER_SM * max(sm_count, 1) // grid_y)
    per_block = -(-rows // min(rows, target))
    return BnSumsPlan(vec, bx, BN_SUMS_THREADS // bx, -(-rows // per_block),
                      grid_y, per_block)


def set_conv_impl(impl: str) -> None:
    global _CONV_IMPL
    if impl not in IMPLS:
        raise ValueError(f"conv impl must be one of {IMPLS}, got {impl!r}")
    _CONV_IMPL = impl


def get_conv_impl() -> str:
    if _CONV_IMPL is None:
        set_conv_impl(os.environ.get("PACING_CONV_IMPL", "xla"))
    return _CONV_IMPL


def fusable(h: int, w: int, kernel_size: int, stride: int,
            dilation: int) -> bool:
    """The JAX package's shape gate, unchanged: 3x3 stride-1 dilation-1
    convs whose height splits into two halves of whole 16-row tiles."""
    return (kernel_size == 3 and stride == 1 and dilation == 1
            and h % (2 * _TH) == 0 and w >= 8)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in ROUTES.values():
        for route in counts:
            counts[route] = 0


def _fold_groups(vec, groups):
    """(groups*c,) physical vector -> (c,) logical sum over groups."""
    if groups == 1:
        return vec
    return vec.reshape(groups, -1).sum(dim=0)


def _tile_groups(vec, groups):
    return vec.repeat(groups) if groups > 1 else vec


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("fused_convbn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_convbn_conv_stats.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.fused_convbn_conv_stats.restype = i
    lib.fused_convbn_conv_pad_out.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.fused_convbn_conv_pad_out.restype = i
    lib.fused_convbn_bn_sums.argtypes = [p, p, p, p, p, i, p] + [i] * 5 + [f] + [i] * 5 + [p]
    lib.fused_convbn_bn_sums.restype = i
    lib.fused_convbn_reduce_rows.argtypes = [p, i, i, p, p]
    lib.fused_convbn_reduce_rows.restype = i
    lib.fused_convbn_error_string.argtypes = [i]
    lib.fused_convbn_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _wgmma_library():
    lib = _build.load("conv_wgmma")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_wgmma.argtypes = [p] * 5 + [i] * 13 + [p]
    lib.conv_wgmma.restype = i
    return lib


def _launch_wgmma(plan, x, w9, bias, out, partials, pad_out):
    """One launch of the wgmma route; the weights go K-major,
    ``(Cout, 9·Cin)``, as the kernel's B."""
    n, hp, wp, cin = x.shape
    cout = w9.shape[2]
    wk = w9.permute(2, 0, 1).reshape(cout, 9 * cin).contiguous()
    return _wgmma_library().conv_wgmma(
        x.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), None if partials is None else partials.data_ptr(),
        n, hp - 2, wp - 2, cin, cout, int(pad_out), plan.bn, plan.bk, plan.box_w,
        plan.box_h, plan.stages, plan.rows, plan.grid,
        torch.cuda.current_stream(x.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _bn_sums_counters(index: int):
    """``bn_sums``' ticket counters on card ``index``: zeros, allocated once;
    each launch leaves them zero again.  Calls on one card share them, so
    they run on one stream at a time."""
    return torch.zeros(BN_SUMS_COUNTERS, dtype=torch.int32,
                       device=torch.device("cuda", index))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = _library().fused_convbn_error_string(err).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {err} ({msg})")


def _check_canvas(name, t, dtype=None):
    if t.dim() != 4 or t.shape[1] < 3 or t.shape[2] < 3:
        raise ValueError(f"{name} must be a padded (N, H+2, W+2, C) canvas, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in _DTYPES or (dtype is not None and t.dtype != dtype):
        raise TypeError(f"{name} must be {dtype or 'float32 or bfloat16'}, got {t.dtype}")


def _check_weights(w9, cin, dtype):
    if w9.dim() != 3 or w9.shape[0] != 9 or w9.shape[1] != cin:
        raise ValueError(f"weights must be (9, {cin}, Cout), got {tuple(w9.shape)}")
    if w9.dtype != dtype:
        raise TypeError(f"weights must be {dtype}, got {w9.dtype}")


def _check_kernel_inputs(*tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the fused ConvLayer runs on cpu or cuda, not {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError("all inputs must lie on one device")
        if not t.is_contiguous():
            raise ValueError(f"kernel inputs must be contiguous, got strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must start on a 16-byte boundary")


def _padded(t):
    """``t`` (N, H, W, C) in a new zero-bordered (N, H+2, W+2, C) canvas."""
    n, h, w, c = t.shape
    out = t.new_zeros((n, h + 2, w + 2, c))
    out[:, 1:-1, 1:-1, :] = t
    return out


def _conv9_plain(xp, w9):
    """float32 sum over the nine taps of (pixels, Cin) x (Cin, Cout) products
    of the shifted windows, in the TPU kernel's tap order."""
    h, w = xp.shape[1] - 2, xp.shape[2] - 2
    x32, w32 = xp.float(), w9.float()
    acc = None
    for t in range(9):
        dh, dw = divmod(t, 3)
        term = x32[:, dh:dh + h, dw:dw + w, :] @ w32[t]
        acc = term if acc is None else acc + term
    return acc


def conv_stats_plain(xp, w9, bias):
    """Plain PyTorch version of ``conv_stats``: ``(y, sums)``."""
    acc = _conv9_plain(xp, w9) + bias.float()
    sums = torch.stack([acc.sum(dim=(0, 1, 2)), acc.square().sum(dim=(0, 1, 2))])
    return acc.to(xp.dtype), sums


def bn_sums_plain(y, gzp, aux, slope: float):
    """Plain PyTorch version of ``bn_sums``: ``(2, Co)`` float32."""
    gz = gzp[:, 1:-1, 1:-1, :].float()
    xhat = (y.float() - aux[0]) * aux[1]
    yn = xhat * aux[2] + aux[3]
    gaff = gz * torch.where(yn >= 0, 1.0, slope)
    return torch.stack([gaff.sum(dim=(0, 1, 2)), (gaff * xhat).sum(dim=(0, 1, 2))])


def conv_pad_out_plain(dyp, w9t):
    """Plain PyTorch version of ``conv_pad_out``: the padded ``dxp``."""
    return _padded(_conv9_plain(dyp, w9t).to(dyp.dtype))


def conv_stats(xp, w9, bias):
    """``y = conv3x3(xp) + bias`` as ``(N, H, W, Co)`` in ``xp``'s dtype, and
    ``sums`` ``(2, Co)`` float32: the per-channel sum and sum of squares of
    the float32 values before the cast.  ``xp`` ``(N, H+2, W+2, Ci)``,
    ``w9`` ``(9, Ci, Co)`` in ``xp``'s dtype, ``bias`` ``(Co,)`` float32."""
    _check_canvas("xp", xp)
    n, hp, wp, ci = xp.shape
    _check_weights(w9, ci, xp.dtype)
    co = w9.shape[2]
    if bias.dtype != torch.float32 or tuple(bias.shape) != (co,):
        raise TypeError(f"bias must be float32 ({co},), got {bias.dtype} "
                        f"{tuple(bias.shape)}")
    if xp.device.type == "cpu":
        return conv_stats_plain(xp, w9, bias)
    _check_kernel_inputs(xp, w9, bias)
    lib = _library()
    h, w = hp - 2, wp - 2
    dev = xp.device
    plan = conv_plan(xp.dtype, n, h, w, ci, co, False, _sm_count(dev.index))
    y = torch.empty((n, h, w, co), dtype=xp.dtype, device=dev)
    partials = torch.empty((plan.rows, 2 * co), dtype=torch.float32, device=dev)
    sums = torch.empty((2, co), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if plan.route == "wgmma":
            _raise_on(_launch_wgmma(plan, xp, w9, bias, y, partials, False),
                      "conv_stats (wgmma)")
            err = lib.fused_convbn_reduce_rows(partials.data_ptr(), plan.rows, 2 * co,
                                               sums.data_ptr(), stream)
        else:
            err = lib.fused_convbn_conv_stats(
                xp.data_ptr(), w9.data_ptr(), bias.data_ptr(), y.data_ptr(),
                partials.data_ptr(), sums.data_ptr(), _DTYPES[xp.dtype], n, h, w,
                ci, co, plan.rows, stream)
    _raise_on(err, f"conv_stats ({plan.route})")
    LAUNCHES["conv_stats"] += 1
    ROUTES["conv_stats"][plan.route] += 1
    return y, sums


def bn_sums(y, gzp, aux, slope: float):
    """``(2, Co)`` float32 ``[sum g', sum g'·xhat]`` over all pixels, with
    ``xhat = (y - mean)·rstd``, ``yn = xhat·gamma + beta`` and
    ``g' = gz·(1 if yn >= 0 else slope)``.  ``y`` ``(N, H, W, Co)``,
    ``gzp`` ``(N, H+2, W+2, Co)`` (its centre is read), both in one dtype;
    ``aux`` ``(4, Co)`` float32 rows ``[mean, rstd, gamma, beta]``."""
    if y.dim() != 4:
        raise ValueError(f"y must be (N, H, W, Co), got {tuple(y.shape)}")
    _check_canvas("gzp", gzp, y.dtype)
    n, h, w, co = y.shape
    if tuple(gzp.shape) != (n, h + 2, w + 2, co):
        raise ValueError(f"gzp must be {(n, h + 2, w + 2, co)}, got {tuple(gzp.shape)}")
    if aux.dtype != torch.float32 or tuple(aux.shape) != (4, co):
        raise TypeError(f"aux must be float32 (4, {co}), got {aux.dtype} {tuple(aux.shape)}")
    if y.device.type == "cpu":
        return bn_sums_plain(y, gzp, aux, slope)
    _check_kernel_inputs(y, gzp, aux)
    dev = y.device
    plan = bn_sums_plan(y.dtype, n, h, w, co, _sm_count(dev.index))
    counters = _bn_sums_counters(dev.index)
    partials = torch.empty((plan.grid_x, 2 * co), dtype=torch.float32, device=dev)
    out = torch.empty((2, co), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _library().fused_convbn_bn_sums(
            y.data_ptr(), gzp.data_ptr(), aux.data_ptr(), partials.data_ptr(),
            counters.data_ptr(), counters.numel(), out.data_ptr(), _DTYPES[y.dtype],
            n, h, w, co, float(slope), plan.vec, plan.bx, plan.grid_x, plan.grid_y,
            plan.rows_per_block, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "bn_sums")
    LAUNCHES["bn_sums"] += 1
    return out


def conv_pad_out(dyp, w9t):
    """``dxp`` ``(N, H+2, W+2, Ci)``: ``conv3x3(dyp, w9t)`` in the centre and
    zeros on the border, in ``dyp``'s dtype.  ``dyp`` ``(N, H+2, W+2, Co)``,
    ``w9t`` ``(9, Co, Ci)`` (the flipped, in/out-transposed kernel)."""
    _check_canvas("dyp", dyp)
    n, hp, wp, co = dyp.shape
    _check_weights(w9t, co, dyp.dtype)
    ci = w9t.shape[2]
    if dyp.device.type == "cpu":
        return conv_pad_out_plain(dyp, w9t)
    _check_kernel_inputs(dyp, w9t)
    dev = dyp.device
    dxp = torch.empty((n, hp, wp, ci), dtype=dyp.dtype, device=dev)
    plan = conv_plan(dyp.dtype, n, hp - 2, wp - 2, co, ci, True, _sm_count(dev.index))
    with torch.cuda.device(dev):
        if plan.route == "wgmma":
            err = _launch_wgmma(plan, dyp, w9t, None, dxp, None, True)
        else:
            err = _library().fused_convbn_conv_pad_out(
                dyp.data_ptr(), w9t.data_ptr(), dxp.data_ptr(), _DTYPES[dyp.dtype],
                n, hp - 2, wp - 2, co, ci, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, f"conv_pad_out ({plan.route})")
    LAUNCHES["conv_pad_out"] += 1
    ROUTES["conv_pad_out"][plan.route] += 1
    return dxp


def weight_grad(xp, dy):
    """``dW`` ``(3, 3, Ci, Co)`` float32 of the 3x3 conv of ``xp`` ``(N, H+2,
    W+2, Ci)``, given its output cotangent ``dy`` ``(N, H, W, Co)``, both in
    the compute dtype.  Products are summed and returned in float32, as the
    JAX package's ``preferred_element_type=float32`` asks.  The library's
    weight-gradient convolution on float32 copies, as channels-last views
    of the NHWC tensors: a bfloat16 value is exact in float32 and in TF32,
    so every product is exact whichever of the two the library uses (TF32
    tensor cores add them a little less precisely than float32 does;
    ``chip_smoke.py`` measures the gap)."""
    co, ci = dy.shape[-1], xp.shape[-1]
    _, gw, _ = torch.ops.aten.convolution_backward(
        dy.float().permute(0, 3, 1, 2), xp.float().permute(0, 3, 1, 2),
        dy.new_empty((co, ci, 3, 3), dtype=torch.float32), None, [1, 1], [0, 0],
        [1, 1], False, [0, 0], 1, [False, True, False])
    return gw.permute(2, 3, 1, 0)


class _ConvBnLReLU(torch.autograd.Function):
    """Forward ``_fwd_impl`` and backward ``_bwd`` of the JAX custom VJP."""

    @staticmethod
    def forward(ctx, xp, kernel, bias, scale, beta, eps, groups, slope):
        n, hp, wp, ci = xp.shape
        co = kernel.shape[-1]
        dt = xp.dtype
        w9 = kernel.to(dt).reshape(9, ci, co).contiguous()
        y, sums = conv_stats(xp, w9, bias.float())
        cnt = n * (hp - 2) * (wp - 2) * groups
        m = _fold_groups(sums[0], groups) / cnt
        v = _fold_groups(sums[1], groups) / cnt - m.square()
        r = torch.rsqrt(v + eps)
        m_t = _tile_groups(m, groups)
        rg_t = _tile_groups(r * scale, groups)
        b_t = _tile_groups(beta, groups)
        yn = (y.float() - m_t) * rg_t + b_t
        zp = _padded(torch.where(yn >= 0, yn, yn * slope).to(dt))
        ctx.save_for_backward(xp, kernel, y, scale, beta, m, r, sums[0])
        ctx.groups, ctx.slope = groups, slope
        ctx.mark_non_differentiable(m, v)
        return zp, m, v

    @staticmethod
    def backward(ctx, gzp, _gm, _gv):
        xp, kernel, y, scale, beta, m, r, sum_y_phys = ctx.saved_tensors
        groups, slope = ctx.groups, ctx.slope
        n, h, w, co = y.shape
        ci = xp.shape[-1]
        dt = y.dtype
        cnt = n * h * w * groups

        m_t = _tile_groups(m, groups)
        r_t = _tile_groups(r, groups)
        ga_t = _tile_groups(scale, groups)
        be_t = _tile_groups(beta, groups)
        aux = torch.stack([m_t, r_t, ga_t, be_t]).float()
        gzp = gzp.to(dt).contiguous()
        sums = bn_sums(y, gzp, aux, slope)
        sum_g = _fold_groups(sums[0], groups)
        sum_gx = _fold_groups(sums[1], groups)

        # The conv-output cotangent dy, unpadded for the weight gradient and
        # padded for the dx kernel.
        gz = gzp[:, 1:-1, 1:-1, :].float()
        xhat = (y.float() - m_t) * r_t
        yn = xhat * ga_t + be_t
        gaff = gz * torch.where(yn >= 0, 1.0, slope)
        rg_t = _tile_groups(r * scale, groups)
        dy = (rg_t * (gaff - _tile_groups(sum_g / cnt, groups)
                      - xhat * _tile_groups(sum_gx / cnt, groups))).to(dt)

        dxp = None
        if ctx.needs_input_grad[0]:
            w9t = kernel.to(dt).flip((0, 1)).permute(0, 1, 3, 2).reshape(9, co, ci)
            w9t = w9t.contiguous()
            dxp = conv_pad_out(_padded(dy), w9t).to(xp.dtype)

        dkernel = None
        if ctx.needs_input_grad[1]:
            dkernel = weight_grad(xp, dy).to(kernel.dtype)

        # Conv bias gradient in closed form from the per-physical-channel sums
        # (for groups=1 BN absorbs the bias and this is roundoff around 0).
        cnt_phys = n * h * w
        sum_xhat_phys = (sum_y_phys - cnt_phys * m_t) * r_t
        dbias = rg_t * (sums[0] - cnt_phys * _tile_groups(sum_g / cnt, groups)
                        - _tile_groups(sum_gx / cnt, groups) * sum_xhat_phys)
        return dxp, dkernel, dbias, sum_gx, sum_g, None, None, None


def conv_bn_lrelu_train(xp, kernel, bias, scale, beta, eps: float,
                        groups: int, negative_slope: float):
    """Fused training-mode ConvLayer on a padded canvas.

    Args:
      xp: (N, H+2, W+2, Ci) input padded by 1 (compute dtype).
      kernel: (3, 3, Ci, Co) float32 (HWIO).
      bias: (Co,) float32 physical conv bias.
      scale/beta: (C_logical,) float32 BN affine (C_logical = Co // groups).
      eps/groups/negative_slope: constants.
    Returns:
      (zp, mean, var): zp is the (N, H+2, W+2, Co) padded output in the
      compute dtype; mean/var are the (C_logical,) float32 population
      statistics for the running-statistics update (not differentiable).
    """
    return _ConvBnLReLU.apply(xp.contiguous(), kernel, bias, scale, beta,
                              eps, groups, negative_slope)


def conv_bn_lrelu_reference(xp, kernel, bias, scale, beta, eps: float,
                            groups: int, negative_slope: float):
    """Unfused twin (library conv + reduce statistics + LeakyReLU) on the
    same padded-canvas contract; the parity oracle for the tests."""
    x = xp[:, 1:-1, 1:-1, :]
    dt = x.dtype
    y = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).to(dt),
        bias.to(dt), padding=1).permute(0, 2, 3, 1)
    c = y.shape[-1] // groups
    y_g = y.float().reshape(-1, groups, c)
    m = y_g.mean(dim=(0, 1))
    v = y_g.square().mean(dim=(0, 1)) - m.square()
    r = torch.rsqrt(v + eps)
    yn = ((y.float() - _tile_groups(m, groups)) * _tile_groups(r * scale, groups)
          + _tile_groups(beta, groups)).to(dt)
    z = torch.where(yn >= 0, yn, yn * negative_slope)
    return _padded(z), m, v
