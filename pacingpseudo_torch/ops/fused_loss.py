"""Fused weak-supervision loss: one pass over both logit fields.

The port of ``pacingpseudo_tpu/ops/pallas/fused_loss.py``.  It computes the
three pixel-wise losses of the pacing objective together:

* partial cross entropy of the weak stream against the scribble target,
  with ``ignore_index`` (reference losses/losses.py:35-43);
* entropy of the weak stream, normalised by the valid-mask sum
  (losses.py:9-24);
* soft-label cross entropy of the strong stream against the weak softmax
  (the ``ce_loss`` consistency variant, losses.py:45-62), **not** detached:
  its gradient flows into the weak stream too.

Kernels (``csrc/fused_loss.cu``, CUDA C++ for ``sm_90a``):

* ``fused_loss_fwd`` replaces ``_fwd_kernel``
  (``pacingpseudo_tpu/ops/pallas/fused_loss.py:60``): one launch on the
  partition :func:`fused_loss_plan` gives; per-block partial sums, which
  the block that ends last adds in a fixed order and turns into the losses;
* ``fused_loss_bwd`` replaces ``_bwd_kernel`` (``:96``): the analytic
  gradient of both streams in one elementwise pass.

Both are bound by device-memory bytes: each reads the two logit fields,
the target and the mask once, and the backward writes the two gradient
fields (see the source for the byte counts and the design).

Layout of every public function here: logits ``(N, C, H, W)`` float32
with each ``(H, W)`` class plane contiguous (any NCHW tensor or batch
slice of one), ``scb_target`` ``(N, H, W)`` int64 (what ``argmax``
gives), ``valid_mask`` ``(N, H, W)`` float32, contiguous.  C is 2..5.

On a CPU tensor the wrappers run the plain PyTorch versions
(:func:`forward_plain`, :func:`backward_plain`); on a CUDA tensor they
launch the kernel or raise.  ``LAUNCHES`` counts kernel launches,
``ROUTES`` the forward's by route.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from pacingpseudo_torch.ops import _build

LAUNCHES = {"fused_loss_fwd": 0, "fused_loss_bwd": 0}
# The forward's launches by route: 16-byte loads (vec 4) or scalar (vec 1).
ROUTES = {"fused_loss_fwd": {"vec4": 0, "scalar": 0}}

_THREADS = 256          # kThreads in the source
_SUMS = 5               # kSums in the source
_OUT = 11               # [5 sums, pce, ent, sce, 3 denominators]
_EPS = 1e-8
# The forward's partition: FWD_UNROLL groups of vec pixels a thread a
# pass, one wave of FWD_BLOCKS_PER_SM blocks an SM (kFwdUnroll and
# kFwdBlocksPerSm in the source).
FWD_UNROLL = 1
FWD_BLOCKS_PER_SM = 3


@dataclasses.dataclass(frozen=True)
class FusedLossPlan:
    """The forward's grid: ``grid_x`` blocks of each of the ``n`` images
    (``grid_y``), block ``bx`` taking that image's pixels ``[bx*chunk,
    min((bx+1)*chunk, hw))`` in groups of ``vec`` (4: 16-byte loads; 1:
    scalar loads)."""
    vec: int
    chunk: int
    grid_x: int
    grid_y: int


def fused_loss_plan(n: int, c: int, h: int, w: int, sm_count: int = 132,
                    aligned: bool = True) -> FusedLossPlan:
    """The partition of ``fused_loss_fwd`` over ``n`` images of ``h x w``
    pixels and ``c`` classes on a card of ``sm_count`` SMs: about
    ``FWD_BLOCKS_PER_SM`` blocks an SM, each a contiguous run of pixels of
    one image, at least one full pass of the block's groups, the run a
    multiple of the vector width.  ``vec`` is 4 where ``h*w % 4 == 0`` and
    the caller's planes are 16-byte aligned (``aligned``), else 1.  Pure:
    the tests check it on the CPU, the C entry refuses any plan that does
    not cover the pixels exactly."""
    if not 2 <= c <= 5 or n < 1 or h < 1 or w < 1:
        raise ValueError(f"no fused-loss plan for n={n} c={c} h={h} w={w}")
    hw = h * w
    vec = 4 if aligned and hw % 4 == 0 else 1
    per_image = max(1, -(-FWD_BLOCKS_PER_SM * max(sm_count, 1) // n))
    chunk = max(-(-hw // per_image), _THREADS * FWD_UNROLL * vec)
    chunk = min(-(-chunk // vec) * vec, hw)
    return FusedLossPlan(vec, chunk, -(-hw // chunk), n)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for routes in ROUTES.values():
        for route in routes:
            routes[route] = 0


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("fused_loss")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_loss_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, ll, ll, i, i, i, i, p]
    lib.fused_loss_fwd.restype = i
    lib.fused_loss_bwd.argtypes = [p, p, p, p, p, p, p, i, ll, i, ll, ll, i, i, p]
    lib.fused_loss_bwd.restype = i
    lib.fused_loss_out_size.argtypes = []
    lib.fused_loss_out_size.restype = i
    lib.fused_loss_error_string.argtypes = [i]
    lib.fused_loss_error_string.restype = ctypes.c_char_p
    if lib.fused_loss_out_size() != _OUT:
        raise RuntimeError("fused_loss library does not match this wrapper")
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_counter(index: int):
    """``fused_loss_fwd``'s ticket counter on card ``index``: zero,
    allocated once; each launch leaves it zero again.  Calls on one card
    share it, so they run on one stream at a time."""
    return torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", index))


def _aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_inputs(lw, ls, tgt, mask):
    if lw.dim() != 4 or ls.shape != lw.shape:
        raise ValueError(f"logits must be two equal (N, C, H, W) tensors, got "
                         f"{tuple(lw.shape)} and {tuple(ls.shape)}")
    n, c, h, w = lw.shape
    if not 2 <= c <= 5:
        raise ValueError(f"the fused loss takes 2..5 classes, got {c}")
    if lw.dtype != torch.float32 or ls.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {lw.dtype}, {ls.dtype}")
    if tgt.dtype != torch.int64 or tuple(tgt.shape) != (n, h, w):
        raise TypeError(f"scb_target must be int64 {(n, h, w)}, got "
                        f"{tgt.dtype} {tuple(tgt.shape)}")
    if mask.dtype != torch.float32 or tuple(mask.shape) != (n, h, w):
        raise TypeError(f"valid_mask must be float32 {(n, h, w)}, got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    if len({lw.device, ls.device, tgt.device, mask.device}) != 1:
        raise ValueError("all inputs must lie on one device")


def _check_kernel_layout(lw, ls, tgt, mask):
    if lw.device.type != "cuda":
        raise ValueError(f"the fused loss runs on cpu or cuda, not {lw.device}")
    _, _, h, w = lw.shape
    if lw.stride(3) != 1 or lw.stride(2) != w:
        raise ValueError("each (H, W) class plane of the logits must be "
                         f"contiguous, got strides {lw.stride()}")
    if ls.stride() != lw.stride():
        raise ValueError(f"weak and strong logits must share strides, got "
                         f"{lw.stride()} and {ls.stride()}")
    if not (tgt.is_contiguous() and mask.is_contiguous()):
        raise ValueError("scb_target and valid_mask must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = _library().fused_loss_error_string(err).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {err} ({msg})")


def _softmaxes(lw, ls):
    lpw = F.log_softmax(lw.float(), dim=1)
    lps = F.log_softmax(ls.float(), dim=1)
    return lpw.exp(), lpw, lps.exp(), lps


def _select(tgt, c):
    """(N, C, H, W) one-hot of ``tgt``; out-of-range targets select nothing."""
    classes = torch.arange(c, device=tgt.device).view(1, c, 1, 1)
    return (tgt.unsqueeze(1) == classes).float()


def forward_plain(logits_weak, logits_strong, scb_target, valid_mask,
                  ignore_index: int):
    """Plain PyTorch version of ``fused_loss_fwd``: the 11-float result."""
    pw, lpw, _, lps = _softmaxes(logits_weak, logits_strong)
    valid = (scb_target != ignore_index).float()
    mask = valid_mask.float()
    nll = -(_select(scb_target, pw.shape[1]) * lpw).sum(dim=1)
    ent = -(pw * lpw).sum(dim=1)
    sce = -(pw * lps).sum(dim=1)
    sums = torch.stack([(nll * valid).sum(), valid.sum(), (ent * mask).sum(),
                        (sce * mask).sum(), mask.sum()])
    cnt = sums[1].clamp_min(_EPS)
    msum = sums[4].clamp_min(_EPS)
    den = torch.stack([cnt, msum, msum])
    return torch.cat([sums, sums[[0, 2, 3]] / den, den])


def backward_plain(logits_weak, logits_strong, scb_target, valid_mask, scal,
                   ignore_index: int):
    """Plain PyTorch version of ``fused_loss_bwd``: ``(dlw, dls)``.

    ``scal`` is ``[g_pce/cnt, g_ent/msum, g_sce/msum]``.  Per pixel and
    class k:
      weak:   (p_w - 1[k=tgt])·valid·g_pce − p_w(log p_w + H)·mask·g_ent
              − p_w(log p_s + sce_pix)·mask·g_sce
      strong: (p_s − p_w)·mask·g_sce
    """
    pw, lpw, ps, lps = _softmaxes(logits_weak, logits_strong)
    valid = (scb_target != ignore_index).float().unsqueeze(1)
    mask = valid_mask.float().unsqueeze(1)
    g_pce, g_ent, g_sce = scal[0], scal[1], scal[2]
    ent_pix = -(pw * lpw).sum(dim=1, keepdim=True)
    sce_pix = -(pw * lps).sum(dim=1, keepdim=True)
    dlw = ((pw - _select(scb_target, pw.shape[1])) * valid * g_pce
           - pw * (lpw + ent_pix) * mask * g_ent
           - pw * (lps + sce_pix) * mask * g_sce)
    dls = (ps - pw) * mask * g_sce
    return dlw, dls


def forward_plan(logits_weak, logits_strong, scb_target, valid_mask
                 ) -> FusedLossPlan:
    """The plan :func:`fused_loss_forward` launches on these CUDA tensors:
    the vector route where the class planes, the target and the mask allow
    16-byte loads."""
    n, c, h, w = logits_weak.shape
    aligned = (logits_weak.stride(0) % 4 == 0 and logits_weak.stride(1) % 4 == 0
               and _aligned16(logits_weak, logits_strong, scb_target, valid_mask))
    return fused_loss_plan(n, c, h, w, _sm_count(logits_weak.device.index), aligned)


def fused_loss_forward(logits_weak, logits_strong, scb_target, valid_mask,
                       ignore_index: int):
    """The 11-float forward result ``[pce_sum, pce_cnt, ent_sum, sce_sum,
    mask_sum, pce, ent, sce, max(cnt,1e-8), max(msum,1e-8), max(msum,1e-8)]``.
    """
    _check_inputs(logits_weak, logits_strong, scb_target, valid_mask)
    if logits_weak.device.type == "cpu":
        return forward_plain(logits_weak, logits_strong, scb_target,
                             valid_mask, ignore_index)
    _check_kernel_layout(logits_weak, logits_strong, scb_target, valid_mask)
    n, c, h, w = logits_weak.shape
    dev = logits_weak.device
    s_n, s_c = logits_weak.stride(0), logits_weak.stride(1)
    plan = forward_plan(logits_weak, logits_strong, scb_target, valid_mask)
    partials = torch.empty(plan.grid_x * plan.grid_y * _SUMS,
                           dtype=torch.float32, device=dev)
    out = torch.empty(_OUT, dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.fused_loss_fwd(
            logits_weak.data_ptr(), logits_strong.data_ptr(),
            scb_target.data_ptr(), valid_mask.data_ptr(), partials.data_ptr(),
            _fwd_counter(dev.index).data_ptr(), out.data_ptr(), c, n, h * w,
            s_n, s_c, int(ignore_index), plan.vec, plan.chunk, plan.grid_x,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "fused_loss_fwd")
    LAUNCHES["fused_loss_fwd"] += 1
    ROUTES["fused_loss_fwd"]["vec4" if plan.vec == 4 else "scalar"] += 1
    return out


def fused_loss_backward(logits_weak, logits_strong, scb_target, valid_mask,
                        scal, ignore_index: int):
    """``(dlw, dls)``, contiguous ``(N, C, H, W)`` float32, from the
    device-resident scale factors ``scal = [g_pce/cnt, g_ent/msum,
    g_sce/msum]``."""
    _check_inputs(logits_weak, logits_strong, scb_target, valid_mask)
    if scal.dtype != torch.float32 or tuple(scal.shape) != (3,):
        raise TypeError(f"scal must be float32 (3,), got {scal.dtype} "
                        f"{tuple(scal.shape)}")
    if logits_weak.device.type == "cpu":
        return backward_plain(logits_weak, logits_strong, scb_target,
                              valid_mask, scal, ignore_index)
    _check_kernel_layout(logits_weak, logits_strong, scb_target, valid_mask)
    if scal.device != logits_weak.device or not scal.is_contiguous():
        raise ValueError("scal must be a contiguous tensor on the logits' device")
    n, c, h, w = logits_weak.shape
    dev = logits_weak.device
    npix = n * h * w
    dlw = torch.empty((n, c, h, w), dtype=torch.float32, device=dev)
    dls = torch.empty((n, c, h, w), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.fused_loss_bwd(
            logits_weak.data_ptr(), logits_strong.data_ptr(),
            scb_target.data_ptr(), valid_mask.data_ptr(), scal.data_ptr(),
            dlw.data_ptr(), dls.data_ptr(), c, npix, h * w,
            logits_weak.stride(0), logits_weak.stride(1), int(ignore_index),
            max(1, -(-npix // _THREADS)),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "fused_loss_bwd")
    LAUNCHES["fused_loss_bwd"] += 1
    return dlw, dls


class _FusedPacingLosses(torch.autograd.Function):
    """Kernel forward, kernel (analytic) backward.  With a rank group the
    two counts of the forward's result are summed over the ranks and the
    three losses become this rank's sums over the global denominators,
    which the backward then scales by; the kernels do not change."""

    @staticmethod
    def forward(ctx, logits_weak, logits_strong, scb_target, valid_mask,
                ignore_index, ranks):
        out = fused_loss_forward(logits_weak, logits_strong, scb_target,
                                 valid_mask, ignore_index)
        if ranks is not None:
            # slices and stacks, no index list: a list would be uploaded,
            # which a CUDA graph capture refuses
            cnt, msum = ranks.sum(out[1:5:3]).clamp_min(_EPS).unbind()
            den = torch.stack([cnt, msum, msum])
            out = torch.cat([out[:5], torch.stack([out[0], out[2], out[3]]) / den, den])
        ctx.save_for_backward(logits_weak, logits_strong, scb_target,
                              valid_mask, out)
        ctx.ignore_index = ignore_index
        return out[5], out[6], out[7]

    @staticmethod
    def backward(ctx, g_pce, g_ent, g_sce):
        logits_weak, logits_strong, scb_target, valid_mask, out = ctx.saved_tensors
        scal = torch.stack([g_pce, g_ent, g_sce]).float() / out[8:]
        dlw, dls = fused_loss_backward(logits_weak, logits_strong, scb_target,
                                       valid_mask, scal, ctx.ignore_index)
        return dlw, dls, None, None, None, None


def fused_pacing_losses(logits_weak, logits_strong, scb_target, valid_mask,
                        ignore_index: int, ranks=None):
    """``(loss_pce, loss_ent, loss_sce)`` with the reference normalisation:
    ``sum/max(cnt,1e-8)`` over non-ignored pixels for the partial CE and
    ``sum/max(sum(mask),1e-8)`` for the two masked losses.  Differentiable
    in both logit fields.  Layout and dtypes: see the module docstring.
    With ``ranks`` (a ``parallel.mesh.RankGroup``) the counts are the
    global batch's and each loss is this rank's share of the global loss."""
    return _FusedPacingLosses.apply(logits_weak, logits_strong, scb_target,
                                    valid_mask, ignore_index, ranks)
