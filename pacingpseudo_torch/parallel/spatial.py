"""Height sharding: activations split along H over a ``space`` axis.

The port of ``pacingpseudo_tpu/parallel/spatial.py``.  JAX pins the batch
to ``P('data', 'space')`` after the augmentation and lets GSPMD partition
the model and insert the halo exchanges; PyTorch has no GSPMD, so this
module writes each exchange out, on the rank group of ``parallel/mesh.py``
(a ``RankGroup`` with ``n_space > 1``: rank ``r`` holds rows ``r //
n_space`` of the batch and heights ``r % n_space`` of the image, as JAX's
``train_mesh`` lays out its devices).

* The split is taken on the **split level**: the coarsest level of the
  model (``H / output_stride`` rows) when it has a row a shard or more,
  else the coarsest finer level that does (:class:`HeightSplit`).  Its rows
  are cut into ``n_space`` contiguous runs as equal as they can be
  (:func:`height_runs`: 7, 7, 6, 6, 6 for 32 rows on 5 shards), and each
  finer level's boundaries are the split level's times its stride.  So
  every 2x2 max-pool and stride-2 conv down to the split level stays on its
  shard, and shards may be unequal: every count is summed over the ranks.
* The levels below the split level (where the coarsest level has fewer
  rows than there are shards) are **replicated**: the op that goes below
  the split level takes the whole height (:func:`gather_whole`, whose
  backward sums the shards' cotangents over the space axis and hands each
  its own rows), every coarser level is computed whole on every space
  rank, and the decoder cuts its rows again where it reaches the split
  level (:func:`own_rows`).  Each rank back-propagates only its own rows'
  loss through the replicated levels, so their parameter gradients are
  partial sums that the grid's gradient sum adds once; their BatchNorm
  statistics are one copy's, summed over the data axis only
  (``models/norm.py``).  A tensor's width names its level
  (:meth:`HeightSplit.replicated`: whether the level lies below the split
  level), and its height against the width whether it is whole
  (:meth:`HeightSplit.whole`, :func:`local_shard`): the split level's
  input to the op that goes below it is whole after the gather, and the
  transposed conv's output back at the split level is whole until
  :func:`own_rows` cuts it.
* :func:`shard_batch` cuts a batch to this rank's block, rows and heights
  (``make_spatial_constraint``'s counterpart, applied at the same point:
  after the augmentation, before the model), and returns it with its
  :class:`Shard`, the rank group and the split, which
  ``parallel.mesh.attach_ranks`` hands the modules that read across a
  shard's edge for that batch.
* :func:`halo_rows` gives a shard its ``k`` neighbouring rows above and
  below (zeros beyond the image), for a 3x3 conv of dilation ``k``; its
  backward returns each halo row's gradient to the rank that owns the row.
  ``k`` may exceed a neighbour's height: the halo then spans several.
* :func:`gather_heights` assembles the whole height of a sharded tensor
  (the memory bank's features, inference's predictions); a replicated one
  is whole already.

Every exchange is an ``all_reduce`` SUM over the space group of a
zero-filled buffer in which each rank fills its own slot (exact: one rank
alone contributes each element), the one collective that gloo runs on CUDA
tensors as well.  On NCCL ranks a train step is captured in a CUDA graph
with its exchanges (``train/graph.py``): a halo's rows are read and
written as slices of the buffer, with no index tensor to upload, and the
resize matrices are uploaded once a shape, by the eager update before the
capture (:func:`_upload`).  :func:`spatial_forward` and
:func:`shard_spatial` are the inference counterparts of JAX's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from pacingpseudo_torch.ops.resize import bilinear_resize_align_corners
from pacingpseudo_torch.parallel.mesh import RankGroup, attach_ranks


def height_runs(h_coarse: int, n_space: int) -> List[int]:
    """``h_coarse`` rows in ``n_space`` contiguous runs as equal as they can
    be, the longer ones first."""
    if n_space < 1 or h_coarse < n_space:
        raise ValueError(f"{h_coarse} coarse rows do not split over {n_space} shards")
    q, r = divmod(h_coarse, n_space)
    return [q + 1] * r + [q] * (n_space - r)


def check_split(height: int, stride: int, n_space: int) -> None:
    """Exit with a message naming the sizes where an image of ``height``
    rows cannot be height-sharded ``n_space`` ways by a model of output
    stride ``stride``.  The JAX package refuses what its UNet refuses: a
    height that is not a multiple of the output stride (a 2x2 pool of an odd
    height floors, and the decoder's upsample then misses its skip); GSPMD
    pads any other split.  The port refuses that, and a split with more
    space ranks than the image has rows, which needs more than 8 space
    ranks (the output stride is 8 or more)."""
    if height % stride:
        raise SystemExit(
            f"height sharding: an image of {height} rows at output stride {stride}: the "
            f"height must be a multiple of the output stride (the UNet's 2x2 pools halve it "
            f"{stride.bit_length() - 1} times and the decoder doubles it back)")
    if height < n_space:
        raise SystemExit(
            f"height sharding: an image of {height} rows does not split over {n_space} "
            f"space shards (each needs an image row or more)")


def split_stride(height: int, stride: int, n_space: int) -> int:
    """The stride of the split level: the coarsest level, of output stride
    ``stride``, with at least ``n_space`` rows of an image of ``height``."""
    s = stride
    while s > 1 and height // s < n_space:
        s //= 2
    return s


@dataclasses.dataclass(frozen=True)
class HeightSplit:
    """The split of an image of ``height`` rows whose split level is
    ``height // stride`` rows, cut in ``runs``; ``index`` is this rank's
    shard.  ``width``, the image's width, is set where levels below the
    split level are replicated (a level is told by its width, a whole
    tensor by its height against its width); None where the split level is
    the model's coarsest."""
    height: int
    stride: int
    runs: Tuple[int, ...]
    index: int
    width: Optional[int] = None

    @classmethod
    def of(cls, height: int, stride: int, n_space: int, index: int,
           width: Optional[int] = None) -> "HeightSplit":
        """The split of an image of ``height`` x ``width`` by a model of
        output stride ``stride``; ``width`` is needed where the coarsest
        level has fewer than ``n_space`` rows."""
        check_split(height, stride, n_space)
        s = split_stride(height, stride, n_space)
        if s < stride and width is None:
            raise ValueError(f"a split of {height} rows at output stride {stride} over "
                             f"{n_space} shards replicates the levels below stride {s}: "
                             f"it needs the image's width")
        return cls(height, s, tuple(height_runs(height // s, n_space)), index,
                   width if s < stride else None)

    def replicated(self, w_local: int) -> bool:
        """Whether a tensor ``w_local`` wide lies below the split level: it
        is then whole in height on every space rank."""
        return self.width is not None and self.width > w_local * self.stride

    def bounds(self, factor: int) -> List[int]:
        """Every shard's first row at the level ``factor`` times the split
        one, and the level's height last."""
        out = [0]
        for r in self.runs:
            out.append(out[-1] + r * factor)
        return out

    def whole(self, h_local: int, w_local: int) -> bool:
        """Whether a tensor of ``h_local`` x ``w_local`` is whole in height:
        the image's aspect (a shard has fewer rows than its level).  Only
        a split that replicates levels (``width`` set) has whole tensors."""
        return self.width is not None and h_local * self.width == self.height * w_local

    def factor(self, h_local: int) -> int:
        """The level of a shard of ``h_local`` rows: its height over the
        split level's."""
        run = self.runs[self.index]
        if h_local % run:
            raise ValueError(f"a shard of {h_local} rows is at no level of the split "
                             f"{self.runs} (shard {self.index})")
        return h_local // run

    def rows(self, factor: int = None) -> slice:
        """This shard's rows at the level ``factor`` (the image's: ``stride``)."""
        b = self.bounds(self.stride if factor is None else factor)
        return slice(b[self.index], b[self.index + 1])


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's height shard of the batch in flight: the rank group,
    whose space axis holds the other shards, and the split."""
    ranks: RankGroup
    split: HeightSplit


def local_shard(x: torch.Tensor, shard: Optional[Shard]) -> Optional[Shard]:
    """``shard`` where ``x`` is a height shard of it, None where ``x`` is
    whole: no split, a level below the split level (replicated), or a split
    level's tensor gathered whole or not yet cut (:meth:`HeightSplit.whole`)."""
    if shard is None or shard.split.whole(*x.shape[-2:]):
        return None
    return shard


def own_rows(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """This shard's rows of ``x``, a replicated tensor whose width is that of
    a level the split cuts (where the decoder reaches the split level
    again).  Differentiable: the other rows' cotangents are zero, each
    rank's own rows' loss back-propagates through the replicated levels."""
    split = shard.split
    factor = split.stride * x.shape[-1] // split.width
    b = split.bounds(factor)
    if x.shape[-2] != b[-1]:
        raise ValueError(f"a tensor {x.shape[-1]} wide of {x.shape[-2]} rows is not whole "
                         f"at its level ({b[-1]} rows)")
    return x[..., b[split.index]:b[split.index + 1], :]


class _GatherWhole(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.rows = shard, shard.split.rows(shard.split.factor(x.shape[-2]))
        return gather_heights(x, shard)

    @staticmethod
    def backward(ctx, grad):
        total = ctx.shard.ranks.sum_(grad.float().contiguous(), "space")
        return total[..., ctx.rows, :].to(grad.dtype), None


def gather_whole(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The whole height of the height shard ``x``, for an op whose output
    lies below the split level (a 2x2 pool or a stride-2 conv of the split
    level).  Differentiable: every space rank back-propagates its own rows'
    loss through the replicated levels, so the backward sums the ranks'
    cotangents over the space axis (in float32) and hands each rank its own
    rows."""
    return _GatherWhole.apply(x, shard)


def shard_batch(batch: Dict[str, torch.Tensor], ranks: RankGroup, stride: int,
                rows: bool = True) -> Tuple[Dict[str, torch.Tensor], Optional[Shard]]:
    """This rank's block of a global batch: the rows of its data index (with
    ``rows``) of every tensor, and the heights of its space index of every
    ``(N, ..., H, W)`` leaf (3 dims or more), each a contiguous copy (the
    kernels take contiguous planes); and the block's :class:`Shard`.
    Without a space axis only the rows are cut, and the shard is None."""
    if rows:
        batch = {k: ranks.local_rows(v) for k, v in batch.items()}
    if ranks.n_space == 1:
        return batch, None
    sizes = {tuple(v.shape[-2:]) for v in batch.values() if v.dim() >= 3}
    if len(sizes) != 1:
        raise ValueError(f"the batch's leaves have sizes {sorted(sizes)}")
    height, width = sizes.pop()
    split = HeightSplit.of(height, stride, ranks.n_space, ranks.space_index, width)
    keep = split.rows()
    return ({k: v[..., keep, :].contiguous() if v.dim() >= 3 else v for k, v in batch.items()},
            Shard(ranks, split))


@dataclasses.dataclass(frozen=True)
class _HaloPlan:
    """Where a shard's halo rows live in the exchange buffer.  Each rank's
    slot holds its first ``k`` rows (part 0) and last ``k`` rows (part 1),
    the latter aligned to the slot's end; ``above``/``below`` index the
    rows this shard reads (``-1``: beyond the image, zero)."""
    k: int
    n_space: int
    above: Tuple[int, ...]
    below: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def _halo_plan(split: HeightSplit, h_local: int, k: int) -> _HaloPlan:
    b = split.bounds(split.factor(h_local))
    start, stop = b[split.index], b[split.index + 1]

    def where(row):
        if row < 0 or row >= b[-1]:
            return -1
        s = max(i for i in range(len(b) - 1) if b[i] <= row)
        if row - b[s] < k:
            return (s * 2) * k + row - b[s]
        return (s * 2 + 1) * k + k - (b[s + 1] - row)

    return _HaloPlan(k, len(b) - 1, tuple(where(r) for r in range(start - k, start)),
                     tuple(where(r) for r in range(stop, stop + k)))


def _fill_slot(buf, x, plan: _HaloPlan, index: int):
    """This shard's first and last ``k`` rows into its slot of ``buf``."""
    k, h = plan.k, x.shape[-2]
    m = min(k, h)
    slot = buf[..., 2 * k * index:2 * k * (index + 1), :]
    slot[..., :m, :] = x[..., :m, :]
    slot[..., 2 * k - m:, :] = x[..., h - m:, :]


def _runs(idx: Tuple[int, ...]) -> List[Tuple[int, int, int]]:
    """``idx`` (buffer rows, ``-1`` a zero row) as ``(first, stop, rows)``
    runs: consecutive buffer rows ``[first, stop)``, or ``rows`` zero rows
    where ``first`` is -1."""
    out = []
    for i in idx:
        if out and ((i < 0 and out[-1][0] < 0)
                    or (i >= 0 and out[-1][0] >= 0 and out[-1][1] == i)):
            first, stop, n = out[-1]
            out[-1] = (first, stop + (i >= 0), n + 1)
        else:
            out.append((i, i + 1, 1) if i >= 0 else (-1, -1, 1))
    return out


def _read(buf, idx: Tuple[int, ...]):
    """The buffer rows ``idx`` (``-1`` a zero row), as slices of ``buf``:
    no index tensor, so nothing is uploaded (a CUDA graph captures it)."""
    parts = [buf[..., first:stop, :] if first >= 0 else
             buf.new_zeros((*buf.shape[:-2], n, buf.shape[-1]))
             for first, stop, n in _runs(idx)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def _write(buf, idx: Tuple[int, ...], rows):
    """``buf``'s rows ``idx`` set to ``rows``' (the rows of a ``-1`` are
    dropped): the transpose of :func:`_read`."""
    j = 0
    for first, stop, n in _runs(idx):
        if first >= 0:
            buf[..., first:stop, :] = rows[..., j:j + n, :]
        j += n


class _HaloRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, k, shard):
        ranks = shard.ranks
        plan = _halo_plan(shard.split, x.shape[-2], k)
        ctx.plan, ctx.ranks = plan, ranks
        shape = (*x.shape[:-2], 2 * k * plan.n_space, x.shape[-1])
        buf = x.new_zeros(shape, dtype=torch.float32)
        _fill_slot(buf, x.float(), plan, ranks.space_index)
        ranks.sum_(buf, "space")
        buf = buf.to(x.dtype)
        return torch.cat([_read(buf, plan.above), x, _read(buf, plan.below)], dim=-2)

    @staticmethod
    def backward(ctx, grad):
        plan, ranks = ctx.plan, ctx.ranks
        k = plan.k
        h = grad.shape[-2] - 2 * k
        buf = grad.new_zeros((*grad.shape[:-2], 2 * k * plan.n_space, grad.shape[-1]),
                             dtype=torch.float32)
        for idx, rows in ((plan.above, grad[..., :k, :]), (plan.below, grad[..., k + h:, :])):
            _write(buf, idx, rows.float())
        ranks.sum_(buf, "space")
        dx = grad[..., k:k + h, :].float()
        m = min(k, h)
        slot = buf[..., 2 * k * ranks.space_index:2 * k * (ranks.space_index + 1), :]
        dx[..., :m, :] += slot[..., :m, :]
        dx[..., h - m:, :] += slot[..., 2 * k - m:, :]
        return dx.to(grad.dtype), None, None


def halo_rows(x: torch.Tensor, k: int, shard: Shard) -> torch.Tensor:
    """This shard ``(..., h, W)`` with the ``k`` rows of the image above it
    and below it, ``(..., h + 2k, W)``: zeros beyond the image's edge.
    Differentiable: a halo row's gradient goes back to its owner's row."""
    return _HaloRows.apply(x, k, shard)


def conv2d(x, weight, bias, stride, padding, dilation, shard: Shard):
    """``F.conv2d`` of a height shard: the rows its kernel reaches on the
    neighbouring shards come by :func:`halo_rows`, the width is padded with
    zeros as usual.  A 3x3 conv of padding ``p`` reads ``p`` rows each side,
    at stride 1 (any dilation) and at stride 2 (dilation 1) alike, since
    every shard starts on an even row of a level that a stride-2 conv
    reads."""
    ph, pw = padding
    return F.conv2d(halo_rows(x, ph, shard) if ph else x, weight, bias, stride, (0, pw),
                    dilation)


@functools.lru_cache(maxsize=None)
def interp_matrix(in_size: int, out_size: int) -> torch.Tensor:
    """Dense ``(out_size, in_size)`` align-corners linear interpolation
    matrix: the port's copy of the JAX package's ``_interp_matrix``
    (``pacingpseudo_tpu/ops/resize.py:21``)."""
    import numpy as np

    w = np.zeros((out_size, in_size), np.float32)
    if out_size == 1 or in_size == 1:
        w[:, 0] = 1.0
        return torch.from_numpy(w)
    scale = (in_size - 1) / (out_size - 1)
    pos = np.arange(out_size) * scale
    lo = np.clip(np.floor(pos).astype(np.int64), 0, in_size - 2)
    frac = (pos - lo).astype(np.float32)
    w[np.arange(out_size), lo] = 1.0 - frac
    w[np.arange(out_size), lo + 1] = frac
    return torch.from_numpy(w)


def _upload(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``, made once a key by the caches below.  An upload
    from host memory cannot be captured in a CUDA graph: the eager update
    before a capture (``train/graph.py``) runs every shape the captured
    one does and fills the caches, and a miss inside a capture raises
    here rather than inside CUDA."""
    if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a resize matrix of height sharding was first needed inside "
                           "a CUDA graph capture; the eager update before it makes it")
    return t.to(device)


@functools.lru_cache(maxsize=None)
def _shard_matrix(split: HeightSplit, h_in: int, h_out: int, device) -> torch.Tensor:
    """The rows of the global height-interpolation matrix that produce this
    shard's output rows, over its input rows and one halo row each side."""
    f_in, f_out = split.factor(h_in), split.factor(h_out)
    b_in, b_out = split.bounds(f_in), split.bounds(f_out)
    a, b = b_in[split.index], b_in[split.index + 1]
    rows = interp_matrix(b_in[-1], b_out[-1])[b_out[split.index]:b_out[split.index + 1]]
    lo, hi = max(a - 1, 0), min(b + 1, b_in[-1])
    if rows[:, :lo].any() or rows[:, hi:].any():
        raise ValueError(f"an align-corners resize {b_in[-1]} -> {b_out[-1]} rows reads "
                         f"beyond one halo row of shard {split.index} of {split.runs}")
    out = torch.zeros((rows.shape[0], b - a + 2))
    out[:, lo - (a - 1):hi - (a - 1)] = rows[:, lo:hi]
    return _upload(out, device)


@functools.lru_cache(maxsize=None)
def _width_matrix(w_in: int, w_out: int, device) -> torch.Tensor:
    return _upload(interp_matrix(w_in, w_out), device)


def resize_align_corners(x, out_h: int, out_w: int, shard: Shard):
    """The align-corners bilinear resize of a height shard ``(N, C, h, W)``
    to this shard's ``out_h`` rows of the resized image: ``out_h`` and
    ``h`` are local heights of two levels of the split.  The global source
    rows of a 2x or 8x resize lie within one row of the shard's own, so one
    halo row each side and the shard's rows of the global 1-D interpolation
    matrix (:func:`interp_matrix`) compute it; the width is resized whole.
    In float32, cast back to ``x``'s dtype.  ``F.interpolate`` on the shard
    would take the shard's coordinates for the image's.  A replicated ``x``
    is resized whole and cut to the shard's rows (:func:`own_rows`)."""
    split = shard.split
    if split.whole(*x.shape[-2:]):
        # A replicated input (the aux logits at a level below the split
        # one): resized whole as one process resizes it, then cut to this
        # shard's rows where the output's level is a split one.
        if split.replicated(out_w):
            return bilinear_resize_align_corners(x, out_h, out_w)
        y = bilinear_resize_align_corners(x, split.height * out_w // split.width, out_w)
        y = own_rows(y, shard)
        if y.shape[-2] != out_h:
            raise ValueError(f"a resize to {out_h} local rows: this shard has {y.shape[-2]}")
        return y
    w_in = x.shape[-1]
    y = x.float()
    if x.shape[-2] != out_h:
        wh = _shard_matrix(shard.split, x.shape[-2], out_h, x.device)
        y = torch.einsum("oh,nchw->ncow", wh, halo_rows(y, 1, shard))
    if w_in != out_w:
        y = torch.einsum("pw,ncow->ncop", _width_matrix(w_in, out_w, x.device), y)
    return y.to(x.dtype)


def gather_heights(t: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The whole height of a ``(..., h, W)`` tensor of the height shard
    ``shard`` (None, or a replicated ``t``: ``t`` is whole): every space
    shard's rows in order, outside autograd."""
    if local_shard(t, shard) is None:
        return t.detach()
    split, index = shard.split, shard.ranks.space_index
    b = split.bounds(split.factor(t.shape[-2]))
    out = t.new_zeros((*t.shape[:-2], b[-1], t.shape[-1]))
    out[..., b[index]:b[index + 1], :] = t.detach()
    return shard.ranks.sum_(out, "space")


def shard_spatial(image: torch.Tensor, ranks: RankGroup, stride: int
                  ) -> Tuple[torch.Tensor, Optional[Shard]]:
    """This rank's heights of an ``(N, C, H, W)`` image (its rows untouched)
    and their shard: JAX's ``shard_spatial``."""
    block, shard = shard_batch({"image": image}, ranks, stride, rows=False)
    return block["image"], shard


def spatial_forward(model, ranks: RankGroup):
    """``fwd(image) -> logits`` of an ``(N, C, H, W)`` image whose rows are
    this rank's: the model runs on the rank's heights, exchanging halos over
    the space group, and the logits come back whole in height (JAX's
    ``spatial_forward``, whose output is the global array)."""
    stride = model.output_stride

    @torch.no_grad()
    def fwd(image):
        image, shard = shard_spatial(image, ranks, stride)
        attach_ranks(model, ranks, shard)
        return gather_heights(model(image)["segmentation/logits"], shard)

    return fwd
