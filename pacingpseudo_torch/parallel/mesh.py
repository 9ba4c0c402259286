"""Data-parallel training over ranks: one process a device.

The port of the data half of ``pacingpseudo_tpu/parallel/mesh.py``.  JAX
shards the batch over a ``data`` mesh inside one program and lets XLA
insert the collectives; here each rank is a process that holds a replica
of the train state on its device and the rows ``[r·N/W, (r+1)·N/W)`` of
the global batch of ``N`` (:meth:`RankGroup.rows`), and the step calls the
collectives itself.  One update over ``W`` ranks computes the function the
single-device update computes on the global batch:

* BatchNorm reduces its statistics over the global batch (sync BN,
  ``models/norm.py``), through :func:`sum_over_ranks`, whose backward sums
  the statistics' gradients over the ranks;
* every loss is this rank's sum over the global count, so the ranks'
  losses add up to the global loss and their gradients are **summed**
  (:meth:`RankGroup.sum_grads`), not averaged;
* the memory bank folds the gathered global batch in order and stays
  bit-equal on every rank; the augmentation and dropout draw for the
  global batch on every rank, and each rank keeps its rows.

Every collective is an ``all_reduce`` (SUM) or a ``broadcast``: an
all-gather is a zero-filled buffer with this rank's slot filled, summed
over the ranks, which is exact because one rank alone contributes each
element.  These two are the only collectives gloo runs on CUDA tensors,
so two ranks may share one card over gloo; across cards the backend is
NCCL, on the CPU gloo.

The group is an explicit object (:class:`RankGroup`) that the loop passes
down to the step, the losses and the model's modules
(:func:`attach_ranks`); nothing reads a process-global group.
"""
from __future__ import annotations

import datetime
import os
import sys
import traceback
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# What a rank waits for the others before it gives up.
TIMEOUT = datetime.timedelta(minutes=5)


def factor_devices(avail: int, batch_size: int) -> Tuple[int, int]:
    """Factor ``avail`` devices as ``(n_space, n_data)`` maximising
    utilisation: the JAX package's rule (``parallel/mesh.py:29-48``).

    Pure data parallelism needs ``n_data | batch_size``; where that strands
    devices (batch 12 on 8 devices uses 6), the rest goes on a ``space``
    (activation height) axis.  Preference: most devices used, then the
    smallest space factor, then the largest data axis.
    """
    best = (1, max(d for d in range(1, avail + 1) if batch_size % d == 0))
    best_used = best[0] * best[1]
    for s in range(2, avail + 1):
        if avail % s:
            continue
        d = max(dd for dd in range(1, avail // s + 1) if batch_size % dd == 0)
        if d * s > best_used:
            best, best_used = (s, d), d * s
    return best


def plan_data_parallel(avail: int, batch_size: int, spatial_shards: int) -> Tuple[int, str]:
    """The data axis of ``avail`` devices at ``batch_size``: ``(n_data,
    what was decided)``, as the JAX loop splits its devices
    (``train/loop.py:319-364``).

    ``spatial_shards`` 0 is AUTO (:func:`factor_devices`); 1 is a pure data
    mesh of the largest divisor of the batch that fits.  Height sharding
    (a ``space`` axis > 1) is not ported: a split that asks for one raises
    ``SystemExit`` rather than quietly use fewer devices.
    """
    if avail < 1:
        raise ValueError(f"no devices to split ({avail})")
    refuse = ("height sharding (a 'space' axis, parallel/spatial.py) is not ported "
              "yet; --spatial_shards 1 runs a data mesh of the largest divisor of the "
              "batch")
    if spatial_shards > 1:
        raise SystemExit(f"--spatial_shards {spatial_shards}: {refuse}")
    if spatial_shards == 0:
        n_space, n_data = factor_devices(avail, batch_size)
        if n_space > 1:
            raise SystemExit(
                f"batch {batch_size} on {avail} devices: the AUTO split is data={n_data} "
                f"x space={n_space}; {refuse}")
        return n_data, f"data mesh of {n_data} (of {avail} devices)"
    n_data = max(d for d in range(1, avail + 1) if batch_size % d == 0)
    note = f"data mesh of {n_data}"
    if n_data != avail:
        note += f" (clamped from {avail} devices: batch {batch_size} divisibility)"
    return n_data, note


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo (the CPU, or
    ranks that share a card)."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


class RankGroup:
    """One rank's view of a data-parallel world: the ``torch.distributed``
    group, ``world``, ``rank`` and this rank's ``device``."""

    def __init__(self, group, device):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = torch.device(device)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A new tensor: ``t`` summed over the ranks, outside autograd."""
        return self.sum_(t.detach().clone())

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src=src, group=self.group)
        return t

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not split over {self.world} ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.rows(t.shape[0])]

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of which ``t`` holds this rank's rows: every
        rank's rows in rank order (an all-gather as a summed zero-filled
        buffer), outside autograd."""
        out = t.new_zeros((t.shape[0] * self.world, *t.shape[1:]))
        out[self.rows(out.shape[0])] = t.detach()
        return self.sum_(out)

    def sum_grads(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Sum every parameter's gradient over the ranks, as one buffer."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = self.sum_(torch.cat([g.reshape(-1).float() for g in grads]))
        pos = 0
        for g in grads:
            g.copy_(flat[pos:pos + g.numel()].view_as(g))
            pos += g.numel()

    def sum_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each rank's share of every metric, summed: the global values."""
        names = list(metrics)
        total = self.sum(torch.stack([metrics[k].detach().float() for k in names]))
        return dict(zip(names, total.unbind()))


def init_rank_group(rank: int, devices: Sequence, store_path: str) -> RankGroup:
    """Join the world of ``len(devices)`` ranks as ``rank``, on
    ``devices[rank]``, through a ``FileStore`` at ``store_path`` (a file
    every rank reaches, absent before the first rank arrives), on the
    backend :func:`backend_for` the devices."""
    devices = [torch.device(d) for d in devices]
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(store_path, len(devices))
    dist.init_process_group(backend_for(devices), store=store, rank=rank, world_size=len(devices),
                            timeout=TIMEOUT)
    return RankGroup(dist.group.WORLD, device)


def close_rank_group(ranks: Optional[RankGroup]) -> None:
    """Leave the world after the last collective of a rank that succeeded
    (a failed rank ends its process instead: :func:`spawn_ranks`)."""
    if ranks is not None and dist.is_initialized():
        dist.destroy_process_group()


class _SumOverRanks(torch.autograd.Function):
    """``all_reduce`` SUM whose backward is an ``all_reduce`` SUM: the
    gradient of the global loss (the sum of the ranks' losses) with respect
    to one rank's contribution to a sum is the sum of every rank's
    gradient with respect to that sum."""

    @staticmethod
    def forward(ctx, t, ranks):
        ctx.ranks = ranks
        return ranks.sum(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.ranks.sum(grad), None


def sum_over_ranks(t: torch.Tensor, ranks: RankGroup) -> torch.Tensor:
    """``t`` summed over the ranks, differentiably."""
    return _SumOverRanks.apply(t, ranks)


def attach_ranks(model: torch.nn.Module, ranks: Optional[RankGroup]) -> None:
    """Give every module of ``model`` that reduces over the batch (sync
    BatchNorm, the aux path's dropout) the group; None detaches."""
    for m in model.modules():
        if hasattr(m, "ranks"):
            m.ranks = ranks


def replicate(module: torch.nn.Module, ranks: RankGroup) -> None:
    """Broadcast every parameter and buffer of ``module`` from rank 0."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            ranks.broadcast_(t.data)


def shard_indices(num_slices: int, ranks: RankGroup) -> List[int]:
    """The slices of a pool of ``num_slices`` that this rank holds: the pool
    padded to a multiple of the world by repeating its last slice, split in
    ``world`` equal runs (JAX's ``stage_resident_pool``, mesh.py:97-119).
    The padding rows are never asked for: indices stay below
    ``num_slices``."""
    per = -(-num_slices // ranks.world)
    return [min(i, num_slices - 1) for i in range(ranks.rank * per, (ranks.rank + 1) * per)]


def stage_resident_pool(ds, ranks: RankGroup):
    """This rank's shard of the training pool of the ``SliceDataset`` ``ds``
    on ``ranks.device``, rounded as the single-device pool
    (``data.resident.stage_train_pool``)."""
    from pacingpseudo_torch.data.npz_dataset import SliceDataset
    from pacingpseudo_torch.data.resident import stage_train_pool

    files = [ds.file_ls[i] for i in shard_indices(len(ds), ranks)]
    shard = SliceDataset(files, ds.num_classes, ds.ignored_index,
                         canvas_size=ds.canvas_size)
    return stage_train_pool(shard, ranks.device)


def make_resident_gather(ranks: RankGroup):
    """``gather(pool_shard, idx) -> raw batch`` over a sharded pool
    (:func:`stage_resident_pool`): the masked local lookup of JAX's
    ``make_resident_gather`` (mesh.py:146-160), then one collective that
    leaves **every** rank the whole raw batch of the global indices ``idx``
    (each rank augments the global batch).  The hits of all keys travel as
    the bytes of one buffer; each byte has one rank's contribution, so the
    sum is exact and the batch equals ``data.resident.gather`` of the
    whole pool bit for bit."""

    def gather(pool: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        per = next(iter(pool.values())).shape[0]
        loc = idx.long() - ranks.rank * per
        hit = (loc >= 0) & (loc < per)
        safe = loc.clamp(0, per - 1)
        # Widest element first, so that each key's bytes start aligned.
        names = sorted(pool, key=lambda k: -pool[k].element_size())
        parts = []
        for k in names:
            got = pool[k][safe]
            got = torch.where(hit.view(-1, *[1] * (got.dim() - 1)), got,
                              torch.zeros((), dtype=got.dtype, device=got.device))
            parts.append(got.contiguous())
        flat = ranks.sum_(torch.cat([p.view(torch.uint8).reshape(-1) for p in parts]))
        out, pos = {}, 0
        for k, p in zip(names, parts):
            nbytes = p.numel() * p.element_size()
            out[k] = flat[pos:pos + nbytes].view(p.dtype).view(p.shape)
            pos += nbytes
        return {k: out[k] for k in pool}

    return gather


def _run_rank(rank: int, fn, args: tuple) -> None:
    """A spawned rank: ``fn(rank, *args)``.  A rank that fails prints its
    traceback and ends its process at once: leaving the group cleanly
    would wait on ranks that wait in a collective for it, so ``fn`` calls
    :func:`close_rank_group` on success only."""
    try:
        fn(rank, *args)
    except BaseException:      # SystemExit of a failed check too: end the rank now
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def spawn_ranks(fn, world: int, args: tuple) -> None:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (``spawn``) and
    wait for all; a rank that fails ends at once (:func:`_run_rank`), the
    others are then terminated, and this raises."""
    import torch.multiprocessing as mp

    mp.start_processes(_run_rank, args=(fn, args), nprocs=world, join=True,
                       start_method="spawn")
