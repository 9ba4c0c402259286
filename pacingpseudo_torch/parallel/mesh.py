"""Training over ranks: one process a device, on a data x space grid.

The port of ``pacingpseudo_tpu/parallel/mesh.py`` and of the grid of its
``parallel/spatial.py``.  JAX shards the batch over a ``data`` mesh axis
(and activation heights over a ``space`` axis) inside one program and lets
XLA insert the collectives; here each rank is a process that holds a
replica of the train state on its device and its block of the global batch
of ``N``: the rows ``[d·N/n_data, (d+1)·N/n_data)`` of its data index ``d``
(:meth:`RankGroup.rows`) and, with a space axis, the heights of its space
index (``parallel/spatial.py``).  The step calls the collectives itself.
One update over the ranks computes the function the single-device update
computes on the global batch:

* BatchNorm reduces its statistics over the global batch (sync BN,
  ``models/norm.py``), through :func:`sum_over_ranks`, whose backward sums
  the statistics' gradients over the ranks;
* every loss is this rank's sum over the global count (summed over the
  ranks, never taken as a rank's count times the world: height shards may
  be unequal), so the ranks' losses add up to the global loss and their
  gradients are **summed** (:meth:`RankGroup.sum_grads`), not averaged;
* the memory bank folds the gathered global batch in order and stays
  bit-equal on every rank; the augmentation and dropout draw for the
  global batch on every rank, and each rank keeps its block.

Every collective is an ``all_reduce`` (SUM) or a ``broadcast``, over the
world or over one of the two subgroups of a grid (:func:`make_grid`): an
all-gather is a zero-filled buffer with this rank's slot filled, summed
over the ranks, which is exact because one rank alone contributes each
element.  These two are the only collectives gloo runs on CUDA tensors,
so two ranks may share one card over gloo; across cards the backend is
NCCL, on the CPU gloo.

The group is an explicit object (:class:`RankGroup`) that the loop passes
down to the step, the losses and the model's modules
(:func:`attach_ranks`); nothing reads a process-global group.

Every collective on the train step's path can be captured in a CUDA graph
(``train/graph.py``) where the backend is NCCL: each is one ``all_reduce``
on tensors the step allocates on the card, with no host read and no
upload, issued in the same order on every rank.  Gloo copies CUDA tensors
through the host and cannot be captured: ranks on gloo step eagerly
(``train.step.uses_graph``).
"""
from __future__ import annotations

import datetime
import os
import sys
import traceback
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

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


def plan_data_parallel(avail: int, batch_size: int, spatial_shards: int
                       ) -> Tuple[int, int, str]:
    """The ``(n_data, n_space, what was decided)`` split of ``avail``
    devices at ``batch_size``, as the JAX loop splits its devices
    (``train/loop.py:331-351``), with JAX's log lines in the note.

    ``spatial_shards`` 0 is AUTO (:func:`factor_devices`: a ``space`` axis
    where a pure data mesh would idle devices); an explicit value is the
    space axis, clamped to the devices, and the data axis the largest
    divisor of the batch that fits beside it.
    """
    if avail < 1:
        raise ValueError(f"no devices to split ({avail})")
    notes = []
    if spatial_shards == 0:
        n_space, n_data = factor_devices(avail, batch_size)
        if n_space > 1:
            idle = avail - max(d for d in range(1, avail + 1) if batch_size % d == 0)
            notes.append(f"auto spatial fallback: batch {batch_size} on {avail} devices -> "
                         f"data={n_data} x space={n_space} (pure data mesh would idle {idle})")
        else:
            notes.append(f"data mesh of {n_data} (of {avail} devices)")
    else:
        n_space = spatial_shards
        if n_space > 1 and avail // n_space < 1:
            notes.append(f"clamping spatial_shards {n_space} -> {avail} (devices)")
            n_space = avail
        avail_data = max(avail // n_space, 1)
        n_data = max(d for d in range(1, avail_data + 1) if batch_size % d == 0)
        if n_space == 1:
            note = f"data mesh of {n_data}"
            if n_data != avail:
                note += f" (clamped from {avail} devices: batch {batch_size} divisibility)"
            notes.append(note)
        elif n_data != avail_data:
            notes.append(f"clamping data mesh {avail_data} -> {n_data} "
                         f"(batch {batch_size} divisibility)")
    if n_space > 1:
        notes.append(f"mesh data={n_data} x space={n_space}")
    return n_data, max(n_space, 1), "; ".join(notes)


def resolve_devices(device: Union[str, torch.device, Sequence], num_devices: int = 0
                    ) -> List[torch.device]:
    """The devices of a run: ``device`` (one device, or a list of cards), the
    first ``num_devices`` of them (0: all).  The CPU is one device that
    ``num_devices`` ranks may share.  A card that does not exist raises;
    there is no CPU fallback, and a run never quietly gets fewer devices
    than it asks for."""
    listed = ([torch.device(device)] if isinstance(device, (str, torch.device))
              else [torch.device(d) for d in device])
    if not listed:
        raise ValueError("no device given")
    if all(d.type == "cpu" for d in listed):
        return [torch.device("cpu")] * max(1, int(num_devices))
    for i, d in enumerate(listed):
        if d.type != "cuda":
            raise ValueError(f"a run on cards lists {d}: the devices are "
                             f"{', '.join(map(str, listed))}")
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {d}: pass the CPU explicitly")
        index = torch.cuda.current_device() if d.index is None else d.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"{d} does not exist: this machine has "
                               f"{torch.cuda.device_count()} card(s)")
        listed[i] = torch.device("cuda", index)
    if num_devices > len(listed):
        raise SystemExit(f"--num_devices {num_devices}: only {len(listed)} card(s) "
                         f"listed ({', '.join(map(str, listed))})")
    return listed[:num_devices or len(listed)]


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo (the CPU, or
    ranks that share a card)."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


class RankGroup:
    """One rank's view of a world of ``n_data x n_space`` ranks: the
    ``torch.distributed`` group, its ``backend`` (``"nccl"`` or
    ``"gloo"``), ``world``, ``rank``, this rank's ``device``, and its
    place on the grid, numbered as JAX's
    ``train_mesh`` lays out its devices (``parallel/spatial.py:42-52``):
    ``data_index = rank // n_space``, ``space_index = rank % n_space``.

    Sums run over one of three axes: ``"world"`` (BatchNorm statistics,
    loss normalisers, gradients, metrics), ``"space"`` (the ranks that
    share this rank's rows: halos and gathers along the height) and
    ``"data"`` (the ranks that share its heights: the rows of a batch and
    the sharded pool)."""

    def __init__(self, group, device, n_space: int = 1, space_group=None, data_group=None):
        self.group = group
        self.backend = str(dist.get_backend(group))
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = torch.device(device)
        if n_space < 1 or self.world % n_space:
            raise ValueError(f"{self.world} ranks do not split into a space axis of {n_space}")
        self.n_space = n_space
        self.n_data = self.world // n_space
        self.data_index, self.space_index = divmod(self.rank, n_space)
        self._groups = {"world": group,
                        "space": space_group if n_space > 1 else None,
                        "data": (data_group if n_space > 1 else group)
                        if self.n_data > 1 else None}

    def sum_(self, t: torch.Tensor, axis: str = "world") -> torch.Tensor:
        """``t`` summed over the ranks of ``axis``, in place; returns ``t``."""
        group = self._groups[axis]
        if group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def sum(self, t: torch.Tensor, axis: str = "world") -> torch.Tensor:
        """A new tensor: ``t`` summed over the ranks of ``axis``, outside
        autograd."""
        return self.sum_(t.detach().clone(), axis)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src=src, group=self.group)
        return t

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``: its data index's."""
        if n % self.n_data:
            raise ValueError(f"a batch of {n} does not split over {self.n_data} data ranks")
        per = n // self.n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.rows(t.shape[0])]

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of which ``t`` holds this rank's rows: every
        data rank's rows in order (an all-gather over the data axis as a
        summed zero-filled buffer), outside autograd."""
        out = t.new_zeros((t.shape[0] * self.n_data, *t.shape[1:]))
        out[self.rows(out.shape[0])] = t.detach()
        return self.sum_(out, "data")

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


def init_rank_group(rank: int, devices: Sequence, store_path: str,
                    n_space: int = 1) -> RankGroup:
    """Join the world of ``len(devices)`` ranks as ``rank``, on
    ``devices[rank]``, through a ``FileStore`` at ``store_path`` (a file
    every rank reaches, absent before the first rank arrives), on the
    backend :func:`backend_for` the devices, as one rank of a grid with a
    space axis of ``n_space`` (:func:`make_grid`)."""
    devices = [torch.device(d) for d in devices]
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(store_path, len(devices))
    dist.init_process_group(backend_for(devices), store=store, rank=rank,
                            world_size=len(devices), timeout=TIMEOUT)
    return make_grid(device, n_space)


def make_grid(device, n_space: int = 1) -> RankGroup:
    """This rank's :class:`RankGroup` on a grid of ``world / n_space`` data x
    ``n_space`` space ranks of the initialised world.  Every rank creates
    the space groups (one a data index) and then the data groups (one a
    space index), all in the same order, as ``dist.new_group`` requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_space < 1 or world % n_space:
        raise ValueError(f"{world} ranks do not split into a space axis of {n_space}")
    space_group = data_group = None
    if n_space > 1:
        n_data = world // n_space
        for d in range(n_data):
            g = dist.new_group([d * n_space + s for s in range(n_space)])
            if rank // n_space == d:
                space_group = g
        for s in range(n_space):
            g = dist.new_group([d * n_space + s for d in range(n_data)])
            if rank % n_space == s:
                data_group = g
    return RankGroup(dist.group.WORLD, device, n_space, space_group, data_group)


def close_rank_group(ranks: Optional[RankGroup]) -> None:
    """Leave the world after the last collective of a rank that succeeded
    (a failed rank ends its process instead: :func:`spawn_ranks`)."""
    if ranks is not None and dist.is_initialized():
        dist.destroy_process_group()


class _SumOverRanks(torch.autograd.Function):
    """``all_reduce`` SUM over an axis whose backward is an ``all_reduce``
    SUM over that axis: the gradient of the global loss (the sum of the
    ranks' losses) with respect to one rank's contribution to a sum is the
    sum of the gradients, with respect to that sum, of the ranks that
    share it."""

    @staticmethod
    def forward(ctx, t, ranks, axis):
        ctx.ranks, ctx.axis = ranks, axis
        return ranks.sum(t, axis)

    @staticmethod
    def backward(ctx, grad):
        return ctx.ranks.sum(grad, ctx.axis), None, None


def sum_over_ranks(t: torch.Tensor, ranks: RankGroup, axis: str = "world") -> torch.Tensor:
    """``t`` summed over the ranks of ``axis``, differentiably."""
    return _SumOverRanks.apply(t, ranks, axis)


def attach_ranks(model: torch.nn.Module, ranks: Optional[RankGroup], shard=None) -> None:
    """Give every module of ``model`` that reduces over the batch (sync
    BatchNorm, the aux path's dropout) the group, and every module that
    reads across a height shard's edge (the convs, the resizes) the
    ``parallel.spatial.Shard`` of the batch it is about to run (None: the
    batch is whole in height); None detaches."""
    for m in model.modules():
        if hasattr(m, "ranks"):
            m.ranks = ranks
        if hasattr(m, "shard"):
            m.shard = shard


def replicate(module: torch.nn.Module, ranks: RankGroup) -> None:
    """Broadcast every parameter and buffer of ``module`` from rank 0."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            ranks.broadcast_(t.data)


def shard_indices(num_slices: int, ranks: RankGroup) -> List[int]:
    """The slices of a pool of ``num_slices`` that this rank holds: the pool
    padded to a multiple of the data axis by repeating its last slice, split
    in ``n_data`` equal runs, the run of this rank's data index (JAX's
    ``stage_resident_pool``, mesh.py:97-119: sharded over ``data``,
    replicated across ``space``).  The padding rows are never asked for:
    indices stay below ``num_slices``."""
    per = -(-num_slices // ranks.n_data)
    d = ranks.data_index
    return [min(i, num_slices - 1) for i in range(d * per, (d + 1) * per)]


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
        loc = idx.long() - ranks.data_index * per
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
        flat = ranks.sum_(torch.cat([p.view(torch.uint8).reshape(-1) for p in parts]), "data")
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
