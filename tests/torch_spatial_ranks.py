"""Rank workers of ``tests/test_torch_port_spatial.py``.

Each runs in a process that ``parallel.mesh.spawn_ranks`` starts (so it
lives in a module without JAX, which a spawned process imports quickly),
joins a world of gloo ranks on the CPU through a ``FileStore``, computes on
the inputs the test saved with ``torch.save``, and saves what it got to
``<out>.<rank>``.
"""
import torch

from pacingpseudo_torch.models.aux_path import memory_update
from pacingpseudo_torch.models.unet import UNet
from pacingpseudo_torch.parallel import mesh, spatial

import torch_parallel_ranks

STRIDE = 8


def block(t, ranks, stride=STRIDE):
    """This rank's rows and heights of the global ``t``, and their shard."""
    got, shard = spatial.shard_batch({"t": t}, ranks, stride)
    return got["t"], shard


def halo_convs(inp, ranks):
    """For each ``(name, x, weight, cotangent, stride, dilation, level)`` of
    ``inp["convs"]`` (``x`` at ``level`` times the split's coarse rows):
    this rank's block of the sharded conv's output and the gradients of
    ``sum(y * cotangent)``, its block of ``dx`` and its share of
    ``dweight`` (the test sums the shares)."""
    out = {}
    for name, x, w, cot, stride, dil, level in inp["convs"]:
        cot = block(cot, ranks, level // stride)[0]
        xb, shard = block(x, ranks, level)
        xb = xb.clone().requires_grad_(True)
        wb = w.clone().requires_grad_(True)
        y = spatial.conv2d(xb, wb, None, (stride, stride), (dil, dil), (dil, dil), shard)
        (y * cot).sum().backward()
        out[name] = (y.detach(), xb.grad, wb.grad)
    return out


def resizes(inp, ranks):
    """The sharded align-corners resize of each ``(name, x, factor,
    cotangent)`` of ``inp["resizes"]``: the whole resized image (gathered)
    and this rank's block of the input gradient of ``sum(y * cotangent)``."""
    out = {}
    for name, x, factor, cot in inp["resizes"]:
        # x is at the coarse level of an image of x.shape[-2] * STRIDE rows
        split = spatial.HeightSplit.of(x.shape[-2] * STRIDE, STRIDE, ranks.n_space,
                                       ranks.space_index)
        shard = spatial.Shard(ranks, split)
        xb = ranks.local_rows(x)
        xb = xb[..., split.rows(1), :].clone().requires_grad_(True)
        y = spatial.resize_align_corners(xb, xb.shape[-2] * factor, x.shape[-1] * factor, shard)
        (y * ranks.local_rows(cot)[..., split.rows(factor), :]).sum().backward()
        out[name] = (ranks.gather_rows(spatial.gather_heights(y, shard)), xb.grad)
    return out


def forwards(inp, ranks):
    """The eval-mode UNet forward of each ``(name, state_dict, image)`` of
    ``inp["forwards"]`` on this grid (``spatial.spatial_forward``): the whole
    logits of this rank's rows."""
    out = {}
    for name, sd, image in inp["forwards"]:
        model = UNet(num_classes=inp["forward_classes"], init_ch=8, output_stride=STRIDE,
                     elab_end_points=False, **inp["forward_kw"].get(name, {}))
        model.load_state_dict(sd)
        model.eval()
        out[name] = spatial.spatial_forward(model, ranks)(ranks.local_rows(image))
    return out


def banks(inp, ranks):
    """``memory_update`` of features gathered over both axes from this
    rank's block, in every mode."""
    feats, shard = block(inp["aux_features"], ranks, 1)
    feats = spatial.gather_heights(ranks.gather_rows(feats), shard)
    return {(ens, mode): memory_update(inp["bank"], feats, inp["scribble"], step=1,
                                       max_step=4, ensemble_mode=ens, update_mode=mode)
            for ens in ("cosine_similarity", "mean") for mode in ("all", "first")}


def units(rank, devices, store, inputs, out):
    """Every unit of the test on this rank, on two grids of the 4 ranks
    (space 4, and data 2 x space 2; the chunked step on the latter); saved
    to ``<out>.<rank>``."""
    torch.set_num_threads(1)
    grids = {4: mesh.init_rank_group(rank, devices, store, 4)}
    grids[2] = mesh.make_grid(devices[rank], 2)
    inp = torch.load(inputs, weights_only=False)
    res = {"grid": {s: (g.data_index, g.space_index, g.n_data) for s, g in grids.items()}}
    for s, ranks in grids.items():
        res[s] = {"convs": halo_convs(inp, ranks), "resizes": resizes(inp, ranks),
                  "forwards": forwards(inp, ranks), "banks": banks(inp, ranks)}
    for name, s in inp["steps"]:
        res[name] = torch_parallel_ranks.one_step(inp[f"{name}_config"], inp[f"{name}_sd0"],
                                                  inp[f"{name}_batch"], grids[s])
    res["chunk"] = torch_parallel_ranks.chunk_runs(inp, grids[2], paths=("resident",))
    torch.save(res, f"{out}.{rank}")
    mesh.close_rank_group(grids[4])


def loops(rank, devices, store, n_space, data_root, jobs):
    """``train.loop``'s rank body for each ``(config, run_dir, split)`` of
    ``jobs``, in one world of ``n_space`` space ranks (what
    ``loop.train_driver`` spawns for one run)."""
    from pacingpseudo_torch.train import loop

    torch.set_num_threads(1)
    ranks = mesh.init_rank_group(rank, devices, store, n_space)
    for config, run_dir, split in jobs:
        loop._train_driver(config, data_root, run_dir, device=devices[rank], ranks=ranks,
                           split=split)
    mesh.close_rank_group(ranks)


def deep_grids(rank, devices, store):
    """Two grids of a world of 8 ranks whose split goes below the coarsest
    level: data 2 x space 4, and space 5 on ranks 0-4 (None on the
    others)."""
    import torch.distributed as dist

    grids = {4: mesh.init_rank_group(rank, devices, store, 4)}
    g5 = dist.new_group(list(range(5)))
    grids[5] = mesh.RankGroup(g5, devices[rank], 5, space_group=g5) if rank < 5 else None
    return grids


def gather_whole(unit, ranks):
    """``gather_whole`` of this rank's block of ``x`` at the split level of
    an image of ``hw`` at output ``stride`` (``unit = (hw, stride, x,
    cotangent, coarse)``), and the gradient of ``sum(y * (space index + 1) *
    cotangent)``: ``(y, dx, gather_heights of the replicated coarse
    tensor)``."""
    (height, width), stride, x, cot, coarse = unit
    split = spatial.HeightSplit.of(height, stride, ranks.n_space, ranks.space_index, width)
    shard = spatial.Shard(ranks, split)
    xb = ranks.local_rows(x)[..., split.rows(1), :].clone().requires_grad_(True)
    y = spatial.gather_whole(xb, shard)
    (y * ranks.local_rows(cot) * (ranks.space_index + 1)).sum().backward()
    return y.detach(), xb.grad, spatial.gather_heights(ranks.local_rows(coarse), shard)


def step_with_shares(inp, name, ranks):
    """``torch_parallel_ranks.one_step`` on ``ranks``, with this rank's own
    gradients before the grid's sum (in ``model.parameters()`` order)."""
    shares = []
    summed = ranks.sum_grads

    def sum_grads(params):
        params = list(params)
        shares.extend(None if p.grad is None else p.grad.clone() for p in params)
        summed(params)

    ranks.sum_grads = sum_grads
    try:
        out = torch_parallel_ranks.one_step(inp[f"{name}_config"], inp[f"{name}_sd0"],
                                            inp[f"{name}_batch"], ranks)
    finally:
        del ranks.sum_grads
    return (*out, shares)


def deep_units(rank, devices, store, inputs, out):
    """The height splits past the coarsest level's rows, on the grids of
    :func:`deep_grids`: each grid's forwards, steps and gather units, saved
    to ``<out>.<rank>``."""
    torch.set_num_threads(1)
    grids = deep_grids(rank, devices, store)
    inp = torch.load(inputs, weights_only=False)
    res = {}
    for s, ranks in grids.items():
        if ranks is None:
            continue
        res[s] = {"grid": (ranks.data_index, ranks.space_index, ranks.n_data)}
        for name, sd, image, stride, sc in inp["forwards"][s]:
            model = UNet(num_classes=inp["forward_classes"], init_ch=8, output_stride=stride,
                         is_stride_conv=sc, is_trans_conv=sc, elab_end_points=False)
            model.load_state_dict(sd)
            model.eval()
            res[s][name] = spatial.spatial_forward(model, ranks)(ranks.local_rows(image))
        for name in inp["steps"][s]:
            res[s][name] = step_with_shares(inp, name, ranks)
        if s in inp["gather"]:
            res[s]["gather"] = gather_whole(inp["gather"][s], ranks)
    torch.save(res, f"{out}.{rank}")
    mesh.close_rank_group(grids[4])
