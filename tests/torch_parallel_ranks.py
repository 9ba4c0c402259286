"""Rank workers of ``tests/test_torch_port_parallel.py``.

Each runs in a process that ``parallel.mesh.spawn_ranks`` starts (so it
lives in a module without JAX, which a spawned process imports quickly),
joins a world of gloo ranks on the CPU through a ``FileStore``, computes on
the inputs the test saved with ``torch.save``, and saves what it got to
``<out>.<rank>``.
"""
import torch

from pacingpseudo_torch import losses as L
from pacingpseudo_torch.aug.engine import augment_batch
from pacingpseudo_torch.config import ExperimentConfig
from pacingpseudo_torch.data.npz_dataset import SliceDataset
from pacingpseudo_torch.models.aux_path import memory_update
from pacingpseudo_torch.models.norm import BatchNorm2d
from pacingpseudo_torch.ops.fused_loss import fused_pacing_losses
from pacingpseudo_torch.parallel import mesh
from pacingpseudo_torch.train.state import build_model, create_train_state
from pacingpseudo_torch.train.step import (_accumulate, make_chunked_train_step,
                                           make_pacing_train_step,
                                           make_resident_chunked_train_step,
                                           make_upper_bound_train_step, seed_step)


def loss_terms(inp, ranks=None):
    """Every loss with a global normaliser, on the inputs' rows of this
    rank (all of them without ``ranks``): ``{name: (loss, d loss / d
    logits)}``."""
    rows = (lambda t: t) if ranks is None else ranks.local_rows
    lw = rows(inp["logits"]).clone().requires_grad_(True)
    ls = rows(inp["logits_strong"]).clone().requires_grad_(True)
    tgt, mask = rows(inp["target"]), rows(inp["mask"])
    prob_t = torch.softmax(rows(inp["logits_strong"]), 1)
    terms = {
        "pce": lambda: L.partial_cross_entropy_loss(lw, tgt, 3, ranks),
        "ent": lambda: L.entropy_minimization_loss(lw, mask, ranks),
        "ent_nomask": lambda: L.entropy_minimization_loss(lw, None, ranks),
        "sce": lambda: L.soft_label_cross_entropy_loss(lw, prob_t, mask, ranks),
        "l1": lambda: L.l1_loss(torch.softmax(lw, 1), prob_t, mask, ranks),
        "l2": lambda: L.l2_loss(torch.softmax(lw, 1), prob_t, mask, ranks),
        "kl": lambda: L.kl_loss(lw, ls, mask, ranks),
        "kl_nomask": lambda: L.kl_loss(lw, ls, None, ranks),
        "dice": lambda: L.dice_loss_fn(lw, rows(inp["one_hot"]), ranks),
        "fused": lambda: sum(w * t for w, t in zip(
            (1.0, 0.37, 2.1), fused_pacing_losses(lw, ls, tgt, mask[:, 0], 3, ranks))),
    }
    out = {}
    for name, fn in terms.items():
        lw.grad = ls.grad = None
        loss = fn()
        loss.backward()
        out[name] = (loss.detach(), lw.grad.clone(),
                     None if ls.grad is None else ls.grad.clone())
    return out


def sync_bn(inp, ranks=None):
    """Sync BN forward and backward: ``(y, dx, dweight, dbias, running_mean,
    running_var)`` of ``sum(y * w)``."""
    rows = (lambda t: t) if ranks is None else ranks.local_rows
    bn = BatchNorm2d(inp["bn_x"].shape[1])
    bn.ranks = ranks
    x = rows(inp["bn_x"]).clone().requires_grad_(True)
    y = bn(x)
    (y * rows(inp["bn_w"])).sum().backward()
    if ranks is not None:
        ranks.sum_grads(bn.parameters())
    return (y.detach(), x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var)


def banks(inp, ranks=None):
    """``memory_update`` of the global batch in every mode: with ``ranks``
    from this rank's rows gathered in rank order, as the step gathers them."""
    feats, scb = inp["aux_features"], inp["scribble"]
    if ranks is not None:
        feats = ranks.gather_rows(ranks.local_rows(feats))
        scb = ranks.gather_rows(ranks.local_rows(scb))
    return {(ens, mode): memory_update(inp["bank"], feats, scb, step=1, max_step=4,
                                       ensemble_mode=ens, update_mode=mode)
            for ens in ("cosine_similarity", "mean") for mode in ("all", "first")}


def one_step(config_kw, sd0, batch, ranks=None):
    """One train step from ``sd0`` on the pre-augmented global ``batch``:
    ``(metrics, new state_dict, the gradients)``."""
    config = ExperimentConfig(**config_kw).validate()
    model = build_model(config, device="cpu")
    model.load_state_dict(sd0, strict=True)
    state = create_train_state(config, device="cpu", model=model)
    make = (make_upper_bound_train_step if config.session == "Upperbound"
            else make_pacing_train_step)
    metrics = make(config, 4, ranks=ranks)(state, dict(batch))
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    mesh.attach_ranks(model, None)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.clone() for k, v in model.state_dict().items()}, grads)


def augmented_rows(inp, ranks=None):
    """``augment_batch`` of the global raw batch with a seeded generator;
    with ``ranks`` this rank's rows of it."""
    from pacingpseudo_torch.aug.params import BaseAugParams, StrongAugParams
    base = BaseAugParams(crop_size=(32, 32), num_classes=3, ignored_index=3)
    out = augment_batch(inp["raw"], torch.Generator().manual_seed(11), base,
                        StrongAugParams.color(1.0), True)
    return out if ranks is None else {k: ranks.local_rows(v) for k, v in out.items()}


def pool_gather(inp, ranks):
    """The sharded pool's gather of ``inp["pool_idx"]``, and this rank's shard size."""
    ds = SliceDataset(inp["pool_files"], 3, 3)
    shard = mesh.stage_resident_pool(ds, ranks)
    got = mesh.make_resident_gather(ranks)(shard, inp["pool_idx"])
    # The keys are views of one buffer: clone them to save them apart.
    return {k: v.clone() for k, v in got.items()}, shard["image"].shape[0]


def state_tensors(state):
    """The model's state and Adam's moments (and step counts), cloned."""
    out = {f"model.{k}": v.clone() for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        for k, v in state.optimizer.state[p].items():
            out[f"opt.{name}.{k}"] = v.clone() if torch.is_tensor(v) else v
    return out


def chunk_runs(inp, ranks, paths=("resident", "streamed")):
    """A chunk of ``K`` updates on ``ranks`` and the same ``K`` updates one
    at a time, each reseeded from ``(seed, step)`` as the chunk reseeds
    them, both from ``inp["chunk_sd0"]``: ``{(path, "chunk" | "single"):
    (summed metrics, state_tensors)}``.  ``resident``: the pre-augmented
    pool ``inp["chunk_pool"]`` sharded over the data axis, index blocks
    ``inp["chunk_blocks"]`` (K, N) through ``make_resident_gather``;
    ``streamed``: the raw batches ``inp["chunk_raw"]`` stacked (K, N, ...),
    augmented inside the step."""
    from pacingpseudo_torch.aug.engine import make_train_augment_fn
    from pacingpseudo_torch.aug.params import BaseAugParams, StrongAugParams

    config = ExperimentConfig(**inp["chunk_config"]).validate()
    pool = inp["chunk_pool"]
    shard = {k: v[mesh.shard_indices(v.shape[0], ranks)] for k, v in pool.items()}
    pool_gather = mesh.make_resident_gather(ranks)
    base = BaseAugParams(crop_size=(32, 32), num_classes=3, ignored_index=3)
    augment_fn = make_train_augment_fn(base, StrongAugParams.color(1.0), True)
    out = {}
    for path in paths:
        xs = inp["chunk_blocks"] if path == "resident" else inp["chunk_raw"]
        k_steps = xs.shape[0] if path == "resident" else xs["image"].shape[0]
        for how in ("chunk", "single"):
            model = build_model(config, device="cpu")
            model.load_state_dict(inp["chunk_sd0"], strict=True)
            state = create_train_state(config, device="cpu", model=model)
            step = make_pacing_train_step(config, inp["chunk_spe"], ranks=ranks,
                                          augment_fn=None if path == "resident" else augment_fn)
            gen = torch.Generator()
            if how == "chunk" and path == "resident":
                acc = make_resident_chunked_train_step(step, k_steps, shard,
                                                       pool_gather=pool_gather)(
                    state, xs, gen, config.seed)
            elif how == "chunk":
                acc = make_chunked_train_step(step, k_steps)(state, xs, gen, config.seed)
            else:
                acc = None
                for k in range(k_steps):
                    seed_step(gen, torch.device("cpu"), config.seed, state.step)
                    batch = (pool_gather(shard, xs[k]) if path == "resident"
                             else {key: v[k] for key, v in xs.items()})
                    acc = _accumulate(acc, step(state, batch, gen))
            mesh.attach_ranks(model, None)
            out[(path, how)] = (acc, state_tensors(state))
    return out


def units(rank, devices, store, inputs, out):
    """Every unit of the test on this rank; saved to ``<out>.<rank>``."""
    torch.set_num_threads(1)
    ranks = mesh.init_rank_group(rank, devices, store)
    inp = torch.load(inputs, weights_only=False)
    res = {"world": ranks.world, "rank": ranks.rank,
           "losses": loss_terms(inp, ranks), "bn": sync_bn(inp, ranks),
           "banks": banks(inp, ranks), "aug": augmented_rows(inp, ranks),
           "pool": pool_gather(inp, ranks)}
    for name in ("pacing", "upper_bound"):
        res[name] = one_step(inp[f"{name}_config"], inp[f"{name}_sd0"],
                             inp[f"{name}_batch"], ranks)
    res["chunk"] = chunk_runs(inp, ranks)
    torch.save(res, f"{out}.{rank}")
    mesh.close_rank_group(ranks)


def loops(rank, devices, store, data_root, jobs):
    """``train.loop``'s rank body for each ``(config, run_dir)`` of ``jobs``,
    in one world (what ``loop.train_driver`` spawns for one run)."""
    from pacingpseudo_torch.train import loop

    torch.set_num_threads(1)
    ranks = mesh.init_rank_group(rank, devices, store)
    for config, run_dir in jobs:
        loop._train_driver(config, data_root, run_dir, device=devices[rank], ranks=ranks,
                           split="data mesh of 2 (of 2 devices), over gloo")
    mesh.close_rank_group(ranks)
