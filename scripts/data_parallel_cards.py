"""Data-parallel and height-sharded training on the cards of one machine.

    python3 scripts/data_parallel_cards.py
    python3 scripts/data_parallel_cards.py --phase space --spatial_shards 2
    python3 scripts/data_parallel_cards.py --phase graph
    python3 scripts/data_parallel_cards.py --phase deep

On one card this is ``chip_smoke.py``'s ``train (data-parallel)`` phase
alone (two ranks sharing the card over gloo); with two cards or more the
phase puts its ranks on ``cuda:0`` and ``cuda:1`` over NCCL and times the
update on them.  Before it, the single-card eager update of the same
session (full-width Experiment step, the augmentation inside) is timed: 3
warm-up and 5 timed updates, each ending in a synchronize.  ``--phase
space`` runs ``train (height-sharded)`` instead, and ``--phase graph``
``train (ranks, graph)``: the replayed update on NCCL ranks (data 2, space
2, and data 2 x space 2 with four cards) held against the eager update on
the same ranks and timed beside it, after one card's eager and replayed
update of the same session (8 timed of each, ``_time_replay_and_eager``).
``--phase deep`` runs ``train (height-sharded, past the coarse rows)``: 48x48
images at output stride 16 (3 coarse rows) on 4 space ranks, NCCL on four
cards, its loop replayed, after one card's eager update at that shape; no
loop follows it.  After the other phases, the epoch loop (2 epochs of 20 steps, the pool resident
and sharded, ``steps_per_dispatch`` 8) on every card of the machine, one
rank a card; its log must name the dispatch the ranks take.  Prints the
cards' names and power limits first.  Exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pacingpseudo_torch.aug.engine import make_train_augment_fn  # noqa: E402
from pacingpseudo_torch.ops import _build, fused_convbn, fused_loss  # noqa: E402
from pacingpseudo_torch.ops import warp_cubic, warp_table  # noqa: E402
from pacingpseudo_torch.train import loop  # noqa: E402
from pacingpseudo_torch.train.state import create_train_state  # noqa: E402
from pacingpseudo_torch.train.step import make_pacing_train_step, seed_step  # noqa: E402


def single_card_ms(config, raws, dev):
    """Median ms of 5 eager updates after 3 warm-up ones on one card."""
    state = create_train_state(config, device=dev, seed=3)
    step = make_pacing_train_step(config, 100, augment_fn=make_train_augment_fn(
        *loop._augment_params(config), True))
    gen = torch.Generator(device=dev)
    ms = []
    for i in range(8):
        seed_step(gen, dev, config.seed, state.step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, raws[i % 2], gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms[3:])


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--phase", choices=["data", "space", "graph", "deep"], default="data")
    p.add_argument("--spatial_shards", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures the cards")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    cards = torch.cuda.device_count()
    print(f"{smi}\ntorch {torch.__version__}, CUDA {torch.version.cuda}, {cards} card(s)",
          flush=True)
    print(f"build: {_build.build()[0]:.2f} s", flush=True)
    dev = torch.device("cuda", 0)
    smi = "; ".join(smi.splitlines())     # one line per card, on one line
    with tempfile.TemporaryDirectory() as root:
        raw_batches, _, config = cs.make_raw_pool(root, dev)
        raws = [next(raw_batches) for _ in range(cs.GR_TIMED)]
        raw_batches.close()
        if args.phase == "deep":
            loop_root = os.path.join(root, "loop")
            cs.make_loop_pool(loop_root, config.seed)
            print(f"launches by path: "
                  f"{cs.phase_height_sharded_deep(dev, loop_root, raws[:2], smi)}", flush=True)
            return
        augment_fn = make_train_augment_fn(*loop._augment_params(config), True)
        if args.phase == "graph":
            eager, replay, _ = cs._time_replay_and_eager(
                "single card", config, augment_fn, raws, dev,
                (fused_loss, warp_table, warp_cubic, fused_convbn))
            print(f"single card: median of {len(raws)} updates: eager {eager:.3f} ms, "
                  f"replayed {replay:.3f} ms", flush=True)
        else:
            raws = raws[:2]
            ms = single_card_ms(config, raws, dev)
            print(f"single card: median eager update {ms:.3f} ms", flush=True)
        cs._release_memory()
        loop_root = os.path.join(root, "loop")
        cs.make_loop_pool(loop_root, config.seed)
        if args.phase == "data":
            cs.phase_data_parallel(dev, loop_root, raws, smi, ms)
        elif args.phase == "space":
            print(f"launches by path: {cs.phase_height_sharded(dev, loop_root, raws, smi, ms)}",
                  flush=True)
        else:
            print(f"launches by path: "
                  f"{cs.phase_ranks_graph(dev, loop_root, raws, smi, (eager, replay))}",
                  flush=True)
        cfg = dataclasses.replace(config, epoch=cs.LOOP_EPOCHS, num_devices=cards,
                                  device_resident_data="on", ckp_interval=1,
                                  spatial_shards=args.spatial_shards)
        run_dir = os.path.join(loop_root, "runs", f"cards{cards}")
        cs._release_memory()
        t0 = time.perf_counter()
        loop.train_driver(cfg, loop_root, run_dir,
                          device=[torch.device("cuda", i) for i in range(cards)])
        log, epochs, metrics = cs._loop_epochs(run_dir)
        split = next((line for line in log.splitlines() if "data-parallel: " in line), "")
        dispatch = cs._loop_dispatch(cfg.steps_per_dispatch, "nccl")
        if cards > 1 and dispatch not in log:
            sys.exit(f"the loop on {cards} cards did not log '{dispatch}':\n{log[-2000:]}")
        print(f"loop on {cards} card(s), {split.split('data-parallel: ')[-1]}, {dispatch}: "
              f"{time.perf_counter() - t0:.1f} s with the ranks' start, epochs (s, slices/s) "
              f"{epochs}, metrics {metrics}", flush=True)


if __name__ == "__main__":
    main()
