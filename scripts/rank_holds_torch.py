"""The rank holds of ``chip_smoke.py``, repeated on its own batches.

    python scripts/rank_holds_torch.py [--repeats 4]

``chip_smoke.py`` holds one update on ranks against the single-card eager
update three times: ``train (data-parallel)`` (2 ranks), ``train
(height-sharded)`` (space 2) and ``train (height-sharded, past the coarse
rows)`` (space 4 at 48x48, output stride 16).  Each takes its checkpoint
from one bf16 update whose rounding differs from call to call, so one
smoke run shows one draw of each hold's margin.  This script writes the
smoke's raw pool, takes the same raw batches the smoke hands those phases
(batches 54-59 of its loader, after the phases before them), and runs the
first two holds once and the third ``--repeats`` times, each from a fresh
checkpoint, through ``chip_smoke._hold_on_ranks`` itself: each line it
prints is the smoke's line for that hold, whose "nearest its bound" is the
margin.  A hold that fails ends the script non-zero, as in the smoke.

Runs on a card only: the ranks share ``cuda:0`` over gloo where the
machine has one card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# chip_smoke.py's raw batches: 1 for the augmentation, 8 each for five
# trained paths, 12 for the graph phase, 1 replayed, then 2 each for the
# data-parallel, height-sharded and past-the-coarse-rows holds.
DP_BATCH, SP_BATCH, DEEP_BATCH = 54, 56, 58


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeats", type=int, default=4,
                   help="holds past the coarse rows, each from a fresh checkpoint")
    args = p.parse_args(argv)

    import torch

    import chip_smoke as smoke
    if not torch.cuda.is_available():
        smoke._fail("no CUDA device: the rank holds run on a GPU only")
    from pacingpseudo_torch.ops import _build
    from pacingpseudo_torch.ops import fused_convbn as fc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"build: {_build.build()[0]:.2f} s", flush=True)
    fc.set_conv_impl("xla")
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="rank_holds_") as root:
        raw_batches, _, _ = smoke.make_raw_pool(os.path.join(root, "pool"), dev)
        raws = [next(raw_batches) for _ in range(DEEP_BATCH + 2)]
        raw_batches.close()
        smoke._hold_on_ranks("train (data-parallel)", dev, os.path.join(root, "dp"),
                             raws[DP_BATCH:DP_BATCH + 2], smi, 0.0, smoke.DP_WORLD)
        smoke._release_memory()
        smoke._hold_on_ranks("train (height-sharded)", dev, os.path.join(root, "sp"),
                             raws[SP_BATCH:SP_BATCH + 2], smi, 0.0, smoke.SP_WORLD,
                             smoke.SP_WORLD)
        smoke._release_memory()
        for r in range(args.repeats):
            t0 = time.perf_counter()
            smoke._hold_on_ranks(f"train (height-sharded, past the coarse rows), repeat {r}",
                                 dev, os.path.join(root, f"deep{r}"),
                                 raws[DEEP_BATCH:DEEP_BATCH + 2], smi, 0.0, smoke.DEEP_WORLD,
                                 smoke.DEEP_WORLD, smoke.DEEP_CONFIG)
            smoke._release_memory()
            print(f"repeat {r}: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
