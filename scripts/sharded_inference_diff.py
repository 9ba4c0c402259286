"""How many pixels height-sharded inference predicts differently from one card.

    python3 scripts/sharded_inference_diff.py [--train_steps 0 20] [--spatial_shards 2]

For each ``--train_steps`` count: the Experiment model at full width (the
CHAOS shape, init_ch 32) from seeded random weights, trained that many
eager steps (batch 12) on ``chip_smoke.py``'s synthetic loop pool
(``make_loop_pool``, fold 1) where the count is above 0; then
``chip_smoke.sharded_inference_diff``: ``run_inference`` in bf16 on
``chip_smoke.py``'s 384-slice test fold on one card and with
``--spatial_shards`` on as many ranks (a card each where the machine has
them, else all on ``cuda:0`` over gloo).  Prints, with the card's name and
power limit, the predicted pixels that differ in all, the slices with
any, and the most in one slice, beside ``chip_smoke.py``'s limits.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pacingpseudo_torch.ops import _build  # noqa: E402
from pacingpseudo_torch.train import checkpoint as ckpt  # noqa: E402
from pacingpseudo_torch.train import loop  # noqa: E402
from pacingpseudo_torch.train.state import create_train_state  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--train_steps", type=int, nargs="+", default=[0, 20])
    parser.add_argument("--spatial_shards", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    _build.build()
    dev = torch.device("cuda", 0)
    config = cs._experiment_config()
    kwargs = dict(input_ch=config.input_ch, init_ch=config.init_ch, max_ch=config.max_ch,
                  output_stride=config.output_stride, is_stride_conv=config.is_stride_conv,
                  is_trans_conv=config.is_trans_conv)
    plane = 256 * 256
    with tempfile.TemporaryDirectory(prefix="sharded_inference_") as root:
        cs.make_loop_pool(os.path.join(root, "pool"), config.seed)
        for steps in args.train_steps:
            run_dir = os.path.join(root, f"run{steps}")
            if steps:
                train = dataclasses.replace(config, epoch=1, ckp_interval=1, **cs.EAGER_LOOP)
                loop._train_driver(train, os.path.join(root, "pool"), run_dir,
                                   max_steps_per_epoch=steps, device=dev)
                checkpoint = os.path.join(run_dir, "ckps", "ckp_0")
            else:
                checkpoint = os.path.join(run_dir, "ckp")
                ckpt.save_checkpoint(checkpoint, create_train_state(config, device=dev,
                                                                    seed=config.seed))
            test_root = os.path.join(root, f"test{steps}")
            cs.make_test_fold(test_root, config.seed)
            one, sp, differ = cs.sharded_inference_diff(dev, test_root, kwargs, checkpoint,
                                                        args.spatial_shards)
            print(f"{smi}: {steps} training steps, spatial_shards {args.spatial_shards}: "
                  f"{sum(differ)} predicted pixels of {cs.TEST_FOLD_SLICES * plane} differ "
                  f"from one card's ({sum(differ) / (cs.TEST_FOLD_SLICES * plane):.3e} of "
                  f"them; limit {cs.SHARDED_PIXELS_MAX:g}), in "
                  f"{sum(n > 0 for n in differ)} slices, at most {max(differ)} in one "
                  f"({max(differ) / plane:.3e} of a slice; limit "
                  f"{cs.SHARDED_SLICE_PIXELS_MAX:g}); Dice {sp['dice']:.4f} on the ranks, "
                  f"{one['dice']:.4f} on one card", flush=True)


if __name__ == "__main__":
    main()
