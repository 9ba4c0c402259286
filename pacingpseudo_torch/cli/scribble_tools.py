"""Offline scribble tooling (CLI) over a directory of slice ``.npz`` files.

The port of ``pacingpseudo_tpu/cli/scribble_tools.py``, the same argv.
The reference ships the artificial-scribble generator and the
scribble-shortening ablation as functions without a driver:

  # scribbles from dense labels (the LVSC preprocessing)
  python -m pacingpseudo_torch.cli.scribble_tools generate \\
      --in_dir data/lvsc/slices --num_classes 2 --ignored_index 2

  # shorten the scribbles to a fraction of their length (ablation)
  python -m pacingpseudo_torch.cli.scribble_tools shorten \\
      --in_dir data/chaos/slices --out_dir data/chaos/slices_50 --ratio 0.5
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from pacingpseudo_torch.tools.scribbles import delete_endpoints, generate_scribble


def cmd_generate(args):
    files = sorted(glob.glob(os.path.join(args.in_dir, "*.npz")))
    out_dir = args.out_dir or args.in_dir
    os.makedirs(out_dir, exist_ok=True)
    for path in files:
        with np.load(path) as data:
            payload = {k: data[k] for k in data.files}
        lab = payload["lab"].astype(np.int64)
        scb = generate_scribble(lab, args.num_classes, args.ignored_index)
        payload["scb"] = scb.astype(np.float32)
        np.savez(os.path.join(out_dir, os.path.basename(path)), **payload)
    print(f"generated scribbles for {len(files)} slices -> {out_dir}")


def cmd_shorten(args):
    files = sorted(glob.glob(os.path.join(args.in_dir, "*.npz")))
    os.makedirs(args.out_dir, exist_ok=True)
    for path in files:
        with np.load(path) as data:
            payload = {k: data[k] for k in data.files}
        scb = payload["scb"].astype(np.int64)
        unknown = (scb == args.ignored_index).astype(np.float64)
        new_scb = np.full_like(scb, args.ignored_index)
        # Shorten each class's scribble independently (the reference tool
        # operates per class mask, utils_shorten_scribble_length.py:32-62).
        for cls in range(args.num_classes):
            mask = (scb == cls).astype(np.float64)
            length = int(mask.sum())
            if length == 0:
                continue
            short, unknown = delete_endpoints(mask, unknown, length, args.ratio)
            new_scb[short == 1] = cls
        payload["scb"] = new_scb.astype(np.float32)
        np.savez(os.path.join(args.out_dir, os.path.basename(path)), **payload)
    print(f"shortened scribbles (ratio={args.ratio}) for {len(files)} slices "
          f"-> {args.out_dir}")


def main(argv=None):
    p = argparse.ArgumentParser(description="scribble tooling")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="fabricate scribbles from dense labels")
    g.add_argument("--in_dir", required=True)
    g.add_argument("--out_dir", default="")
    g.add_argument("--num_classes", type=int, required=True)
    g.add_argument("--ignored_index", type=int, required=True)
    g.set_defaults(fn=cmd_generate)

    s = sub.add_parser("shorten", help="shorten scribbles to a length ratio")
    s.add_argument("--in_dir", required=True)
    s.add_argument("--out_dir", required=True)
    s.add_argument("--num_classes", type=int, default=5)
    s.add_argument("--ignored_index", type=int, default=5)
    s.add_argument("--ratio", type=float, required=True)
    s.set_defaults(fn=cmd_shorten)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
