"""Write the pool that the JAX package's ``study_r3`` trained and evaluated on.

    python scripts/study_r3_pool_torch.py [--data_root study_torch_r3split/data]
        [--slices 1916] [--seed 1] [--scribble_style skeleton|dilated]

``study_r3`` (``scripts/quality_study.sh`` at revision ``e76e14f``) wrote its
pool with the writer of revisions ``e76e14f``-``5168465``: 1,916 ``hard``
phantoms of 256x256 (5 classes, seed 1, 1-pixel skeleton scribbles) named
``pat{i // 24:03d}_slice{i % 24:03d}``, drawn from one
``RandomState(seed)`` stream in that order, and five folds that each took
every fifth slice of that order (``test = rel_paths[fold::folds]``, the
training list the other slices in the same order).  Today's writer, the JAX
package's and the port's, draws the same phantoms and scribbles byte for
byte, but cuts whole 24-slice patients into folds; so this script writes the
slices through the port's own writer
(``pacingpseudo_torch.data.synthetic.write_synthetic_dataset``) and then
overwrites the five fold lists with the old split.  Fold 0 then holds 1,532
training and 384 test slices, the test slices from all 80 pseudo-patients, as
every ``study_r3`` ``train.log`` header and ``study_r3/summary.json`` say.

``study_r3_dilated`` (``scripts/quality_study_dilated.sh``, revisions
``8660479`` and ``1608dda``) read the writer of ``5168465`` with
``--synthetic_scribble_style dilated``: the same phantoms and split, the
scribbles stroke-width dilations of the skeleton.  ``--scribble_style
dilated`` writes that pool; today's writer draws its slices byte for byte too.

A ``r3_split`` file in the split directory marks a pool whose lists are the
old split, and names its size, seed and scribble style (a marker without a
style, as the skeleton pools were first marked, is a skeleton pool); the
trainer must then be run without ``--synthetic_data``, which would write
today's lists again (``scripts/quality_study_torch.py --r3_split`` does so).
Uses numpy and scipy only.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DATASET = "chaost1"
MODALITY = "t1"
SIZE = (256, 256)
NUM_CLASSES = 5
IGNORED_INDEX = 5
FOLDS = 5
MARK = "r3_split"
STYLES = ("skeleton", "dilated")


def split_dir(data_root: str) -> str:
    return os.path.join(data_root, "chaos", "train_test_split", "five_fold_split", MODALITY)


def r3_folds(rel_paths: List[str], folds: int = FOLDS) -> List[Tuple[List[str], List[str]]]:
    """``(train, test)`` of every fold as the old writer cut them: the test
    list every ``folds``-th path from the fold's index, the training list the
    others, both in the pool's order."""
    out = []
    for fold in range(folds):
        test = rel_paths[fold::folds]
        test_set = set(test)
        out.append(([p for p in rel_paths if p not in test_set], test))
    return out


def marker_text(num_slices: int, size: Tuple[int, int], seed: int,
                scribble_style: str = "skeleton") -> str:
    """The ``r3_split`` marker's line; a skeleton pool's as first written."""
    style = "" if scribble_style == "skeleton" else f" scribbles {scribble_style}"
    return f"{num_slices} {tuple(size)} seed {seed}{style}: test = rel_paths[fold::{FOLDS}]\n"


def read_marker(data_root: str) -> Optional[dict]:
    """``{"slices", "size", "seed", "scribble_style"}`` of the pool's marker,
    ``None`` where the split directory has none."""
    path = os.path.join(split_dir(data_root), MARK)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        text = f.read()
    m = re.match(r"(\d+) \((\d+), (\d+)\) seed (\d+)(?: scribbles (\w+))?:", text)
    if m is None:
        raise ValueError(f"{path}: not a marker of this script: {text!r}")
    return {"slices": int(m.group(1)), "size": (int(m.group(2)), int(m.group(3))),
            "seed": int(m.group(4)), "scribble_style": m.group(5) or "skeleton"}


def write_pool(data_root: str, num_slices: int = 1916, seed: int = 1,
               size: Tuple[int, int] = SIZE, scribble_style: str = "skeleton") -> List[str]:
    """Write (or keep) the phantoms and write the old fold lists; returns the
    pool's relative paths in their order."""
    from pacingpseudo_torch.data.synthetic import write_synthetic_dataset

    if scribble_style not in STYLES:
        raise ValueError(f"scribble_style {scribble_style!r} not in {STYLES}")
    rel_paths = write_synthetic_dataset(
        data_root, DATASET, num_slices, size, NUM_CLASSES, IGNORED_INDEX, folds=FOLDS,
        modality=MODALITY, seed=seed, difficulty="hard", scribble_style=scribble_style)
    base = split_dir(data_root)
    for fold, (train, test) in enumerate(r3_folds(rel_paths)):
        for name, paths in (("train", train), ("test", test)):
            with open(os.path.join(base, f"{name}_fold{fold}.txt"), "w") as f:
                f.write("\n".join(paths) + "\n")
    with open(os.path.join(base, MARK), "w") as f:
        f.write(marker_text(num_slices, size, seed, scribble_style))
    return rel_paths


def expected_fold0(num_slices: int, batch_size: int) -> Dict[str, int]:
    """Fold 0's figures for a pool of ``num_slices`` and a batch: the slices,
    the training and test slices, the pseudo-patients the test slices come
    from (the writer's naming: 24 slices a patient from 240 slices up), the
    canvas and the updates an epoch.  At 1,916 slices and batch 12 they are
    those of every ``study_r3`` and ``study_r3_dilated`` ``train.log`` header
    (``train slices=1532 val slices=384 steps/epoch=127 canvas=256``) and
    ``summary.json`` (80 patients)."""
    test = range(0, num_slices, FOLDS)
    group = 24 if num_slices >= 48 * FOLDS else max(1, num_slices // (2 * FOLDS))
    train = num_slices - len(test)
    return {"slices": num_slices, "train": train, "test": len(test),
            "patients": len({i // group for i in test}), "canvas": SIZE[0],
            "steps": train // batch_size}


def fold_identity(data_root: str, batch_size: int, fold: int = 0) -> Dict[str, int]:
    """A fold's figures as the pool on disk gives them (``expected_fold0``'s
    keys): the lists' lengths, the test slices' patients, the largest slice
    extent rounded up to 32 as the loader's canvas is."""
    import numpy as np

    base = split_dir(data_root)
    lists = {}
    for name in ("train", "test"):
        with open(os.path.join(base, f"{name}_fold{fold}.txt")) as f:
            lists[name] = f.read().split()
    extent = 0
    for rel in lists["train"] + lists["test"]:
        with np.load(os.path.join(data_root, "chaos", rel)) as z:
            extent = max(extent, *z["img"].shape[:2])
    return {"slices": len(lists["train"]) + len(lists["test"]), "train": len(lists["train"]),
            "test": len(lists["test"]),
            "patients": len({os.path.basename(p).split("_")[0] for p in lists["test"]}),
            "canvas": -(-extent // 32) * 32, "steps": len(lists["train"]) // batch_size}


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_root", default=os.path.join("study_torch_r3split", "data"))
    ap.add_argument("--slices", type=int, default=1916)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--scribble_style", default="skeleton", choices=STYLES)
    args = ap.parse_args(argv)
    rel_paths = write_pool(args.data_root, args.slices, args.seed,
                           scribble_style=args.scribble_style)
    train, test = r3_folds(rel_paths)[0]
    patients = {os.path.basename(p).split("_")[0] for p in test}
    print(f"{args.data_root}: {len(rel_paths)} slices ({args.scribble_style} scribbles); "
          f"fold 0: {len(train)} train, {len(test)} test from {len(patients)} pseudo-patients")
    return rel_paths


if __name__ == "__main__":
    main()
