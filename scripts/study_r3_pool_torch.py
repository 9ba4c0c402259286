"""Write the pool that the JAX package's ``study_r3`` trained and evaluated on.

    python scripts/study_r3_pool_torch.py [--data_root study_torch_r3split/data]
        [--slices 1916] [--seed 1]

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

A ``r3_split`` file in the split directory marks a pool whose lists are the
old split; the trainer must then be run without ``--synthetic_data``, which
would write today's lists again (``scripts/quality_study_torch.py --r3_split``
does so).  Uses numpy and scipy only.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Tuple

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


def write_pool(data_root: str, num_slices: int = 1916, seed: int = 1,
               size: Tuple[int, int] = SIZE) -> List[str]:
    """Write (or keep) the phantoms and write the old fold lists; returns the
    pool's relative paths in their order."""
    from pacingpseudo_torch.data.synthetic import write_synthetic_dataset

    rel_paths = write_synthetic_dataset(
        data_root, DATASET, num_slices, size, NUM_CLASSES, IGNORED_INDEX, folds=FOLDS,
        modality=MODALITY, seed=seed, difficulty="hard", scribble_style="skeleton")
    base = split_dir(data_root)
    for fold, (train, test) in enumerate(r3_folds(rel_paths)):
        for name, paths in (("train", train), ("test", test)):
            with open(os.path.join(base, f"{name}_fold{fold}.txt"), "w") as f:
                f.write("\n".join(paths) + "\n")
    with open(os.path.join(base, MARK), "w") as f:
        f.write(f"{num_slices} {size} seed {seed}: test = rel_paths[fold::{FOLDS}]\n")
    return rel_paths


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_root", default=os.path.join("study_torch_r3split", "data"))
    ap.add_argument("--slices", type=int, default=1916)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    rel_paths = write_pool(args.data_root, args.slices, args.seed)
    train, test = r3_folds(rel_paths)[0]
    patients = {os.path.basename(p).split("_")[0] for p in test}
    print(f"{args.data_root}: {len(rel_paths)} slices; fold 0: {len(train)} train, "
          f"{len(test)} test from {len(patients)} pseudo-patients")
    return rel_paths


if __name__ == "__main__":
    main()
