"""Five-fold split file parsing.

The port's own copy of ``pacingpseudo_tpu/data/splits.py``.

Preserves the reference's on-disk conventions so existing data layouts work
unchanged:

* CHAOS:  ``<data_root>/chaos/train_test_split/five_fold_split/<modality>/
  {train,test}_fold<k>.txt`` with lines relative to ``<data_root>/chaos/``
  (reference: train_chaos.py:455-461, inference.py:305-313);
* ACDC / LVSC: ``<data_root>/<ds>/train_test_split/five_fold_split/
  test_fold<k>.txt`` (inference.py:300-318).
"""
from __future__ import annotations

import os
from typing import List, Tuple


def _read_list(txt_path: str, prefix: str) -> List[str]:
    with open(txt_path, "r") as f:
        lines = f.readlines()
    return [os.path.join(prefix, p.rstrip("\n")) for p in lines if p.strip()]


def _split_dir(data_root: str, dataset: str, modality: str | None) -> Tuple[str, str]:
    ds_dir = "chaos" if dataset in ("chaos", "chaost1", "chaost2") else dataset
    base = os.path.join(data_root, ds_dir, "train_test_split", "five_fold_split")
    if ds_dir == "chaos":
        if modality is None:
            modality = dataset[-2:] if dataset.startswith("chaost") else "t1"
        base = os.path.join(base, modality)
    return base, os.path.join(data_root, ds_dir)


def read_fold_split(data_root: str, dataset: str, fold: int,
                    modality: str | None = None) -> Tuple[List[str], List[str]]:
    """Return (train_files, val_files) for a fold."""
    base, prefix = _split_dir(data_root, dataset, modality)
    train = _read_list(os.path.join(base, f"train_fold{fold}.txt"), prefix)
    val = _read_list(os.path.join(base, f"test_fold{fold}.txt"), prefix)
    return train, val


def read_test_split(data_root: str, dataset: str, fold: int,
                    modality: str | None = None) -> List[str]:
    """Return the test files for a fold (inference)."""
    base, prefix = _split_dir(data_root, dataset, modality)
    return _read_list(os.path.join(base, f"test_fold{fold}.txt"), prefix)
