"""Slice pools resident on the device.

The single-device counterpart of the JAX loop's resident data
(``pacingpseudo_tpu/train/loop.py:412-445``, ``parallel/mesh.py::
stage_resident_pool`` and ``make_resident_gather`` for a mesh of one): every
slice of a split is loaded once, through :class:`BatchLoader`, into device
tensors, and a step then sends only an index block; :func:`gather` picks
its raw batch out of the pool on the device.

A pool is a dict of ``image/label/scribble`` (V, S, S) and ``size`` (V, 2)
int32, in the split's order.  The training pool is rounded as the JAX loop
rounds it (:func:`~pacingpseudo_torch.data.npz_dataset.shrink_raw`:
float16 image, uint8 label/scribble), so it holds 4 bytes a canvas pixel.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pacingpseudo_torch.data.npz_dataset import (FULL_DTYPES, RAW_KEYS, SHRUNK_DTYPES,
                                                 BatchLoader, SliceDataset,
                                                 raw_batch_to_device)

# The JAX loop's budget for a resident training pool on one device
# (loop.py:414-419): "auto" stages the pool when it is smaller.
RESIDENT_BUDGET_BYTES = 6 * 2**30
STAGE_BATCH = 256
_TORCH_DTYPES = {np.float32: torch.float32, np.float16: torch.float16,
                 np.uint8: torch.uint8, np.int32: torch.int32}


def pool_bytes(num_slices: int, canvas_size: int) -> int:
    """Bytes of a rounded pool: float16 image + uint8 label + uint8 scribble."""
    return num_slices * canvas_size ** 2 * 4


def use_resident(mode: str, num_slices: int, canvas_size: int, n_data: int = 1) -> bool:
    """JAX's rule for ``device_resident_data`` (loop.py:413-423): ``"on"``,
    or ``"auto"`` with a pool under :data:`RESIDENT_BUDGET_BYTES` a device
    of the data mesh of ``n_data`` (the pool is sharded over it);
    ``"off"`` streams."""
    return mode == "on" or (mode == "auto" and pool_bytes(num_slices, canvas_size)
                            < n_data * RESIDENT_BUDGET_BYTES)


def stage_pool(ds: SliceDataset, device, shrink: bool) -> Dict[str, torch.Tensor]:
    """Every slice of ``ds`` on ``device``, in order; rounded by
    ``shrink_raw`` when ``shrink``, else float32 canvases."""
    dtypes = SHRUNK_DTYPES if shrink else FULL_DTYPES
    n, s = len(ds), ds.canvas_size
    pool = {k: torch.empty((n, 2) if k == "size" else (n, s, s),
                           dtype=_TORCH_DTYPES[dtypes[k]], device=device)
            for k in RAW_KEYS}
    pos = 0
    for batch in BatchLoader(ds, batch_size=STAGE_BATCH, shuffle=False, drop_last=False):
        part = raw_batch_to_device(batch, device, shrink=shrink)
        m = part["image"].shape[0]
        for k in RAW_KEYS:
            pool[k][pos:pos + m].copy_(part[k])
        pos += m
    return pool


def stage_train_pool(train_ds: SliceDataset, device) -> Dict[str, torch.Tensor]:
    """The training pool: every training slice once, rounded as the JAX
    loop stages it (loop.py:425-432)."""
    return stage_pool(train_ds, device, shrink=True)


def gather(pool: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The raw batch of the slices ``idx`` (N,) int32, on the pool's
    device: ``jnp.take(v, idx, axis=0)`` of every key, as JAX's
    single-device ``make_resident_gather``.  Each batch keeps its pool's
    memory layout (``index_select`` would make it contiguous), so a step
    adds in the order it would on a batch the loader handed over in that
    layout."""
    return {k: v[idx] for k, v in pool.items()}
