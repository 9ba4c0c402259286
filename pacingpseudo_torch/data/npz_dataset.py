"""Host-side .npz slice pipeline.

The port's own copy of the numpy / thread-pool path of
``pacingpseudo_tpu/data/npz_dataset.py``.  The reference loads one ``.npz``
per 2D slice with keys ``uid/img/lab/scb`` through DataLoader worker
processes that also run the whole augmentation chain on the CPU
(reference: chaos_dataset.py:58-105, train_chaos.py:237-238).  Here the
host does only the cheap part -- file I/O, padding to a static canvas,
batching, prefetch -- and all augmentation runs on the device
(aug/engine.py).  The JAX package's C++ loader (``data/native``) is not
ported: :class:`BatchLoader` has no ``native`` branch.

Batches are "raw canvas" dicts:
    image/label/scribble: (N, S, S) float32 -- padded to the static canvas
      (image pad 0, label/scribble pad ``ignored_index``)
    size: (N, 2) int32 live extents (h, w)
and are identical for CHAOS/ACDC/LVSC: the dataset is a config axis, not a
class hierarchy.  :func:`raw_batch_to_device` moves one to the device.
"""
from __future__ import annotations

import concurrent.futures
import queue
import threading
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

RAW_KEYS = ("image", "label", "scribble", "size")


def load_npz_slice(path: str) -> Dict[str, np.ndarray]:
    """Read one slice file (keys ``uid/img/lab/scb``, chaos_dataset.py:92-105)."""
    with np.load(path) as data:
        return {
            "uid": str(data["uid"]),
            "image": data["img"].astype(np.float32),
            "label": data["lab"].astype(np.float32),
            "scribble": data["scb"].astype(np.float32),
        }


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SliceDataset:
    """A list of slice files + the static canvas geometry."""

    def __init__(self, file_ls: Sequence[str], num_classes: int,
                 ignored_index: int, canvas_size: Optional[int] = None):
        if not len(file_ls):
            raise ValueError("Empty file list")
        self.file_ls = list(file_ls)
        self.num_classes = num_classes
        self.ignored_index = ignored_index
        if canvas_size is None:
            # Scan a sample of files to derive the canvas: max extent rounded
            # up to a multiple of 32 (the UNet's deepest stride).
            probe = self.file_ls[:: max(1, len(self.file_ls) // 64)][:64]
            m = 0
            for p in probe:
                s = load_npz_slice(p)["image"].shape
                m = max(m, s[0], s[1])
            canvas_size = _round_up(m, 32)
        self.canvas_size = canvas_size

    def __len__(self):
        return len(self.file_ls)

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        s = load_npz_slice(self.file_ls[idx])
        h, w = s["image"].shape
        cs = self.canvas_size
        if h > cs or w > cs:
            raise ValueError(
                f"Slice {self.file_ls[idx]} ({h}x{w}) exceeds canvas {cs}")
        img = np.zeros((cs, cs), np.float32)
        lab = np.full((cs, cs), self.ignored_index, np.float32)
        scb = np.full((cs, cs), self.ignored_index, np.float32)
        img[:h, :w] = s["image"]
        lab[:h, :w] = s["label"]
        scb[:h, :w] = s["scribble"]
        return {"uid": s["uid"], "image": img, "label": lab, "scribble": scb,
                "size": np.array([h, w], np.int32)}


class BatchLoader:
    """Shuffling, batching, thread-prefetching loader over a SliceDataset.

    ``drop_last=True`` + shuffling for training (train_chaos.py:237);
    ordered, keep-last for validation (:238).  ``prefetch`` batches are
    loaded ahead by a thread pool so device steps do not wait on file I/O.
    """

    def __init__(self, dataset: SliceDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, num_threads: int = 8, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.num_threads = num_threads
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        """Pin the shuffle order to ``(seed, epoch)`` so crash+resume at
        epoch k reproduces the uninterrupted run's batch stream."""
        self.rng = np.random.RandomState([self.seed, epoch])

    def _collate(self, idxs: Sequence[int]) -> Dict[str, np.ndarray]:
        samples = [self.dataset.load(i) for i in idxs]
        batch = {k: np.stack([s[k] for s in samples]) for k in RAW_KEYS}
        batch["uid"] = [s["uid"] for s in samples]
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        n_batches = len(self)
        yield from self.batches([order[i * self.batch_size:(i + 1) * self.batch_size]
                                 for i in range(n_batches)])

    def batches(self, chunks: Sequence[Sequence[int]]
                ) -> Iterator[Dict[str, np.ndarray]]:
        """The batches of the given slice indices, one a chunk, in order,
        prefetched like the loader's own order (the epoch loop passes the
        order it shuffles itself)."""
        if self.num_threads <= 0:
            for c in chunks:
                yield self._collate(c)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # Give up when the consumer has left, instead of blocking on a
            # full queue for ever.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with concurrent.futures.ThreadPoolExecutor(self.num_threads) as pool:
                futures = [pool.submit(self._collate, c) for c in chunks]
                try:
                    for f in futures:
                        if not put(f.result()):
                            return
                    put(None)
                except Exception as exc:   # hand a load error to the consumer
                    put(exc)
                finally:
                    for g in futures:
                        g.cancel()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def raw_batch_to_device(batch: Dict[str, np.ndarray], device="cuda"
                        ) -> Dict[str, torch.Tensor]:
    """Move a raw canvas batch to ``device``: ``image/label/scribble``
    (N, S, S) float32 and ``size`` (N, 2) int32.  ``uid`` stays on the host
    and is not part of the result."""
    out = {}
    for k in RAW_KEYS:
        dtype = np.int32 if k == "size" else np.float32
        a = np.ascontiguousarray(batch[k], dtype=dtype)
        out[k] = torch.from_numpy(a).to(device)
    return out
