"""Host-side .npz slice pipeline.

The port's own copy of the numpy / thread-pool path of
``pacingpseudo_tpu/data/npz_dataset.py``.  The reference loads one ``.npz``
per 2D slice with keys ``uid/img/lab/scb`` through DataLoader worker
processes that also run the whole augmentation chain on the CPU
(reference: chaos_dataset.py:58-105, train_chaos.py:237-238).  Here the
host does only the cheap part -- file I/O, padding to a static canvas,
batching, prefetch -- and all augmentation runs on the device
(aug/engine.py).  :class:`BatchLoader` reads a batch through the C++
loader (``data/native``: zip walk, inflate, npy parse and canvas padding
in a ``std::thread`` pool, without the GIL) where it builds, as the JAX
package's default loader does, else through numpy; ``route`` says which.
Both fill the same float32 canvases byte for byte.

Batches are "raw canvas" dicts:
    image/label/scribble: (N, S, S) float32 -- padded to the static canvas
      (image pad 0, label/scribble pad ``ignored_index``)
    size: (N, 2) int32 live extents (h, w)
and are identical for CHAOS/ACDC/LVSC: the dataset is a config axis, not a
class hierarchy.  :func:`raw_batch_to_device` moves one to the device;
training batches go up rounded by :func:`shrink_raw` (float16 image,
uint8 label/scribble), as the JAX loop uploads them.
"""
from __future__ import annotations

import concurrent.futures
import functools
import logging
import queue
import threading
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

RAW_KEYS = ("image", "label", "scribble", "size")
# Host dtypes of a raw batch, as loaded and as :func:`shrink_raw` rounds it.
FULL_DTYPES = {"image": np.float32, "label": np.float32, "scribble": np.float32,
               "size": np.int32}
SHRUNK_DTYPES = {"image": np.float16, "label": np.uint8, "scribble": np.uint8,
                 "size": np.int32}


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

    ``native`` (the default, as in the JAX package) reads each batch with
    one call of the C++ loader when its library builds; ``route`` is then
    ``"native"``, else ``"numpy"``.  A loader that asked for the native
    route and cannot have it logs the compiler's message once a process.
    """

    def __init__(self, dataset: SliceDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, num_threads: int = 8, prefetch: int = 2,
                 native: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.route = "native" if native and _native_route() else "numpy"

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
        if self.route == "native":
            from pacingpseudo_torch.data.native.loader import load_batch_native, uids_of
            paths = [self.dataset.file_ls[i] for i in idxs]
            batch = load_batch_native(paths, self.dataset.canvas_size,
                                      float(self.dataset.ignored_index),
                                      num_threads=max(1, self.num_threads))
            batch["uid"] = uids_of(paths)
            return batch
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


@functools.lru_cache(maxsize=None)
def _native_route() -> bool:
    """Whether the C++ loader's library is built and loads; the first
    time it is not, one log line with the compiler's message."""
    from pacingpseudo_torch.data.native.loader import build_error, native_available
    if native_available():
        return True
    logging.warning("native npz loader unavailable, batches take the numpy route: %s",
                    " ".join(build_error().split()))
    return False


def shrink_raw(raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The raw batch the JAX loop uploads for training (``_shrink_raw``,
    ``pacingpseudo_tpu/train/loop.py:195-208``): image float16, label and
    scribble uint8 (exact for their values), ``size`` and any other key as
    they are.  The augmentation casts back to float32 on the device; the
    image keeps float16's rounding (~1e-3 relative)."""
    out = dict(raw)
    if out["image"].dtype != np.float16:
        out["image"] = out["image"].astype(np.float16)
    for k in ("label", "scribble"):
        if k in out and out[k].dtype != np.uint8:
            out[k] = out[k].astype(np.uint8)
    return out


def raw_batch_to_device(batch: Dict[str, np.ndarray], device="cuda",
                        shrink: bool = False) -> Dict[str, torch.Tensor]:
    """Move a raw canvas batch to ``device``: ``image/label/scribble``
    (N, S, S) float32 and ``size`` (N, 2) int32, or with ``shrink`` the
    :func:`shrink_raw` dtypes (float16, uint8).  ``uid`` stays on the host
    and is not part of the result."""
    if shrink:
        batch = shrink_raw(batch)
    dtypes = SHRUNK_DTYPES if shrink else FULL_DTYPES
    out = {}
    for k in RAW_KEYS:
        a = np.ascontiguousarray(batch[k], dtype=dtypes[k])
        out[k] = torch.from_numpy(a).to(device)
    return out


def stack_to_device(batches: Sequence[Dict[str, np.ndarray]], device
                    ) -> Dict[str, torch.Tensor]:
    """``K`` raw batches rounded by :func:`shrink_raw` and stacked on a
    leading axis, ``(K, N, S, S)`` and ``size`` ``(K, N, 2)``, in one copy a
    key; from pinned memory when ``device`` is a card."""
    device = torch.device(device)
    shrunk = [shrink_raw(b) for b in batches]
    out = {}
    for k in RAW_KEYS:
        host = torch.from_numpy(np.stack([b[k] for b in shrunk]).astype(SHRUNK_DTYPES[k],
                                                                        copy=False))
        if device.type == "cuda":
            host = host.pin_memory()
        out[k] = host.to(device, non_blocking=device.type == "cuda")
    return out
