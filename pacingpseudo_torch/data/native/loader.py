"""ctypes bindings for the native npz batch loader (``npz_loader.cpp``).

The port's counterpart of ``pacingpseudo_tpu/data/native/loader.py``, with
the same names: :func:`native_available`, :func:`load_batch_native` (one C
call fills the padded ``(N, S, S)`` float32 canvases of a whole batch in a
``std::thread`` pool, without the GIL) and :class:`NativeBatchLoader`.

The library is compiled at first use, by ``g++`` alone, into
``build/libnpz_loader-<digest>.so`` at the root of the checkout
(``build/`` is git-ignored), never into the package.  The digest covers
the source and the flags, so a library older than its source is never
loaded: after a change of the C signature the bindings below would call
mismatched code.  The compiler writes a name of its own process and the
result is renamed into place, so processes that build at once (test
workers, training ranks) never load a half-written file.  Where the
machine has no ``zlib.h``, the source declares the part of zlib it uses and
the build links ``libz.so.1`` by its full path.

When the library cannot be built, :func:`native_available` is False and
:func:`build_error` holds the compiler's message; ``BatchLoader`` then
takes the numpy route and says so once in the log.
"""
from __future__ import annotations

import ctypes
import errno
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pacingpseudo_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "npz_loader.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
# Where ``libz.so.1`` lives when the linker finds no ``libz.so``.
_LIBZ_DIRS = ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu", "/lib64",
              "/usr/lib64", "/lib", "/usr/lib", "/lib/aarch64-linux-gnu",
              "/usr/lib/aarch64-linux-gnu")


def library_path(defines: Sequence[str] = ()) -> Path:
    """The library's file: ``build/libnpz_loader-<digest of source and flags>.so``."""
    flags = " ".join((*CXX_FLAGS, *defines))
    digest = hashlib.sha256(SOURCE.read_bytes() + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libnpz_loader-{digest}.so"


def _libz_links():
    """The ways to link zlib, in order: ``-lz``, then each ``libz.so.1``
    found by its full path."""
    yield ["-lz"]
    for d in _LIBZ_DIRS:
        p = Path(d, "libz.so.1")
        if p.is_file():
            yield [str(p)]


def build(defines: Sequence[str] = ()) -> Path:
    """Compile the library unless it is built; returns its path.  Raises
    ``RuntimeError`` with the compiler's output when no link of zlib
    works.  ``defines`` (``-D`` flags) are part of the file's digest."""
    out = library_path(defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    logs = []
    for link in _libz_links():
        cmd = ["g++", *CXX_FLAGS, *defines, "-o", str(tmp), str(SOURCE), *link]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            logs.append(f"{' '.join(cmd)}: {exc}")
            break
        if proc.returncode == 0:
            os.replace(tmp, out)
            return out
        logs.append(f"{' '.join(cmd)}:\n{proc.stdout}{proc.stderr}")
    tmp.unlink(missing_ok=True)
    raise RuntimeError("g++ could not build the native npz loader:\n" + "\n".join(logs))


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built library and declare ``ppt_load_batch``'s signature."""
    lib = ctypes.CDLL(str(path))
    lib.ppt_load_batch.restype = ctypes.c_int
    lib.ppt_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """``(library, None)``, or ``(None, why it could not be built or loaded)``;
    tried once a process."""
    try:
        return open_library(build()), None
    except (RuntimeError, OSError) as exc:
        return None, str(exc)


def native_available() -> bool:
    return _library()[0] is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's message), or None."""
    return _library()[1]


def load_batch_native(paths: Sequence[str], canvas: int, ignored_index: float,
                      num_threads: int = 8, lib: Optional[ctypes.CDLL] = None
                      ) -> Dict[str, np.ndarray]:
    """The raw batch of ``paths``: ``image/label/scribble`` ``(N, canvas,
    canvas)`` float32 (image padded with 0, label and scribble with
    ``ignored_index``) and ``size`` ``(N, 2)`` int32, loaded by the C library
    (``lib``, or this process's build).  Raises naming the first file that
    failed: ``FileNotFoundError`` where it does not exist (as ``np.load``
    does), else ``RuntimeError``."""
    if lib is None:
        lib, why = _library()
        if lib is None:
            raise RuntimeError(f"native npz loader unavailable: {why}")
    n = len(paths)
    img = np.empty((n, canvas, canvas), np.float32)
    lab = np.empty((n, canvas, canvas), np.float32)
    scb = np.empty((n, canvas, canvas), np.float32)
    size = np.empty((n, 2), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    err = ctypes.create_string_buffer(1024)
    f32 = ctypes.POINTER(ctypes.c_float)
    rc = lib.ppt_load_batch(
        c_paths, n, int(canvas), 0.0, float(ignored_index),
        img.ctypes.data_as(f32), lab.ctypes.data_as(f32), scb.ctypes.data_as(f32),
        size.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(num_threads), err, len(err))
    if rc != 0:
        msg = f"native loader failed: {err.value.decode(errors='replace')}"
        if 1 <= rc <= n and not os.path.exists(paths[rc - 1]):
            raise FileNotFoundError(errno.ENOENT, msg, paths[rc - 1])
        raise RuntimeError(msg)
    return {"image": img, "label": lab, "scribble": scb, "size": size}


def uids_of(paths: Sequence[str]):
    """The slices' uids: the file names without ``.npz``, as the data
    writers name them."""
    return [os.path.splitext(os.path.basename(p))[0] for p in paths]


class NativeBatchLoader:
    """Batch iterator backed by the C library (shuffle / drop_last
    semantics of ``BatchLoader``)."""

    def __init__(self, file_ls: Sequence[str], canvas: int,
                 ignored_index: float, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, num_threads: int = 8):
        self.file_ls = list(file_ls)
        self.canvas = canvas
        self.ignored_index = ignored_index
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.num_threads = num_threads

    def __len__(self):
        n = len(self.file_ls)
        return n // self.batch_size if self.drop_last else (
            (n + self.batch_size - 1) // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.file_ls))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in range(len(self)):
            idxs = order[i * self.batch_size:(i + 1) * self.batch_size]
            paths = [self.file_ls[j] for j in idxs]
            batch = load_batch_native(paths, self.canvas, self.ignored_index,
                                      self.num_threads)
            batch["uid"] = uids_of(paths)
            yield batch
