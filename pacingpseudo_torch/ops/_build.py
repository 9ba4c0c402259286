"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use, by ``nvcc`` alone, into ``build/lib<name>-<hash>.so`` at the root of
the checkout (``build/`` is git-ignored).  The hash covers the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded.  :func:`build` starts one ``nvcc`` per source, all at once, and
waits for every one of them.  Nothing here runs at import time: this
module imports on machines without a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("fused_loss", "warp_table", "warp_cubic", "fused_convbn", "conv_wgmma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = SOURCES) -> Tuple[float, Dict[str, str]]:
    """Compile every source of ``names`` that is not built yet.

    Returns the wall seconds taken and each compiled source's ``nvcc``
    output (``-Xptxas -v``: registers, shared memory, spills).  Raises with
    the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return time.perf_counter() - start, logs


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed.  The
    caller keeps the handle (each wrapper module caches its own)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
