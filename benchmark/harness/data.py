"""The pool of slices a traffic mix trains and validates on, made from the seed.

The phantoms and their scribbles are frozen copies of the port's synthetic
CHAOS data (``harness/phantoms.py``): background plus one organ a
foreground class at a jittered canonical position, texture, a bias field
and distractor blobs ("hard"), and a one-pixel skeleton scribble a class.

A phantom and its scribble take ~0.2 s of host time, so a mix names how
many distinct phantoms it draws (``train_phantoms``, ``val_phantoms``),
each from seed words of its own and in ``host_processes`` worker processes
at once, and every slice of a pool is one of them under one of the eight
flips and quarter turns of the square canvas, with noise of its own added
on the device.  So every slice's image differs, the labels repeat, and
making a pool of 1,916 slices takes seconds.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, Optional

import numpy as np
import torch

from harness.phantoms import phantom_job


def _phantoms(seed: int, counts, size: int, num_classes: int, ignored_index: int,
              style: str, processes: int, meanwhile: Optional[Callable[[], None]] = None):
    """``counts[p]`` phantoms of each pool ``p`` and their scribbles, phantom
    ``i`` of pool ``p`` drawn from ``SeedSequence([seed, p, i])``: for each
    pool, image float32, label and scribble uint8, each ``(count, size,
    size)``.  ``meanwhile`` runs in this process while the workers draw.
    The spawned workers, if any, have ended on return."""
    jobs = [(np.random.SeedSequence([seed, p, i]).generate_state(4, np.uint32), size,
             num_classes, ignored_index, style) for p, n in enumerate(counts) for i in range(n)]
    if processes > 1 and len(jobs) > 1:
        with ProcessPoolExecutor(min(processes, len(jobs)),
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            futures = [ex.submit(phantom_job, job) for job in jobs]
            if meanwhile is not None:
                meanwhile()
            drawn = [f.result() for f in futures]
    else:
        if meanwhile is not None:
            meanwhile()
        drawn = [phantom_job(job) for job in jobs]
    out, pos = [], 0
    for n in counts:
        out.append(tuple(np.stack([d[k] for d in drawn[pos:pos + n]]) for k in range(3)))
        pos += n
    return out


def _dihedral(x: torch.Tensor, variant: torch.Tensor) -> torch.Tensor:
    """Each ``(S, S)`` plane of ``x`` (V, S, S) under its ``variant`` (V,):
    ``variant % 4`` quarter turns, then a flip of the rows when >= 4."""
    out = torch.empty_like(x)
    for v in range(8):
        sel = variant == v
        if not bool(sel.any()):
            continue
        y = torch.rot90(x[sel], v % 4, dims=(1, 2))
        out[sel] = torch.flip(y, dims=(1,)) if v >= 4 else y
    return out


def make_pool(mix: Dict, flags: Dict, seed: int, device,
              meanwhile: Optional[Callable[[], None]] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The mix's training and validation pools on ``device``, made from
    ``seed`` and staged as a resident run stages them: ``{"train": raw,
    "val": raw}``, each ``image`` (V, S, S) float16, ``label`` and
    ``scribble`` (V, S, S) uint8 and ``size`` (V, 2) int32.

    Slice ``i`` of a pool is distinct phantom ``i % D`` of that pool under
    dihedral variant ``(i // D) % 8``, plus Gaussian noise of
    ``mix["slice_noise"]`` of its own, added in float32 before the image is
    rounded.  The training and validation pools draw their phantoms apart.
    ``meanwhile`` runs while the phantoms are drawn."""
    size = int(flags["input_size"][0])
    c, ign = int(flags["num_classes"]), int(flags["ignored_index"])
    words = np.random.SeedSequence([seed, 0x706F6F6C]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(words[0] >> 1))
    parts = ("train", "val")
    drawn = _phantoms(seed, [int(mix[f"{p}_phantoms"]) for p in parts], size, c, ign,
                      mix["scribble_style"], int(mix["host_processes"]), meanwhile)
    out = {}
    for part, (img, lab, scb) in zip(parts, drawn):
        n, d = int(mix[f"{part}_slices"]), int(mix[f"{part}_phantoms"])
        i = torch.arange(n, device=device)
        phantom, variant = i % d, (i // d) % 8
        raw = {}
        for key, plane, dtype in (("image", img, torch.float32), ("label", lab, torch.uint8),
                                  ("scribble", scb, torch.uint8)):
            raw[key] = _dihedral(torch.from_numpy(plane).to(device=device, dtype=dtype)[phantom],
                                 variant)
        noise = torch.randn((n, size, size), generator=gen, device=device)
        raw["image"] = (raw["image"] + noise * float(mix["slice_noise"])).to(torch.float16)
        raw["size"] = torch.full((n, 2), size, dtype=torch.int32, device=device)
        out[part] = raw
    return out
