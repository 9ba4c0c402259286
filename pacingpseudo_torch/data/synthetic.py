"""Synthetic dataset fixtures: random geometric phantoms + skeleton scribbles.

The port's own copy of ``pacingpseudo_tpu/data/synthetic.py`` (numpy and
scipy only): the same seed writes the same files.  Serves the parity tests
and the end-to-end smoke paths when no real data is mounted.  Each slice is
a CHAOS-style ``.npz`` with keys ``uid/img/lab/scb`` (chaos_dataset.py:92-105):
random soft-intensity ellipse "organs" per foreground class, the dense label,
and an artificial scribble built with tools/scribbles.py (the same recipe the
reference uses to fabricate LVSC scribbles).
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from pacingpseudo_torch.tools.scribbles import generate_scribble


def shorten_scribbles(scb: np.ndarray, num_classes: int, ignored_index: int,
                      ratio: float) -> np.ndarray:
    """Per-class scribble shortening (the reference's own ablation knob,
    utils_shorten_scribble_length.py): keep ``ratio`` of each stroke's
    pixels, eroding from the endpoints; removed pixels become unknown."""
    from pacingpseudo_torch.tools.scribbles import delete_endpoints

    out = scb.copy()
    for c in range(num_classes):
        m = (scb == c).astype(np.float64)
        length = int(m.sum())
        if length == 0:
            continue
        short, _ = delete_endpoints(m, np.zeros_like(m), length, ratio)
        out[(m > 0) & (short == 0)] = ignored_index
    return out


def _smooth_field(rng, h, w, scale, amp):
    """Band-limited random field in [-amp, amp] (coarse noise, cubic zoom)."""
    import scipy.ndimage as ndi
    gh, gw = max(h // scale, 2), max(w // scale, 2)
    g = rng.randn(gh, gw)
    f = ndi.zoom(g, (h / gh + 1e-9, w / gw + 1e-9), order=3)[:h, :w]
    if f.shape != (h, w):  # zoom rounding
        out = np.zeros((h, w))
        out[: f.shape[0], : f.shape[1]] = f
        f = out
    return (f / (np.abs(f).max() + 1e-6)) * amp


def _ellipse_mask(yy, xx, cy, cx, ry, rx, theta):
    dy = (yy - cy) * np.cos(theta) + (xx - cx) * np.sin(theta)
    dx = -(yy - cy) * np.sin(theta) + (xx - cx) * np.cos(theta)
    return (dy / ry) ** 2 + (dx / rx) ** 2 <= 1.0


def _blob_mask(yy, xx, cy, cx, r0, rng, waviness=0.45, harmonics=(2, 7)):
    """Star-deformed blob: radius r0·(1 + w·Σ sin(kθ+φ)/k) — non-convex
    organ boundaries whose extent scribble supervision alone
    underconstrains (the regime knob for the pacing-wins hunt)."""
    th = np.arctan2(yy - cy, xx - cx)
    rad = np.hypot(yy - cy, xx - cx)
    pert = np.zeros_like(th)
    for k in range(*harmonics):
        pert += rng.uniform(-1.0, 1.0) / k * np.sin(
            k * th + rng.uniform(0, 2 * np.pi))
    return rad <= r0 * (1.0 + waviness * pert)


def make_phantom(rng: np.random.RandomState, size: Tuple[int, int],
                 num_classes: int, difficulty: str = "easy"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic slice: background + (num_classes-1) elliptical organs.

    ``difficulty``:
      * "easy" — each class has a distinct intensity bump (the small
        fixtures; intensity alone nearly identifies the class).
      * "hard" — anatomy-like task for the quality study: every organ
        draws its mean intensity from the SAME distribution (classes are
        not intensity-separable), each class instead owns a canonical
        image position (jittered), organs carry smooth texture, a global
        bias field and heavier noise corrupt the image, and 2-3
        organ-like DISTRACTOR blobs belong to the background — so
        segmentation requires shape/position context, leaving room for
        the consistency/pseudo-label machinery to matter (the regime the
        reference's +0.26 DSC gap lives in, README.md:114-115).
      * "jagged" — "hard" with star-deformed non-convex organ boundaries
        (_blob_mask): many more boundary pixels per organ, so sparse
        scribbles underconstrain extent — the knob family for the
        pacing-wins regime hunt.
    """
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    lab = np.zeros((h, w), np.int32)

    if difficulty == "easy":
        img = rng.randn(h, w).astype(np.float32) * 0.05
        for c in range(1, num_classes):
            mask = _ellipse_mask(
                yy, xx, rng.uniform(0.25 * h, 0.75 * h),
                rng.uniform(0.25 * w, 0.75 * w),
                rng.uniform(0.06 * h, 0.16 * h),
                rng.uniform(0.06 * w, 0.16 * w), rng.uniform(0, np.pi))
            lab[mask] = c
            img[mask] += 0.4 + 0.4 * c / num_classes
        img += rng.randn(h, w).astype(np.float32) * 0.02
        return img.astype(np.float32), lab

    assert difficulty in ("hard", "jagged"), difficulty
    jagged = difficulty == "jagged"
    img = rng.randn(h, w) * 0.05 + _smooth_field(rng, h, w, 32, 0.25)
    n_fg = max(num_classes - 1, 1)
    for c in range(1, num_classes):
        ang = 2 * np.pi * (c - 1) / n_fg + rng.uniform(-0.35, 0.35)
        cy = h * (0.5 + 0.22 * np.sin(ang)) + rng.uniform(-0.06, 0.06) * h
        cx = w * (0.5 + 0.22 * np.cos(ang)) + rng.uniform(-0.06, 0.06) * w
        if jagged:
            mask = _blob_mask(yy, xx, cy, cx,
                              rng.uniform(0.07 * min(h, w),
                                          0.12 * min(h, w)), rng)
        else:
            mask = _ellipse_mask(yy, xx, cy, cx,
                                 rng.uniform(0.06 * h, 0.13 * h),
                                 rng.uniform(0.06 * w, 0.13 * w),
                                 rng.uniform(0, np.pi))
        lab[mask] = c
        mu = rng.uniform(0.25, 0.65)          # class-INdependent intensity
        img[mask] += mu + _smooth_field(rng, h, w, 16, 0.15)[mask]
    for _ in range(rng.randint(2, 4)):        # background distractors
        if jagged:
            mask = _blob_mask(
                yy, xx, rng.uniform(0.12 * h, 0.88 * h),
                rng.uniform(0.12 * w, 0.88 * w),
                rng.uniform(0.04 * min(h, w), 0.08 * min(h, w)), rng)
        else:
            mask = _ellipse_mask(
                yy, xx, rng.uniform(0.12 * h, 0.88 * h),
                rng.uniform(0.12 * w, 0.88 * w),
                rng.uniform(0.04 * h, 0.09 * h),
                rng.uniform(0.04 * w, 0.09 * w), rng.uniform(0, np.pi))
        mask &= lab == 0
        img[mask] += rng.uniform(0.25, 0.65)
    img += rng.randn(h, w) * 0.06
    return img.astype(np.float32), lab


SLICES_A_WORKER = 64     # a pool of fewer slices a worker is written serially
MAX_WORKERS = 8


def _write_slice(job) -> None:
    """One slice's scribble (``tools/scribbles.py``), then its ``.npz``."""
    path, uid, img, lab, num_classes, ignored_index, style, ratio = job
    scb = generate_scribble(lab, num_classes, ignored_index, style=style)
    if ratio < 1.0:
        scb = shorten_scribbles(scb, num_classes, ignored_index, ratio)
    np.savez(path, uid=uid, img=img, lab=lab.astype(np.float32),
             scb=scb.astype(np.float32))


def _write_slices(jobs, num_slices: int) -> None:
    """:func:`_write_slice` for every job, in host processes when the pool is
    large: the scribbles' thinning takes ~70% of a slice's time and draws
    nothing, so the files are those of a serial run.  At most four jobs a
    worker are in flight, so a large pool is never held in memory."""
    workers = min(MAX_WORKERS, os.cpu_count() or 1, num_slices // SLICES_A_WORKER)
    if workers <= 1:
        for job in jobs:
            _write_slice(job)
        return
    import collections
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        pending: collections.deque = collections.deque()
        for job in jobs:
            pending.append(ex.submit(_write_slice, job))
            if len(pending) >= 4 * workers:
                pending.popleft().result()
        for f in pending:
            f.result()


def write_synthetic_dataset(root: str, dataset: str, num_slices: int,
                            size: Tuple[int, int], num_classes: int,
                            ignored_index: int, folds: int = 5,
                            modality: str = "t1", seed: int = 0,
                            size_jitter: int = 0,
                            difficulty: str = "easy",
                            scribble_style: str = "skeleton",
                            scribble_ratio: float = 1.0) -> List[str]:
    """Write a reference-layout synthetic dataset under ``root``.

    Produces ``<root>/<ds>/slices/*.npz`` plus the five-fold split txts in
    the reference's directory convention (splits.py), so the real CLI
    entry points run unmodified against it.

    ``size_jitter`` > 0 varies each slice's extent uniformly in
    ``[size - jitter, size + jitter]`` per axis — ACDC/LVSC-style
    heterogeneous slice geometry (their entry points crop/embed per slice;
    CHAOS alone is uniformly 256x256).
    """
    rng = np.random.RandomState(seed)
    ds_dir = "chaos" if dataset in ("chaos", "chaost1", "chaost2") else dataset
    slice_dir = os.path.join(root, ds_dir, "slices")
    os.makedirs(slice_dir, exist_ok=True)

    # Idempotent: a previous identical generation (marker matches) is kept,
    # so pre-generating a large pool and then launching the trainer with
    # --synthetic_data does not redo the (host-side, minutes-at-LVSC-scale)
    # phantom synthesis.
    marker = os.path.join(slice_dir, ".generated")
    stamp = (f"{dataset} {num_slices} {size} {num_classes} {ignored_index} "
             f"{folds} {modality} {seed} {size_jitter} {difficulty} "
             f"{scribble_style}")
    if scribble_ratio != 1.0:  # the ratio joined the stamp later; keep old
        stamp += f" r{scribble_ratio}"  # pools' markers valid unchanged
    # 24 slices per pseudo-patient at study scale; for tiny smoke pools use
    # smaller groups so every fold still has patients on BOTH sides of the
    # patient-level split below.
    group = 24 if num_slices >= 48 * folds else max(1,
                                                    num_slices // (2 * folds))
    all_rel = [os.path.join(
        "slices", f"pat{i // group:03d}_slice{i % group:03d}.npz")
        for i in range(num_slices)]
    split_base = os.path.join(root, ds_dir, "train_test_split",
                              "five_fold_split")
    if ds_dir == "chaos":
        split_base = os.path.join(split_base, modality)

    def _pool_intact() -> bool:
        if not os.path.exists(marker):
            return False
        with open(marker) as f:
            if f.read().strip() != stamp:
                return False
        # Spot-check the marker isn't stale after a partial clean: first and
        # last slice files must still exist.
        ds_root = os.path.join(root, ds_dir)
        return bool(all_rel) and all(
            os.path.exists(os.path.join(ds_root, p))
            for p in (all_rel[0], all_rel[-1]))

    if not _pool_intact():
        # Regenerating: clear slice files not in the new layout first, so a
        # directory-scanning consumer never sees a mix of stale and fresh
        # slices (e.g. a pool written before the adaptive-group-size change
        # used different pseudo-patient names).  ONLY when the
        # .generated marker proves this slices dir was written by us — a
        # shared data_root holding real converted slices must never be
        # swept by a synthetic regeneration.
        if os.path.exists(marker):
            keep = {os.path.basename(p) for p in all_rel}
            for fn in os.listdir(slice_dir):
                if fn.endswith(".npz") and fn not in keep:
                    os.remove(os.path.join(slice_dir, fn))
        def slices():
            # The phantoms draw from one stream, in order; the scribbles
            # and the writes need no draw.
            for rel in all_rel:
                sz = size
                if size_jitter:
                    sz = (int(rng.randint(size[0] - size_jitter,
                                          size[0] + size_jitter + 1)),
                          int(rng.randint(size[1] - size_jitter,
                                          size[1] + size_jitter + 1)))
                img, lab = make_phantom(rng, sz, num_classes, difficulty)
                # patient-grouped uids so the per-patient aggregation
                # protocol (evals/infer.py) is exercised
                uid = os.path.splitext(os.path.basename(rel))[0]
                yield (os.path.join(slice_dir, uid + ".npz"), uid, img, lab,
                       num_classes, ignored_index, scribble_style,
                       scribble_ratio)

        _write_slices(slices(), num_slices)
    # Folds are PATIENT-level, mirroring the reference protocol (README.md:19
    # "split slices into five folds at patient level") and prepare_data.
    # write_five_fold_splits: sorted patients striped round-robin into test
    # sets, so no pseudo-patient leaks across the train/test boundary.
    # (Re)written even when the pool is cached — it is cheap and heals pools
    # generated before this scheme existed.
    by_patient: dict = {}
    for p in all_rel:
        by_patient.setdefault(
            os.path.basename(p).split("_")[0], []).append(p)
    patients = sorted(by_patient)
    os.makedirs(split_base, exist_ok=True)
    for fold in range(folds):
        test_p = set(patients[fold::folds])
        train = [p for pat in patients if pat not in test_p
                 for p in by_patient[pat]]
        test = [p for pat in patients if pat in test_p
                for p in by_patient[pat]]
        with open(os.path.join(split_base, f"train_fold{fold}.txt"), "w") as f:
            f.write("\n".join(train) + "\n")
        with open(os.path.join(split_base, f"test_fold{fold}.txt"), "w") as f:
            f.write("\n".join(test) + "\n")
    with open(marker, "w") as f:
        f.write(stamp + "\n")
    return all_rel
