"""Hausdorff distances (HD and HD95) on the host, medpy-compatible, on scipy.

The port's own copy of ``pacingpseudo_tpu/evals/hd.py``.  The reference
evaluates HD95 with ``medpy.metric.hd95`` (reference inference.py:218-237);
medpy is not a dependency, so its algorithm is written out on
``scipy.ndimage``:

* border pixels of a mask = ``mask ^ binary_erosion(mask, footprint)``
  with ``footprint = generate_binary_structure(rank, connectivity)``;
* directed surface distances = the Euclidean distance transform of the
  complement of the other mask's border (``sampling=voxelspacing``), read
  at this mask's border pixels;
* HD95 = the 95th percentile (numpy's linear interpolation) of both
  directed distance sets together; HD = the larger of the two maxima.

The per-class functions keep the reference's NaN gating: NaN when a side
is empty **or** full (a full mask has no border).
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def surface_distances(result, reference, voxelspacing=None, connectivity=1):
    """Directed surface distances from ``result``'s border to ``reference``'s.

    Mirrors ``medpy.metric.binary.__surface_distances``.
    """
    result = np.atleast_1d(result.astype(bool))
    reference = np.atleast_1d(reference.astype(bool))
    if voxelspacing is not None:
        voxelspacing = np.atleast_1d(
            np.asarray(voxelspacing, dtype=np.float64))
        if voxelspacing.size == 1:
            voxelspacing = np.repeat(voxelspacing, result.ndim)
        if voxelspacing.size != result.ndim:
            raise ValueError("voxelspacing must match mask rank")

    footprint = ndimage.generate_binary_structure(result.ndim, connectivity)

    if not np.count_nonzero(result):
        raise RuntimeError("The first supplied array does not contain any binary object.")
    if not np.count_nonzero(reference):
        raise RuntimeError("The second supplied array does not contain any binary object.")

    result_border = result ^ ndimage.binary_erosion(result, structure=footprint, iterations=1)
    reference_border = reference ^ ndimage.binary_erosion(reference, structure=footprint, iterations=1)

    dt = ndimage.distance_transform_edt(~reference_border, sampling=voxelspacing)
    return dt[result_border]


def hd95(result, reference, voxelspacing=None, connectivity=1):
    """95th-percentile symmetric Hausdorff distance (medpy ``hd95``)."""
    hd1 = surface_distances(result, reference, voxelspacing, connectivity)
    hd2 = surface_distances(reference, result, voxelspacing, connectivity)
    return float(np.percentile(np.hstack((hd1, hd2)), 95))


def hd(result, reference, voxelspacing=None, connectivity=1):
    """Symmetric Hausdorff distance (medpy ``hd``)."""
    hd1 = surface_distances(result, reference, voxelspacing, connectivity).max()
    hd2 = surface_distances(reference, result, voxelspacing, connectivity).max()
    return float(max(hd1, hd2))


def compute_95hd(pred_hard, label, num_classes, spacing):
    """Per-class HD95 with the reference's NaN gating.

    Reference: inference.py:218-237: NaN when either side is empty **or**
    full (a full mask has no border).
    """
    out = []
    for cls in range(num_classes):
        p = pred_hard == cls
        t = label == cls
        if not np.any(p) or not np.any(t) or np.all(p) or np.all(t):
            out.append(np.nan)
        else:
            out.append(hd95(p, t, spacing, 1))
    return out


def compute_hd(pred_hard, label, num_classes, spacing):
    """Per-class plain HD with the same NaN gating (reference: inference.py:239-258)."""
    out = []
    for cls in range(num_classes):
        p = pred_hard == cls
        t = label == cls
        if not np.any(p) or not np.any(t) or np.all(p) or np.all(t):
            out.append(np.nan)
        else:
            out.append(hd(p, t, spacing, 1))
    return out
