"""The comparison that decides ``correct``.

Both sides are read as a *trace*: what one side did over the first three
updates of the mix's start epoch and one validation pass of the initial state,

* ``batch``: the augmented batch of update 0 (image, strong image,
  one-hot label and scribble, valid mask);
* ``outputs``: the model's outputs of update 0 (the weak logits and, in the
  Experiment session, the strong and aux logits);
* ``losses``: the total loss of each of the three updates (``terms``, each
  loss term of each);
* ``grad``: each parameter's first gradient norm as the optimizer got it,
  ``|m_1| / (1 - beta1)`` from Adam's first moment after update 0 (the
  loss's gradient plus the weight decay); the reference's trace also holds
  ``raw_grad``, the loss's own gradient norms, which pick the leaves left
  out (:func:`quiet_leaves`);
* ``update``: each parameter's change ``|theta_3 - theta_0|``;
* ``buffers``: the BatchNorm running statistics and the memory bank after
  the three updates;
* ``val``: the validation sums (loss, per-class Dice and counts) of the
  initial state over the whole validation pool, taken before update 0 (the
  three updates move each side's weights apart by their rounding, and a
  validation after them would read that drift, not the pass itself).

:func:`compare` turns a program trace and the reference's into the numbers
that :data:`NAMES` lists; :func:`verdict` holds those a cell's limits name.
``grad`` is the median parameter's gap of first-gradient norms and
``update`` the worst parameter's gap of change norms (``grad_worst`` and
``update_median`` the others), ``terms0`` the worst relative gap of a loss
term of the first update, ``loss`` the worst of the three updates'
relative loss gaps (``loss0`` the first's), ``val_loss`` the relative gap
of the validation loss sum and ``val_dice`` the largest gap of a class's
Dice sum or count over the slices.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

# Every number :func:`compare` reads; a cell's limits file names those it
# holds to a limit (see PERF.md for why each is or is not compared).
NAMES = ("aug_image", "aug_maps", "outputs", "loss", "loss0", "terms0", "grad", "grad_worst",
         "update", "update_median", "buffers", "val_loss", "val_dice")
# A parameter whose reference gradient norm (the loss's own, before Adam
# adds the weight decay) is under this share of the median parameter's is
# moved by round-off alone (a conv bias ahead of a train-mode BatchNorm):
# it is left out of ``grad`` and ``update``.
QUIET_LEAF = 1e-3
BETA1 = 0.9


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """``|a - b| / |b|`` (inf where the shapes differ)."""
    if a.shape != b.shape:
        return math.inf
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]):
    """The median and the worst leaf's gap of norms, ``| |p| - |r| |`` over
    the larger of the leaf's reference norm and the median leaf's."""
    if set(prog) != set(ref):
        return math.inf, math.inf
    norms = sorted(ref[k] for k in keep)
    median = norms[len(norms) // 2]
    gaps = sorted(abs(prog[k] - ref[k]) / max(ref[k], median) for k in keep)
    return gaps[len(gaps) // 2], gaps[-1]


def quiet_leaves(ref_raw_grad: Dict[str, float]) -> List[str]:
    """The parameters whose reference gradient is nought to rounding."""
    norms = sorted(ref_raw_grad.values())
    median = norms[len(norms) // 2]
    return sorted(k for k, v in ref_raw_grad.items() if v < QUIET_LEAF * median)


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number of :data:`NAMES` for ``prog`` against ``ref``."""
    out = {}
    pb, rb = prog["batch"], ref["batch"]
    images = [k for k in ("image", "image_strong") if k in rb]
    maps = [k for k in ("label", "scribble", "valid_mask") if k in rb]
    if any(pb[k].shape != rb[k].shape for k in images + maps):
        out["aug_image"] = out["aug_maps"] = math.inf
    else:
        out["aug_image"] = max(float((pb[k].double() - rb[k].double()).abs().max())
                               for k in images)
        out["aug_maps"] = float(sum(int((pb[k] != rb[k]).sum()) for k in maps))
    keys = [k for k in ref["outputs"] if k.endswith("logits") or k.endswith("logits_strong")]
    out["outputs"] = max(_rel(prog["outputs"].get(k, torch.zeros(0)), ref["outputs"][k])
                         for k in keys)
    out["loss"] = max(abs(p - r) / max(abs(r), 1e-12)
                      for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, prog["losses"])):
        out["loss"] = math.inf
    if prog["losses"]:
        out["loss0"] = abs(prog["losses"][0] - ref["losses"][0]) / max(abs(ref["losses"][0]),
                                                                        1e-12)
    pt, rt = prog["terms"][0], ref["terms"][0]
    out["terms0"] = max((abs(pt.get(k, math.inf) - v) / max(abs(v), 1e-12)
                         for k, v in rt.items()), default=0.0)
    quiet = set(quiet_leaves(ref["raw_grad"]))
    keep = [k for k in ref["grad"] if k not in quiet]
    out["grad"], out["grad_worst"] = _leaf_gaps(prog["grad"], ref["grad"], keep)
    out["update_median"], out["update"] = _leaf_gaps(prog["update"], ref["update"], keep)
    out["buffers"] = max((_rel(prog["buffers"][k], v) for k, v in ref["buffers"].items()),
                         default=0.0)
    pv, rv = prog["val"], ref["val"]
    n = max(float(rv["n_sum"]), 1.0)
    out["val_loss"] = abs(float(pv["loss_sum"]) - float(rv["loss_sum"])) \
        / max(abs(float(rv["loss_sum"])), 1e-12)
    if float(pv["n_sum"]) != float(rv["n_sum"]):
        out["val_loss"] = math.inf
    out["val_dice"] = max(float((pv["dice_sum"] - rv["dice_sum"]).abs().max()),
                          float((pv["dice_cnt"] - rv["dice_cnt"]).abs().max())) / n
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, lines)``: every number that ``limits`` names at or under
    its limit, and one ``(name, number, limit, ok)`` line each."""
    lines = []
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        lines.append((name, value, limit, value <= limit))
    return all(ok for *_, ok in lines), lines
