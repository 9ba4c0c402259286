"""Summarise a three-arm quality study into the README-style table.

The port's copy of ``pacingpseudo_tpu/tools/study_summary.py``.  The
study trains the reference's headline comparison: Baseline/Control (UNet
+ pCE), PacingPseudo/Experiment (full pacing losses) and Upperbound
(fully supervised); the reference publishes +0.26 DSC between the first
two on CHAOS T1 (reference README.md:114-116).  Each arm leaves:

  <root>/<arm>/run-fold0/valdice.npz                 per-epoch val Dice
  <root>/<arm>/outputs/Inference/<ds>/run-fold0/eval_data.npz
        dicearr (N, C) / hd95arr (N, C) / uids (N,)  test-fold metrics

as the port's ``cli.train`` and ``cli.inference`` write them.  Per-patient
aggregation is ``evals.infer.aggregate_per_patient``: the published
protocol (README.md:106), each foreground class averaged over patients,
then over classes, NaN-excluded.

Usage:  python -m pacingpseudo_torch.tools.study_summary \\
            --root STUDY [--arms Control Experiment Upperbound] \\
            [--dataset chaost1] [--json out.json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

import numpy as np

from pacingpseudo_torch.evals.infer import aggregate_per_patient


def per_slice_dice(dicearr: np.ndarray) -> float:
    """Mean over foreground classes then slices, NaN-excluded per slice."""
    per = np.nanmean(dicearr[:, 1:], axis=1)
    return float(np.nanmean(per))


def summarise_arm(root: str, arm: str, dataset: str) -> dict:
    """One arm's row: its best validation Dice and epoch, the epochs that
    ran, and the test fold's Dice a slice and a patient and HD95 a slice,
    from whichever of its two files exist."""
    out: dict = {"arm": arm}
    vd_path = os.path.join(root, arm, "run-fold0", "valdice.npz")
    if os.path.exists(vd_path):
        vd = np.load(vd_path)["valdice"]
        valid = np.where(np.isfinite(vd))[0]
        if valid.size:
            best = int(valid[np.argmax(vd[valid])])
            out["best_val_dice"] = float(vd[best])
            out["best_epoch"] = best
            out["epochs"] = int(vd.shape[0])
            # valdice holds the configured epoch count (train/loop.py): an
            # interrupted run leaves trailing zeros.  Record what ran.
            nz = np.where(np.nan_to_num(vd) != 0)[0]
            out["epochs_completed"] = int(nz[-1] + 1) if nz.size else 0
    found = glob.glob(os.path.join(root, arm, "outputs", "Inference", dataset, "run-*",
                                   "eval_data.npz"))
    if found:
        d = np.load(sorted(found)[-1], allow_pickle=True)
        dice, hd95 = d["dicearr"], d["hd95arr"]
        out["test_dice_slice"] = per_slice_dice(dice)
        if "uids" in d:
            agg = aggregate_per_patient(d["uids"], dice, dice.shape[1])
            out["test_dice_patient"] = agg["overall"]
            out["n_patients"] = agg["num_patients"]
        else:
            out["test_dice_patient"] = None
        out["test_hd95_slice"] = float(np.nanmean(np.nanmean(hd95[:, 1:], axis=1)))
        out["n_slices"] = int(dice.shape[0])
    return out


def render_table(rows: List[dict]) -> str:
    """The rows as a markdown table, "—" where an arm lacks a value."""
    lines = ["| Arm | best val Dice (epoch) | test Dice (slice) | "
             "test Dice (patient) | test HD95 |", "|---|---|---|---|---|"]
    for r in rows:
        bv = (f"{r['best_val_dice']:.4f} ({r['best_epoch']})"
              if "best_val_dice" in r else "—")
        ts = f"{r['test_dice_slice']:.4f}" if r.get("test_dice_slice") is not None else "—"
        tp = (f"{r['test_dice_patient']:.4f}"
              if r.get("test_dice_patient") is not None else "—")
        th = f"{r['test_hd95_slice']:.1f}" if r.get("test_hd95_slice") is not None else "—"
        lines.append(f"| {r['arm']} | {bv} | {ts} | {tp} | {th} |")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="study_r3")
    ap.add_argument("--arms", nargs="+", default=["Control", "Experiment", "Upperbound"])
    ap.add_argument("--dataset", default="chaost1")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)

    rows = [summarise_arm(args.root, a, args.dataset) for a in args.arms]
    print(render_table(rows))
    by_arm = {r["arm"]: r for r in rows}
    ctrl = by_arm.get("Control", {}).get("test_dice_patient")
    expt = by_arm.get("Experiment", {}).get("test_dice_patient")
    if ctrl is not None and expt is not None:
        print(f"\nExperiment - Control = {expt - ctrl:+.4f} DSC "
              f"(reference gains +0.26 on real CHAOS T1, README.md:114-115)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)


if __name__ == "__main__":
    main()
