"""Hold the port's three-arm quality study against the JAX package's.

    python scripts/quality_study_compare.py --jax study_r3 --port study_torch

Reads each study's per-epoch validation Dice (``<arm>/run-fold0/valdice.npz``)
and test metrics (``summary.json``; the port's seeds other than 1 in
``<arm>-s<seed>`` and ``summary-s<seed>.json``, as
``scripts/quality_study_torch.py`` writes them).  For each arm it prints, and
writes to ``<port>/compare.json``: JAX's and each port seed's mean validation
Dice over the epoch windows ``WINDOWS``, the best validation Dice and its
epoch, and the test DSC a slice and a patient and HD95 a slice.

The verdict follows four rules, fixed before any port run:

(a) For every port seed, Upperbound's best validation Dice exceeds the
    larger of Control's and Experiment's by at least ``ORDER_GAP`` (a seed
    that stopped early: its best in the epochs it ran).
(b) In each window up to epoch 100, JAX's window mean lies within the port
    seeds' mean +- max(0.05, 3 s_w), s_w the sample standard deviation of
    the seeds' window means.
(c) In the windows 100-200 and 200-400, which only seed 1 reaches, JAX's
    mean lies within seed 1's +- max(0.05, 3 max(s_w over 25-50 and
    50-100)).
(d) Seed 1's test DSC a slice lies within JAX's +- max(0.05, 3 s_best) for
    each arm, s_best the standard deviation over the seeds of the best
    validation Dice in epochs 0-99.

A spread needs two seeds: with fewer, s is 0 and the band is 0.05.  A rule
whose inputs do not exist (a window no seed reached, a seed without test
metrics) is "not evaluated".  Uses numpy and json only.
"""
from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

ARMS = ("Control", "Experiment", "Upperbound")
WINDOWS = ((0, 10), (10, 25), (25, 50), (50, 100), (100, 200), (200, 400))
EARLY = WINDOWS[:4]          # rule (b): the windows that every seed reaches
LATE = WINDOWS[4:]           # rule (c): seed 1 only
SPREAD_WINDOWS = ((25, 50), (50, 100))
FIRST_EPOCHS = 100           # rule (d)'s s_best: the best in epochs 0-99
ORDER_GAP = 0.15
MIN_BAND = 0.05
TEST_KEYS = ("test_dice_slice", "test_dice_patient", "test_hd95_slice")


def completed_epochs(valdice: np.ndarray) -> int:
    """Epochs that ran: a run that stopped early leaves trailing zeros
    (``train/loop.py`` sizes ``valdice`` to the configured epochs)."""
    nz = np.where(np.nan_to_num(valdice) != 0)[0]
    return int(nz[-1] + 1) if nz.size else 0


def window_means(valdice: np.ndarray) -> Dict[str, Optional[float]]:
    """The mean of each window of ``WINDOWS`` (epochs ``a`` to ``b - 1``) that
    the run completed; ``None`` for one it did not reach to its end."""
    n = completed_epochs(valdice)
    return {f"{a}-{b}": (float(np.mean(valdice[a:b])) if n >= b else None)
            for a, b in WINDOWS}


def best(valdice: np.ndarray, epochs: Optional[int] = None) -> tuple:
    """``(best validation Dice, its epoch)`` over the completed epochs, or
    the first ``epochs`` of them."""
    n = completed_epochs(valdice)
    if epochs is not None:
        n = min(n, epochs)
    if n == 0:
        return None, None
    e = int(np.argmax(valdice[:n]))
    return float(valdice[e]), e


def _arm_record(root: str, arm_dir: str, summary: Dict[str, dict]) -> dict:
    vd = np.load(os.path.join(root, arm_dir, "run-fold0", "valdice.npz"))["valdice"]
    top, epoch = best(vd)
    rec = {"epochs_completed": completed_epochs(vd), "windows": window_means(vd),
           "best_val_dice": top, "best_epoch": epoch,
           "best_val_dice_0_99": best(vd, FIRST_EPOCHS)[0]}
    row = summary.get(arm_dir, {})
    rec.update({k: row.get(k) for k in TEST_KEYS})
    return rec


def _summary(path: str) -> Dict[str, dict]:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {r["arm"]: r for r in json.load(f)}


def port_seeds(root: str) -> List[int]:
    """The seeds of the port's study under ``root``: 1 for ``Control``,
    ``k`` for ``Control-s<k>``, where the arm's ``valdice.npz`` exists."""
    seeds = []
    for name in os.listdir(root):
        m = re.fullmatch(r"Control(?:-s(\d+))?", name)
        if m and os.path.exists(os.path.join(root, name, "run-fold0", "valdice.npz")):
            seeds.append(int(m.group(1) or 1))
    return sorted(seeds)


def load(jax_root: str, port_root: str) -> dict:
    """Every study's records: ``{"jax": {arm: rec}, "port": {seed: {arm: rec}}}``."""
    out = {"jax": {}, "port": {}}
    jax_summary = _summary(os.path.join(jax_root, "summary.json"))
    for arm in ARMS:
        out["jax"][arm] = _arm_record(jax_root, arm, jax_summary)
    for seed in port_seeds(port_root):
        sfx = "" if seed == 1 else f"-s{seed}"
        summary = _summary(os.path.join(port_root, f"summary{sfx}.json"))
        out["port"][seed] = {arm: _arm_record(port_root, arm + sfx, summary) for arm in ARMS}
    return out


def _spread(values: List[float]) -> float:
    """The sample standard deviation; 0 for fewer than two values."""
    return float(np.std(values, ddof=1)) if len(values) > 1 else 0.0


def _within(jax_value: float, port_value: float, band: float) -> dict:
    """Whether the two lie within ``band`` of each other (a band about
    either)."""
    return {"jax": jax_value, "port": port_value, "band": band,
            "pass": bool(abs(jax_value - port_value) <= band)}


def _verdict(checks: List[dict]) -> str:
    if not checks:
        return "not evaluated"
    return "pass" if all(c["pass"] for c in checks) else "fail"


def verdict(records: dict) -> dict:
    """Rules (a)-(d) of the module docstring on ``load``'s records."""
    jax, port = records["jax"], records["port"]
    rules = {}

    checks = []
    for seed, arms in port.items():
        tops = {arm: arms[arm]["best_val_dice"] for arm in ARMS}
        if any(v is None for v in tops.values()):
            continue
        gap = tops["Upperbound"] - max(tops["Control"], tops["Experiment"])
        checks.append({"seed": seed, "gap": gap, "pass": bool(gap >= ORDER_GAP)})
    rules["a"] = {"checks": checks, "verdict": _verdict(checks)}

    checks = []
    for arm in ARMS:
        for a, b in EARLY:
            key = f"{a}-{b}"
            got = [port[s][arm]["windows"][key] for s in port
                   if port[s][arm]["windows"][key] is not None]
            if not got or jax[arm]["windows"][key] is None:
                continue
            band = max(MIN_BAND, 3 * _spread(got))
            checks.append({"arm": arm, "window": key, "seeds": len(got),
                           **_within(jax[arm]["windows"][key], float(np.mean(got)), band)})
    rules["b"] = {"checks": checks, "verdict": _verdict(checks)}

    checks = []
    if 1 in port:
        for arm in ARMS:
            spread = max(_spread([port[s][arm]["windows"][f"{a}-{b}"] for s in port
                                  if port[s][arm]["windows"][f"{a}-{b}"] is not None])
                         for a, b in SPREAD_WINDOWS)
            for a, b in LATE:
                key = f"{a}-{b}"
                got, want = port[1][arm]["windows"][key], jax[arm]["windows"][key]
                if got is None or want is None:
                    continue
                checks.append({"arm": arm, "window": key,
                               **_within(want, got, max(MIN_BAND, 3 * spread))})
    rules["c"] = {"checks": checks, "verdict": _verdict(checks)}

    checks = []
    if 1 in port:
        for arm in ARMS:
            got, want = port[1][arm]["test_dice_slice"], jax[arm]["test_dice_slice"]
            tops = [port[s][arm]["best_val_dice_0_99"] for s in port
                    if port[s][arm]["best_val_dice_0_99"] is not None]
            if got is None or want is None:
                continue
            checks.append({"arm": arm, **_within(want, got, max(MIN_BAND, 3 * _spread(tops)))})
    rules["d"] = {"checks": checks, "verdict": _verdict(checks)}
    return rules


def overall(rules: dict) -> str:
    """"fail" if a rule failed, "pass" if every rule passed, else
    "incomplete" (a rule not evaluated, none failed)."""
    verdicts = {r["verdict"] for r in rules.values()}
    if "fail" in verdicts:
        return "fail"
    return "pass" if verdicts == {"pass"} else "incomplete"


def _fmt(v, digits=4) -> str:
    return "—" if v is None else f"{v:.{digits}f}"


def render(records: dict, rules: dict) -> str:
    """Each arm's table (JAX, then the port's seeds) and the rules' checks."""
    lines = []
    for arm in ARMS:
        lines.append(f"== {arm} ==")
        head = ["run"] + [f"{a}-{b}" for a, b in WINDOWS] + [
            "best (epoch)", "test DSC slice", "test DSC patient", "HD95 slice"]
        lines.append("| " + " | ".join(head) + " |")
        lines.append("|" + "---|" * len(head))
        runs = [("JAX", records["jax"][arm])] + [
            (f"port seed {s}", records["port"][s][arm]) for s in records["port"]]
        for name, rec in runs:
            cells = [name] + [_fmt(rec["windows"][f"{a}-{b}"], 3) for a, b in WINDOWS]
            cells.append(f"{_fmt(rec['best_val_dice'])} ({rec['best_epoch']})")
            cells += [_fmt(rec["test_dice_slice"]), _fmt(rec["test_dice_patient"]),
                      _fmt(rec["test_hd95_slice"], 2)]
            lines.append("| " + " | ".join(cells) + " |")
    for rule, res in rules.items():
        lines.append(f"rule ({rule}): {res['verdict']}")
        for c in res["checks"]:
            lines.append("  " + json.dumps(c))
    lines.append(f"verdict: {overall(rules)}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax", default="study_r3")
    ap.add_argument("--port", default="study_torch")
    ap.add_argument("--json", default="", help="default: <port>/compare.json")
    args = ap.parse_args(argv)
    records = load(args.jax, args.port)
    rules = verdict(records)
    print(render(records, rules))
    out = {"jax_root": args.jax, "port_root": args.port,
           "records": {"jax": records["jax"],
                       "port": {str(s): r for s, r in records["port"].items()}},
           "rules": rules, "verdict": overall(rules)}
    with open(args.json or os.path.join(args.port, "compare.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
