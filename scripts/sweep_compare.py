"""Hold the port's five-fold jagged sweep against the JAX package's ``study_r5/sweep/``.

    python scripts/sweep_compare.py [--jax study_r5/sweep] [--port study_torch_sweep]

Both sides keep, for each arm (``Control80``, ``Experiment80``), a
``fold{N}.json`` a fold (per-slice test DSC ``dice`` and HD95 ``hd95`` of
the fold's best checkpoint, from ``cli.sweep``).  JAX's validation curves
come from its arm logs (``Control80.log``, ``Experiment80.log``), the
port's from each fold's ``valdice.npz`` (``<arm>80/fold{N}/valdice.npz``,
copied there by ``scripts/sweep_torch.py``).  Writes ``<port>/compare.json``.

JAX's arm logs hold every attempt of every fold: its relay watchdog
restarted a stalled attempt, and an attempt could run on beside the next,
their lines interleaved (Control fold 0, Experiment fold 0 has four
``config:`` lines).  A fold's last attempt is what follows the last
``config:`` line naming that fold, up to the next ``config:`` line of
another fold.  Its ``val: NNN`` lines give one reading an epoch; where an
epoch is read more than once there (an earlier attempt still running the
same deterministic run), the readings must agree, or the parser raises.
The header lines (``train slices=... canvas=...``) of every attempt of a
fold are kept: ``scripts/sweep_torch.py`` holds the port's pool to them.

The rules, fixed before the port's first run on the card (JAX's figures in
brackets):

(a) pacing wins: Experiment - Control per-slice test DSC is above 0 in at
    least 4 of 5 folds, and the overall gap (the difference of the arms'
    means over the folds) is at least +0.030 [5 of 5, +0.060; fold gaps
    +0.090 / +0.079 / +0.057 / +0.036 / +0.040].
(b) DSC: each arm's overall DSC within 0.04 of JAX's [Control 0.2898,
    Experiment 0.3501], and each fold's within 0.08 of JAX's fold (one JAX
    seed spreads 0.049: Control fold 0 reads 0.2713 at seed 1 and 0.3205 at
    seed 2, ``Control80_s2/fold0.json``).
(c) HD95: each arm's overall HD95 within 15 of JAX's [211.87, 201.34], and
    each fold's within 30.
(d) validation curves: for each arm and fold, the mean of validation Dice
    over epochs 10-79 within 0.07 of JAX's last attempt [Control 0.1805 /
    0.2186 / 0.1976 / 0.1741 / 0.1918; Experiment 0.2200 / 0.2128 / 0.2253
    / 0.2226 / 0.2099; JAX's Control seed 2 reads 0.2409 on fold 0].

The mean over epochs 0-9 (JAX Control 0.154-0.174, Experiment 0.160-0.193)
is reported beside the rules, with no rule on it: a reading on the Control
arm's early miss under train-mode BatchNorm against ``study_r3``.

A rule's verdict is ``pass`` when every comparison it makes passes, ``fail``
when one fails, and ``not evaluated`` when a fold or an arm it needs is
missing on the port's side.  The overall verdict is ``pass`` when all four
pass, ``fail`` when one fails, else ``incomplete``.  The runner's
``pool.json`` files (the checksum of fold 0's arrays, written in every call)
must agree across the calls; ``compare.json`` names them.  Numpy only.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

ARMS = ("Control", "Experiment")
FOLDS = (0, 1, 2, 3, 4)
EPOCHS = 80
WINDOW = (10, 80)            # rule (d): epochs 10-79
EARLY = (0, 10)              # reported: epochs 0-9
WIN_FOLDS, GAP_MIN = 4, 0.030
DICE_BAND, FOLD_DICE_BAND = 0.04, 0.08
HD_BAND, FOLD_HD_BAND = 15.0, 30.0
CURVE_BAND = 0.07

HEADER = re.compile(r"train slices=(\d+) val slices=(\d+) steps/epoch=(\d+) canvas=(\d+)")
VAL = re.compile(r"^val: (\d+), loss: [0-9.]+, \[.*All: ([0-9.]+)\]")


def arm_name(arm: str, epochs: int = EPOCHS) -> str:
    return f"{arm}{epochs}"


def parse_jax_log(path: str) -> Dict[int, dict]:
    """Each fold of a JAX arm log: ``headers`` (every attempt's
    ``(train, val, steps, canvas)``), ``config`` (the last attempt's config
    line) and ``valdice`` (the last attempt's ``All`` an epoch, in epoch
    order)."""
    with open(path) as f:
        lines = f.read().splitlines()
    starts = [(i, json.loads(line[len("config: "):])) for i, line in enumerate(lines)
              if line.startswith("config: ")]
    out: Dict[int, dict] = {}
    for k, (i, config) in enumerate(starts):
        fold = int(config["fold"])
        rec = out.setdefault(fold, {"headers": []})
        end = next((j for j, c in starts[k + 1:] if int(c["fold"]) != fold), len(lines))
        m = next((HEADER.search(line) for line in lines[i:end] if HEADER.search(line)), None)
        if m:
            rec["headers"].append(tuple(int(x) for x in m.groups()))
        rec["config"], rec["span"] = config, (i, end)
    for fold, rec in out.items():
        readings: Dict[int, float] = {}
        for line in lines[rec["span"][0]:rec["span"][1]]:
            m = VAL.match(line)
            if not m:
                continue
            epoch, value = int(m.group(1)), float(m.group(2))
            if readings.setdefault(epoch, value) != value:
                raise ValueError(f"{path}: fold {fold}'s last attempt reads epoch {epoch} "
                                 f"as {readings[epoch]} and {value}")
        if sorted(readings) != list(range(len(readings))):
            raise ValueError(f"{path}: fold {fold}'s last attempt skips epochs")
        rec["valdice"] = np.array([readings[e] for e in range(len(readings))])
        del rec["span"]
    return out


def _window(values: Optional[np.ndarray], lo_hi) -> Optional[float]:
    if values is None or len(values) < lo_hi[1]:
        return None
    return float(np.mean(values[lo_hi[0]:lo_hi[1]]))


def read_side(root: str, jax_logs: bool, epochs: int = EPOCHS) -> Dict[str, dict]:
    """``{arm: {fold: {dice, hd95, val_10_79, val_0_9, epoch0}}}`` of one
    side; folds without a ``fold{N}.json`` are left out."""
    side: Dict[str, dict] = {}
    for arm in ARMS:
        folds: Dict[int, dict] = {}
        name = arm_name(arm, epochs)
        curves = {}
        if jax_logs and os.path.exists(os.path.join(root, name + ".log")):
            curves = {f: r["valdice"] for f, r in
                      parse_jax_log(os.path.join(root, name + ".log")).items()}
        for fold in FOLDS:
            path = os.path.join(root, name, f"fold{fold}.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                res = json.load(f)
            curve = curves.get(fold)
            npz = os.path.join(root, name, f"fold{fold}", "valdice.npz")
            if not jax_logs and os.path.exists(npz):
                curve = np.load(npz)["valdice"]
            folds[fold] = {"dice": float(res["dice"]), "hd95": float(res["hd95"]),
                           "val_10_79": _window(curve, WINDOW),
                           "val_0_9": _window(curve, EARLY),
                           "epoch0": None if curve is None else float(curve[0])}
        side[arm] = folds
    return side


def _overall(folds: Dict[int, dict], key: str) -> Optional[float]:
    if sorted(folds) != list(FOLDS):
        return None
    return float(np.mean([folds[f][key] for f in FOLDS]))


def _verdict(checks: List[dict], complete: bool) -> str:
    if any(not c["pass"] for c in checks):
        return "fail"
    return "pass" if complete and checks else "not evaluated"


def evaluate(jax: Dict[str, dict], port: Dict[str, dict]) -> dict:
    """The four rules of the module docstring, and the overall verdict."""
    complete = all(sorted(port[a]) == list(FOLDS) for a in ARMS)
    rules = {}

    gaps = {f: port["Experiment"][f]["dice"] - port["Control"][f]["dice"]
            for f in FOLDS if f in port["Experiment"] and f in port["Control"]}
    jax_gaps = {f: jax["Experiment"][f]["dice"] - jax["Control"][f]["dice"] for f in FOLDS}
    won = sum(g > 0 for g in gaps.values())
    overall_gap = (None if not complete else
                   _overall(port["Experiment"], "dice") - _overall(port["Control"], "dice"))
    checks_a = []
    if complete:
        checks_a = [{"what": "folds won", "port": won, "min": WIN_FOLDS,
                     "pass": won >= WIN_FOLDS},
                    {"what": "overall gap", "port": overall_gap, "min": GAP_MIN,
                     "pass": overall_gap >= GAP_MIN}]
    elif len(gaps) - won > len(FOLDS) - WIN_FOLDS:
        checks_a = [{"what": "folds lost", "port": len(gaps) - won,
                     "max": len(FOLDS) - WIN_FOLDS, "pass": False}]
    rules["a"] = {"verdict": _verdict(checks_a, complete), "checks": checks_a,
                  "fold_gaps": {str(f): g for f, g in gaps.items()},
                  "jax_fold_gaps": {str(f): g for f, g in jax_gaps.items()},
                  "jax_overall_gap": (_overall(jax["Experiment"], "dice")
                                      - _overall(jax["Control"], "dice"))}

    def bands(key, overall_band, fold_band):
        checks = []
        for arm in ARMS:
            for f in FOLDS:
                if f in port[arm]:
                    got, want = port[arm][f][key], jax[arm][f][key]
                    checks.append({"arm": arm, "fold": f, "port": got, "jax": want,
                                   "band": fold_band, "pass": abs(got - want) <= fold_band})
            got = _overall(port[arm], key)
            if got is not None:
                want = _overall(jax[arm], key)
                checks.append({"arm": arm, "fold": "overall", "port": got, "jax": want,
                               "band": overall_band, "pass": abs(got - want) <= overall_band})
        return {"verdict": _verdict(checks, complete), "checks": checks}

    rules["b"] = bands("dice", DICE_BAND, FOLD_DICE_BAND)
    rules["c"] = bands("hd95", HD_BAND, FOLD_HD_BAND)
    checks_d, curves_complete = [], complete
    for arm in ARMS:
        for f in FOLDS:
            got = port[arm].get(f, {}).get("val_10_79")
            if got is None:
                curves_complete = False
                continue
            want = jax[arm][f]["val_10_79"]
            checks_d.append({"arm": arm, "fold": f, "port": got, "jax": want,
                             "band": CURVE_BAND, "pass": abs(got - want) <= CURVE_BAND})
    rules["d"] = {"verdict": _verdict(checks_d, curves_complete), "checks": checks_d}
    verdicts = [r["verdict"] for r in rules.values()]
    verdict = ("fail" if "fail" in verdicts else
               "pass" if all(v == "pass" for v in verdicts) else "incomplete")
    early = {arm: {str(f): {"port": port[arm].get(f, {}).get("val_0_9"),
                            "port_epoch0": port[arm].get(f, {}).get("epoch0"),
                            "jax": jax[arm][f]["val_0_9"], "jax_epoch0": jax[arm][f]["epoch0"]}
                   for f in FOLDS} for arm in ARMS}
    return {"rules": rules, "verdict": verdict, "window_0_9": early}


def pool_checksums(port_root: str) -> dict:
    """Fold 0's checksum as every call of the runner read it."""
    sums = {}
    for path in sorted(glob.glob(os.path.join(port_root, "*", "fold*", "pool.json"))):
        with open(path) as f:
            sums[os.path.relpath(path, port_root)] = json.load(f)["fold0_sha256"]
    return {"fold0_sha256": sums, "agree": len(set(sums.values())) <= 1}


def _table(side: Dict[str, dict]) -> dict:
    return {arm: {"folds": {str(f): r for f, r in folds.items()},
                  "overall_dice": _overall(folds, "dice"),
                  "overall_hd95": _overall(folds, "hd95")} for arm, folds in side.items()}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax", default=os.path.join("study_r5", "sweep"))
    ap.add_argument("--port", default="study_torch_sweep")
    args = ap.parse_args(argv)
    jax, port = read_side(args.jax, True), read_side(args.port, False)
    out = evaluate(jax, port)
    out.update({"jax": _table(jax), "port": _table(port), "pool": pool_checksums(args.port)})
    if not out["pool"]["agree"]:
        out["verdict"] = "fail"
    with open(os.path.join(args.port, "compare.json"), "w") as f:
        json.dump(out, f, indent=2)
    for key, rule in out["rules"].items():
        print(f"rule ({key}): {rule['verdict']}")
    print(f"verdict: {out['verdict']}")
    return out


if __name__ == "__main__":
    main()
