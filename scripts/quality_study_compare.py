"""Hold the port's three-arm quality study against the JAX package's.

    python scripts/quality_study_compare.py --jax study_r3 --port study_torch
    python scripts/quality_study_compare.py --protocol dilated \
        --jax study_r3_dilated --port study_torch_dilated [--slices 1916]

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
metrics) is "not evaluated".

``--protocol dilated`` holds the two-arm study of
``scripts/quality_study_dilated.sh`` (``study_r3_dilated``: dilated
scribbles, BatchNorm frozen from epoch 1 on, 200 epochs; JAX's Experiment
arm completed 157) under rules fixed before any port run, over the windows
``DILATED.windows``:

(a) Over epochs 50-149 of seed 1, Control's mean validation Dice exceeds
    Experiment's by at least 0.03 (JAX: 0.2771 against 0.1441).
(b) In the windows 0-10, 10-25 and 25-50, for both arms, JAX's window mean
    lies within the port seeds' mean +- max(0.05, 3 s_w).
(c) In the windows 50-100 and 100-150 for both arms and 150-200 for
    Control, seed 1 only, JAX's mean lies within seed 1's +- max(0.05,
    3 max(s_w over 10-25 and 25-50)).
(d) Seed 1's test DSC a slice lies within JAX's +- max(0.05, 3 s_best),
    s_best the standard deviation over the seeds of the best validation
    Dice in epochs 0-49.

Each rule lists the checks whose inputs do not exist as "not evaluated".
Before any rule the script exits non-zero unless every arm, JAX's and the
port's, read the same study: its ``config.json`` has the BatchNorm quirk on
and JAX's ``epoch`` (200), and every header of its ``log.txt`` reads fold 0
of the pool (JAX's: 1,532 training and 384 validation slices, 127 updates
an epoch, a canvas of 256; the port's: those of ``--slices``, by default
JAX's).  Uses numpy and json only.
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


def window_means(valdice: np.ndarray, windows=WINDOWS) -> Dict[str, Optional[float]]:
    """The mean of each window of ``windows`` (epochs ``a`` to ``b - 1``) that
    the run completed; ``None`` for one it did not reach to its end."""
    n = completed_epochs(valdice)
    return {f"{a}-{b}": (float(np.mean(valdice[a:b])) if n >= b else None)
            for a, b in windows}


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


class Protocol:
    """A study's arms, windows and the epochs of rule (d)'s best."""

    def __init__(self, arms, windows, first_epochs):
        self.arms, self.windows, self.first_epochs = arms, windows, first_epochs

    @property
    def best_key(self) -> str:
        return f"best_val_dice_0_{self.first_epochs - 1}"


R3 = Protocol(ARMS, WINDOWS, FIRST_EPOCHS)
DILATED = Protocol(("Control", "Experiment"),
                   ((0, 10), (10, 25), (25, 50), (50, 100), (100, 150), (150, 200)), 50)
DILATED_EARLY = DILATED.windows[:3]
DILATED_LATE = {"Control": DILATED.windows[3:], "Experiment": DILATED.windows[3:5]}
DILATED_SPREAD = ((10, 25), (25, 50))
DILATED_ORDER = (50, 150)
DILATED_ORDER_GAP = 0.03
DILATED_EPOCHS = 200
# Fold 0 of study_r3's pool in every study_r3_dilated train.log header
JAX_FOLD0 = {"slices": 1916, "train": 1532, "test": 384, "steps": 127, "canvas": 256}
HEADER = re.compile(r"train slices=(\d+) val slices=(\d+) steps/epoch=(\d+) canvas=(\d+)")


def _arm_record(root: str, arm_dir: str, summary: Dict[str, dict],
                protocol: Protocol = R3) -> dict:
    vd = np.load(os.path.join(root, arm_dir, "run-fold0", "valdice.npz"))["valdice"]
    top, epoch = best(vd)
    rec = {"epochs_completed": completed_epochs(vd),
           "windows": window_means(vd, protocol.windows),
           "best_val_dice": top, "best_epoch": epoch,
           protocol.best_key: best(vd, protocol.first_epochs)[0]}
    if protocol is DILATED:
        a, b = DILATED_ORDER
        rec[f"mean_{a}_{b - 1}"] = (float(np.mean(vd[a:b])) if rec["epochs_completed"] >= b
                                    else None)
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


def load(jax_root: str, port_root: str, protocol: Protocol = R3) -> dict:
    """Every study's records: ``{"jax": {arm: rec}, "port": {seed: {arm: rec}}}``."""
    out = {"jax": {}, "port": {}}
    jax_summary = _summary(os.path.join(jax_root, "summary.json"))
    for arm in protocol.arms:
        out["jax"][arm] = _arm_record(jax_root, arm, jax_summary, protocol)
    for seed in port_seeds(port_root):
        sfx = "" if seed == 1 else f"-s{seed}"
        summary = _summary(os.path.join(port_root, f"summary{sfx}.json"))
        out["port"][seed] = {arm: _arm_record(port_root, arm + sfx, summary, protocol)
                             for arm in protocol.arms}
    return out


def expected_fold0(num_slices: int, batch_size: int) -> Dict[str, int]:
    """The header's figures of fold 0 of ``study_r3``'s split of
    ``num_slices`` (the test list every fifth slice); at 1,916 slices and
    batch 12 ``JAX_FOLD0``."""
    test = len(range(0, num_slices, 5))
    return {"slices": num_slices, "train": num_slices - test, "test": test,
            "steps": (num_slices - test) // batch_size, "canvas": JAX_FOLD0["canvas"]}


def identity(jax_root: str, port_root: str, slices: int = JAX_FOLD0["slices"]) -> List[str]:
    """What differs from the dilated study in any arm's ``config.json`` and
    ``log.txt`` headers (see the module docstring); empty when none does."""
    runs = [(os.path.join(jax_root, arm), JAX_FOLD0["slices"]) for arm in DILATED.arms]
    runs += [(os.path.join(port_root, arm + ("" if seed == 1 else f"-s{seed}")), slices)
             for seed in port_seeds(port_root) for arm in DILATED.arms]
    faults = []
    for arm_root, n in runs:
        run_dir = os.path.join(arm_root, "run-fold0")
        with open(os.path.join(run_dir, "config.json")) as f:
            config = json.load(f)
        if config.get("ref_quirk_bn_eval_after_first_epoch") is not True:
            faults.append(f"{run_dir}: the BatchNorm quirk is not on")
        if config.get("epoch") != DILATED_EPOCHS:
            faults.append(f"{run_dir}: epoch {config.get('epoch')}, not {DILATED_EPOCHS}")
        fold = expected_fold0(n, config["batch_size"])
        want = (fold["train"], fold["test"], fold["steps"], fold["canvas"])
        with open(os.path.join(run_dir, "log.txt")) as f:
            headers = [tuple(int(x) for x in m) for m in HEADER.findall(f.read())]
        if not headers or any(h != want for h in headers):
            faults.append(f"{run_dir}: log headers {headers}, not {want}")
    return faults


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


def verdict_dilated(records: dict) -> dict:
    """Rules (a)-(d) of ``--protocol dilated`` on ``load``'s records."""
    jax, port = records["jax"], records["port"]
    rules = {}
    a, b = DILATED_ORDER
    key = f"mean_{a}_{b - 1}"

    def rule(checks, missing):
        return {"checks": checks, "not_evaluated": missing, "verdict": _verdict(checks)}

    checks, missing = [], []
    if 1 in port and None not in (port[1]["Control"][key], port[1]["Experiment"][key]):
        gap = port[1]["Control"][key] - port[1]["Experiment"][key]
        checks.append({"seed": 1, "epochs": f"{a}-{b - 1}", "control": port[1]["Control"][key],
                       "experiment": port[1]["Experiment"][key], "gap": gap,
                       "jax_gap": _gap(jax, key), "pass": bool(gap >= DILATED_ORDER_GAP)})
    else:
        missing.append({"seed": 1, "epochs": f"{a}-{b - 1}"})
    rules["a"] = rule(checks, missing)

    checks, missing = [], []
    for arm in DILATED.arms:
        for a, b in DILATED_EARLY:
            w = f"{a}-{b}"
            got = [port[s][arm]["windows"][w] for s in port
                   if port[s][arm]["windows"][w] is not None]
            if not got or jax[arm]["windows"][w] is None:
                missing.append({"arm": arm, "window": w})
                continue
            band = max(MIN_BAND, 3 * _spread(got))
            checks.append({"arm": arm, "window": w, "seeds": len(got),
                           **_within(jax[arm]["windows"][w], float(np.mean(got)), band)})
    rules["b"] = rule(checks, missing)

    checks, missing = [], []
    for arm in DILATED.arms:
        spread = max(_spread([port[s][arm]["windows"][f"{a}-{b}"] for s in port
                              if port[s][arm]["windows"][f"{a}-{b}"] is not None])
                     for a, b in DILATED_SPREAD)
        for a, b in DILATED_LATE[arm]:
            w = f"{a}-{b}"
            got = port[1][arm]["windows"][w] if 1 in port else None
            want = jax[arm]["windows"][w]
            if got is None or want is None:
                missing.append({"arm": arm, "window": w})
                continue
            checks.append({"arm": arm, "window": w,
                           **_within(want, got, max(MIN_BAND, 3 * spread))})
    rules["c"] = rule(checks, missing)

    checks, missing = [], []
    for arm in DILATED.arms:
        got = port[1][arm]["test_dice_slice"] if 1 in port else None
        want = jax[arm]["test_dice_slice"]
        tops = [port[s][arm][DILATED.best_key] for s in port
                if port[s][arm][DILATED.best_key] is not None]
        if got is None or want is None:
            missing.append({"arm": arm})
            continue
        checks.append({"arm": arm, "seeds": len(tops),
                       **_within(want, got, max(MIN_BAND, 3 * _spread(tops)))})
    rules["d"] = rule(checks, missing)
    return rules


def _gap(arms: dict, key: str) -> Optional[float]:
    c, e = arms["Control"][key], arms["Experiment"][key]
    return None if c is None or e is None else c - e


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


def render(records: dict, rules: dict, protocol: Protocol = R3) -> str:
    """Each arm's table (JAX, then the port's seeds) and the rules' checks."""
    lines = []
    for arm in protocol.arms:
        lines.append(f"== {arm} ==")
        head = ["run"] + [f"{a}-{b}" for a, b in protocol.windows] + [
            "best (epoch)", "test DSC slice", "test DSC patient", "HD95 slice"]
        lines.append("| " + " | ".join(head) + " |")
        lines.append("|" + "---|" * len(head))
        runs = [("JAX", records["jax"][arm])] + [
            (f"port seed {s}", records["port"][s][arm]) for s in records["port"]]
        for name, rec in runs:
            cells = [name] + [_fmt(rec["windows"][f"{a}-{b}"], 3) for a, b in protocol.windows]
            cells.append(f"{_fmt(rec['best_val_dice'])} ({rec['best_epoch']})")
            cells += [_fmt(rec["test_dice_slice"]), _fmt(rec["test_dice_patient"]),
                      _fmt(rec["test_hd95_slice"], 2)]
            lines.append("| " + " | ".join(cells) + " |")
    for rule, res in rules.items():
        lines.append(f"rule ({rule}): {res['verdict']}")
        for c in res["checks"]:
            lines.append("  " + json.dumps(c))
        for c in res.get("not_evaluated", []):
            lines.append("  not evaluated: " + json.dumps(c))
    lines.append(f"verdict: {overall(rules)}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax", default="study_r3")
    ap.add_argument("--port", default="study_torch")
    ap.add_argument("--json", default="", help="default: <port>/compare.json")
    ap.add_argument("--protocol", default="r3", choices=["r3", "dilated"],
                    help="r3: study_r3's three arms; dilated: study_r3_dilated's two")
    ap.add_argument("--slices", type=int, default=JAX_FOLD0["slices"],
                    help="dilated: the port's pool (its fold 0 the log headers must read)")
    args = ap.parse_args(argv)
    protocol = DILATED if args.protocol == "dilated" else R3
    if protocol is DILATED:
        faults = identity(args.jax, args.port, args.slices)
        if faults:
            raise SystemExit("not the dilated study:\n" + "\n".join(faults))
    records = load(args.jax, args.port, protocol)
    rules = verdict_dilated(records) if protocol is DILATED else verdict(records)
    print(render(records, rules, protocol))
    out = {"jax_root": args.jax, "port_root": args.port,
           "records": {"jax": records["jax"],
                       "port": {str(s): r for s, r in records["port"].items()}},
           "rules": rules, "verdict": overall(rules)}
    if protocol is DILATED:
        out["protocol"] = "dilated"
    with open(args.json or os.path.join(args.port, "compare.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
