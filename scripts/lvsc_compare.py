"""Hold the port's LVSC rehearsal against the JAX package's.

    python scripts/lvsc_compare.py [--jax lvsc_rehearsal] [--port lvsc_torch]
        [--json <port>/compare.json]

Reads JAX's kept run (``<jax>/run-fold0/valdice.npz``, 36 epochs; the header
of ``<jax>/train_r5.log``; ``<jax>/eval_r5.log``), the ``val:`` lines of its
earlier 40-epoch attempt (``<jax>/train.log``), and the port's run as
``scripts/lvsc_rehearsal_torch.py`` leaves it (``<port>/run-fold0/
{valdice.npz,log.txt}``, ``<port>/eval.log``).  Prints the validation Dice
windows, the best epoch and the evaluation of both, and writes them with the
verdict to ``<port>/compare.json``.

The verdict follows three rules, fixed before any port run:

(a) The rise: the port's best validation Dice over the epochs it ran is at
    least ``RISE_DICE``, at an epoch no later than ``RISE_EPOCH``.
(b) The trajectory: in each window of ``WINDOWS`` (epochs, both ends
    included) the port's mean validation Dice lies within the two JAX runs'
    means widened by ``BAND`` on each side.  A window the port did not
    finish is not evaluated.
(c) The evaluation of ``best_ckp`` on fold 0: overall Dice at least JAX's
    less ``DICE_MARGIN``, overall HD95 at most JAX's plus ``HD95_MARGIN``,
    over JAX's slice and patient counts.  Without ``eval.log``: not
    evaluated.

Before the rules, the port's header must give JAX's training and validation
slice counts, steps an epoch and canvas; a mismatch exits non-zero after the
JSON is written.  Exits 0 whatever the verdict.  Uses numpy and json only.
"""
from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

WINDOWS = ((0, 5), (6, 11), (12, 17))
BAND = 0.10
RISE_DICE = 0.94
RISE_EPOCH = 11
DICE_MARGIN = 0.03
HD95_MARGIN = 1.50
IDENTITY_KEYS = ("train", "val", "steps", "canvas")


def completed_epochs(valdice: np.ndarray) -> int:
    """Epochs that ran: a run that stopped early leaves trailing zeros."""
    nz = np.where(np.nan_to_num(valdice) != 0)[0]
    return int(nz[-1] + 1) if nz.size else 0


def window_means(valdice: np.ndarray) -> Dict[str, Optional[float]]:
    """Mean validation Dice over each window that the run finished."""
    ran = completed_epochs(valdice)
    return {f"{a}-{b}": (float(np.mean(valdice[a:b + 1])) if ran > b else None)
            for a, b in WINDOWS}


def read_val_lines(log_path: str) -> np.ndarray:
    """The "All" Dice of every ``val: <epoch>`` line of a log, by epoch."""
    vals = {}
    with open(log_path) as f:
        for line in f:
            m = re.search(r"val: (\d+), .*All: ([\d.]+)\]", line)
            if m:
                vals[int(m[1])] = float(m[2])
    return np.array([vals[e] for e in range(len(vals))])


def read_header(log_path: str) -> Dict[str, int]:
    """``train slices=... val slices=... steps/epoch=... canvas=...``."""
    with open(log_path) as f:
        for line in f:
            m = re.search(r"train slices=(\d+) val slices=(\d+) steps/epoch=(\d+) "
                          r"canvas=(\d+)", line)
            if m:
                return dict(zip(IDENTITY_KEYS, map(int, m.groups())))
    raise SystemExit(f"{log_path}: no 'train slices=' header")


def read_eval(log_path: str) -> Optional[dict]:
    """Overall and per-patient Dice and HD95, the slice and patient counts and
    slices/s of an inference log; None if there is no such log."""
    if not os.path.isfile(log_path):
        return None
    with open(log_path) as f:
        text = f.read()
    overall = re.search(r"overall Dice: ([\d.na]+), overall HD95: ([\d.na]+)", text)
    patient = re.search(r"Per-patient \((\d+) patients\) Dice: ([\d.na]+), HD95: ([\d.na]+)",
                        text)
    rate = re.search(r"(\d+) slices in ([\d.]+)s \(([\d.]+) slices/s\)", text)
    if not (overall and patient and rate):
        raise SystemExit(f"{log_path}: no overall, per-patient or slices line")
    return {"dice": float(overall[1]), "hd95": float(overall[2]),
            "patients": int(patient[1]), "dice_patient": float(patient[2]),
            "hd95_patient": float(patient[3]), "slices": int(rate[1]),
            "seconds": float(rate[2]), "slices_per_s": float(rate[3])}


def _record(valdice: np.ndarray) -> dict:
    ran = completed_epochs(valdice)
    best = int(np.argmax(valdice[:ran])) if ran else None
    return {"epochs": ran, "valdice": [float(v) for v in valdice[:ran]],
            "windows": window_means(valdice),
            "best_val_dice": None if best is None else float(valdice[best]),
            "best_epoch": best}


def load(jax_root: str, port_root: str) -> dict:
    jax = _record(np.load(os.path.join(jax_root, "run-fold0", "valdice.npz"))["valdice"])
    jax["header"] = read_header(os.path.join(jax_root, "train_r5.log"))
    jax["eval"] = read_eval(os.path.join(jax_root, "eval_r5.log"))
    attempt = _record(read_val_lines(os.path.join(jax_root, "train.log")))
    port = _record(np.load(os.path.join(port_root, "run-fold0", "valdice.npz"))["valdice"])
    port["header"] = read_header(os.path.join(port_root, "run-fold0", "log.txt"))
    port["eval"] = read_eval(os.path.join(port_root, "eval.log"))
    return {"jax": jax, "jax_attempt": attempt, "port": port}


def _verdict(checks: List[dict]) -> str:
    if not checks:
        return "not evaluated"
    return "pass" if all(c["pass"] for c in checks) else "fail"


def verdict(records: dict) -> dict:
    """Rules (a)-(c) of the module docstring on ``load``'s records."""
    jax, attempt, port = records["jax"], records["jax_attempt"], records["port"]
    rules = {}

    checks = []
    if port["best_epoch"] is not None:
        checks.append({"best_val_dice": port["best_val_dice"], "epoch": port["best_epoch"],
                       "at_least": RISE_DICE, "epoch_at_most": RISE_EPOCH,
                       "pass": bool(port["best_val_dice"] >= RISE_DICE
                                    and port["best_epoch"] <= RISE_EPOCH)})
    rules["a"] = {"checks": checks, "verdict": _verdict(checks)}

    checks = []
    for key, got in port["windows"].items():
        runs = [r["windows"][key] for r in (jax, attempt)]
        if got is None or None in runs:
            continue
        band = [min(runs) - BAND, max(runs) + BAND]
        checks.append({"window": key, "port": got, "jax_r5": runs[0], "jax_attempt": runs[1],
                       "band": band, "pass": bool(band[0] <= got <= band[1])})
    rules["b"] = {"checks": checks, "verdict": _verdict(checks)}

    checks = []
    got, want = port["eval"], jax["eval"]
    if got is not None:
        checks = [
            {"metric": "overall Dice", "port": got["dice"], "jax": want["dice"],
             "at_least": want["dice"] - DICE_MARGIN,
             "pass": bool(got["dice"] >= want["dice"] - DICE_MARGIN)},
            {"metric": "overall HD95", "port": got["hd95"], "jax": want["hd95"],
             "at_most": want["hd95"] + HD95_MARGIN,
             "pass": bool(got["hd95"] <= want["hd95"] + HD95_MARGIN)},
            {"metric": "slices", "port": got["slices"], "jax": want["slices"],
             "pass": got["slices"] == want["slices"]},
            {"metric": "patients", "port": got["patients"], "jax": want["patients"],
             "pass": got["patients"] == want["patients"]}]
    rules["c"] = {"checks": checks, "verdict": _verdict(checks)}
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


def render(records: dict, identity: dict, rules: dict) -> str:
    lines = ["| run | " + " | ".join(f"{a}-{b}" for a, b in WINDOWS)
             + " | best (epoch) | overall Dice | HD95 | patient Dice | slices/s |",
             "|" + "---|" * (len(WINDOWS) + 6)]
    for name in ("jax", "jax_attempt", "port"):
        rec = records[name]
        ev = rec.get("eval") or {}
        lines.append("| " + " | ".join(
            [name] + [_fmt(rec["windows"][f"{a}-{b}"]) for a, b in WINDOWS]
            + [f"{_fmt(rec['best_val_dice'])} ({rec['best_epoch']})", _fmt(ev.get("dice")),
               _fmt(ev.get("hd95"), 2), _fmt(ev.get("dice_patient")),
               _fmt(ev.get("slices_per_s"), 1)]) + " |")
    lines.append(f"identity: {json.dumps(identity)}")
    for rule, res in rules.items():
        lines.append(f"rule ({rule}): {res['verdict']}")
        for c in res["checks"]:
            lines.append("  " + json.dumps(c))
    lines.append(f"verdict: {overall(rules)}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax", default="lvsc_rehearsal")
    ap.add_argument("--port", default="lvsc_torch")
    ap.add_argument("--json", default="", help="default: <port>/compare.json")
    args = ap.parse_args(argv)
    records = load(args.jax, args.port)
    want, got = records["jax"]["header"], records["port"]["header"]
    identity = {"port": got, "jax": want, "pass": got == want}
    rules = verdict(records)
    print(render(records, identity, rules))
    out = {"jax_root": args.jax, "port_root": args.port, "identity": identity,
           "records": records, "rules": rules, "verdict": overall(rules)}
    with open(args.json or os.path.join(args.port, "compare.json"), "w") as f:
        json.dump(out, f, indent=2)
    if not identity["pass"]:
        raise SystemExit(f"identity check failed: port {got}, JAX {want}")
    return out


if __name__ == "__main__":
    main()
