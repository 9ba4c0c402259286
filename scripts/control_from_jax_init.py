"""Train the port from JAX's own initial variables: the Control arm on ``study_r3``'s pool and split, or both arms of one fold of the five-fold jagged sweep.

    python scripts/control_from_jax_init.py --init build/jax_init/control_seed1.pt \\
        [--root study_torch_jaxinit] [--seeds 1 2 3] [--stop_after_epoch 9] [--slices 1916]
        [--gpu 0]
        [--device cuda|cpu] [-- <extra cli.train args>]
    python scripts/control_from_jax_init.py --sweep_fold 0 \\
        --init build/jax_init/control80_seed1.pt \\
        --init_experiment build/jax_init/experiment80_seed1.pt \\
        [--parts jax_init seeds] [--seeds 2 3] [--root study_torch_fault3]
        [--slices 1916] [--epochs 80] [--gpu 0] [--device cuda|cpu] [--summarize]
        [-- <extra cli.sweep args>]

**study_r3's Control arm** (without ``--sweep_fold``).  The test of the
port's Control arm validating above JAX's in epochs 0-9
under train-mode BatchNorm (``study_r3``: JAX 0.1155 over epochs 0-9; the
port, from its own draws of seeds 1 / 2 / 3, 0.201 / 0.185 / 0.211, mean
0.1992).  Both kept JAX runs are seed 1, so the port's draws and JAX's one
draw differ.  This script takes the draw away: ``--init`` is JAX's seed-1
initial variables of the kept Control run (``study_r3/Control/run-fold0/
config.json``), drawn on a CPU by ``tests/jax_init.py`` as JAX's loop draws
them and converted to the port's state_dict.  Each seed of ``--seeds`` then
trains the Control arm with ``cli.train`` on the argv that
``scripts/quality_study_torch.py --r3_split`` gives it (``study_r3``'s 1,916
hard phantoms with skeleton scribbles and its every-fifth-slice split,
written under ``<root>/data``; the 400-epoch schedule, stopped after
``--stop_after_epoch``; train-mode BatchNorm; a fresh optimiser), its
initial weights and BatchNorm statistics replaced by ``--init``'s before the
first update.  The seed still sets the batches' order and the augmentation.
The pool is checked against JAX's header before training and every log
after, as the study runner checks them.

Decision rule, fixed before the run on the card: take the mean validation
Dice over epochs 0-9 of each seed (``valdice.npz``), and the mean of that
over the seeds.
- at most 0.14: the initial draw explains the miss (JAX 0.1155);
- at least 0.17: the draw is ruled out (the port's own draws read 0.1992),
  and what is left is what only the TPU ran;
- between: inconclusive.

Writes ``<root>/jax_init.json``: the init file's sha256 (over its
state_dict's tensors, as ``tests/jax_init.py`` prints it) and leaf count,
each seed's epoch 0 and 0-9 mean, the mean over the seeds and the verdict.
A restart inside a seed's run resumes from its checkpoint.  Without CUDA the
script exits, unless ``--device cpu`` asks for the CPU.

**A fold of the jagged sweep** (``--sweep_fold N``): draw against defect
for the port's pacing gap on ``study_r5/sweep/`` (the port's seed 1 wins 3
of 5 folds by +0.0063 where JAX's seed 1 wins 5 of 5 by +0.0603; on fold 0
the port reads -0.0152 against JAX's +0.0900, ``study_torch_sweep/
compare.json``).  Two parts, each a run of both arms on fold ``N`` through
``cli.sweep``'s own path (``scripts/sweep_torch.py``'s ``run_fold``: the
80-epoch schedule, the best checkpoint's per-slice test DSC and HD95), on
one pool written once under ``<root>/data`` and held against JAX's headers:

(i) ``jax_init``: seed 1, each arm's initial variables replaced by JAX's
    seed-1 draw of that arm (``--init`` Control's, ``--init_experiment``
    the Experiment's; ``tests/jax_init.py --config study_r5/sweep/
    <arm>80.log`` draws them from the arm log's ``config:`` line), written
    under ``<root>/jax_init/<arm>80/``;
(ii) ``seeds``: the port's own draws of ``--seeds`` (default 2 and 3),
    under ``<root>/seed<S>/<arm>80/``.

The gap of a run is Experiment minus Control per-slice test DSC on the fold
(``scripts/sweep_compare.py``'s fold gap).  Decision rule, fixed before
the first run on the card (on fold 0 JAX's seed 1 reads +0.0900):
- *explained by the draw*: the gap of (i) is at least +0.05;
- *not the draw*: the gap of (i) is at most +0.02 and every gap of (ii)
  lies below +0.03;
- otherwise *still open*; *incomplete* while a run is missing.
Each call writes ``<root>/fault3.json`` over the runs present (calls that
each write the pool copy the earlier calls' fold JSONs back first): each
run's DSC, HD95, validation windows, best epochs and gap, the port's seed 1
and JAX's seeds beside them, the rule's verdict and each init file's
sha256.  ``--summarize`` writes it again over the runs present, on any
machine.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from scripts import quality_study_torch as study  # noqa: E402

SLICES = 1916                # study_r3's pool
EXPLAINED, RULED_OUT = 0.14, 0.17
WINDOW = 10                  # epochs 0-9
# The sweep fold's rule (module docstring).
DRAW_EXPLAINS, NOT_DRAW_I, NOT_DRAW_II = 0.05, 0.02, 0.03
SWEEP_PARTS = ("jax_init", "seeds")
SWEEP_SEEDS = (2, 3)
LATE_WINDOW = (40, 80)       # reported beside the rule: the Experiment arm's late fall
PORT_SEED1 = os.path.join(ROOT, "study_torch_sweep")     # the port's seed-1 sweep


def verdict(mean: float) -> str:
    """The decision rule of the module docstring."""
    if mean <= EXPLAINED:
        return "the initial draw explains the miss"
    if mean >= RULED_OUT:
        return "the initial draw is ruled out"
    return "inconclusive"


def state_dict_digest(sd) -> str:
    """sha256 over a state_dict: each key, then its tensor's bytes."""
    digest = hashlib.sha256()
    for key, value in sd.items():
        digest.update(key.encode())
        digest.update(value.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def load_init(path: str):
    """The state_dict of ``--init``, with its digest and leaf count."""
    import torch
    sd = torch.load(path, map_location="cpu")
    return sd, state_dict_digest(sd), len(sd)


def _from_init(make_state, sd):
    """``create_train_state`` that loads ``sd`` into the fresh model."""
    def create(config, **kw):
        state = make_state(config, **kw)
        missing, unexpected = state.model.load_state_dict(sd, strict=False)
        if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
            raise SystemExit(f"--init does not fit the model: missing {missing}, "
                             f"unexpected {unexpected}")
        study._say(f"the fresh {config.session} model holds --init's {len(sd)} leaves")
        return state
    return create


def run_seed(seed: int, args, extra: List[str], sd) -> Dict[str, float]:
    """Train one seed from ``sd``; its epoch 0 and 0-9 mean."""
    import numpy as np

    from pacingpseudo_torch.cli import train as train_cli
    from pacingpseudo_torch.train import loop
    from scripts.study_r3_pool_torch import expected_fold0

    argv = study.train_argv("Control", args.root, 400, args.slices, "hard", seed, args.gpu,
                            extra, r3_split=True, tag="study_torch_jaxinit")
    config = study.arm_config(argv)
    study.write_pool(argv, args.slices, "skeleton")
    run_dir = os.path.join(study.arm_dir(args.root, "Control", seed), "run-fold0")
    make_state = loop.create_train_state
    loop.create_train_state = _from_init(make_state, sd)
    try:
        study._say(f"seed {seed}: training from --init to epoch {args.stop_after_epoch}")
        train_cli.main(argv, stop_after_epoch=args.stop_after_epoch)
    finally:
        loop.create_train_state = make_state
    expected = expected_fold0(args.slices, config.batch_size)
    cap = train_cli.build_parser().parse_args(argv).max_steps_per_epoch
    if cap:
        expected["steps"] = min(expected["steps"], cap)
    study.check_log(run_dir, config, expected)
    study._release()
    valdice = np.load(os.path.join(run_dir, "valdice.npz"))["valdice"]
    ran = min(WINDOW, args.stop_after_epoch + 1)      # a rehearsal may stop sooner
    return {"epoch0": float(valdice[0]), "window_0_9": float(np.mean(valdice[:ran]))}


def sweep_verdict(gap_i: Optional[float], gaps_ii: List[float], seeds: int) -> str:
    """The sweep fold's decision rule (module docstring): ``gap_i`` the gap
    of the run from JAX's draws, ``gaps_ii`` those of the port's own
    ``seeds`` draws present so far."""
    if gap_i is None:
        return "incomplete"
    if gap_i >= DRAW_EXPLAINS:
        return "explained by the draw"
    if gap_i > NOT_DRAW_I:
        return "still open"
    if len(gaps_ii) < seeds:
        return "incomplete"
    return "not the draw" if all(g < NOT_DRAW_II for g in gaps_ii) else "still open"


def fold_reading(root: str, fold: int, epochs: int = 80) -> Optional[dict]:
    """Both arms' per-slice test DSC and HD95 on ``fold`` under ``root``
    (``<root>/<arm>80/fold<N>.json``), their validation windows (0-9,
    10-79, 40-79) and best epochs, and the gap; None while an arm is
    missing."""
    from scripts import sweep_compare
    side = sweep_compare.read_side(root, False, epochs)
    if any(fold not in side[arm] for arm in sweep_compare.ARMS):
        return None
    out = {arm: {k: side[arm][fold][k] for k in ("dice", "hd95", "val_0_9", "val_10_79")}
           for arm in sweep_compare.ARMS}
    for arm in sweep_compare.ARMS:
        curve = _curve(root, arm, fold, epochs)
        if curve is not None:
            out[arm]["val_40_79"] = sweep_compare._window(curve, LATE_WINDOW)
            out[arm]["best_epoch"] = int(curve.argmax())
    out["gap"] = out["Experiment"]["dice"] - out["Control"]["dice"]
    return out


def _curve(root: str, arm: str, fold: int, epochs: int):
    """The fold's validation Dice an epoch (``valdice.npz``), or None."""
    import numpy as np
    from scripts import sweep_compare
    path = os.path.join(root, sweep_compare.arm_name(arm, epochs), f"fold{fold}",
                        "valdice.npz")
    return np.load(path)["valdice"] if os.path.exists(path) else None


def sweep_summary(args, digests: Dict[str, str]) -> dict:
    """``<root>/fault3.json`` over the runs present under ``args.root``."""
    from scripts import sweep_compare
    fold = args.sweep_fold
    runs = {name: fold_reading(os.path.join(args.root, name), fold, args.epochs)
            for name in ["jax_init"] + [f"seed{s}" for s in args.seeds]}
    runs = {k: v for k, v in runs.items() if v is not None}
    gap_i = runs["jax_init"]["gap"] if "jax_init" in runs else None
    gaps_ii = [runs[f"seed{s}"]["gap"] for s in args.seeds if f"seed{s}" in runs]
    jax = sweep_compare.read_side(args.jax, True)
    jax_gap = jax["Experiment"][fold]["dice"] - jax["Control"][fold]["dice"]
    jax_curves = {arm: sweep_compare.parse_jax_log(
        os.path.join(args.jax, sweep_compare.arm_name(arm) + ".log"))[fold]["valdice"]
        for arm in sweep_compare.ARMS}
    seed2 = os.path.join(args.jax, "Control80_s2", f"fold{fold}.json")
    jax_control_s2 = None
    if os.path.exists(seed2):
        with open(seed2) as f:
            jax_control_s2 = json.load(f)["dice"]
    path = os.path.join(args.root, "fault3.json")
    if os.path.exists(path):                # a call without part (i) keeps its digests
        with open(path) as f:
            digests = {**json.load(f).get("init_sha256", {}), **digests}
    out = {"fold": fold, "runs": runs, "gap_i": gap_i, "gaps_ii": gaps_ii,
           "port_seed1": fold_reading(PORT_SEED1, fold),
           "jax_seed1": {**{arm: {"dice": jax[arm][fold]["dice"], "hd95": jax[arm][fold]["hd95"],
                                  "val_0_9": jax[arm][fold]["val_0_9"],
                                  "val_10_79": jax[arm][fold]["val_10_79"],
                                  "val_40_79": sweep_compare._window(jax_curves[arm],
                                                                     LATE_WINDOW),
                                  "best_epoch": int(jax_curves[arm].argmax())}
                             for arm in sweep_compare.ARMS}, "gap": jax_gap},
           "jax_control_seed2": jax_control_s2, "init_sha256": digests,
           "rule": {"draw_explains_min": DRAW_EXPLAINS, "not_draw_i_max": NOT_DRAW_I,
                    "not_draw_ii_below": NOT_DRAW_II},
           "verdict": sweep_verdict(gap_i, gaps_ii, len(args.seeds))}
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    return out


def run_sweep_fold(args, extra: List[str]) -> dict:
    """Both parts of the sweep fold (module docstring) that ``--parts``
    names, on one pool, then ``fault3.json``."""
    from pacingpseudo_torch.cli import sweep
    from pacingpseudo_torch.train import loop
    from scripts import sweep_torch

    fold = args.sweep_fold
    inits, digests = {}, {}
    if "jax_init" in args.parts:
        for arm, path in (("Control", args.init), ("Experiment", args.init_experiment)):
            if path is None:
                raise SystemExit(f"the jax_init part needs {arm}'s init file")
            inits[arm], digests[arm], leaves = load_init(path)
            study._say(f"{arm} init {path}: {leaves} leaves, sha256 {digests[arm]}")
    data_root = os.path.join(args.root, "data")
    pool_args = sweep_torch._parse(sweep_torch.sweep_argv(
        "Control", args.root, fold, args.epochs, args.slices, 1, args.gpu, extra))
    t0 = time.perf_counter()
    sweep.write_pool(pool_args)
    study._say(f"pool {data_root}: written or kept in {time.perf_counter() - t0:.1f} s")
    expected, patients = None, None
    if args.slices == sweep_torch.JAX_SLICES and pool_args.batch_size == sweep_torch.JAX_BATCH:
        expected = sweep_torch.jax_headers(args.jax, [fold])
        patients = sweep_torch.TEST_PATIENTS
    ident = sweep_torch.check_pool(data_root, [fold], pool_args.batch_size, expected,
                                   patients)[fold]
    checksum = sweep_torch.fold0_checksum(data_root)
    study._say(f"fold {fold}: {ident}; fold 0's arrays sha256 {checksum}")
    runs = ([("jax_init", 1)] if "jax_init" in args.parts else []) + (
        [(f"seed{s}", s) for s in args.seeds] if "seeds" in args.parts else [])
    make_state = loop.create_train_state
    for name, seed in runs:
        run_root = os.path.join(args.root, name)
        os.makedirs(run_root, exist_ok=True)
        link = os.path.join(run_root, "data")
        if not os.path.exists(link):
            os.symlink(os.path.abspath(data_root), link)
        for arm in sweep_torch.ARMS:
            ns = argparse.Namespace(root=run_root, epochs=args.epochs, slices=args.slices,
                                    seed=seed, gpu=args.gpu)
            if name == "jax_init":
                loop.create_train_state = _from_init(make_state, inits[arm])
            try:
                study._say(f"{name}: {arm} fold {fold}, seed {seed}")
                sweep_torch.run_fold(arm, fold, ns, extra, ident, checksum)
            finally:
                loop.create_train_state = make_state
            reading = fold_reading(run_root, fold, args.epochs)
            if reading is not None:
                study._say(f"{name}: gap {reading['gap']:+.4f} ({reading})")
    out = sweep_summary(args, digests)
    study._say(f"fold {fold}: gap (i) {out['gap_i']}, gaps (ii) {out['gaps_ii']}: "
               f"{out['verdict']}")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--init", help="the port's state_dict of JAX's draw (the Control "
                   "arm's, in the sweep mode)")
    p.add_argument("--root", help="default study_torch_jaxinit, or study_torch_fault3 "
                   "with --sweep_fold")
    p.add_argument("--seeds", nargs="+", type=int,
                   help="default 1 2 3, or the sweep mode's own seeds 2 3")
    p.add_argument("--stop_after_epoch", type=int, default=WINDOW - 1)
    p.add_argument("--slices", type=int, default=SLICES, help="the pool's size (a rehearsal's)")
    p.add_argument("--gpu", default="0", help="CUDA indices for cli.train")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cpu' runs on the CPU; the default needs CUDA")
    p.add_argument("--sweep_fold", type=int, help="run both arms of this fold of the "
                   "jagged sweep instead (module docstring)")
    p.add_argument("--init_experiment", help="the sweep mode: the Experiment arm's init")
    p.add_argument("--epochs", type=int, default=80, help="the sweep's schedule (a "
                   "rehearsal's)")
    p.add_argument("--parts", nargs="+", choices=SWEEP_PARTS, default=list(SWEEP_PARTS))
    p.add_argument("--jax", default=os.path.join(ROOT, "study_r5", "sweep"),
                   help="JAX's sweep directory")
    p.add_argument("--summarize", action="store_true", help="the sweep mode: only "
                   "write fault3.json over the runs present (no card needed)")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra: List[str] = []
    if "--" in argv:
        cut = argv.index("--")
        argv, extra = argv[:cut], argv[cut + 1:]
    args = build_parser().parse_args(argv)
    sweep_mode = args.sweep_fold is not None
    if args.root is None:
        args.root = "study_torch_fault3" if sweep_mode else "study_torch_jaxinit"
    if args.seeds is None:
        args.seeds = list(SWEEP_SEEDS) if sweep_mode else [1, 2, 3]
    if sweep_mode and args.summarize:
        out = sweep_summary(args, {})
        study._say(f"fold {args.sweep_fold}: gap (i) {out['gap_i']}, gaps (ii) "
                   f"{out['gaps_ii']}: {out['verdict']}")
        return out
    if args.device == "cpu":
        args.gpu = "cpu"
    else:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the run is on a card "
                             "(--device cpu runs it on the CPU)")
    os.makedirs(args.root, exist_ok=True)
    if sweep_mode:
        return run_sweep_fold(args, extra)
    if args.init is None:
        raise SystemExit("--init is required")
    sd, digest, leaves = load_init(args.init)
    study._say(f"--init {args.init}: {leaves} leaves, sha256 {digest}")
    seeds = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        seeds[str(seed)] = {**run_seed(seed, args, extra, sd),
                            "seconds": time.perf_counter() - t0}
        study._say(f"seed {seed}: {seeds[str(seed)]}")
    mean = sum(s["window_0_9"] for s in seeds.values()) / len(seeds)
    out = {"init_sha256": digest, "init_leaves": leaves, "seeds": seeds,
           "mean_window_0_9": mean, "jax_window_0_9": 0.1155,
           "port_own_draws_window_0_9": 0.1992, "verdict": verdict(mean)}
    with open(os.path.join(args.root, "jax_init.json"), "w") as f:
        json.dump(out, f, indent=2)
    study._say(f"mean over seeds {mean:.4f}: {out['verdict']}")
    return out


if __name__ == "__main__":
    main()
