"""The three-arm quality study, trained and evaluated by the PyTorch port.

    python scripts/quality_study_torch.py [--root study_torch] [--epochs 400]
        [--slices 1916] [--difficulty hard] [--seed 1]
        [--arms Control Experiment Upperbound] [--stop_after_epoch K]
        [--gpu 0] [--device cuda|cpu] [-- <extra cli.train args>]

The protocol of ``scripts/quality_study.sh``, through the port's own entry
points.  For each arm: train with ``pacingpseudo_torch.cli.train`` on the
argv that the shell script gives ``train_chaos.py`` (fold 0, T1, a hard
synthetic pool of ``--slices`` phantoms written under ``<root>/data`` by the
first arm, under a lock, and reused by the others, ``--max_restarts 2``;
the four pacing flags for Experiment), then evaluate its best checkpoint with
``pacingpseudo_torch.cli.inference`` (per-slice DSC and HD95 into
``<arm>/outputs``, its log copied to ``<arm>/eval.log``), then touch
``<arm>/DONE``.  An arm with a ``DONE`` marker is skipped; one that holds a
checkpoint but no marker is resumed (``--resume``), its ``valdice.npz``
keeping the earlier epochs.  After the arms, ``<root>/summary.json`` is
written by ``pacingpseudo_torch.tools.study_summary``.

``--stop_after_epoch K`` stops each arm's training after epoch K, with the
schedules still spanning ``--epochs``; the best checkpoint so far is
evaluated, and the arm is not marked ``DONE``, so a later call without the
option trains it on to the end.  Seeds other than 1 put ``-s<seed>`` after
every arm directory and the pool (``Control-s2``, ``data-s2``) and write
``summary-s<seed>.json``.

The arms run in this process, one after another, on ``--gpu`` (CUDA
indices, as ``cli.train`` takes them): three arms on three cards are three
calls, ``--arms X --gpu i`` each.  The study runs on a card: without CUDA
it exits, unless ``--device cpu`` asks for the CPU.  What follows ``--`` is
appended to every ``cli.train`` argv (a smaller model for a test).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ARMS = ("Control", "Experiment", "Upperbound")
# The pacing losses of the Experiment arm (quality_study.sh:58)
ARM_FLAGS = {"Experiment": ["--do_loss_ent", "--do_decoder_consistency", "--do_aux_path",
                            "--do_memory"]}
DATASET = "chaost1"


def suffix(seed: int) -> str:
    """What follows an arm directory, the pool and the summary for ``seed``."""
    return "" if seed == 1 else f"-s{seed}"


def arm_dir(root: str, arm: str, seed: int) -> str:
    return os.path.join(root, arm + suffix(seed))


def data_root(root: str, seed: int) -> str:
    """The pool of ``seed``'s arms (``cli.train`` writes it with that seed)."""
    return os.path.join(root, "data" + suffix(seed))


def train_argv(arm: str, root: str, epochs: int, slices: int, difficulty: str, seed: int,
               gpu: str, extra: List[str] = ()) -> List[str]:
    """``cli.train``'s argv for one arm, as ``quality_study.sh:41-45`` builds
    ``train_chaos.py``'s, with the seed and the devices added."""
    return ["--session", arm, "--tag", "study_torch", "--fold", "0", "--modality", "t1",
            "--epoch", str(epochs), "--synthetic_data", str(slices),
            "--synthetic_difficulty", difficulty,
            "--data_root", data_root(root, seed),
            "--run_dir", os.path.join(arm_dir(root, arm, seed), "run-fold0"),
            "--max_restarts", "2", "--seed", str(seed), "--gpu", gpu,
            *ARM_FLAGS.get(arm, []), *extra]


def arm_config(argv: List[str]):
    """The ``ExperimentConfig`` that ``cli.train`` builds from ``argv``."""
    from pacingpseudo_torch.cli import train as train_cli
    return train_cli.config_from_args(train_cli.build_parser().parse_args(argv))


def write_pool(argv: List[str]) -> None:
    """The pool that ``cli.train`` writes for ``argv``, written under a lock
    in the data directory: arms that start together (one a card) write it
    once, and ``cli.train`` finds it in place."""
    import fcntl

    from pacingpseudo_torch.cli import train as train_cli
    args = train_cli.build_parser().parse_args(argv)
    os.makedirs(args.data_root, exist_ok=True)
    with open(os.path.join(args.data_root, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        train_cli.write_synthetic_pool(args, train_cli.config_from_args(args))


# The model's flags that cli.inference takes too: a study whose extra
# cli.train args change one passes it on.
MODEL_FLAGS = ("input_ch", "init_ch", "max_ch", "output_stride", "compute_dtype")


def inference_argv(arm_root: str, data_root: str, gpu: str, config) -> List[str]:
    """``cli.inference``'s argv for one arm (``quality_study.sh:48-51``), with
    the model's flags where ``config`` (the arm's) differs from their
    defaults."""
    from pacingpseudo_torch.cli import inference as infer_cli
    defaults = infer_cli.build_parser().parse_args(["--fold", "0", "--checkpoint_file", ""])
    model = [a for flag in MODEL_FLAGS if getattr(config, flag) != getattr(defaults, flag)
             for a in (f"--{flag}", str(getattr(config, flag)))]
    return ["--dataset", DATASET, "--fold", "0",
            "--checkpoint_file", os.path.join(arm_root, "run-fold0"), "--best_ckp",
            "--data_root", data_root, "--root", os.path.join(arm_root, "outputs"),
            "--gpu", gpu, *model]


def _say(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _epoch_of(checkpoint: Optional[str]) -> int:
    """The epoch of ``ckps/ckp_<epoch>``, -1 for none."""
    return -1 if checkpoint is None else int(os.path.basename(checkpoint)[len("ckp_"):])


def run_arm(arm: str, args, extra: List[str]) -> None:
    """Train one arm (or carry it on), evaluate its best checkpoint and mark
    it ``DONE`` when its training reached the last epoch.  A stopped arm
    without a best checkpoint yet is not evaluated."""
    from pacingpseudo_torch.cli import inference as infer_cli
    from pacingpseudo_torch.cli import train as train_cli
    from pacingpseudo_torch.train.checkpoint import latest_checkpoint, resolve_checkpoint_path

    rd = arm_dir(args.root, arm, args.seed)
    if os.path.exists(os.path.join(rd, "DONE")):
        _say(f"skip {arm} (done)")
        return
    run_dir = os.path.join(rd, "run-fold0")
    argv = train_argv(arm, args.root, args.epochs, args.slices, args.difficulty, args.seed,
                      args.gpu, extra)
    last = _epoch_of(latest_checkpoint(run_dir))
    if last >= 0:
        argv.append("--resume")
    stop = args.stop_after_epoch
    if stop is not None and last >= stop:
        _say(f"{arm}: trained to epoch {last} already")
    else:
        write_pool(argv)
        _say(f"training {arm}" + (f" to epoch {stop}" if stop is not None else "")
             + (f" from the checkpoint of epoch {last}" if last >= 0 else ""))
        train_cli.main(argv, stop_after_epoch=stop)
    _release()
    done = _epoch_of(latest_checkpoint(run_dir)) == args.epochs - 1
    if not done and not os.path.exists(resolve_checkpoint_path(run_dir, DATASET, True)):
        # a validation Dice of 0 so far saves no best checkpoint
        _say(f"{arm}: no best checkpoint yet, not evaluated")
        return
    _say(f"evaluating {arm}")
    infer_cli.main(inference_argv(rd, data_root(args.root, args.seed), args.gpu,
                                  arm_config(argv)))
    shutil.copyfile(os.path.join(rd, "outputs", "Inference", DATASET, "run-fold0", "log.txt"),
                    os.path.join(rd, "eval.log"))
    _release()
    if done:
        open(os.path.join(rd, "DONE"), "w").close()


def _release() -> None:
    """Hand the last arm's cached device memory back before the next."""
    import gc

    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="study_torch")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--slices", type=int, default=1916)
    p.add_argument("--difficulty", default="hard", choices=["easy", "hard", "jagged"])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--arms", nargs="+", default=list(ARMS), choices=ARMS)
    p.add_argument("--stop_after_epoch", type=int, default=None,
                   help="stop each arm's training after this epoch (not marked DONE)")
    p.add_argument("--gpu", default="0", help="CUDA indices for cli.train and cli.inference")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cpu' runs the study on the CPU; the default needs CUDA")
    return p


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Run the study; returns the summary's rows."""
    argv = list(sys.argv[1:] if argv is None else argv)
    extra: List[str] = []
    if "--" in argv:
        cut = argv.index("--")
        argv, extra = argv[:cut], argv[cut + 1:]
    args = build_parser().parse_args(argv)
    if args.device == "cpu":
        args.gpu = "cpu"
    else:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the study runs on a card "
                             "(--device cpu runs it on the CPU)")
    os.makedirs(args.root, exist_ok=True)
    for arm in args.arms:
        run_arm(arm, args, extra)

    from pacingpseudo_torch.tools import study_summary
    summary = os.path.join(args.root, f"summary{suffix(args.seed)}.json")
    arms = [a + suffix(args.seed) for a in ARMS]
    study_summary.main(["--root", args.root, "--arms", *arms, "--json", summary])
    _say(f"wrote {summary}")
    with open(summary) as f:
        return json.load(f)


if __name__ == "__main__":
    main()
