"""The three-arm quality study, trained and evaluated by the PyTorch port.

    python scripts/quality_study_torch.py [--root study_torch] [--epochs 400]
        [--slices 1916] [--difficulty hard] [--seed 1]
        [--arms Control Experiment Upperbound] [--stop_after_epoch K]
        [--gpu 0] [--device cuda|cpu] [--r3_split] [--scribble_style skeleton|dilated]
        [--tag study_torch] [-- <extra cli.train args>]

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

``--r3_split`` trains every seed's arms on the pool that the JAX package's
``study_r3`` read: ``scripts/study_r3_pool_torch.py`` writes it once under
``<root>/data`` (``--slices`` hard phantoms of seed 1, the folds every fifth
slice), and ``cli.train`` runs without ``--synthetic_data``, which would cut
today's patient-level folds again.  Before any training the runner exits
unless the pool's marker names ``--slices`` and ``--scribble_style`` and fold
0 holds the figures ``study_r3_pool_torch.expected_fold0`` gives (at 1,916
slices and batch 12 those of JAX's ``train.log`` headers: 1,532 training and
384 test slices from 80 pseudo-patients, a canvas of 256, 127 updates an
epoch); after each arm's training, unless its log's header reads the same
figures and, under ``--ref_quirk_bn_eval_after_first_epoch``, the frozen-BN
step took over at epoch 1 (or at the epoch a resumed run started).

``--scribble_style dilated`` gives the scribbles of
``scripts/quality_study_dilated.sh`` (``study_r3_dilated``): with
``--r3_split`` to the pool's writer, without it to ``cli.train`` as
``--synthetic_scribble_style``.  ``--tag`` names the arms' runs
(``config.json``'s ``tag``).  The dilated study:

    python scripts/quality_study_torch.py --root study_torch_dilated --r3_split \
        --scribble_style dilated --tag study_torch_dilated --epochs 200 \
        --arms Control Experiment -- --ref_quirk_bn_eval_after_first_epoch

Each arm also leaves ``<arm>/resources.json``: the card's name and power
limit, the peak device memory its training allocated and reserved (the
captured graphs' pools included) and the process's peak resident set so
far.  The summary keeps the rows of an earlier call for the arms this call
did not run.
"""
from __future__ import annotations

import argparse
import json
import os
import re
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


def data_root(root: str, seed: int, r3_split: bool = False) -> str:
    """The pool of ``seed``'s arms (``cli.train`` writes it with that seed);
    with ``r3_split`` the one pool of every seed."""
    return os.path.join(root, "data" + ("" if r3_split else suffix(seed)))


def train_argv(arm: str, root: str, epochs: int, slices: int, difficulty: str, seed: int,
               gpu: str, extra: List[str] = (), r3_split: bool = False,
               scribble_style: str = "skeleton", tag: str = "study_torch") -> List[str]:
    """``cli.train``'s argv for one arm, as ``quality_study.sh:41-45`` (and
    ``quality_study_dilated.sh:41-45``) builds ``train_chaos.py``'s, with the
    seed and the devices added; with ``r3_split`` without the pool's flags
    (the pool is written beforehand)."""
    pool = [] if r3_split else ["--synthetic_data", str(slices),
                                "--synthetic_difficulty", difficulty]
    if not r3_split and scribble_style != "skeleton":
        pool += ["--synthetic_scribble_style", scribble_style]
    return ["--session", arm, "--tag", tag, "--fold", "0", "--modality", "t1",
            "--epoch", str(epochs), *pool,
            "--data_root", data_root(root, seed, r3_split),
            "--run_dir", os.path.join(arm_dir(root, arm, seed), "run-fold0"),
            "--max_restarts", "2", "--seed", str(seed), "--gpu", gpu,
            *ARM_FLAGS.get(arm, []), *extra]


def arm_config(argv: List[str]):
    """The ``ExperimentConfig`` that ``cli.train`` builds from ``argv``."""
    from pacingpseudo_torch.cli import train as train_cli
    return train_cli.config_from_args(train_cli.build_parser().parse_args(argv))


def write_pool(argv: List[str], r3_slices: int = 0, scribble_style: str = "skeleton") -> None:
    """The pool that ``cli.train`` writes for ``argv`` (or, ``r3_slices`` > 0,
    ``study_r3``'s pool of that many slices with ``scribble_style``'s
    scribbles), written under a lock in the data directory: arms that start
    together (one a card) write it once, and ``cli.train`` finds it in place.
    An r3 pool whose marker names another size or style is refused, as is
    one whose fold 0 does not hold ``expected_fold0``'s figures."""
    import fcntl

    from pacingpseudo_torch.cli import train as train_cli
    args = train_cli.build_parser().parse_args(argv)
    os.makedirs(args.data_root, exist_ok=True)
    with open(os.path.join(args.data_root, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if r3_slices:
            from scripts import study_r3_pool_torch as r3
            mark = r3.read_marker(args.data_root)
            want = {"slices": r3_slices, "scribble_style": scribble_style}
            if mark is not None and {k: mark[k] for k in want} != want:
                raise SystemExit(f"{args.data_root} holds a pool of {mark}, not {want}")
            r3.write_pool(args.data_root, r3_slices, scribble_style=scribble_style)
            got = r3.fold0_identity(args.data_root, args.batch_size)
            expected = r3.expected_fold0(r3_slices, args.batch_size)
            if got != expected:
                raise SystemExit(f"{args.data_root}: fold 0 reads {got}, not {expected}")
            _say(f"pool {args.data_root}: {scribble_style} scribbles, fold 0 {got}")
        else:
            train_cli.write_synthetic_pool(args, train_cli.config_from_args(args))


HEADER = re.compile(r"train slices=(\d+) val slices=(\d+) steps/epoch=(\d+) canvas=(\d+)")
FROZEN = "on: frozen-BN step"


def check_log(run_dir: str, config, expected: Optional[dict]) -> None:
    """Exit unless every header of the run's log reads ``expected``'s fold 0
    (where given) and, under the BatchNorm quirk, a run that trained past
    epoch 0 logged the frozen-BN step's taking over (``train/loop.py`` logs
    it at epoch 1, or at the epoch a resumed run starts)."""
    with open(os.path.join(run_dir, "log.txt")) as f:
        log = f.read()
    headers = [tuple(int(x) for x in m) for m in HEADER.findall(log)]
    if expected is not None:
        want = (expected["train"], expected["test"], expected["steps"], expected["canvas"])
        if not headers or any(h != want for h in headers):
            raise SystemExit(f"{run_dir}: log headers {headers}, not {want}")
    if config.ref_quirk_bn_eval_after_first_epoch:
        trained = [int(e) for e in re.findall(r"epoch: (\d+), lr:", log)]
        if max(trained, default=0) >= 1 and FROZEN not in log:
            raise SystemExit(f"{run_dir}: trained to epoch {max(trained)} under the BN quirk, "
                             f"but its log never took the frozen-BN step")


def resources(gpu: str) -> dict:
    """The card's name and power limit, the peak device memory since the
    last reset, and the process's peak resident set so far."""
    import resource
    import subprocess

    import torch
    out = {"peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    if gpu != "cpu" and torch.cuda.is_available():
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", gpu.split(",")[0]], capture_output=True, text=True).stdout.strip()
        out["peak_cuda_allocated_bytes"] = torch.cuda.max_memory_allocated()
        out["peak_cuda_reserved_bytes"] = torch.cuda.max_memory_reserved()
    return out


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
                      args.gpu, extra, args.r3_split, args.scribble_style, args.tag)
    config = arm_config(argv)
    last = _epoch_of(latest_checkpoint(run_dir))
    if last >= 0:
        argv.append("--resume")
    stop = args.stop_after_epoch
    if stop is not None and last >= stop:
        _say(f"{arm}: trained to epoch {last} already")
    else:
        _say(f"pool of {arm}")
        write_pool(argv, args.slices if args.r3_split else 0, args.scribble_style)
        _say(f"training {arm}" + (f" to epoch {stop}" if stop is not None else "")
             + (f" from the checkpoint of epoch {last}" if last >= 0 else ""))
        _reset_peak(args.gpu)
        train_cli.main(argv, stop_after_epoch=stop)
        with open(os.path.join(rd, "resources.json"), "w") as f:
            json.dump(resources(args.gpu), f, indent=2)
    expected = None
    if args.r3_split:
        from scripts.study_r3_pool_torch import expected_fold0
        expected = expected_fold0(args.slices, config.batch_size)
        cap = train_cli.build_parser().parse_args(argv).max_steps_per_epoch
        if cap:
            expected["steps"] = min(expected["steps"], cap)
    check_log(run_dir, config, expected)
    _release()
    done = _epoch_of(latest_checkpoint(run_dir)) == args.epochs - 1
    if not done and not os.path.exists(resolve_checkpoint_path(run_dir, DATASET, True)):
        # a validation Dice of 0 so far saves no best checkpoint
        _say(f"{arm}: no best checkpoint yet, not evaluated")
        return
    _say(f"evaluating {arm}")
    infer_cli.main(inference_argv(rd, data_root(args.root, args.seed, args.r3_split), args.gpu,
                                  config))
    shutil.copyfile(os.path.join(rd, "outputs", "Inference", DATASET, "run-fold0", "log.txt"),
                    os.path.join(rd, "eval.log"))
    _release()
    if done:
        open(os.path.join(rd, "DONE"), "w").close()


def _reset_peak(gpu: str) -> None:
    import torch
    if gpu != "cpu" and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


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
    p.add_argument("--r3_split", action="store_true",
                   help="train on study_r3's pool and fold split (every fifth slice)")
    p.add_argument("--scribble_style", default="skeleton", choices=["skeleton", "dilated"],
                   help="the pool's scribbles (quality_study_dilated.sh: dilated)")
    p.add_argument("--tag", default="study_torch", help="the arms' run tag")
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
    kept = {}
    if os.path.exists(summary):
        with open(summary) as f:
            kept = {r["arm"]: r for r in json.load(f)}
    ran = {a + suffix(args.seed) for a in args.arms}
    rows = [study_summary.summarise_arm(args.root, arm, DATASET) if arm in ran else kept[arm]
            for arm in (a + suffix(args.seed) for a in ARMS) if arm in ran or arm in kept]
    print(study_summary.render_table(rows))
    with open(summary, "w") as f:
        json.dump(rows, f, indent=2)
    _say(f"wrote {summary}")
    return rows


if __name__ == "__main__":
    main()
