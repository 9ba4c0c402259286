"""The LVSC session at the JAX package's rehearsal scale, trained and evaluated
by the PyTorch port.

    python scripts/lvsc_rehearsal_torch.py [--root lvsc_torch] [--gpu 0]
        [--num_devices 0] [--stop_after_epoch 17] [--slices 29086]
        [--size 224 224] [--device cuda|cpu] [-- <extra cli.train args>]

The port's counterpart of ``scripts/lvsc_rehearsal_r5.sh`` and
``scripts/gen_lvsc_data.py``, through the port's own entry points:

1. write the pool with the port's writer and the JAX script's arguments
   (``write_pool``: ``--slices`` "easy" phantoms of 224x224 whose extents are
   drawn within 16 px of it per axis, 2 classes, seed 1) under
   ``<root>/data``, and time it;
2. check fold 0 against the JAX run's header before training
   (``check_identity``: 23,254 training and 5,832 validation slices, 243 test
   pseudo-patients, a canvas of 256, 1,937 steps an epoch); the run exits
   non-zero on a mismatch.  A pool of another size has no JAX record: its
   counts are printed and not checked;
3. train with ``pacingpseudo_torch.cli.train`` on the JAX script's argv
   (``train_argv``) plus ``--gpu``, ``--num_devices`` and
   ``--steps_per_dispatch 8``, the schedules spanning 36 epochs, in two
   child processes: epochs 0 to ``SHORT_STOP``, then, unless the call would
   run past ``CALL_MINUTES`` (``projected_minutes``, from the pool's write
   and epoch 0), resumed to ``--stop_after_epoch``;
4. evaluate ``best_ckp`` with ``pacingpseudo_torch.cli.inference`` on fold
   0 (``inference_argv``) in a child process, whose log goes to
   ``<root>/eval.log`` and whose peak resident memory is read;
5. write ``<root>/rehearsal.json`` (what each phase took) and hold the run
   against JAX's with ``scripts/lvsc_compare.py`` (``<root>/compare.json``).

The run is not resumable across calls: each call writes the pool again.  It
needs one card and, at 29,086 slices, ~17 GB of disk for the pool (checked
before writing).  Without CUDA it exits, unless ``--device cpu`` asks for
the CPU; what follows ``--`` is appended to the train argv (a smaller model
for a test), and ``--size`` writes a smaller pool.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DATASET = "lvsc"
SLICES = 29086
SIZE = (224, 224)
NUM_CLASSES = 2
IGNORED_INDEX = 2
SEED = 1
SIZE_JITTER = 16
EPOCHS = 36                 # LVSC_EPOCHS of the kept run (lvsc_rehearsal/chain_r5.log)
BATCH = 12
# The kept JAX run's fold 0 (lvsc_rehearsal/train_r5.log:4, eval_r5.log:32-35).
JAX_IDENTITY = {"train": 23254, "val": 5832, "patients": 243, "canvas": 256, "steps": 1937}
SLICE_BYTES = 224 * 224 * 4 * 3 + 1024     # float32 image, label and scribble
DISK_SPARE = 4 * 2**30                     # checkpoints with Adam's state, the outputs
# The slowest inference rate with HD95 the port has read on the card (PERF.md
# section 5), for the projection of the evaluation's time.
EVAL_SLICES_PER_S = 31.8
# The run is sized to end within an hour on one card: where the projection
# passes CALL_MINUTES it stops after epoch SHORT_STOP.
CALL_MINUTES = 55.0
SHORT_STOP = 11


def _say(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def write_pool(data_root: str, slices: int = SLICES, size: Tuple[int, int] = SIZE) -> float:
    """The pool of ``scripts/gen_lvsc_data.py``, through the port's writer;
    returns the seconds it took (an intact pool is kept)."""
    from pacingpseudo_torch.data.synthetic import write_synthetic_dataset

    t0 = time.time()
    write_synthetic_dataset(data_root, DATASET, slices, tuple(size),
                            num_classes=NUM_CLASSES, ignored_index=IGNORED_INDEX,
                            modality="t1", seed=SEED, size_jitter=SIZE_JITTER,
                            difficulty="easy")
    return time.time() - t0


def identity(data_root: str, fold: int = 0, batch_size: int = BATCH) -> Dict[str, int]:
    """Fold ``fold``'s counts as the trainer and inference will read them."""
    from pacingpseudo_torch.data.npz_dataset import SliceDataset
    from pacingpseudo_torch.data.splits import read_fold_split
    from pacingpseudo_torch.evals.infer import patient_key

    train, val = read_fold_split(data_root, DATASET, fold)
    canvas = SliceDataset(train, NUM_CLASSES, IGNORED_INDEX).canvas_size
    patients = {patient_key(os.path.splitext(os.path.basename(p))[0]) for p in val}
    return {"train": len(train), "val": len(val), "patients": len(patients),
            "canvas": canvas, "steps": len(train) // batch_size}


def check_identity(data_root: str, expected: Dict[str, int], fold: int = 0,
                   batch_size: int = BATCH) -> Dict[str, int]:
    """``identity``, exiting non-zero where it differs from ``expected``."""
    got = identity(data_root, fold, batch_size)
    wrong = {k: (got[k], v) for k, v in expected.items() if got[k] != v}
    if wrong:
        raise SystemExit(f"identity check failed (got, want): {wrong}")
    return got


def train_argv(root: str, slices: int, gpu: str, num_devices: int,
               extra: Sequence[str] = ()) -> List[str]:
    """``cli.train``'s argv: ``lvsc_rehearsal_r5.sh:72-76`` with the epochs of
    the kept run, the port's devices and 8 steps a dispatch."""
    return ["--dataset", DATASET, "--session", "Experiment", "--tag", "lvsc_scale",
            "--fold", "0", "--epoch", str(EPOCHS), "--ckp_interval", "4",
            "--do_loss_ent", "--do_decoder_consistency", "--do_aux_path", "--do_memory",
            "--synthetic_data", str(slices), "--synthetic_size_jitter", str(SIZE_JITTER),
            "--data_root", os.path.join(root, "data"),
            "--run_dir", os.path.join(root, "run-fold0"),
            "--gpu", gpu, "--num_devices", str(num_devices), "--steps_per_dispatch", "8",
            *extra]


# The model's flags that cli.inference takes too: extra cli.train args that
# change one are passed on.
MODEL_FLAGS = ("--input_ch", "--init_ch", "--max_ch", "--output_stride", "--compute_dtype")


def inference_argv(root: str, gpu: str, extra: Sequence[str] = ()) -> List[str]:
    """``cli.inference``'s argv: ``lvsc_rehearsal_r5.sh:92-94`` with the port's
    devices and the model flags of ``extra``."""
    model = [a for i, flag in enumerate(extra) if flag in MODEL_FLAGS
             for a in (flag, extra[i + 1])]
    return ["--dataset", DATASET, "--fold", "0",
            "--checkpoint_file", os.path.join(root, "run-fold0"), "--best_ckp",
            "--data_root", os.path.join(root, "data"), "--root", os.path.join(root, "outputs"),
            "--gpu", gpu, *model]


_STAMP = re.compile(r"^\[(\d\d):(\d\d):(\d\d)\.(\d{3})\] (.*)$")


def log_times(log_path: str) -> Dict[str, object]:
    """From a run's ``log.txt``: the seconds of each epoch's training (its own
    line), of its validation (from its epoch line to its ``val:`` line), and
    of the set-up of each start (from the ``config:`` line to the first epoch
    line after it), and each start's staging line and seconds (from it to the
    dispatch line that follows it)."""
    out = {"epoch_s": {}, "val_s": {}, "setup_s": [], "staging": [], "staging_s": []}
    last, prev, day = None, 0.0, 0.0
    with open(log_path) as f:
        for line in f:
            m = _STAMP.match(line.rstrip("\n"))
            if not m:
                continue
            t = day + int(m[1]) * 3600 + int(m[2]) * 60 + int(m[3]) + int(m[4]) / 1e3
            if t < prev:                                        # past midnight
                day += 86400
                t += 86400
            prev = t
            msg = m[5]
            if msg.startswith("config:"):
                last = ("config", t)
            elif msg.startswith("staging "):
                out["staging"].append(msg)
                staged = t
            elif msg.startswith("steps per dispatch") and out["staging"]:
                out["staging_s"].append(t - staged)
            em = re.match(r"epoch: (\d+), .* ([\d.]+) s/epoch", msg)
            if em:
                epoch = int(em[1])
                out["epoch_s"][epoch] = float(em[2])
                if last and last[0] == "config":
                    out["setup_s"].append(t - float(em[2]) - last[1])
                last = ("epoch", t, epoch)
            vm = re.match(r"val: (\d+),", msg)
            if vm and last and last[0] == "epoch" and last[2] == int(vm[1]):
                out["val_s"][int(vm[1])] = t - last[1]
    return out


def projected_minutes(pool_s: float, setup_s: float, epoch0_s: float, val0_s: float,
                      last_epoch: int, val_slices: int) -> float:
    """The call's minutes to train epochs 0..``last_epoch`` and evaluate: the
    pool's write, two set-ups (the start and the resumed start), every epoch
    as long as epoch 0 with its validation, and the evaluation at
    ``EVAL_SLICES_PER_S``."""
    return (pool_s + 2 * setup_s + (last_epoch + 1) * (epoch0_s + val0_s)
            + val_slices / EVAL_SLICES_PER_S) / 60.0


def _run_child(argv: List[str], what: str) -> Tuple[float, float]:
    """Run ``argv`` with the repo importable; returns (seconds, peak resident
    GiB).  Exits non-zero when it fails."""
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    t0 = time.time()
    proc = subprocess.Popen(argv, env={**os.environ, "PYTHONPATH": path})
    _, status, usage = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    if proc.returncode:
        raise SystemExit(f"{what} failed with exit code {proc.returncode}")
    return time.time() - t0, usage.ru_maxrss / 2**20     # ru_maxrss is in KiB


def train(argv: List[str], stop_after_epoch: int, resume: bool) -> Tuple[float, float]:
    """``cli.train.main(argv, stop_after_epoch)`` in a child process."""
    code = ("import sys; from pacingpseudo_torch.cli import train; "
            "train.main(sys.argv[2:], stop_after_epoch=int(sys.argv[1]))")
    return _run_child([sys.executable, "-c", code, str(stop_after_epoch), *argv,
                       *(["--resume"] if resume else [])],
                      f"training to epoch {stop_after_epoch}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="lvsc_torch")
    p.add_argument("--gpu", default="0", help="CUDA indices for cli.train and cli.inference")
    p.add_argument("--num_devices", type=int, default=0)
    p.add_argument("--stop_after_epoch", type=int, default=17)
    p.add_argument("--slices", type=int, default=SLICES)
    p.add_argument("--size", type=int, nargs=2, default=list(SIZE))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cpu' runs on the CPU; the default needs CUDA")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
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
            raise SystemExit("no CUDA device: the rehearsal runs on a card "
                             "(--device cpu runs it on the CPU)")
    if tuple(args.size) != SIZE:
        extra = ["--input_size", *map(str, args.size), *extra]
    data_root = os.path.join(args.root, "data")
    os.makedirs(data_root, exist_ok=True)
    record: Dict[str, object] = {"argv": argv}
    started = time.time()

    need = args.slices * SLICE_BYTES * (args.size[0] * args.size[1]) // (224 * 224)
    free = shutil.disk_usage(data_root).free
    _say(f"disk: {free / 2**30:.1f} GiB free under {data_root}, the pool needs "
         f"{need / 2**30:.1f} GiB and {DISK_SPARE / 2**30:.0f} GiB more")
    if free < need + DISK_SPARE:
        raise SystemExit("not enough disk for the pool")
    pool_s = write_pool(data_root, args.slices, tuple(args.size))
    record["pool"] = {"slices": args.slices, "seconds": pool_s, "cpus": os.cpu_count()}
    _say(f"pool: {args.slices} slices in {pool_s:.1f} s")

    if (args.slices, tuple(args.size)) == (SLICES, SIZE):
        counts = check_identity(data_root, JAX_IDENTITY)
        _say(f"identity: {counts} equals the JAX run's fold 0")
    else:
        counts = identity(data_root)
        _say(f"identity: {counts} (no JAX record at this size: not checked)")
    record["identity"] = counts

    t_argv = train_argv(args.root, args.slices, args.gpu, args.num_devices, extra)
    record["train_argv"] = t_argv
    first = min(SHORT_STOP, args.stop_after_epoch)
    _say(f"training epochs 0-{first}")
    seconds, rss = train(t_argv, first, resume=False)
    record["train"] = [{"epochs": [0, first], "seconds": seconds, "peak_rss_gib": rss}]
    log_path = os.path.join(args.root, "run-fold0", "log.txt")
    times = log_times(log_path)
    projected = projected_minutes(pool_s, times["setup_s"][0], times["epoch_s"][0],
                                  times["val_s"][0], args.stop_after_epoch, counts["val"])
    stop = args.stop_after_epoch if projected <= CALL_MINUTES else first
    record["projection"] = {"minutes": projected, "limit": CALL_MINUTES,
                            "stop_after_epoch": stop}
    _say(f"projected call to epoch {args.stop_after_epoch} with the evaluation: "
         f"{projected:.1f} min (limit {CALL_MINUTES}): stop after epoch {stop}")
    if stop > first:
        seconds, rss = train(t_argv, stop, resume=True)
        record["train"].append({"epochs": [first + 1, stop], "seconds": seconds,
                                "peak_rss_gib": rss})
    record["log"] = log_times(log_path)

    _say("evaluating best_ckp")
    i_argv = inference_argv(args.root, args.gpu, extra)
    seconds, rss = _run_child([sys.executable, "-m", "pacingpseudo_torch.cli.inference",
                               *i_argv], "inference")
    record["eval"] = {"seconds": seconds, "peak_rss_gib": rss}
    shutil.copyfile(os.path.join(args.root, "outputs", "Inference", DATASET, "run-fold0",
                                 "log.txt"), os.path.join(args.root, "eval.log"))
    record["seconds"] = time.time() - started
    record["self_peak_rss_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    with open(os.path.join(args.root, "rehearsal.json"), "w") as f:
        json.dump(record, f, indent=2)
    _say(f"wrote {os.path.join(args.root, 'rehearsal.json')}")

    if counts == JAX_IDENTITY:
        from scripts import lvsc_compare
        lvsc_compare.main(["--jax", os.path.relpath(os.path.join(ROOT, "lvsc_rehearsal")),
                           "--port", args.root])
    return record


if __name__ == "__main__":
    main()
