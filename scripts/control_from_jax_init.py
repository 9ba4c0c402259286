"""Train the port's Control arm from JAX's own initial variables, on ``study_r3``'s pool and split.

    python scripts/control_from_jax_init.py --init build/jax_init/control_seed1.pt \\
        [--root study_torch_jaxinit] [--seeds 1 2 3] [--stop_after_epoch 9] [--slices 1916]
        [--gpu 0]
        [--device cuda|cpu] [-- <extra cli.train args>]

The test of the port's Control arm validating above JAX's in epochs 0-9
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--init", required=True, help="the port's state_dict of JAX's draw")
    p.add_argument("--root", default="study_torch_jaxinit")
    p.add_argument("--seeds", nargs="+", type=int, default=[1, 2, 3])
    p.add_argument("--stop_after_epoch", type=int, default=WINDOW - 1)
    p.add_argument("--slices", type=int, default=SLICES, help="the pool's size (a rehearsal's)")
    p.add_argument("--gpu", default="0", help="CUDA indices for cli.train")
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
            raise SystemExit("no CUDA device: the run is on a card "
                             "(--device cpu runs it on the CPU)")
    os.makedirs(args.root, exist_ok=True)
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
