"""How near its bounds the replay hold of ``chip_smoke.py`` comes, over repeats.

    python3 scripts/replay_hold_spread.py [--repeats 3]

For each full-width step that ``chip_smoke.py``'s ``train (raw, graph)``
phase holds (the Experiment step, the Upperbound step, the Experiment step
under the fused conv impl): ``--repeats`` times, ``_hold_replay_once`` in
the default mode with ``EAGER_RUNS_DEFAULT`` (one replayed update held
against the eager update beside four more eager updates' spread), on two
raw batches of ``make_raw_pool``'s synthetic pool.  Prints each hold's
summary, whose last clause names the check that came nearest its bound,
or the check that failed, with the card's name and power limit first.
Exits non-zero if any hold failed.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pacingpseudo_torch.aug import engine  # noqa: E402
from pacingpseudo_torch.aug.presets import base_params_for  # noqa: E402
from pacingpseudo_torch.ops import _build  # noqa: E402
from pacingpseudo_torch.ops import fused_convbn as fc  # noqa: E402
from pacingpseudo_torch.train.loop import _augment_params  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    _build.build()
    dev = torch.device("cuda", 0)
    config, ub_config = cs._experiment_config(), cs._upper_bound_config()
    runs = (("Experiment", config, engine.make_train_augment_fn(*_augment_params(config), True),
             "xla"),
            ("Upperbound", ub_config,
             engine.make_train_augment_fn(base_params_for(ub_config.dataset), do_strong=False),
             "xla"),
            ("Experiment, fused conv", config,
             engine.make_train_augment_fn(*_augment_params(config), True), "fused"))
    failed = 0
    with tempfile.TemporaryDirectory(prefix="replay_hold_") as root:
        raw_batches, _, _ = cs.make_raw_pool(root, dev)
        try:
            for label, cfg, augment_fn, impl in runs:
                for i in range(args.repeats):
                    name = f"{label}, repeat {i}"
                    raws = [next(raw_batches), next(raw_batches)]
                    fc.set_conv_impl(impl)
                    try:
                        summary = "passed: " + cs._hold_replay_once(
                            name, cfg, augment_fn, raws, dev, cs.EAGER_RUNS_DEFAULT)
                    except SystemExit:
                        failed += 1
                        summary = "FAILED (the FAIL line before this one)"
                    finally:
                        fc.set_conv_impl("xla")
                    print(f"{smi}: {name}, default mode: {summary}", flush=True)
                    cs._release_memory()
        finally:
            raw_batches.close()
    print(f"{failed} of {len(runs) * args.repeats} holds failed", flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
