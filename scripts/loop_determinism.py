"""Which operations make the float32 eager loop differ from run to run.

    python3 scripts/loop_determinism.py

The float32 loop of ``chip_smoke.py``'s ``loop (resident, graph)`` phase
(the Experiment session at init_ch 8, 2 epochs of 20 steps on
``make_loop_pool``'s fold 1, TF32 off, deterministic cuDNN), run eagerly:

1. once under ``torch.use_deterministic_algorithms(True, warn_only=True)``,
   printing each distinct warning, which names an operation that has no
   deterministic implementation on the card;
2. three times as the phase runs it, and three times under
   ``use_deterministic_algorithms(True, warn_only=True)``, printing each
   set's per-epoch metrics and their largest spread;
3. the backward of each candidate operation at the loop's shapes, three
   times with deterministic algorithms off and three times on, printing
   whether the three gradients are equal bit for bit.

Prints the card's name and power limit first.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys
import tempfile
import warnings

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pacingpseudo_torch.ops import _build  # noqa: E402
from pacingpseudo_torch.train import loop  # noqa: E402


def spread(runs):
    """The largest difference of a metric between two runs, by name."""
    out = {}
    for epoch in range(len(runs[0])):
        for k in runs[0][epoch]:
            vals = [r[epoch][k] for r in runs]
            out[k] = max(out.get(k, 0.0), max(vals) - min(vals))
    return out


def _probe_ops(dev):
    """``{op: {mode: three backward passes equal bit for bit}}`` for the
    operations of the float32 step whose CUDA backward may add with
    atomics: the align-corners bilinear upsample (the decoder's 2x, the aux
    path's 8x) and the 2x2 max-pool, at the loop's shapes (batch 12, the
    two streams stacked to 24, init_ch 8)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {
        "interpolate 2x (24, 64, 32, 32)": (
            (24, 64, 32, 32),
            lambda x: F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)),
        "interpolate 8x (12, 5, 32, 32)": (
            (12, 5, 32, 32),
            lambda x: F.interpolate(x, size=(256, 256), mode="bilinear", align_corners=True)),
        "max_pool2d (24, 8, 256, 256)": ((24, 8, 256, 256), lambda x: F.max_pool2d(x, 2, 2)),
    }
    out = {}
    for name, (shape, fn) in cases.items():
        x = torch.randn(shape, generator=gen, device=dev)
        cot = torch.randn(fn(x).shape, generator=gen, device=dev)
        out[name] = {}
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode, warn_only=True)
            grads = []
            for _ in range(3):
                xr = x.clone().requires_grad_(True)
                (fn(xr) * cot).sum().backward()
                grads.append(xr.grad)
            torch.use_deterministic_algorithms(False)
            out[name][mode] = all(torch.equal(g, grads[0]) for g in grads)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    _build.build()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    config = dataclasses.replace(
        cs._experiment_config(), epoch=cs.LOOP_EPOCHS, ckp_interval=1,
        ref_quirk_bn_eval_after_first_epoch=True, init_ch=8, hid_ch=16,
        compute_dtype="float32", **cs.EAGER_LOOP)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        probes = _probe_ops(dev)
    print(f"{smi}: three backward passes equal bit for bit, deterministic algorithms off / on: "
          f"{ {k: [v[False], v[True]] for k, v in probes.items()} }; warnings "
          f"{sorted({str(w.message).splitlines()[0] for w in caught})}", flush=True)
    with tempfile.TemporaryDirectory(prefix="loop_determinism_") as root:
        cs.make_loop_pool(root, config.seed)

        def run(tag):
            run_dir, _ = loop._train_driver(config, root, os.path.join(root, "runs", tag),
                                            device=dev)
            return cs._loop_epochs(run_dir)[2]

        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run("warn")
        torch.use_deterministic_algorithms(False)
        seen = sorted({str(w.message).splitlines()[0] for w in caught
                       if "deterministic" in str(w.message)})
        print(f"{len(seen)} distinct warnings of operations without a deterministic form:",
              flush=True)
        for line in seen:
            print(f"  {line}", flush=True)
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode, warn_only=True)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                runs = [run(f"{mode}{i}") for i in range(3)]
            torch.use_deterministic_algorithms(False)
            print(f"{smi}: deterministic algorithms {mode}: 3 eager float32 loops; largest "
                  f"spread of each metric {spread(runs)}; runs {runs}", flush=True)


if __name__ == "__main__":
    main()
