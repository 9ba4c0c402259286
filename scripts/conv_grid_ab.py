"""Does the persistent grid of the wgmma ConvLayer GEMM pay?  An A/B on one
CUDA card (an H100).

    python3 scripts/conv_grid_ab.py

For every fused layer of the full-width Experiment step whose GEMMs take
the ``"wgmma"`` route (``pacingpseudo_torch/csrc/conv_wgmma.cu``), times
``conv_stats`` and ``conv_pad_out`` (bf16, alone, L2 flushed before each
launch, median of 20 launches, as ``chip_smoke.time_conv_kernels`` does)
under two grids of the same kernel and plan: the plan's persistent grid
(at most two blocks an SM up to BN = 96, one above, each walking several
output tiles) and one block per output tile.  The two are timed in turns
(persistent, per tile, per tile, persistent) and each is the mean of its
two turns.  Prints the card's name and power limit, one line per layer and
the sums over the step's layers.
"""
from __future__ import annotations

import dataclasses
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pacingpseudo_torch.ops import _build  # noqa: E402
from pacingpseudo_torch.ops import fused_convbn as fc  # noqa: E402
from scripts.reckon_fused_conv_bounds import conv_layer_shapes  # noqa: E402

REPS = 20
ORDER = ("persistent", "per tile", "per tile", "persistent")


def _per_tile(plan_fn):
    """``plan_fn`` with the wgmma plans' grid set to one block a tile."""
    def plan(dtype, n, h, w, cin, cout, pad_out, sms=132):
        p = plan_fn(dtype, n, h, w, cin, cout, pad_out, sms)
        if p.route != "wgmma":
            return p
        return dataclasses.replace(p, grid=p.rows * (cout // p.bn))
    return plan


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("conv_grid_ab.py runs on a CUDA card only")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build(("fused_convbn", "conv_wgmma"))
    dev = torch.device("cuda", 0)
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=dev)
    plans = {"persistent": fc.conv_plan, "per tile": _per_tile(fc.conv_plan)}
    total = {(k, g): 0.0 for k in cs.GEMMS for g in plans}
    for i, (name, n, ci, co, h, w, fused, needs_dx) in enumerate(
            conv_layer_shapes(cs._experiment_config())):
        if not fused:
            continue
        xp, w9, bias, gzp, w9t = cs._conv_inputs(n, ci, co, h, w, torch.bfloat16, dev, 500 + i)
        calls = {"conv_stats": lambda: fc.conv_stats(xp, w9, bias),
                 "conv_pad_out": lambda: fc.conv_pad_out(gzp, w9t)}
        line = f"{name.split('backbone.')[-1]} {ci} -> {co} @ {h}x{w}:"
        for k, p in cs._gemm_plans(fc, torch.bfloat16, n, ci, co, h, w).items():
            if p.route != "wgmma" or (k == "conv_pad_out" and not needs_dx):
                continue
            ms = dict.fromkeys(plans, 0.0)
            try:
                for grid in ORDER:
                    fc.conv_plan = plans[grid]
                    ms[grid] += cs._time_ms(calls[k], flush, REPS) / 2
            finally:
                fc.conv_plan = plans["persistent"]
            for grid, v in ms.items():
                total[(k, grid)] += v
            tiles = p.rows * ((co if k == "conv_stats" else ci) // p.bn)
            line += (f" {k} (BN {p.bn}, {p.grid} blocks for {tiles} tiles) persistent "
                     f"{ms['persistent']:.4f} ms, per tile {ms['per tile']:.4f} ms;")
        print(line, flush=True)
        del xp, w9, gzp, w9t
    for k in cs.GEMMS:
        print(f"{k} over the wgmma layers: persistent {total[(k, 'persistent')]:.4f} ms, "
              f"per tile {total[(k, 'per tile')]:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
