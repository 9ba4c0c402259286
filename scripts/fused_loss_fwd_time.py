"""Time ``fused_loss_fwd`` alone on the card, at the train step's shape.

    python3 scripts/fused_loss_fwd_time.py [--root DIR] [--reps 200]

Imports ``pacingpseudo_torch`` from ``--root`` (default: this checkout),
so the same script times another tree's kernel too: unpack the parent
commit into a git-ignored directory and run parent, this tree, this tree,
parent in one call, on one card.  The step's shape: weak and strong
logits as the two halves of one (24, 5, 256, 256) float32 tensor, an int64
target with 5 as the ignore index, a float32 mask.  Each launch is timed
between its own CUDA events with L2 flushed before it (the step finds the
logits cold); prints the median and the quartiles in ms, the card's name
and power limit, and the bound the card's memory rate sets.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from pacingpseudo_torch.ops import fused_loss as fl

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    n, c, h, w = 12, 5, 256, 256
    gen = torch.Generator(device=dev).manual_seed(7)
    logits = 2.0 * torch.randn((2 * n, c, h, w), generator=gen, device=dev)
    lw, ls = logits[:n], logits[n:]
    tgt = torch.randint(0, c + 1, (n, h, w), generator=gen, device=dev)
    mask = (torch.rand((n, h, w), generator=gen, device=dev) > 0.3).float()
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=dev)

    def fn():
        return fl.fused_loss_forward(lw, ls, tgt, mask, c)

    out = fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(args.reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in events)
    nbytes = sum(t.numel() * t.element_size() for t in (lw, ls, tgt, mask, out))
    print(json.dumps({
        "root": args.root, "card": smi, "median_ms": statistics.median(ms),
        "q1_ms": ms[len(ms) // 4], "q3_ms": ms[3 * len(ms) // 4],
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
        "launches": fl.LAUNCHES["fused_loss_fwd"]}), flush=True)


if __name__ == "__main__":
    main()
