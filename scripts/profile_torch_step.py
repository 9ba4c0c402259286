"""Where the time of one PyTorch-port train step goes, on one CUDA card.

    python3 scripts/profile_torch_step.py

Builds the full-width Experiment session of ``chip_smoke.py`` (CHAOS shape,
batch 12, bf16) with the augmentation inside the step, under the conv impl
that ``PACING_CONV_IMPL`` selects (``fused`` or the default ``xla``; run
``PACING_CONV_IMPL=fused python3 scripts/profile_torch_step.py`` for the
fused ConvLayer kernels), on raw batches that
``chip_smoke.make_raw_pool`` writes and loads, takes 3 warm-up steps, then
traces 3 steps with ``torch.profiler``.  Prints the card's name and power
limit, the median step time on the host clock (each step ends in a
synchronize), the device's busy share over the traced window (the union of
kernel intervals over the window), and the kernels by total device time.
Every kernel that the host launched inside ``augment_batch`` (a
``record_function`` range, matched through the launch's correlation id)
counts under the family "augmentation", whatever its name; the host time of
the range and the kernels inside it are listed apart.
The trace is written to ``build/profile/torch_step_trace.json``.
"""
from __future__ import annotations

import collections
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import make_raw_pool  # noqa: E402
from pacingpseudo_torch.aug.engine import make_train_augment_fn  # noqa: E402
from pacingpseudo_torch.aug.presets import base_params_for, strong_params_for  # noqa: E402
from pacingpseudo_torch.ops.fused_convbn import get_conv_impl  # noqa: E402
from pacingpseudo_torch.train.state import create_train_state  # noqa: E402
from pacingpseudo_torch.train.step import make_pacing_train_step  # noqa: E402


STEPS = 3    # traced steps
TOP = 20     # kernels listed by name

AUGMENT = "augmentation"          # family of the kernels launched inside
AUGMENT_RANGE = "augment_batch"   # this record_function range

# Kernel families by name, first match wins.
_FAMILIES = (
    ("fused loss (ours)", ("::fwd_kernel<", "::bwd_kernel<")),
    ("fused conv (ours)", ("::conv3x3_kernel<", "::conv_wgmma_kernel<",
                           "::bn_sums_kernel<", "::reduce_rows_kernel(")),
    ("NCHW<->NHWC layout", ("nchwToNhwc", "nhwcToNchw")),
    ("conv / GEMM", ("xmma", "implicit_gemm", "cudnn", "cutlass", "nvjet",
                     "gemm", "conv")),
    ("bilinear upsample", ("upsample",)),
    ("reduction", ("reduce_kernel",)),
    ("max pool", ("max_pool",)),
    ("concat", ("CatArrayBatchedCopy",)),
    ("elementwise / copy", ("elementwise", "copy", "Functor")),
)


def _family(name):
    for family, keys in _FAMILIES:
        if any(k in name for k in keys):
            return family
    return "other"


def _busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def _launched_inside(events, range_name):
    """Correlation ids of the launches the host made inside the
    ``record_function`` ranges called ``range_name``, and those ranges."""
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == range_name]
    inside = set()
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None and any(a <= e["ts"] <= b for a, b in ranges):
                inside.add(corr)
    return inside, ranges


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures the card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)

    print(f"conv impl {get_conv_impl()} (PACING_CONV_IMPL)", flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="profile_pool_") as root:
        raw_batches, _, config = make_raw_pool(root, dev)
        batches = [next(raw_batches) for _ in range(3 + STEPS)]
        raw_batches.close()
    augment = make_train_augment_fn(
        base_params_for(config.dataset),
        strong_params_for(config.augmentations, config.strength), do_strong=True)

    def augment_fn(raw, generator):
        with record_function(AUGMENT_RANGE):
            return augment(raw, generator)

    state = create_train_state(config, device=dev)
    generator = torch.Generator(device=dev).manual_seed(config.seed)
    step = make_pacing_train_step(config, steps_per_epoch=100,
                                  augment_fn=augment_fn)
    for batch in batches[:3]:
        step(state, batch, generator)
    torch.cuda.synchronize()

    step_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches[3:]:
            t0 = time.perf_counter()
            step(state, batch, generator)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    out = ROOT / "build" / "profile"
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / "torch_step_trace.json"
    prof.export_chrome_trace(str(trace_path))

    events = json.loads(trace_path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    window = [e for e in events if e.get("cat") in ("kernel", "cpu_op")]
    t_start = min(e["ts"] for e in window)
    t_end = max(e["ts"] + e["dur"] for e in window)
    busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    inside, ranges = _launched_inside(events, AUGMENT_RANGE)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    in_augment = collections.defaultdict(lambda: [0.0, 0])
    families = collections.defaultdict(float)
    for e in kernels:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
        if e.get("args", {}).get("correlation") in inside:
            in_augment[e["name"]][0] += e["dur"]
            in_augment[e["name"]][1] += 1
            families[AUGMENT] += e["dur"]
        else:
            families[_family(e["name"])] += e["dur"]
    kernel_us = sum(v[0] for v in by_name.values())

    n = STEPS
    print(f"step ms (host clock, synchronized): {step_ms}, median "
          f"{statistics.median(step_ms):.3f}")
    print(f"traced window {(t_end - t_start) / 1e3:.3f} ms over {n} steps; "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / (t_end - t_start):.1f}%); "
          f"kernel time per step {kernel_us / n / 1e3:.3f} ms in "
          f"{len(kernels) / n:.0f} launches")
    print("kernel time by family (ms per step, share of kernel time):")
    for family, us in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"  {us / n / 1e3:9.4f} ms {100 * us / kernel_us:5.1f}%  {family}")
    print(f"top {TOP} kernels by device time (ms per step, launches per "
          "step, share of kernel time):")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {us / n / 1e3:9.4f} ms {count / n:6.0f} x {100 * us / kernel_us:5.1f}%  "
              f"{name[:140]}")
    for name, (us, count) in sorted(by_name.items()):
        if _family(name).endswith("(ours)") or "::warp_table_kernel(" in name \
                or "::warp_cubic_kernel(" in name:
            print(f"ours: {name}: {us / count:.2f} us per launch, "
                  f"{count / n:.0f} per step")
    print(f"{AUGMENT}: host time of the {AUGMENT_RANGE} range "
          f"{[round((b - a) / 1e3, 3) for a, b in ranges]} ms; "
          f"{sum(v[1] for v in in_augment.values()) / n:.0f} launches and "
          f"{families[AUGMENT] / n / 1e3:.4f} ms of kernel time per step; its "
          "kernels by device time (ms per step, launches per step):")
    for name, (us, count) in sorted(in_augment.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {us / n / 1e3:9.4f} ms {count / n:6.0f} x  {name[:140]}")


if __name__ == "__main__":
    main()
