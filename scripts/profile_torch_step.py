"""Where the time of one PyTorch-port train step goes, on one CUDA card.

    python3 scripts/profile_torch_step.py

Builds the full-width Experiment session of ``chip_smoke.py`` (CHAOS shape,
batch 12, bf16) on its synthetic batch, takes 3 warm-up steps, then traces
3 steps with ``torch.profiler``.  Prints the card's name and power
limit, the median step time on the host clock (each step ends in a
synchronize), the device's busy share over the traced window (the union of
kernel intervals over the window), and the kernels by total device time.
The trace is written to ``build/profile/torch_step_trace.json``.
"""
from __future__ import annotations

import collections
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import make_batch  # noqa: E402
from pacingpseudo_torch.config import ExperimentConfig  # noqa: E402
from pacingpseudo_torch.train.state import create_train_state  # noqa: E402
from pacingpseudo_torch.train.step import make_pacing_train_step  # noqa: E402


STEPS = 3    # traced steps
TOP = 20     # kernels listed by name

# Kernel families by name, first match wins.
_FAMILIES = (
    ("fused loss (ours)", ("::fwd_partials_kernel<", "::fwd_finalize_kernel(",
                           "::bwd_kernel<")),
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures the card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)

    dev = torch.device("cuda", 0)
    config = ExperimentConfig(
        session="Experiment", do_loss_ent=True, do_decoder_consistency=True,
        do_aux_path=True, do_memory=True).validate()
    state = create_train_state(config, device=dev)
    batch = make_batch(config.batch_size, config.spec.input_size[0],
                       config.num_classes, seed=config.seed, dev=dev)
    step = make_pacing_train_step(config, steps_per_epoch=100)
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()

    step_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            t0 = time.perf_counter()
            step(state, batch)
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
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    kernel_us = sum(v[0] for v in by_name.values())

    n = STEPS
    print(f"step ms (host clock, synchronized): {step_ms}, median "
          f"{statistics.median(step_ms):.3f}")
    print(f"traced window {(t_end - t_start) / 1e3:.3f} ms over {n} steps; "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / (t_end - t_start):.1f}%); "
          f"kernel time per step {kernel_us / n / 1e3:.3f} ms in "
          f"{len(kernels) / n:.0f} launches")
    families = collections.defaultdict(float)
    for name, (us, _) in by_name.items():
        families[_family(name)] += us
    print("kernel time by family (ms per step, share of kernel time):")
    for family, us in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"  {us / n / 1e3:9.4f} ms {100 * us / kernel_us:5.1f}%  {family}")
    print(f"top {TOP} kernels by device time (ms per step, launches per "
          "step, share of kernel time):")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {us / n / 1e3:9.4f} ms {count / n:6.0f} x {100 * us / kernel_us:5.1f}%  "
              f"{name[:140]}")
    for name, (us, count) in sorted(by_name.items()):
        if _family(name) == _FAMILIES[0][0]:
            print(f"fused loss: {name}: {us / count:.2f} us per launch, "
                  f"{count / n:.0f} per step")


if __name__ == "__main__":
    main()
