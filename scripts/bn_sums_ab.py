"""Where does ``bn_sums``' time go beyond its bound?  An A/B of build
variants of its kernel on one CUDA card (an H100).

    python3 scripts/bn_sums_ab.py

Builds ``pacingpseudo_torch/csrc/fused_convbn.cu`` several times into
``build/bn_sums_ab/``, each with other constants of ``bn_sums_kernel``: the
pixels in flight a thread (``kBnUnroll``), the blocks an SM it is built
and planned for (``kBnBlocksPerSm``, with ``bn_sums_plan``'s
``BN_SUMS_BLOCKS_PER_SM`` set to match), the partial rows the last block
loads at once (``kBnBatch``), and one diagnostic variant that skips the
last block's sum (its output is not the function, so it is not checked:
the time it saves is the cost of the in-launch reduction).  Every other
variant is held against ``bn_sums_plain`` (rtol 1e-4, as ``chip_smoke.py``
holds the kernel).  For every fused layer of the full-width Experiment
step (bf16, alone, L2 flushed before each launch, median of 10 launches
as ``chip_smoke.time_conv_kernels`` takes them), the variants are timed in
turns, forward then backward, twice; each is the median of its turns.
Prints the card's name and power limit, the registers and spills of each
variant's bf16 16-byte kernel, one line per layer, and the sums over the
step's layers beside the bound.
"""
from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pacingpseudo_torch.ops import _build  # noqa: E402
from pacingpseudo_torch.ops import fused_convbn as fc  # noqa: E402
from scripts.reckon_fused_conv_bounds import conv_layer_shapes, kernel_costs  # noqa: E402

# name: (kBnUnroll, kBnBlocksPerSm, kBnBatch, the last block's sum)
VARIANTS = {
    "as built": (4, 2, 16, True),
    "unroll 8": (8, 2, 16, True),
    "unroll 8, 1 block an SM": (8, 1, 16, True),
    "3 blocks an SM": (4, 3, 16, True),
    "unroll 2, 4 blocks an SM": (2, 4, 16, True),
    "batch 32": (4, 2, 32, True),
    "no final sum (diagnostic)": (4, 2, 16, False),
}
OUT = ROOT / "build" / "bn_sums_ab"


def _build_variants():
    """One library a variant, all nvcc's started together."""
    src = (_build.CSRC_DIR / "fused_convbn.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, (unroll, per_sm, batch, tail)) in enumerate(VARIANTS.items()):
        text = (src.replace("constexpr int kBnUnroll = 4;", f"constexpr int kBnUnroll = {unroll};")
                .replace("constexpr int kBnBatch = 16;", f"constexpr int kBnBatch = {batch};")
                .replace("constexpr int kBnBlocksPerSm = 2;",
                         f"constexpr int kBnBlocksPerSm = {per_sm};"))
        if not tail:
            text = text.replace("  if (!last) return;", "  return;")
        path = OUT / f"variant{i}.cu"
        path.write_text(text)
        jobs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), path)
    libs = {}
    for name, (proc, path) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for j, line in enumerate(lines):
            if "Compiling" in line and "bn_sums_kernelI13__nv_bfloat16Li8E" in line:
                print(f"{name}: {lines[j + 2].strip()}; {lines[j + 3].strip()}", flush=True)
        lib = ctypes.CDLL(str(path.with_suffix(".so")))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_convbn_bn_sums.argtypes = [p, p, p, p, p, i, p] + [i] * 5 + [f] + [i] * 5 + [p]
        lib.fused_convbn_bn_sums.restype = i
        libs[name] = lib
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("bn_sums_ab.py runs on a CUDA card only")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build(("fused_convbn", "conv_wgmma"))
    libs = _build_variants()
    dev = torch.device("cuda", 0)
    sms = fc._sm_count(0)
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=dev)
    counters = torch.zeros(fc.BN_SUMS_COUNTERS, dtype=torch.int32, device=dev)
    spent = torch.zeros_like(counters)
    stream = torch.cuda.current_stream(dev).cuda_stream
    total = dict.fromkeys(VARIANTS, 0.0)
    bound = 0.0
    layers = [s for s in conv_layer_shapes(cs._experiment_config()) if s[6]]
    for li, (name, n, ci, co, h, w, _, _) in enumerate(layers):
        xp, w9, bias, gzp, _ = cs._conv_inputs(n, ci, co, h, w, torch.bfloat16, dev, 500 + li)
        y, sums = fc.conv_stats(xp, w9, bias)
        aux = cs._bn_aux(sums, n * h * w, dev, 600 + li)
        want = fc.bn_sums_plain(y, gzp, aux, 1e-2)
        calls = {}
        for vname, (_, per_sm, _, tail) in VARIANTS.items():
            fc.BN_SUMS_BLOCKS_PER_SM = per_sm
            fc.bn_sums_plan.cache_clear()
            plan = fc.bn_sums_plan(torch.bfloat16, n, h, w, co, sms)
            partials = torch.empty((plan.grid_x, 2 * co), dtype=torch.float32, device=dev)
            out = torch.zeros((2, co), dtype=torch.float32, device=dev)

            # The diagnostic variant draws tickets and never resets them: it
            # gets counters of its own.
            cnt = counters if tail else spent

            def call(lib=libs[vname], plan=plan, partials=partials, out=out, cnt=cnt):
                err = lib.fused_convbn_bn_sums(
                    y.data_ptr(), gzp.data_ptr(), aux.data_ptr(), partials.data_ptr(),
                    cnt.data_ptr(), cnt.numel(), out.data_ptr(), 1, n, h, w, co,
                    1e-2, plan.vec, plan.bx, plan.grid_x, plan.grid_y, plan.rows_per_block,
                    stream)
                if err:
                    sys.exit(f"{vname}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            if tail:
                cs._held(f"bn_sums ({vname}) {name}", out, want,
                         1e-4 * want.abs().amax(dim=1, keepdim=True), 1e-4)
            calls[vname] = call
        fc.BN_SUMS_BLOCKS_PER_SM = VARIANTS["as built"][1]
        fc.bn_sums_plan.cache_clear()
        turns = {k: [] for k in calls}
        order = list(calls)
        for rep in range(4):
            for k in (order if rep % 2 == 0 else order[::-1]):
                turns[k].append(cs._time_ms(calls[k], flush, 10))
        b = kernel_costs(n, ci, co, h, w)["_bn_sums_kernel"][0] / cs.HBM_BYTES_PER_S * 1e3
        bound += b
        line = f"{name.split('backbone.')[-1]} {co} @ {h}x{w}: bound {b:.4f} ms;"
        for k, v in turns.items():
            total[k] += statistics.median(v)
            line += f" {k} {statistics.median(v):.4f};"
        print(line, flush=True)
    print(f"over the step's {len(layers)} layers: bound {bound:.4f} ms; "
          + "; ".join(f"{k} {v:.4f} ms" for k, v in total.items()), flush=True)


if __name__ == "__main__":
    main()
