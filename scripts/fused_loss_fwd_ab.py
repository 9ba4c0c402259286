"""Where does ``fused_loss_fwd``'s time go beyond its bound?  An A/B of
build variants of its kernel on one CUDA card (an H100).

    python3 scripts/fused_loss_fwd_ab.py

Builds ``pacingpseudo_torch/csrc/fused_loss.cu`` several times into
``build/fused_loss_ab/``, each with other constants of ``fwd_kernel``: the
groups of pixels a thread loads at once (``kFwdUnroll``) and the blocks an
SM it is built and planned for (``kFwdBlocksPerSm``, with
``fused_loss_plan``'s ``FWD_UNROLL`` / ``FWD_BLOCKS_PER_SM`` set to
match); or with one of three patches of its source: ``PREFETCH`` issues
the next batch's loads before the current batch is computed, ``DIVIDE``
forms the softmax's ``p`` as ``e / sum(e)`` instead of ``exp(log p)`` (C
fewer exponentials a stream), and ``TOUCH``, a diagnostic, loads
everything and only adds the loaded values (its output is not the function, so it is not checked: its time is what
the loads alone cost).  Every other variant is held against
``forward_plain`` (rtol 1e-5, as ``chip_smoke.py`` holds the kernel) and
two calls must be equal bit for bit.  At the step's shape (weak and strong
as the halves of one (24, 5, 256, 256) tensor), alone, L2 flushed before
each launch, median of 100 launches as ``chip_smoke.py`` takes them, the
variants are timed in turns, forward then backward, twice; each is the
median of its turns.  Two flushes: ``dirty`` is ``chip_smoke.py``'s
(``zero_`` of 512 MiB, which leaves L2 full of dirty lines that the
kernel's reads must write back), ``clean`` reads the 512 MiB instead (L2
full of clean lines).  Last, the kernel at one block (1 x 5 x 16 x 16):
launch, ticket and the last block's sum, with next to no loads.  Prints
the card's name and power limit, the registers and spills of each
variant's C = 5 vector kernel, and one line per variant and flush beside
the bound.
"""
from __future__ import annotations

import ctypes
import pathlib
import re
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pacingpseudo_torch.ops import _build  # noqa: E402
from pacingpseudo_torch.ops import fused_loss as fl  # noqa: E402

# name: (kFwdUnroll, kFwdBlocksPerSm, patches)
VARIANTS = {
    "as built": (fl.FWD_UNROLL, fl.FWD_BLOCKS_PER_SM, ()),
    "unroll 2, 2 an SM (the first design)": (2, 2, ()),
    "unroll 1, 2 an SM, prefetch": (1, 2, ("PREFETCH",)),
    "unroll 1, 2 an SM, prefetch, divide": (1, 2, ("PREFETCH", "DIVIDE")),
    "unroll 1, 1 an SM, prefetch, divide": (1, 1, ("PREFETCH", "DIVIDE")),
    "loads only, as built (diagnostic)": (fl.FWD_UNROLL, fl.FWD_BLOCKS_PER_SM, ("TOUCH",)),
}
OUT = ROOT / "build" / "fused_loss_ab"
KERNEL_HEAD = "template <int C, int VEC>\n__global__ void"
BATCH_HEAD = "template <int C, int VEC>\nstruct FwdBatch {"
LOOP = '''  for (int g = threadIdx.x; g < groups; g += kStride) {
    FwdBatch<C, VEC> cur;
    fwd_load<C, VEC>(cur, g, groups, bw, bs, bt, bm, s_c);
    fwd_accumulate<C, VEC>(cur, ignore, acc);
  }
'''
# (text of the source, its replacement); a helper goes before the code using it.
PATCHES = {
    "PREFETCH": [(LOOP, '''  FwdBatch<C, VEC> cur;
  fwd_load<C, VEC>(cur, threadIdx.x, groups, bw, bs, bt, bm, s_c);
  for (int g = threadIdx.x; g < groups; g += kStride) {
    FwdBatch<C, VEC> next;
    fwd_load<C, VEC>(next, g + kStride, groups, bw, bs, bt, bm, s_c);
    fwd_accumulate<C, VEC>(cur, ignore, acc);
    cur = next;
  }
''')],
    "DIVIDE": [("      softmax_terms<C>(x, pw, lpw);", "      softmax_div<C>(x, pw, lpw);"),
               ("      softmax_terms<C>(x, ps, lps);", "      softmax_div<C>(x, ps, lps);"),
               (BATCH_HEAD, '''template <int C>
__device__ __forceinline__ void softmax_div(const float* x, float* p, float* lp) {
  float m = x[0];
#pragma unroll
  for (int k = 1; k < C; ++k) m = fmaxf(m, x[k]);
  float e[C], denom = 0.f;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    e[k] = expf(x[k] - m);
    denom += e[k];
  }
  const float log_denom = logf(denom), inv = 1.f / denom;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    lp[k] = x[k] - m - log_denom;
    p[k] = e[k] * inv;
  }
}

''' + BATCH_HEAD)],
    "TOUCH": [("fwd_accumulate<C, VEC>(cur, ignore, acc);", "fwd_touch<C, VEC>(cur, acc);"),
              (KERNEL_HEAD, '''template <int C, int VEC>
__device__ __forceinline__ void fwd_touch(const FwdBatch<C, VEC>& b, float* acc) {
#pragma unroll
  for (int u = 0; u < kFwdUnroll; ++u)
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
#pragma unroll
      for (int k = 0; k < C; ++k) acc[0] += b.xw[u][k][v] + b.xs[u][k][v];
      acc[1] += (float)b.t[u][v];
      acc[2] += b.mk[u][v];
    }
}

''' + KERNEL_HEAD)],
}


def _variant_source(src, unroll, per_sm, patches):
    text = re.sub(r"constexpr int kFwdUnroll = \d+;", f"constexpr int kFwdUnroll = {unroll};", src)
    text = re.sub(r"constexpr int kFwdBlocksPerSm = \d+;",
                  f"constexpr int kFwdBlocksPerSm = {per_sm};", text)
    for patch in patches:
        for old, new in PATCHES[patch]:
            if old not in text:
                raise SystemExit(f"patch {patch}: its text is not in fused_loss.cu")
            text = text.replace(old, new, 1)
    return text


def _build_variants():
    """One library a variant, all nvcc's started together."""
    src = (_build.CSRC_DIR / "fused_loss.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, (unroll, per_sm, patches)) in enumerate(VARIANTS.items()):
        cu = OUT / f"v{i}.cu"
        cu.write_text(_variant_source(src, unroll, per_sm, patches))
        so = OUT / f"libv{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for j, line in enumerate(lines):
            if "fwd_kernelILi5ELi4E" in line:
                print(f"{name}: {lines[j + 1].strip()}; {lines[j + 2].strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_loss_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, ll, ll, i, i, i, i, p]
        lib.fused_loss_fwd.restype = i
        libs[name] = lib
    return libs


def _runner(lib, unroll, per_sm, lw, ls, tgt, mask, c, dev):
    saved = fl.FWD_UNROLL, fl.FWD_BLOCKS_PER_SM
    fl.FWD_UNROLL, fl.FWD_BLOCKS_PER_SM = unroll, per_sm
    try:
        plan = fl.forward_plan(lw, ls, tgt, mask)
    finally:
        fl.FWD_UNROLL, fl.FWD_BLOCKS_PER_SM = saved
    n, _, h, w = lw.shape
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    partials = torch.empty(plan.grid_x * plan.grid_y * 5, dtype=torch.float32, device=dev)

    def run():
        out = torch.empty(11, dtype=torch.float32, device=dev)
        err = lib.fused_loss_fwd(
            lw.data_ptr(), ls.data_ptr(), tgt.data_ptr(), mask.data_ptr(),
            partials.data_ptr(), counter.data_ptr(), out.data_ptr(), c, n, h * w,
            lw.stride(0), lw.stride(1), c, plan.vec, plan.chunk, plan.grid_x,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    return run, plan


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    c = 5
    lw, ls, tgt, mask = cs._loss_inputs(c, "random", dev, seed=7)
    want = fl.forward_plain(lw, ls, tgt, mask, c)
    bound = cs._bytes(lw, ls, tgt, mask, want) / cs.HBM_BYTES_PER_S * 1e3
    libs = _build_variants()
    runs = {}
    for name, (unroll, per_sm, patches) in VARIANTS.items():
        touch = "TOUCH" in patches
        run, plan = _runner(libs[name], unroll, per_sm, lw, ls, tgt, mask, c, dev)
        a, b = run(), run()
        torch.cuda.synchronize()
        if not touch:
            cs._check(torch.equal(a, b), f"{name}: two calls differ")
            cs._check(torch.allclose(a, want, rtol=1e-5, atol=0.0),
                      f"{name}: {a.tolist()} vs {want.tolist()}")
        runs[name] = run
        print(f"{name}: {plan.grid_x} x {plan.grid_y} blocks of {plan.chunk} pixels, "
              + ("not checked" if touch else "held"), flush=True)
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=dev)
    words = flush.view(torch.int32)
    flushes = {"dirty": flush.zero_, "clean": lambda: words.max()}
    names = list(runs)
    for mode, fn in flushes.items():
        times = {name: [] for name in runs}
        for order in (names, names[::-1], names, names[::-1]):
            for name in order:
                times[name].append(_time_ms(runs[name], fn))
        for name, ts in times.items():
            ms = statistics.median(ts)
            print(f"{mode} flush: {name}: {ms:.4f} ms (turns {[round(t, 4) for t in ts]}), "
                  f"{bound / ms:.0%} of the bound {bound:.5f} ms", flush=True)
    tiny = cs._loss_inputs(c, "random", dev, 8, 1, 16, 16)
    for name in ("as built",):
        unroll, per_sm = VARIANTS[name][:2]
        run, plan = _runner(libs[name], unroll, per_sm, *tiny, c, dev)
        print(f"one block ({plan.grid_x} x {plan.grid_y}), {name}: dirty flush "
              f"{_time_ms(run, flush.zero_):.4f} ms, clean flush "
              f"{_time_ms(run, flushes['clean']):.4f} ms", flush=True)


def _time_ms(fn, flush, reps=cs.TIMING_REPS):
    """``chip_smoke._time_ms`` with the flush as a function."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


if __name__ == "__main__":
    main()
