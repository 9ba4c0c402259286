"""The reduction of the traced epoch to device numbers.

In a ``--trace 1`` run the harness profiles one whole epoch of the loop
after the window (its dispatches and its boundary), wraps it in a
``record_function`` range named :data:`SPAN`, and each loop phase inside
it in a range of its own
(``bench.dispatch``, ``bench.metrics_read``, ``bench.validation``).  From
the exported Chrome trace this module takes every device operation
(kernels, copies, sets) that starts inside the span, their busy time (the
union of their intervals, as ``scripts/profile_torch_step.py::_busy_us``
computes it), the idle gaps between them labelled by what the host was
doing, and each kernel's time and launch count by name.
"""
from __future__ import annotations

import collections
import json
from typing import Dict, List, NamedTuple, Optional, Tuple

SPAN = "bench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# Kernel families by name, first match wins (a copy of the table of
# scripts/profile_torch_step.py, without the augmentation's family, whose
# host correlation a graph replay does not keep, and with Adam's
# multi-tensor kernels apart).
FAMILIES = (
    ("fused loss", ("::fwd_kernel<", "::bwd_kernel<", "fwd_kernel", "bwd_kernel")),
    ("fused conv", ("::conv3x3_kernel<", "::conv_wgmma_kernel<", "::bn_sums_kernel<",
                    "::reduce_rows_kernel(")),
    ("warp", ("warp_cubic_kernel", "warp_table_kernel")),
    ("NCHW<->NHWC layout", ("nchwToNhwc", "nhwcToNchw")),
    ("conv / GEMM", ("xmma", "implicit_gemm", "cudnn", "cutlass", "nvjet", "gemm", "conv")),
    ("bilinear upsample", ("upsample",)),
    ("reduction", ("reduce_kernel",)),
    ("max pool", ("max_pool",)),
    ("concat", ("CatArrayBatchedCopy",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("elementwise / copy", ("elementwise", "copy", "Functor")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def merge(intervals) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted intervals
    (their total length is the busy time)."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Summary(NamedTuple):
    window_us: float
    busy_us: float
    kernels: Dict[str, Tuple[float, int]]     # name -> (us, launches) outside validation
    all_kernels: Dict[str, Tuple[float, int]]  # name -> (us, launches), the whole span
    gaps: List[Tuple[str, float]]             # (what the host did, us), longest first
    ranges: Dict[str, List[Tuple[float, float]]]

    def kernel_us(self, *keys: str) -> Tuple[float, int]:
        """Total time and launches of the kernels whose names hold one of ``keys``."""
        us = n = 0
        for name, (t, k) in self.kernels.items():
            if any(key in name for key in keys):
                us, n = us + t, n + k
        return us, n

    def family_us(self, *families: str) -> float:
        return sum(t for name, (t, _) in self.kernels.items() if family(name) in families)


def _label(mid: float, ranges, cpu_ops) -> str:
    bench = [n for n, spans in ranges.items() if n != SPAN
             and any(a <= mid <= b for a, b in spans)]
    inner = None
    for ts, te, name in cpu_ops:
        if ts <= mid <= te and (inner is None or ts >= inner[0]):
            inner = (ts, te, name)
    where = bench[0] if bench else "bench.other"
    return f"{where}: {inner[2]}" if inner else f"{where}: host idle or in Python"


def summarize(path: str) -> Optional[Summary]:
    """The :class:`Summary` of the span in the Chrome trace at ``path``, or
    None when the trace holds no span or no device operation in it."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = collections.defaultdict(list)
    cpu_ops = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "user_annotation" and str(e.get("name", "")).startswith("bench."):
            ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        elif cat == "cpu_op":
            cpu_ops.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    if not ranges.get(SPAN):
        return None
    t0, t1 = ranges[SPAN][0]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
              and t0 <= e["ts"] <= t1]
    if not device:
        return None
    intervals = [(e["ts"], min(e["ts"] + e["dur"], t1)) for e in device]
    merged = merge(intervals)
    validation = ranges.get("bench.validation", [])
    kernels: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    all_kernels: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        for table in (all_kernels,) if any(a <= e["ts"] <= b for a, b in validation) \
                else (all_kernels, kernels):
            table[e["name"]][0] += e["dur"]
            table[e["name"]][1] += 1
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = [(_label((a + b) / 2, ranges, cpu_ops), b - a) for a, b in gaps[:10]]
    return Summary(window_us=t1 - t0, busy_us=sum(e - s for s, e in merged),
                   kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                   all_kernels={k: (v[0], v[1]) for k, v in all_kernels.items()},
                   gaps=labelled, ranges=dict(ranges))
