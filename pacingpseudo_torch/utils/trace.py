"""Spans and the device phases of an update, one registry a process; and the
op wrappers' launch counters by name.

* :func:`span` times a block of host code (``perf_counter``, in ms) and
  opens a ``torch.profiler.record_function`` range of the same name, so
  that under a running profiler (``--profile_dir``) the span lies in the
  Chrome trace beside the kernels, on the profiler's clock.  Names carry
  their layer's prefix: ``loop.``, ``graph.``, ``step.``.
* :func:`launch_counters` names the op modules' ``LAUNCHES`` / ``ROUTES``
  dicts, the launch counts the wrappers keep; ``StepGraph`` adds a
  replay's launches to them, and keeps its own ``captures`` / ``replays``.
* The device phases of a train update are CUDA timing events recorded at
  its boundaries (:func:`update`, :func:`mark`).  In an eager update they
  are ordinary events; recorded inside a CUDA graph's capture they are
  event-record nodes (``external=True``), which every replay records
  again.  They are read only by :func:`sample`, which the caller runs
  after a ``synchronize`` it makes anyway (``train/graph.py``: once a
  capture, for the last replayed update of the graph it replaces), so
  nothing on the replay path waits for the device.  On the CPU they do
  nothing.
* :func:`device_pair` records a start and an end event around device work
  outside the step (a validation pass); :func:`sample` reads it later.

Every series keeps its count, its total and its last :data:`SAMPLES`
values.  Host spans and device series share the registry under distinct
names: the phases are ``phase.<name>`` (:data:`PHASES`, and
``phase.update``, the whole update), in device ms.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Deque, Dict, Iterator, Optional

import torch

SAMPLES = 1024
# The update's boundaries in the order its work runs; phase i lies
# between boundaries i and i + 1.
BOUNDS = ("start", "augmented", "forward", "backward", "backward_end", "end")
PHASES = ("augment", "forward", "losses", "backward", "optimizer")


class Series:
    """A named series: how many values, their sum and the last :data:`SAMPLES`."""

    __slots__ = ("count", "total", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.samples: Deque[float] = collections.deque(maxlen=SAMPLES)

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.samples.append(value)


_series: Dict[str, Series] = {}
_events: Dict[tuple, torch.cuda.Event] = {}   # (device index, name) -> event
_depth: Dict[int, int] = {}       # device index -> open update() regions
_pending = set()                  # (device index, name) of unread device pairs


def add(name: str, value: float) -> None:
    """Add ``value`` to series ``name`` (made at its first value)."""
    series = _series.get(name)
    if series is None:
        series = _series[name] = Series()
    series.add(value)


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Time the block on the host's clock into series ``name`` (ms), inside
    a profiler range of the same name (which the trace nests)."""
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            add(name, (time.perf_counter() - t0) * 1e3)


def launch_counters() -> Dict[str, Dict[str, int]]:
    """The op wrappers' own launch counters, by ``<module>.LAUNCHES`` and
    ``<module>.ROUTES.<kernel>``: the dicts themselves, which the wrappers
    add to where they launch."""
    from pacingpseudo_torch.ops import fused_convbn, fused_loss, warp_cubic, warp_table
    out = {}
    for module in (fused_loss, fused_convbn, warp_cubic, warp_table):
        short = module.__name__.rsplit(".", 1)[1]
        out[f"{short}.LAUNCHES"] = module.LAUNCHES
        for kernel, routes in getattr(module, "ROUTES", {}).items():
            out[f"{short}.ROUTES.{kernel}"] = routes
    return out


def series(name: str) -> Optional[Series]:
    return _series.get(name)


def latest(name: str) -> Optional[float]:
    s = _series.get(name)
    return s.samples[-1] if s is not None and s.samples else None


def total(name: str) -> float:
    s = _series.get(name)
    return s.total if s is not None else 0.0


def reset() -> None:
    """Forget every series and pending device pair (events stay)."""
    _series.clear()
    _pending.clear()


# ---------------------------------------------------------------------------
# device phases

def _record(name: str, device: torch.device) -> None:
    key = (device.index, name)
    event = _events.get(key)
    if event is None:
        event = _events[key] = torch.cuda.Event(enable_timing=True, external=True)
    event.record(torch.cuda.current_stream(device))


def mark(name: str, device: torch.device) -> None:
    """Record boundary ``name`` (one of :data:`BOUNDS`) of the update now
    being enqueued on ``device``; nothing off a card."""
    if device.type == "cuda":
        _record(name, device)


@contextlib.contextmanager
def update(device: torch.device) -> Iterator[None]:
    """The region of one update: marks ``start`` and ``end`` around the
    block, at the outermost of nested regions only (the step's own region
    inside ``StepGraph``'s, which takes the gather in too)."""
    if device.type != "cuda":
        yield
        return
    depth = _depth.get(device.index, 0)
    if depth == 0:
        _record("start", device)
    _depth[device.index] = depth + 1
    try:
        yield
    finally:
        _depth[device.index] = depth
    if depth == 0:
        _record("end", device)


@contextlib.contextmanager
def device_pair(name: str, device: torch.device) -> Iterator[None]:
    """Events around the device work the block enqueues; the next
    :func:`sample` adds their distance to series ``name`` (ms)."""
    if device.type != "cuda":
        yield
        return
    _record(name + ".start", device)
    yield
    _record(name + ".end", device)
    _pending.add((device.index, name))


def sample(device: torch.device, phases: bool) -> None:
    """After a ``synchronize`` of ``device``: read the pending device pairs
    and, with ``phases``, the boundaries of the last update recorded (add
    each phase to ``phase.<name>`` and the whole to ``phase.update``).  A
    host read of finished events, no wait."""
    if device.type != "cuda":
        return
    for key in [k for k in _pending if k[0] == device.index]:
        _pending.discard(key)
        start, end = _events[(key[0], key[1] + ".start")], _events[(key[0], key[1] + ".end")]
        add(key[1], start.elapsed_time(end))
    if not phases or any((device.index, b) not in _events for b in BOUNDS):
        return
    start = _events[(device.index, "start")]
    at = [0.0] + [start.elapsed_time(_events[(device.index, b)]) for b in BOUNDS[1:]]
    for phase, a, b in zip(PHASES, at, at[1:]):
        add("phase." + phase, b - a)
    add("phase.update", at[-1])
