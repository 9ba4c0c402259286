"""The program's own measurements, read in the run's process: the series of
``pacingpseudo_torch/utils/trace.py`` (host spans in ms; the device phases
of a replayed update and the validation's device time in device ms, taken
at each recapture).  A program without that module gives nothing.

A series holds one sample an epoch boundary, in order: the set-up's where
it takes one (its first capture, and the validation before it, read at that
capture; the first capture replaces no replayed graph, so the phases take
none there), one for each of the window's boundaries
(``ctx["spans"]["epochs"]``), and last the traced epoch's, under the
profiler.  The readers take the window's, as ``loop.val_ms`` takes the
window's validations: their median, or, beside a wall time that takes the
mean, their mean.  The window is found by position, so a series whose
count is not the set-up's, the window's and the traced epoch's gives
nothing rather than a shifted window."""
import statistics
from typing import Dict, List, Optional

# series that take a sample in the set-up
SET_UP_SAMPLES = {"graph.capture": 1, "loop.val_device": 1}


def window_samples(name: str, ctx: Dict) -> Optional[List[float]]:
    """The window's samples of the program's series ``name``, or None where
    the program keeps no such series or its count is not the one expected."""
    try:
        from pacingpseudo_torch.utils import trace
    except ImportError:
        return None
    series = trace.series(name)
    n, lead = len(ctx["spans"]["epochs"]), SET_UP_SAMPLES.get(name, 0)
    if series is None or n == 0 or series.count != lead + n + 1 \
            or len(series.samples) != series.count:
        return None
    return list(series.samples)[lead:lead + n]


def window_median(name: str, ctx: Dict) -> Optional[float]:
    samples = window_samples(name, ctx)
    return statistics.median(samples) if samples else None
