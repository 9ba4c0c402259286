"""The readers of the program's own measurements (``harness/
program_trace.py``): each returns None with nothing in the program's
registry, and with the registry absent (a program without
``pacingpseudo_torch/utils/trace.py``), and otherwise the median of the
samples planted in its series for the window's epochs (their mean for
``loop.val_device_ms``, as ``loop.val_ms`` takes), leaving out the set-up's
before them (where the series takes one) and the traced epoch's after them;
a series with more or fewer samples than that gives None."""
import sys

import pytest

from harness import cell as C

READERS = {
    "augment.device_ms": "phase.augment",
    "model.forward_ms": "phase.forward",
    "losses.device_ms": "phase.losses",
    "model.backward_ms": "phase.backward",
    "step.optimizer_ms": "phase.optimizer",
    "step.update_ms": "phase.update",
    "dispatch.capture_host_ms": "graph.capture",
    "loop.val_device_ms": "loop.val_device",
}


# the series that take a sample in the set-up: the first capture, and the
# validation before it, which that capture reads
SET_UP = {name: 1 if name in ("graph.capture", "loop.val_device") else 0
          for name in READERS.values()}
# a window of five epoch boundaries
CTX = {"spans": {"epochs": [(200 + e, 127, 8.0, 0.4) for e in range(5)]}}


@pytest.fixture
def registry():
    from pacingpseudo_torch.utils import trace
    trace.reset()
    yield trace
    trace.reset()


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_is_silent_without_samples(metric, registry):
    registry.add("some.other_series", 1.0)
    assert C.load_metric(metric).read(CTX) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_is_silent_without_the_registry(metric, registry, monkeypatch):
    registry.add(READERS[metric], 1.0)
    monkeypatch.setitem(sys.modules, "pacingpseudo_torch.utils.trace", None)
    monkeypatch.delattr(sys.modules["pacingpseudo_torch.utils"], "trace")
    assert C.load_metric(metric).read(CTX) is None


def _plant(registry, metric, window):
    """The set-up's sample where the series takes one, ``window``, and the
    traced epoch's."""
    name = READERS[metric]
    for v in ([9000.0] * SET_UP[name] + list(window) + [700.0]):
        registry.add(name, v)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_gives_the_median_of_the_windows_samples(metric, registry):
    _plant(registry, metric, (5.0, 1.0, 40.0, 2.0, 3.0))
    registry.add("phase.unrelated", 1000.0)
    mean = metric == "loop.val_device_ms"
    assert C.load_metric(metric).read(CTX) == (10.2 if mean else 3.0)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_is_silent_on_a_series_of_another_length(metric, registry):
    name = READERS[metric]
    registry.add(name, 7.0)
    assert C.load_metric(metric).read(CTX) is None
    registry.reset()
    _plant(registry, metric, (5.0, 1.0, 40.0, 2.0))          # a sample short
    assert C.load_metric(metric).read(CTX) is None
    registry.reset()
    _plant(registry, metric, (5.0, 1.0, 40.0, 2.0, 3.0))
    registry.add(name, 50.0)                                   # one after the traced epoch's
    assert C.load_metric(metric).read(CTX) is None
