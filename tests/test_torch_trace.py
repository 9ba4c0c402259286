"""The port's spans, counters and device phases (``pacingpseudo_torch/
utils/trace.py``) and where the loop and the step record them.

On the CPU, at 64x64, init_ch 8, batch 2, on a seeded synthetic CHAOS pool:

* spans count and sum; under a ``torch.profiler`` their names are
  ``user_annotation`` ranges, nested as the spans were, and none starts
  with ``bench.`` (the benchmark's own ranges);
* ``launch_counters()`` names the op modules' own ``LAUNCHES`` / ``ROUTES``
  dicts;
* the phase marks do nothing off a card: a train step with them and one
  with them patched out leave the same metrics and parameters, bit for bit;
* a two-epoch ``_train_driver`` run, resident and streamed, records each
  loop span as often as the loop runs its part, writes them into its
  ``--profile_dir`` trace and logs a ``trace:`` line an epoch.

On a card (marked ``card``; skipped elsewhere; this file imports no JAX, so
it runs there with ``python -m pytest --noconftest tests/test_torch_trace.py
-m card``): a replayed Experiment update's phases are all positive and sum
to its whole, one sample is taken at each capture that replaces a replayed
graph, and the replay path calls no ``synchronize`` and reads no event.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os

import pytest
import torch

from pacingpseudo_torch.aug.engine import make_train_augment_fn
from pacingpseudo_torch.cli import train as cli
from pacingpseudo_torch.data.npz_dataset import BatchLoader, SliceDataset, raw_batch_to_device
from pacingpseudo_torch.data.resident import stage_train_pool
from pacingpseudo_torch.data.splits import read_fold_split
from pacingpseudo_torch.data.synthetic import write_synthetic_dataset
from pacingpseudo_torch.ops import fused_convbn, fused_loss, warp_cubic, warp_table
from pacingpseudo_torch.train import loop
from pacingpseudo_torch.train.graph import StepGraph
from pacingpseudo_torch.train.state import create_train_state
from pacingpseudo_torch.train.step import (make_pacing_train_step,
                                           make_resident_chunked_train_step, seed_step)
from pacingpseudo_torch.utils import trace

S, SLICES = 64, 24
SMALL = ["--input_size", str(S), str(S), "--init_ch", "8", "--hid_ch", "16",
         "--batch_size", "2"]
EXPERIMENT = ["--session", "Experiment", "--do_loss_ent", "--do_decoder_consistency",
              "--do_aux_path", "--do_memory"]
LOOP_SPANS = ("loop.upload", "loop.metrics_read", "loop.validation", "loop.val_read",
              "step.dispatch")


@pytest.fixture(autouse=True)
def fresh_registry():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pool"))
    write_synthetic_dataset(root, "chaos", SLICES, (S, S), 5, 5, seed=1)
    return root


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the chip: python -m pytest --noconftest "
                    "tests/test_torch_trace.py -m card)")
    return torch.device("cuda", 0)


def _config(*extra, **kw):
    args = cli.build_parser().parse_args(["--tag", "t", *SMALL, *EXPERIMENT, "--epoch", "2",
                                          *extra])
    return dataclasses.replace(cli.config_from_args(args), **kw).validate()


# ---------------------------------------------------------------------------
# the registry

def test_spans_count_sum_and_nest(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span("loop.outer"):
                with trace.span("graph.inner"):
                    pass
                with trace.span("graph.inner"):
                    pass
    outer, inner = trace.series("loop.outer"), trace.series("graph.inner")
    assert (outer.count, inner.count) == (3, 6)
    assert inner.total <= outer.total
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    assert _nested(path, "graph.inner", "loop.outer") == (6, 6)
    assert trace.total("graph.inner") == pytest.approx(sum(inner.samples))
    assert trace.latest("graph.inner") == inner.samples[-1]
    assert trace.series("never.recorded") is None and trace.latest("never.recorded") is None
    assert trace.total("never.recorded") == 0.0


def test_a_span_closes_on_an_exception(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with trace.span("loop.outer"):
                raise ValueError
        with trace.span("graph.after"):
            pass
    assert trace.series("loop.outer").count == 1
    assert trace.series("graph.after").count == 1
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    assert _nested(path, "graph.after", "loop.outer") == (0, 1)


def test_series_keep_the_last_samples_and_every_count():
    for v in range(trace.SAMPLES + 10):
        trace.add("phase.update", float(v))
    s = trace.series("phase.update")
    assert s.count == trace.SAMPLES + 10 and len(s.samples) == trace.SAMPLES
    assert s.samples[0] == 10.0 and s.total == sum(range(trace.SAMPLES + 10))


def test_spans_are_profiler_ranges(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("loop.validation"):
            with trace.span("loop.val_read"):
                torch.ones(4).sum()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    names = _annotations(path)
    assert {"loop.validation", "loop.val_read"} <= names


def _user_ranges(path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def _annotations(path):
    return {e["name"] for e in _user_ranges(path)}


def _nested(path, child, parent):
    """``(how many ranges named child lie inside one named parent, how many
    ranges named child)`` in a Chrome trace."""
    ranges = _user_ranges(path)
    outer = [(e["ts"], e["ts"] + e["dur"]) for e in ranges if e["name"] == parent]
    inner = [(e["ts"], e["ts"] + e["dur"]) for e in ranges if e["name"] == child]
    return sum(any(a <= s and t <= b for a, b in outer) for s, t in inner), len(inner)


def test_launch_counters_are_the_op_modules_dicts():
    got = trace.launch_counters()
    # the dicts themselves, which the wrappers and StepGraph's replays add to
    assert got["fused_loss.LAUNCHES"] is fused_loss.LAUNCHES
    assert got["fused_loss.ROUTES.fused_loss_fwd"] is fused_loss.ROUTES["fused_loss_fwd"]
    assert got["fused_convbn.LAUNCHES"] is fused_convbn.LAUNCHES
    for kernel, routes in fused_convbn.ROUTES.items():
        assert got[f"fused_convbn.ROUTES.{kernel}"] is routes
    assert got["warp_cubic.LAUNCHES"] is warp_cubic.LAUNCHES
    assert got["warp_table.LAUNCHES"] is warp_table.LAUNCHES


# ---------------------------------------------------------------------------
# the phases off a card

def _one_step(config, data_root, patched: bool, monkeypatch):
    if patched:
        monkeypatch.setattr(trace, "mark", lambda name, device: None)
        monkeypatch.setattr(trace, "update", lambda device: contextlib.nullcontext())
    train_files, _ = read_fold_split(data_root, "chaos", config.fold, config.modality)
    raw = next(iter(BatchLoader(SliceDataset(train_files, 5, 5), config.batch_size)))
    raw.pop("uid")
    state = create_train_state(config, device="cpu", seed=3)
    augment = make_train_augment_fn(*loop._augment_params(config), True)
    step = make_pacing_train_step(config, 4, augment_fn=augment)
    gen = torch.Generator()
    seed_step(gen, torch.device("cpu"), config.seed, state.step)
    metrics = step(state, raw_batch_to_device(raw, "cpu", shrink=True), gen)
    monkeypatch.undo()
    return metrics, {k: v.clone() for k, v in state.model.state_dict().items()}


def test_phases_do_nothing_on_the_cpu(data_root, one_thread, monkeypatch):
    config = _config("--compute_dtype", "float32")
    with_marks, params = _one_step(config, data_root, False, monkeypatch)
    assert not [name for name in trace._series if name.startswith("phase.")]
    without, want = _one_step(config, data_root, True, monkeypatch)
    assert sorted(with_marks) == sorted(without)
    for k in with_marks:
        if k == "lr":
            assert with_marks[k] == without[k]
        else:
            assert torch.equal(with_marks[k], without[k]), k
    for k in want:
        assert torch.equal(params[k], want[k]), k


# ---------------------------------------------------------------------------
# the loop

def _loop_run(data_root, run_dir, **kw):
    config = _config("--compute_dtype", "float32", "--ckp_interval", "1", "--no-tb_figures",
                     **kw)
    loop._train_driver(config, data_root, run_dir, max_steps_per_epoch=2, device="cpu")
    with open(os.path.join(run_dir, "log.txt")) as fh:
        return config, fh.read()


def test_the_loop_records_its_spans(data_root, tmp_path, one_thread):
    profile_dir = str(tmp_path / "prof")
    config, log = _loop_run(data_root, str(tmp_path / "run"), device_resident_data="on",
                              profile_dir=profile_dir)
    chunk = min(config.steps_per_dispatch, 2)
    dispatches = 2 * -(-2 // chunk)
    for name, n in (("loop.upload", dispatches), ("step.dispatch", dispatches),
                    ("loop.metrics_read", 2), ("loop.validation", 2), ("loop.val_read", 2),
                    ("loop.checkpoint", log.count(" saved in "))):
        assert trace.series(name) is not None and trace.series(name).count == n, name
    assert trace.series("loop.checkpoint").count >= 2        # ckp_0, ckp_1
    assert trace.series("loop.loader_wait") is None
    # the CPU runs eager steps: no capture, no device phase
    assert trace.series("graph.capture") is None and trace.series("phase.update") is None
    assert log.count("trace: 000, update not sampled") == 1
    assert log.count("trace: 001, update not sampled") == 1
    assert " upload " in log and " loader wait 0.00 ms" in log
    # epoch 1 is profiled: the loop's spans lie in its trace
    path = os.path.join(profile_dir, "trace_epoch001.json")
    names = _annotations(path)
    assert set(LOOP_SPANS) <= names
    assert _nested(path, "loop.val_read", "loop.validation") == (1, 1)
    assert not [n for n in names if n.startswith("bench.")]
    assert not [n for n in trace._series if n.startswith("bench.")]


def test_the_streamed_loop_times_the_loaders_wait(data_root, tmp_path, one_thread):
    config, log = _loop_run(data_root, str(tmp_path / "run"), device_resident_data="off")
    chunk = min(config.steps_per_dispatch, 2)
    # two batches an epoch, and the read that finds the epoch's end
    assert trace.series("loop.loader_wait").count == 2 * 3
    assert trace.series("loop.upload").count == 2 * -(-2 // chunk)
    assert log.count("trace: ") == 2


# ---------------------------------------------------------------------------
# on a card

def _card_session(data_root, device, steps_per_epoch=16):
    config = _config(device_resident_data="on")
    train_files, _ = read_fold_split(data_root, "chaos", config.fold, config.modality)
    pool = stage_train_pool(SliceDataset(train_files, 5, 5), device)
    state = create_train_state(config, device=device, seed=3)
    augment = make_train_augment_fn(*loop._augment_params(config), True)
    graph = StepGraph()
    run = make_resident_chunked_train_step(
        make_pacing_train_step(config, steps_per_epoch, augment_fn=augment), 8, pool, graph)
    gen = torch.Generator(device=device)
    n_pool = pool["image"].shape[0]

    def dispatch(k=8):
        idx = torch.arange(k * config.batch_size, device=device, dtype=torch.int32)
        return run(state, (idx % n_pool).view(k, config.batch_size), gen, config.seed)

    return graph, dispatch


@pytest.mark.card
def test_replayed_update_phases_on_a_card(card, data_root):
    graph, dispatch = _card_session(data_root, card)
    dispatch()                  # update 0 eager and captured, 1-7 replays
    assert trace.series("phase.update") is None     # no replayed graph replaced yet
    dispatch()                  # updates 8-15: replays
    assert trace.series("phase.update") is None
    dispatch()                  # update 16, epoch 1: a new capture samples update 15
    torch.cuda.synchronize(card)
    assert (graph.captures, graph.replays) == (2, 22)
    assert trace.series("phase.update").count == 1
    phases = [trace.latest("phase." + p) for p in trace.PHASES]
    whole = trace.latest("phase.update")
    assert all(v > 0 for v in phases), dict(zip(trace.PHASES, phases))
    assert abs(sum(phases) - whole) <= 0.03 * whole
    assert trace.series("graph.capture").count == 2
    for child in ("graph.drain", "graph.empty_cache", "graph.eager_update", "graph.record"):
        assert trace.series(child).count == 2
        assert trace.total(child) <= trace.total("graph.capture")


@pytest.mark.card
def test_the_replay_path_neither_syncs_nor_reads(card, data_root, monkeypatch):
    graph, dispatch = _card_session(data_root, card)
    dispatch()                  # the capture
    torch.cuda.synchronize(card)
    calls = {"synchronize": 0, "elapsed_time": 0, "event.synchronize": 0, "query": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(torch.cuda, "synchronize", counting("synchronize", torch.cuda.synchronize))
    for key, attr in (("elapsed_time", "elapsed_time"), ("event.synchronize", "synchronize"),
                      ("query", "query")):
        monkeypatch.setattr(torch.cuda.Event, attr, counting(key, getattr(torch.cuda.Event, attr)))
    replays = graph.replays
    dispatch()                  # 8 replays
    monkeypatch.undo()
    assert graph.replays == replays + 8 and graph.captures == 1
    assert calls == {"synchronize": 0, "elapsed_time": 0, "event.synchronize": 0, "query": 0}
