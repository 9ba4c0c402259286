"""One run of one cell: set-up, the timed window, the trace, the check.

The window drives the port's training loop as ``pacingpseudo_torch/train/
loop.py::_train_driver`` composes it on one device with a resident pool:
``make_resident_chunked_train_step`` over the session's train step, with
``steps_per_dispatch`` updates a dispatch, each a replay of the step's CUDA
graph (``train/graph.py::StepGraph``, captured again at the first dispatch
of every epoch), batches gathered on the device from the staged pool, the
augmentation inside the step, and at every epoch boundary the loop's host
read of the epoch's metrics and its validation over the whole validation
pool (``make_resident_eval_fn``).  No checkpoint, log or figure is written.

Set-up makes the pools and the initial state from the seed, puts the
state's step at the start of the mix's start epoch, runs that epoch's first
``warmup_updates`` updates through the window's own dispatch (1, 1, 1 and
the rest, so that the first three updates can be read one by one) and one
validation pass.  The window then opens at that update of the epoch and
runs whole epochs: it closes at the same update of a later epoch, the first
one reached after ``seconds``, so that every window holds one epoch
boundary (metric read, validation, recapture) per epoch of updates, as a
run does.  It ends with a ``synchronize()``.

A traced run (``--trace 1``) times, with syncs, the last replay-only
dispatch of the start epoch and the next epoch's capturing dispatch, then
after the window profiles one more whole epoch, boundary included, for the
per-layer metrics; the window itself runs without the profiler.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from harness import check, data, flops, peaks, trace as T
from reference import step as R
from reference.model import BatchNorm2d

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the cell's files, found by name

@dataclasses.dataclass
class Cell:
    name: str
    config: Dict          # configs/<config>.json
    mix: Dict             # mixes/<traffic>.json
    limits: Dict          # limits/<workload>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def flags(self) -> Dict:
        """The configuration's flags, with the mix's own ``flags`` over them
        (a mix may run the same model another way, e.g. one update a
        dispatch)."""
        return {**self.config["flags"], **self.mix.get("flags", {})}


def load_cell(workload: str, bench_json: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    mix, limits and metrics, each read from the file named after it."""
    spec = json.loads(bench_json.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    config = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    # A per-layer metric without a list of cells is read wherever the
    # end-to-end metric it moves is reported.
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(workload, config, mix, limits, e2e, per_layer)


def load_metric(name: str):
    """The reader module ``metrics/<name>.py``."""
    import importlib.util
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# helpers

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def no_tf32():
    """Float32 matmuls and convs in full float32 (the reference's precision)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _subseed(seed: int, tag: int) -> int:
    return int(np.random.SeedSequence([seed, tag]).generate_state(1, np.uint64)[0] >> 1)


def epoch_blocks(seed: int, epoch: int, n_train: int, steps: int, batch: int) -> np.ndarray:
    """The loop's shuffle of epoch ``epoch``: ``(steps, batch)`` slice indices."""
    order = np.arange(n_train)
    np.random.RandomState([seed + 2, epoch]).shuffle(order)
    return order[:steps * batch].reshape(steps, batch)


# ---------------------------------------------------------------------------
# inputs: pools and the initial state

@torch.no_grad()
def make_initial_state(flags: Dict, pools: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial state dict, made from ``seed``: every conv weight and
    bias ``U(+-1/sqrt(fan_in))`` from one draw on the device, BatchNorm's
    affine at one and zero; the BatchNorm running statistics and the bank
    are those of one float32 forward of the reference over the first
    training batch (normalised, not augmented), so that a late epoch's
    frozen BatchNorm and its bank hold values of the data's scale.
    Returned on the host."""
    with no_tf32():
        model = R.build_model(flags, "float32", device)
        convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
        leaves = [t for m in convs for t in (m.weight, m.bias) if t is not None]
        gen = torch.Generator(device=device)
        gen.manual_seed(_subseed(seed, 0x696E6974))
        u = torch.rand(sum(t.numel() for t in leaves), generator=gen, device=device)
        pos = 0
        for m in convs:
            bound = (m.weight.shape[1] * m.weight[0, 0].numel()) ** -0.5
            for t in (m.weight, m.bias):
                if t is None:
                    continue
                t.copy_((u[pos:pos + t.numel()].view_as(t) * 2 - 1) * bound)
                pos += t.numel()
        bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
        for m in bns:
            m.momentum = 1.0
        raw = {k: v[: flags["batch_size"]] for k, v in pools["train"].items()}
        batch = R.A.eval_preprocess_batch(raw, flags["num_classes"])
        model.train()
        if flags["session"] == "Upperbound":
            model(batch["image"])
        else:
            out = model(batch["image"], batch["image"])
            if model.do_aux_path:
                bank = R.memory_update(model.aux_path.memory_bank[:, :, 0, 0],
                                       out["aux/features"], batch["scribble"], 0,
                                       flags["epoch"], flags["update_momentum"], False)
                model.aux_path.memory_bank.copy_(bank[:, :, None, None])
        for m in bns:
            m.momentum = 0.1
            m.num_batches_tracked.zero_()
        state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model
    return state


# ---------------------------------------------------------------------------
# the program

def program_config(flags: Dict, mix: Dict, seed: int):
    from pacingpseudo_torch.config import ExperimentConfig
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in flags.items() if k in fields}
    kw.update(seed=seed, ref_quirk_bn_eval_after_first_epoch=bool(mix["frozen_bn"]),
              device_resident_data="on", tb_figures=False, profile_dir="")
    return ExperimentConfig(**kw).validate()


class Program:
    """The port's state and its loop pieces, built as ``_train_driver``
    builds them on one device with a resident pool."""

    def __init__(self, flags: Dict, mix: Dict, seed: int, init: Dict, pools: Dict, device,
                 start_step: int):
        from pacingpseudo_torch.aug.engine import make_train_augment_fn
        from pacingpseudo_torch.aug.presets import base_params_for, strong_params_for
        from pacingpseudo_torch.train.graph import StepGraph
        from pacingpseudo_torch.train.loop import ValPool, make_resident_eval_fn
        from pacingpseudo_torch.train.optim import make_optimizer
        from pacingpseudo_torch.train.state import TrainState, build_model
        from pacingpseudo_torch.train.step import (make_pacing_train_step,
                                                   make_resident_chunked_train_step,
                                                   make_upper_bound_train_step)
        config = program_config(flags, mix, seed)
        self.config, self.device, self.seed = config, device, seed
        upper = config.session == "Upperbound"
        model = build_model(config, device)
        model.load_state_dict({k: v.to(device) for k, v in init.items()}, strict=True)
        model.train()
        self.state = TrainState(model=model, optimizer=make_optimizer(config, model.parameters()),
                                step=start_step)
        base = dataclasses.replace(base_params_for(config.dataset),
                                   crop_size=tuple(config.input_size))
        if config.aug_image_interp != base.image_interp:
            base = dataclasses.replace(base, image_interp=config.aug_image_interp)
        augment = make_train_augment_fn(base, strong_params_for(config.augmentations,
                                                                config.strength),
                                        config.do_decoder_consistency and not upper)
        self.record: Dict = {}

        def augment_fn(raw, generator):
            out = augment(raw, generator)
            if self.record.pop("batch_armed", False):
                self.record["batch"] = {k: v.clone() for k, v in out.items()}
            return out

        self.pool = pools["train"]
        self.steps_per_epoch = pools["train"]["image"].shape[0] // config.batch_size
        self.chunk = min(max(1, int(config.steps_per_dispatch)), self.steps_per_epoch)
        self.graph = StepGraph()
        make_train = make_upper_bound_train_step if upper else make_pacing_train_step

        def chunked(module_train: bool):
            return make_resident_chunked_train_step(
                make_train(config, self.steps_per_epoch, module_train=module_train,
                           augment_fn=augment_fn), self.chunk, self.pool, self.graph)

        self.train_step = chunked(True)
        self.frozen_step = chunked(False) if config.ref_quirk_bn_eval_after_first_epoch \
            else None
        val = pools["val"]
        n_val, bs = val["image"].shape[0], config.batch_size
        n_blocks = -(-n_val // bs)
        idx = np.arange(n_blocks * bs)
        self.val_pool = ValPool(
            val, torch.from_numpy(np.minimum(idx, n_val - 1).reshape(n_blocks, bs)).to(device),
            torch.from_numpy((idx < n_val).reshape(n_blocks, bs)).to(device))
        self.evaluate = make_resident_eval_fn(config)
        self.generator = torch.Generator(device=device)

    def step_fn(self, epoch: int) -> Callable:
        return self.frozen_step if self.frozen_step is not None and epoch >= 1 \
            else self.train_step

    def dispatch(self, blocks: np.ndarray, epoch: int, acc=None):
        idx = torch.from_numpy(blocks.astype(np.int32)).to(self.device)
        return self.step_fn(epoch)(self.state, idx, self.generator, self.seed, acc)

    def read_metrics(self, acc) -> Dict[str, float]:
        """The loop's one host read of an epoch's accumulated metrics."""
        names = [k for k in acc if k != "lr"]
        values = torch.stack([acc[k].float() for k in names]).cpu().tolist()
        return dict(zip(names, values))

    def validate(self):
        from pacingpseudo_torch.train.loop import summarize_validation
        acc = self.evaluate(self.state, self.val_pool)
        summarize_validation(acc)
        return acc

    def release(self) -> None:
        self.state.optimizer.zero_grad(set_to_none=True)
        self.graph.reset()
        self.state = self.pool = self.val_pool = None


# ---------------------------------------------------------------------------
# the traces the check compares

def _buffers(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var", "memory_bank"))}


def _first_grad(model, optimizer) -> Dict[str, float]:
    out = {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        out[name] = float(st["exp_avg"].double().norm()) / (1 - check.BETA1) \
            if "exp_avg" in st else 0.0
    return out


def _change(model, init: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {name: float((p.detach().double() - init[name].to(p.device).double()).norm())
            for name, p in model.named_parameters()}


def _cpu(acc: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().double().cpu() for k, v in acc.items()}


def program_trace(prog: Program, blocks: np.ndarray, epoch: int, init: Dict):
    """A validation pass of the initial state, then updates 0, 1 and 2 of
    ``epoch`` one dispatch each; returns the trace :mod:`harness.check`
    reads and the epoch's accumulated metrics."""
    model = prog.state.model
    rec = prog.record
    rec["batch_armed"] = True

    def hook(module, args, output):
        if "outputs" not in rec:
            rec["outputs"] = {k: v.detach().clone() for k, v in output.items()}

    val = _cpu(prog.validate())
    handle = model.register_forward_hook(hook)
    losses, terms, acc_epoch = [], [], None
    try:
        for k in range(3):
            acc = prog.dispatch(blocks[k:k + 1], epoch)
            losses.append(float(acc["loss_total"]))
            terms.append({key: float(v) for key, v in acc.items() if key != "lr"})
            acc_epoch = acc if acc_epoch is None else {
                key: acc_epoch[key] + v for key, v in acc.items()}
            if k == 0:
                grad = _first_grad(model, prog.state.optimizer)
    finally:
        handle.remove()
    out = {"batch": rec.pop("batch"), "outputs": rec.pop("outputs"), "losses": losses,
           "terms": terms,
           "grad": grad, "update": _change(model, init), "buffers": _buffers(model),
           "val": val}
    return out, acc_epoch


def reference_trace(flags: Dict, mix: Dict, init: Dict, pool: Dict, val_pool: Dict,
                    blocks: np.ndarray, seed: int, start_step: int, steps_per_epoch: int,
                    device, precision: str = "float32", drop: Optional[str] = None) -> Dict:
    """The same validation and three updates by the plain reference, from
    the same initial state, batches and draws (``precision`` and ``drop``
    make the control and the planted faults)."""
    with no_tf32():
        model = R.build_model(flags, precision, device)
        model.load_state_dict({k: v.to(device) for k, v in init.items()}, strict=True)
        opt = R.make_adam(flags, model)
        gen = torch.Generator(device=device)
        val = _cpu(R.validation_sums(flags, model, val_pool, flags["batch_size"]))
        module_train = not (mix["frozen_bn"] and start_step // steps_per_epoch >= 1)
        losses, all_terms = [], []
        for k in range(3):
            raw = {key: v[torch.from_numpy(blocks[k]).to(device)] for key, v in pool.items()}
            b, outs, terms = R.train_update(flags, model, opt, raw, start_step + k, seed,
                                            steps_per_epoch, module_train, gen, drop)
            losses.append(terms["loss_total"])
            all_terms.append(terms)
            if k == 0:
                batch, outputs = b, outs
                grad = _first_grad(model, opt)
                raw_grad = {name: float(p.grad.double().norm()) if p.grad is not None else 0.0
                            for name, p in model.named_parameters()}
        result = {"batch": batch, "outputs": outputs, "losses": losses, "grad": grad,
                  "raw_grad": raw_grad, "terms": all_terms,
                  "update": _change(model, init), "buffers": _buffers(model), "val": val}
    del model, opt
    return result


# ---------------------------------------------------------------------------
# the run

@dataclasses.dataclass
class Run:
    result: Dict
    stderr_lines: List[str]


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> Run:
    """One run of ``cell``: the result's dict and the lines of the check."""
    flags, mix = cell.flags, cell.mix
    device = torch.device(device)
    cuda = device.type == "cuda"
    os.environ.update(mix.get("env", {}))    # e.g. PACING_CONV_IMPL, read at first use

    # ---- set-up: inputs from the seed, the program, the warm-up
    marks = [("imports and CUDA", time.perf_counter())]
    # The first optimizer a process builds imports torch's compiler stack
    # (~10 s on the card's host); it is built here while the phantoms are
    # drawn in other processes, so the program's own optimizer finds it loaded.
    pools = data.make_pool(mix, flags, seed, device, meanwhile=lambda: torch.optim.Adam(
        [torch.nn.Parameter(torch.zeros(1))]))
    marks.append(("pool, and torch's optimizer imports", time.perf_counter()))
    init = make_initial_state(flags, pools, seed, device)
    if cuda:
        # The reference's forward that made the initial state holds blocks
        # the program cannot reuse: free them, and count the peak from here.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("initial state", time.perf_counter()))
    bs = int(flags["batch_size"])
    n_train = pools["train"]["image"].shape[0]
    spe = n_train // bs
    start_epoch, warm = int(mix["start_epoch"]), int(mix["warmup_updates"])
    start_step = start_epoch * spe
    prog = Program(flags, mix, seed, init, pools, device, start_step)
    chunk = prog.chunk
    if warm % chunk or not 3 <= warm < spe:
        raise ValueError(f"warmup_updates {warm} must be a multiple of the dispatch's "
                         f"{chunk} updates, at least 3 and under an epoch's {spe}")
    marks.append(("program", time.perf_counter()))
    blocks = epoch_blocks(seed, start_epoch, n_train, spe, bs)
    prog_trace, acc = program_trace(prog, blocks, start_epoch, init)
    marks.append(("updates 0-2, capture, validation", time.perf_counter()))
    for pos in range(3, warm, chunk):
        k = min(chunk, warm - pos)
        acc = prog.dispatch(blocks[pos:pos + k], start_epoch, acc)
    if traced and cuda:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)
    _sync(device)
    marks.append(("the rest of the warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    phases = [(name, t - (marks[i - 1][1] if i else t_start)) for i, (name, t) in
              enumerate(marks)]

    # ---- the loop: one dispatch, and the epoch boundary when it closes an epoch
    loop = {"epoch": start_epoch, "pos": warm, "acc": acc, "blocks": blocks, "failed": 0,
            "in_epoch": 0, "since": time.perf_counter()}
    spans = {"val": [], "capture": [], "replay": [], "epochs": []}

    def advance(synced: bool, record: bool) -> int:
        epoch, pos = loop["epoch"], loop["pos"]
        k = min(chunk, spe - pos)
        if synced:
            _sync(device)
            ts = time.perf_counter()
        captures = prog.graph.captures
        with torch.profiler.record_function("bench.dispatch"):
            loop["acc"] = prog.dispatch(loop["blocks"][pos:pos + k], epoch, loop["acc"])
        if synced:
            _sync(device)
            spans["capture" if prog.graph.captures > captures else "replay"].append(
                (time.perf_counter() - ts) * 1e3)
        pos += k
        loop["in_epoch"] += k
        if pos == spe:
            with torch.profiler.record_function("bench.metrics_read"):
                means = prog.read_metrics(loop["acc"])
            if not math.isfinite(means.get("loss_total", math.nan)):
                loop["failed"] += loop["in_epoch"]
            tv = time.perf_counter()
            with torch.profiler.record_function("bench.validation"):
                prog.validate()
            te = time.perf_counter()
            if record:
                spans["val"].append((te - tv) * 1e3)
                spans["epochs"].append((epoch, loop["in_epoch"], tv - loop["since"], te - tv))
            loop["since"] = te
            epoch, pos = epoch + 1, 0
            loop.update(acc=None, in_epoch=0,
                        blocks=epoch_blocks(seed, epoch, n_train, spe, bs))
        loop.update(epoch=epoch, pos=pos)
        return k

    # ---- the window: whole epochs from update `warm` of the start epoch.  The
    # traced run times the start epoch's last replay-only dispatch of a full
    # chunk and the next epoch's first, capturing dispatch, each synced at
    # both ends.
    last_full = (start_epoch, ((spe - 1) // chunk - 1) * chunk)
    updates = 0
    t0 = loop["since"] = time.perf_counter()
    while True:
        here = (loop["epoch"], loop["pos"])
        updates += advance(traced and (here == last_full or here == (start_epoch + 1, 0)),
                           True)
        if loop["pos"] == warm and time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    failed = loop["failed"]
    if loop["acc"] is not None and not math.isfinite(
            prog.read_metrics(loop["acc"]).get("loss_total", math.nan)):
        failed += loop["in_epoch"]
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_reserved(device))
                   if cuda else 0}
    peak = device_info["memory_peak_bytes"]

    # ---- the traced run: one more whole epoch, with its boundary, profiled
    trace_path, traced_updates = None, 0
    if traced and cuda:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        with torch.profiler.record_function(T.SPAN):
            while True:
                traced_updates += advance(False, False)
                if loop["pos"] == warm:
                    break
            _sync(device)
        prof.stop()
        trace_path = _export(prof)
        del prof
    train_pool, val_pool = pools["train"], pools["val"]
    prog.release()
    del prog, pools
    if cuda:
        torch.cuda.empty_cache()

    # ---- the check, after the window
    ref = reference_trace(flags, mix, init, train_pool, val_pool,
                          epoch_blocks(seed, start_epoch, n_train, spe, bs), seed,
                          start_step, spe, device)
    numbers = check.compare(prog_trace, ref)
    correct, lines = check.verdict(numbers, cell.limits)

    metrics = {}
    for m in cell.end_to_end:
        value = {"train_slices_per_s": updates * bs / window_s,
                 "peak_mem_gib": peak / 2 ** 30,
                 "setup_s": setup_s}.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": updates, "failed": failed,
              "metrics": metrics, "device": device_info}
    summary = None
    if traced:
        summary = T.summarize(trace_path) if trace_path else None
        if trace_path:
            os.remove(trace_path)
        ctx = {"flags": flags, "summary": summary, "traced_updates": traced_updates,
               "spans": spans, "window_s": window_s, "updates": updates, "peaks": peaks,
               "flops": flops}
        metrics = {}
        for m in cell.per_layer:
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        if summary is not None:
            result["device"]["busy_s"] = summary.busy_us / 1e6
            result["device"]["window_s"] = summary.window_us / 1e6
            top = sorted(summary.all_kernels.items(), key=lambda kv: -kv[1][0])[:10]
            result["breakdown"] = {
                "device_ops": [[name, t / 1e6] for name, (t, _) in top],
                "idle_gaps": [[what, us / 1e6] for what, us in summary.gaps]}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit, _ in lines}
    stderr = [f"set-up: {name} {sec:.3f} s" for name, sec in phases]
    stderr += [f"window: epoch {e}: {n} updates and the metric read {t:.3f} s, "
               f"validation {v:.3f} s" for e, n, t, v in spans["epochs"]]
    if traced and summary is not None and traced_updates:
        families = {}
        for name, (us, _) in summary.kernels.items():
            families[T.family(name)] = families.get(T.family(name), 0.0) + us
        stderr += [f"trace: {fam} {us / 1e3 / traced_updates:.3f} ms an update"
                   for fam, us in sorted(families.items(), key=lambda kv: -kv[1])]
    stderr += [f"check {name}: {value!r} (limit {limit!r}) {'ok' if good else 'FAILED'}"
               for name, value, limit, good in lines]
    return Run(result, stderr)


def _export(prof) -> str:
    import tempfile
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    return path
