"""The readings that the check's limits are set from, for one cell.

    python benchmark/controls.py --workload <cell> --seeds 1 2 3 ... [--controls fp8 half program_half]

For every seed, in one process: the program's validation of the initial
state and its first three updates of the start epoch (the set-up of a run,
with no window), the plain reference's, and each control put in the
program's place: ``fp8``, the reference with every convolution's operands rounded to
float8 e4m3 and their gradients to e5m2 (the precision below the
configuration's bfloat16), ``bf16``, the reference in the configuration's
own precision (a second witness for the program's readings), and
``half``, the reference with the planted fault "half of the batch left
out, the mean taken over the rest" (the model runs on the whole batch, the
losses take its first half), and ``program_half`` / ``program_unchanged``,
the port itself with that fault or with a step that returns its state
unchanged (:func:`planted`).  Prints
one JSON line a seed and side with every number of ``harness/check.py`` and, last,
the largest program reading and the smallest control reading of each
number.  The runs of ``run.py`` never run this.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))


PRECISIONS = {"fp8": "fp8", "bf16": "bfloat16"}


class _WholeForward:
    """The port's model as a loss over half of the batch sees it: called
    with the first half, it runs on the whole ``batch`` and hands out the
    first ``n`` samples of each output."""

    def __init__(self, model, batch, n):
        self.__dict__.update(_model=model, _batch=batch, _n=n)

    def __getattr__(self, name):
        return getattr(self._model, name)

    def __call__(self, image, image_strong=None, train=False):
        strong = self._batch.get("image_strong") if image_strong is not None else None
        out = self._model(self._batch["image"], strong, train=train)
        return {k: v[: self._n] for k, v in out.items()}


def half_losses(losses):
    """``losses`` (the port's ``_pacing_losses`` or ``_upper_bound_losses``)
    with the planted fault "half of the batch left out, the mean taken over
    the rest": the model runs on the whole batch, the losses, so the
    backward and the update, take its first half alone."""
    def broken(config, model, batch, epoch, **kw):
        n = batch["image"].shape[0] // 2
        return losses(config, _WholeForward(model, batch, n),
                      {k: v[:n] for k, v in batch.items()}, epoch, **kw)
    return broken


def unchanged_step(make_step):
    """``make_step`` (the port's ``make_pacing_train_step`` or
    ``make_upper_bound_train_step``) with the planted fault "a step that
    returns its state unchanged": the model's state is restored after each
    update."""
    def make(config, steps_per_epoch, **kw):
        step = make_step(config, steps_per_epoch, **kw)

        def broken(state, batch, generator=None):
            keep = {k: v.clone() for k, v in state.model.state_dict().items()}
            metrics = step(state, batch, generator)
            state.model.load_state_dict(keep)
            return metrics

        broken.scalars, broken.ranks = step.scalars, step.ranks
        return broken
    return make


@contextlib.contextmanager
def planted(fault: str):
    """The port's train steps broken by ``fault`` (``"half"``:
    :func:`half_losses`; ``"unchanged"``: :func:`unchanged_step`) while the
    context lasts."""
    import pacingpseudo_torch.train.step as S
    names = ("_pacing_losses", "_upper_bound_losses") if fault == "half" \
        else ("make_pacing_train_step", "make_upper_bound_train_step")
    wrap = half_losses if fault == "half" else unchanged_step
    real = {name: getattr(S, name) for name in names}
    for name, fn in real.items():
        setattr(S, name, wrap(fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(S, name, fn)


def program_side(cell, seed, pools, init, blocks, device, start_step):
    from harness import cell as C
    prog = C.Program(cell.flags, cell.mix, seed, init, pools, device, start_step)
    trace, _ = C.program_trace(prog, blocks, int(cell.mix["start_epoch"]), init)
    prog.release()
    return trace


def readings(cell, seed: int, controls, device, leaves: bool = False):
    import torch
    from harness import cell as C, check, data
    flags, mix = cell.flags, cell.mix
    pools = data.make_pool(mix, flags, seed, device)
    init = C.make_initial_state(flags, pools, seed, device)
    bs = int(flags["batch_size"])
    n_train = pools["train"]["image"].shape[0]
    spe = n_train // bs
    start_step = int(mix["start_epoch"]) * spe
    blocks = C.epoch_blocks(seed, int(mix["start_epoch"]), n_train, spe, bs)
    trace = program_side(cell, seed, pools, init, blocks, device, start_step)
    planted_sides = {}
    for name in controls:
        if name.startswith("program_"):
            with planted(name[len("program_"):]):
                planted_sides[name] = program_side(cell, seed, pools, init, blocks, device,
                                                   start_step)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = C.reference_trace(flags, mix, init, pools["train"], pools["val"], blocks, seed,
                            start_step, spe, device)
    out = {"program": check.compare(trace, ref)}
    sides = {"program": trace}
    for name in controls:
        if name in planted_sides:
            sides[name] = planted_sides[name]
        else:
            kw = {"precision": PRECISIONS[name]} if name in PRECISIONS else {"drop": name}
            sides[name] = C.reference_trace(flags, mix, init, pools["train"], pools["val"],
                                            blocks, seed, start_step, spe, device, **kw)
        out[name] = check.compare(sides[name], ref)
    if leaves:
        for name, side in sides.items():
            out[name]["leaves"] = leaf_gaps(side, ref)
    return out


def leaf_gaps(side, ref, top: int = 6):
    """The look behind ``grad``, ``update`` and ``terms0``:
    the worst leaves' gaps and the median leaf's, and each loss term's gap
    at the first update."""
    from harness import check
    quiet = set(check.quiet_leaves(ref["raw_grad"]))
    out = {}
    for key in ("grad", "update"):
        keep = [k for k in ref[key] if k not in quiet]
        norms = sorted(ref[key][k] for k in keep)
        median = norms[len(norms) // 2]
        gaps = sorted(((abs(side[key][k] - ref[key][k]) / max(ref[key][k], median), k)
                       for k in keep), reverse=True)
        out[key] = {"median_gap": gaps[len(gaps) // 2][0], "worst": gaps[:top]}
    out["terms0"] = {k: abs(side["terms"][0].get(k, float("inf")) - v) / max(abs(v), 1e-12)
                     for k, v in ref["terms"][0].items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=["fp8", "half", "program_half"])
    ap.add_argument("--control_seeds", type=int, default=3,
                    help="run the controls on the first this many seeds")
    ap.add_argument("--leaves", action="store_true",
                    help="also print the worst and the median leaf of grad and update")
    args = ap.parse_args()
    import torch
    from harness import cell as C, check
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = C.load_cell(args.workload)
    device = torch.device("cuda", 0)
    worst = {}
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        got = readings(cell, seed, args.controls if i < args.control_seeds else [], device,
                       args.leaves)
        for side, numbers in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              **numbers}), flush=True)
            for k, v in numbers.items():
                if k == "leaves":
                    continue
                key = (side, k)
                worst[key] = max(worst.get(key, v), v) if side == "program" \
                    else min(worst.get(key, v), v)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    print(json.dumps({"workload": args.workload, "largest_program": {
        k: worst[("program", k)] for k in check.NAMES},
        **{f"smallest_{c}": {k: worst[(c, k)] for k in check.NAMES}
           for c in args.controls if (c, "loss") in worst}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
