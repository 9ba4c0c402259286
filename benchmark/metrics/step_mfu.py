"""Model FLOP utilisation of the traced run's window (before its traced
epoch, so the profiler costs it nothing): the configuration's
model FLOPs an update (``harness/flops.py``: forward, input and weight
gradients, nothing recomputed) times the window's updates, over the
window's seconds, over the card's dense bf16 peak."""
LAYER, UNIT, SOURCE, MOVES, BETTER = "step", "%", "host_clock", "train_slices_per_s", "higher"


def read(ctx):
    if not ctx["updates"] or not ctx["window_s"]:
        return None
    rate = ctx["flops"].update_flops(ctx["flags"]) * ctx["updates"] / ctx["window_s"]
    return 100.0 * rate / ctx["peaks"].BF16_FLOPS
