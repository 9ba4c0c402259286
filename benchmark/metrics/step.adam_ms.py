"""Device milliseconds an update of Adam's multi-tensor kernels (the
capturable Adam of ``train/optim.py``, replayed in the step's graph), over
the traced epoch's training dispatches."""
LAYER, UNIT, SOURCE, MOVES, BETTER = "step", "ms", "device_trace", "train_slices_per_s", "lower"


def read(ctx):
    s = ctx["summary"]
    if s is None or not ctx["traced_updates"]:
        return None
    us = s.family_us("optimizer")
    return us / 1e3 / ctx["traced_updates"] if us else None
