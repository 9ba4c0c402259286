"""Device milliseconds an update of the NCHW<->NHWC conversions around the
library convolutions, over the traced epoch's training dispatches."""
LAYER, UNIT, SOURCE, MOVES, BETTER = "model", "ms", "device_trace", "train_slices_per_s", "lower"


def read(ctx):
    s = ctx["summary"]
    if s is None or not ctx["traced_updates"]:
        return None
    us, n = s.kernel_us("nchwToNhwc", "nhwcToNchw")
    return us / 1e3 / ctx["traced_updates"] if n else None
