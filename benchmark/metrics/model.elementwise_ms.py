"""Device milliseconds an update of the elementwise and reduction kernels
(BatchNorm, LeakyReLU, casts; with them the augmentation's, whose host
correlation a graph replay does not keep), over the traced epoch's
training dispatches; validation's kernels and Adam's multi-tensor kernels
(``step.adam_ms``) are left out."""
LAYER, UNIT, SOURCE, MOVES, BETTER = "model", "ms", "device_trace", "train_slices_per_s", "lower"


def read(ctx):
    s = ctx["summary"]
    if s is None or not ctx["traced_updates"]:
        return None
    us = s.family_us("elementwise / copy", "reduction")
    return us / 1e3 / ctx["traced_updates"] if us else None
