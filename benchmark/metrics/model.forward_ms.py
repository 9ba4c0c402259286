"""Device milliseconds of the model's forward in a replayed update (both
streams in one pass and the aux path's forward): the program's phase events
from the end of the augmentation to right after ``model(...)`` in the
step's losses, read at each recapture; the median over the window's epochs."""
LAYER, UNIT, SOURCE, MOVES, BETTER = ("model", "ms", "program_span", "train_slices_per_s",
                                      "lower")


def read(ctx):
    from harness import program_trace
    return program_trace.window_median("phase.forward", ctx)
