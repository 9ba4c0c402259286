"""Device milliseconds of the gather and the augmentation in a replayed
update: the program's phase events (``pacingpseudo_torch/utils/trace.py``),
from the start of ``StepGraph``'s captured region to the end of
``augment_fn`` in the train step, read at each recapture for the last
replayed update of the epoch before; the median over the window's epochs."""
LAYER, UNIT, SOURCE, MOVES, BETTER = ("augmentation", "ms", "program_span", "train_slices_per_s",
                                      "lower")


def read(ctx):
    from harness import program_trace
    return program_trace.window_median("phase.augment", ctx)
