"""Host milliseconds of a recapture as the program times it: the span
``graph.capture`` of ``StepGraph`` (the drain, ``empty_cache``, the eager
update and the capture itself); the median over the window's
epochs."""
LAYER, UNIT, SOURCE, MOVES, BETTER = ("dispatch", "ms", "program_span", "train_slices_per_s",
                                      "lower")


def read(ctx):
    from harness import program_trace
    return program_trace.window_median("graph.capture", ctx)
