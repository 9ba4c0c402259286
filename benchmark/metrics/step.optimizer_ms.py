"""Device milliseconds from the end of ``backward()`` to the end of the
captured region in a replayed update (Adam, the bank's write, the step's
metrics): the program's phase events, read at each recapture; the median
over the window's epochs."""
LAYER, UNIT, SOURCE, MOVES, BETTER = ("step", "ms", "program_span", "train_slices_per_s",
                                      "lower")


def read(ctx):
    from harness import program_trace
    return program_trace.window_median("phase.optimizer", ctx)
