"""Device milliseconds of ``backward()`` in a replayed update: the
program's phase events around it, read at each recapture; the median over
the window's epochs."""
LAYER, UNIT, SOURCE, MOVES, BETTER = ("model", "ms", "program_span", "train_slices_per_s",
                                      "lower")


def read(ctx):
    from harness import program_trace
    return program_trace.window_median("phase.backward", ctx)
