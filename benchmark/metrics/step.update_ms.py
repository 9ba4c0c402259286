"""Device milliseconds of a whole replayed update (gather, augmentation,
forward, losses, backward, Adam): the program's events at the start and the
end of ``StepGraph``'s captured region, read at each recapture for the last
replayed update of the epoch before; the median over the window's epochs."""
LAYER, UNIT, SOURCE, MOVES, BETTER = ("step", "ms", "program_span", "train_slices_per_s",
                                      "lower")


def read(ctx):
    from harness import program_trace
    return program_trace.window_median("phase.update", ctx)
