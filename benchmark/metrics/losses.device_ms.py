"""Device milliseconds of the loss terms in a replayed update (the fused
loss or the plain terms, the aux CE, the bank's new prototypes and their
CE; CE and Dice in the Upperbound session): the program's phase events from
the forward's end to the start of ``backward()``, read at each recapture;
the median over the window's epochs."""
LAYER, UNIT, SOURCE, MOVES, BETTER = ("losses", "ms", "program_span", "train_slices_per_s",
                                      "lower")


def read(ctx):
    from harness import program_trace
    return program_trace.window_median("phase.losses", ctx)
