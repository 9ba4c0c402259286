"""Device milliseconds of a validation pass (``make_resident_eval_fn``
over the ``ValPool``): the program's events around its blocks, read at the
next recapture; the mean over the window's epochs, the statistic and the
boundaries of ``loop.val_ms``, so that the two compare pass for pass (a
pass's device span lies inside its wall span)."""
import statistics

LAYER, UNIT, SOURCE, MOVES, BETTER = ("loop", "ms", "program_span", "train_slices_per_s",
                                      "lower")


def read(ctx):
    from harness import program_trace
    samples = program_trace.window_samples("loop.val_device", ctx)
    return statistics.fmean(samples) if samples else None
