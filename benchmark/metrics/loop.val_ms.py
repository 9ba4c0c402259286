"""Milliseconds of one validation pass at an epoch boundary
(``train/loop.py::make_resident_eval_fn`` over the ``ValPool``): the
harness's span around it, synced at both ends by the loop's own host
reads; the mean over the window's boundaries."""
LAYER, UNIT, SOURCE, MOVES, BETTER = "loop", "ms", "program_span", "train_slices_per_s", "lower"


def read(ctx):
    spans = ctx["spans"]["val"]
    return sum(spans) / len(spans) if spans else None
