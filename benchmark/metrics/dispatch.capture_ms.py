"""What an epoch's recapture adds to its first dispatch
(``train/graph.py::StepGraph``: one eager update and the capture): the
span of the dispatch in which ``StepGraph.captures`` grew, minus the span
of the epoch before's last replay-only dispatch of as many updates, both
synced at both ends, at the traced run's first boundary."""
LAYER, UNIT, SOURCE, MOVES, BETTER = ("dispatch", "ms", "program_span", "train_slices_per_s",
                                      "lower")


def read(ctx):
    capture, replay = ctx["spans"]["capture"], ctx["spans"]["replay"]
    if not capture or not replay:
        return None
    return sum(capture) / len(capture) - sum(replay) / len(replay)
