"""Share of the traced epoch (one whole epoch of the loop after the
window: its dispatches and its boundary's metric read, validation and
recapture) in which no device operation ran: one minus the union of the
kernels', copies' and sets' intervals over the epoch's length."""
LAYER, UNIT, SOURCE, MOVES, BETTER = "device", "%", "device_trace", "train_slices_per_s", "lower"


def read(ctx):
    s = ctx["summary"]
    if s is None or s.window_us <= 0:
        return None
    return 100.0 * (1.0 - s.busy_us / s.window_us)
