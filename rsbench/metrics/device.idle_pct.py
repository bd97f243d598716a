"""Share of the traced window in which no operation ran on the card
(the profiler's kernels, copies and sets, their union), in %."""

UNIT = "%"
LAYER = "device"
MOVES = "reads_per_s"


def read(trace):
    if trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
