"""Median duration of the window's ``pin`` spans, in ms: all of
``RapidStore.begin_read`` (the clock, the reader slot, one chain resolve
per subgraph and the view's construction).  Nothing where the program
records no ``pin`` span."""

import statistics

UNIT = "ms"
LAYER = "read entry"
MOVES = "read_p95_ms"


def read(trace):
    pins = trace.span_seconds("pin")
    if not pins:
        return None
    return 1e3 * statistics.median(pins)
