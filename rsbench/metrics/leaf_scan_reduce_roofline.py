"""``leaf_scan_reduce``'s share of its roofline over the window, in %:
the least time the H100 needs for each launch (live sectors of the
tiles, each distinct x once, ``length`` and y, over 3.35 TB/s) over the
kernel's device time in the profiler.  Nothing where no launch of it was
traced."""

from rsbench import yardstick

UNIT = "%"
LAYER = "kernels"
MOVES = "reads_per_s"


def read(trace):
    return yardstick.roofline_pct("leaf_scan_reduce", trace.tile_groups, 0,
                                  trace.durations("leaf_scan_reduce"))
