"""``leaf_spmm``'s share of its roofline over the window, in %: the least
time the H100 needs for each launch (live sectors of the tiles, each
distinct row of H once, ``length`` and the output, over 3.35 TB/s; or
the adds over 67 TFLOP/s) over the kernel's device time in the
profiler.  Nothing where no launch of it was traced."""

from rsbench import yardstick

UNIT = "%"
LAYER = "kernels"
MOVES = "reads_per_s"


def read(trace):
    return yardstick.roofline_pct("leaf_spmm", trace.tile_groups, trace.d,
                                  trace.durations("leaf_spmm"))
