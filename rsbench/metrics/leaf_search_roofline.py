"""``leaf_search``'s share of its roofline over the window, in %: the
least time the H100 needs for each launch the window's edge searches
made (the distinct 32-byte sectors its binary searches touch, per pair
the target, index, pos and found, each distinct tile's length, over
3.35 TB/s; or its probes over 67 TFLOP/s) over the kernel's device time
in the profiler.  Nothing where no launch of it was traced."""

from rsbench import yardstick

UNIT = "%"
LAYER = "kernels"
MOVES = "reads_per_s"
KERNEL = "leaf_search_kernel"


def read(trace):
    return yardstick.launch_share_pct(trace.bounds.get(KERNEL, []), trace.durations(KERNEL))
