"""Share of the window's reads (the distinct ``read`` ids of its ``pin``
spans) that assembled part of their view anew, in %: those with an
``assemble`` span whose ``path`` is ``splice``, ``base_splice`` or
``full_concat``.  A ``reuse`` takes the predecessor's arrays whole, and an
``assemble`` span without a ``path`` found them on the view already.
Nothing where the program records no ``pin`` span."""

UNIT = "%"
LAYER = "view assembly"
MOVES = "read_p95_ms"
ANEW = ("splice", "base_splice", "full_concat")


def read(trace):
    reads = {a.get("read") for name, _sec, a in trace.spans if name == "pin"} - {None}
    if not reads:
        return None
    anew = {a.get("read") for name, _sec, a in trace.spans
            if name == "assemble" and a.get("path") in ANEW}
    return 100.0 * len(reads & anew) / len(reads)
