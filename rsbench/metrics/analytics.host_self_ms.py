"""Mean over the window's ``query`` spans of the host's own CPU time in
the query, in ms: the thread CPU time it records (``cpu_ns``) less that
of its child spans (the spans whose ``parent`` is its ``id`` and that
record one: ``device_wait``, ``assemble``, a nested ``query``).  CPU
time, so a client's waits for the GIL or for a core are not in it; a
launch that blocks on a full CUDA queue is.  Nothing where the program
records no ``query`` span with ``cpu_ns``."""

UNIT = "ms"
LAYER = "analytics"
MOVES = "reads_per_s"


def read(trace):
    queries = [(a["cpu_ns"], a["id"]) for name, _sec, a in trace.spans
               if name == "query" and "id" in a and "cpu_ns" in a]
    if not queries:
        return None
    children = {}
    for _name, _sec, a in trace.spans:
        parent = a.get("parent")
        if parent and "cpu_ns" in a:
            children[parent] = children.get(parent, 0) + a["cpu_ns"]
    return 1e-6 * sum(cpu - children.get(i, 0) for cpu, i in queries) / len(queries)
