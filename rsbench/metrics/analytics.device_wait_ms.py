"""Mean over the window's ``query`` spans of the time the host spent
blocked on the card inside the query, in ms: the summed duration of its
``device_wait`` children (convergence flags read back, ``bincount``'s
range read).  Nothing where the program records no ``query`` span."""

UNIT = "ms"
LAYER = "analytics"
MOVES = "read_p95_ms"


def read(trace):
    ids = [a["id"] for name, _sec, a in trace.spans if name == "query" and "id" in a]
    if not ids:
        return None
    waits = {}
    for name, sec, a in trace.spans:
        if name == "device_wait" and a.get("parent"):
            waits[a["parent"]] = waits.get(a["parent"], 0.0) + sec
    return 1e3 * sum(waits.get(i, 0.0) for i in ids) / len(ids)
