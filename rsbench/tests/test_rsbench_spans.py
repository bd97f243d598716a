"""The readers of the program's spans: their arithmetic on hand-built
traces, a whole traced run on the CPU that gives each of them a value,
and the reads they count against those the harness marks."""

import copy
import statistics
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from rsbench import harness, spec, traceread  # noqa: E402
from test_rsbench_imports import _top_level_imports  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 2027
SPAN_METRICS = ["store.pin_ms", "view_assembler.reassembled_pct", "analytics.host_self_ms",
                "analytics.device_wait_ms"]


def _trace(spans) -> traceread.Trace:
    return traceread.Trace(window_s=1.0, busy_s=0.0, device_events=[], spans=spans,
                           counters={})


# two reads: read 1 pins, reassembles its COO (a splice) and runs a query
# with two device waits; read 5 pins, reuses the COO and runs a query that
# nests another with one wait.  Opened spans carry their thread CPU time,
# ``cpu_ns``; the ``upload`` beneath an ``assemble`` carries none.
HAND = [
    ("read", 0.900, {"id": 1, "read": 1}),
    ("pin", 0.010, {"id": 2, "parent": 1, "read": 1, "ts": 0, "chains": 4}),
    ("assemble", 0.050, {"id": 3, "parent": 1, "read": 1, "kind": "device_coo",
                         "path": "splice", "cpu_ns": 45_000_000}),
    ("query", 0.400, {"id": 4, "parent": 1, "read": 1, "kind": "bfs_view", "waits": 2,
                      "cpu_ns": 380_000_000}),
    ("assemble", 0.001, {"id": 6, "parent": 4, "read": 1, "kind": "device_coo",
                         "cpu_ns": 1_000_000}),
    ("device_wait", 0.100, {"id": 7, "parent": 4, "read": 1, "iter": 0,
                            "cpu_ns": 90_000_000}),
    ("device_wait", 0.150, {"id": 8, "parent": 4, "read": 1, "iter": 1,
                            "cpu_ns": 140_000_000}),
    ("pin", 0.030, {"id": 9, "parent": 5, "read": 5, "ts": 0, "chains": 4}),
    ("assemble", 0.002, {"id": 10, "parent": 5, "read": 5, "kind": "device_coo",
                         "path": "reuse", "cpu_ns": 2_000_000}),
    ("query", 0.300, {"id": 11, "parent": 5, "read": 5, "kind": "triangle_count_view",
                      "waits": 0, "cpu_ns": 250_000_000}),
    ("query", 0.200, {"id": 12, "parent": 11, "read": 5, "kind": "sum_intersect_tiles_view",
                      "waits": 1, "cpu_ns": 150_000_000}),
    ("device_wait", 0.040, {"id": 13, "parent": 12, "read": 5, "op": "bincount",
                            "cpu_ns": 30_000_000}),
    ("upload", 0.020, {"id": 14, "parent": 6, "read": 1}),
]
HAND_VALUES = {
    "store.pin_ms": 1e3 * statistics.median([0.010, 0.030]),
    "view_assembler.reassembled_pct": 50.0,
    # CPU ms: query 4: 380 - (1 + 90 + 140); query 11: 250 - 150;
    # query 12: 150 - 30
    "analytics.host_self_ms": (149.0 + 100.0 + 120.0) / 3,
    "analytics.device_wait_ms": 1e3 * (0.250 + 0.0 + 0.040) / 3,
}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_arithmetic_on_a_hand_built_trace(name):
    assert spec.metric_reader(name).read(_trace(HAND)) == pytest.approx(HAND_VALUES[name])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_gives_nothing_without_its_spans(name):
    reader = spec.metric_reader(name)
    assert reader.read(_trace([])) is None
    # a parent program's window: spans without ids, no pin or query
    assert reader.read(_trace([("read", 0.5, {}), ("assemble", 0.1, {"kind": "device_coo"})])) \
        is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_imports_nothing_of_the_program(name):
    """``test_rsbench_imports`` keeps JAX, ``repro`` and ``benchmarks`` out
    of every reader; a reader of the program's spans imports nothing of
    the program either, as the reference does not."""
    assert "repro_torch" not in _top_level_imports(spec.metric_path(name))


@pytest.fixture
def tracing():
    from repro_torch.obs import trace as obs_trace

    was = obs_trace.TRACER.enabled
    obs_trace.TRACER.clear()
    obs_trace.enable()
    yield obs_trace.TRACER
    obs_trace.enable(was)
    obs_trace.TRACER.clear()


def _tiny(traffic: str, writer_from: str = None) -> spec.Cell:
    bench = spec.load_benchmark()
    per_layer = [m for m in bench["per_layer"] if m["name"] in SPAN_METRICS]
    cell = spec.Cell(name=f"g500-s22.{traffic}", chips=1,
                     config=copy.deepcopy(spec.load_json(spec.config_path("g500-s22"))),
                     traffic=copy.deepcopy(spec.load_json(spec.traffic_path(traffic))),
                     end_to_end=[], per_layer=per_layer)
    cell.config["scale"] = 9
    if writer_from:
        other = spec.load_json(spec.traffic_path(writer_from))
        cell.traffic["writer"] = dict(other["writer"], rate_per_s=8.0)
    return cell


def test_a_traced_run_gives_every_span_metric(tracing):
    """A whole tiny traced run of ``coo-ro``, tracing on as ``run.py``
    turns it on: each of the four readers finds its spans, every query
    joins a pinned read, and the ring drops nothing."""
    cell = _tiny("coo-ro")
    res = harness.run(cell, SEED, 1.0, True, CPU, time.perf_counter())
    assert res["correct"], res["numbers"]
    tr = res["trace"]
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"]).read(tr)
        assert value is not None and value >= 0.0, m["name"]
    pins = {a["read"] for n, _s, a in tr.spans if n == "pin"}
    queries = [a for n, _s, a in tr.spans if n == "query"]
    assert queries and all(a["read"] in pins for a in queries)
    assert tracing.ring.dropped() == 0


def test_reassembled_reads_are_those_the_harness_marks(tracing):
    """With a writer, reads after each commit splice their COO.  The reads
    that ``view_assembler.reassembled_pct`` counts (a non-``reuse`` path)
    are as many as those the harness marks ``assembled`` (a COO or tiles
    array of the view that its predecessor bundle did not hold); both are
    read over the reads issued in the window."""
    cell = _tiny("coo-ro", writer_from="analytics-w")
    state = harness.setup(cell, SEED, CPU, True, seconds=1.0)
    w = harness.window(state, 1.0, True)
    issued = [r for r in w.reads if r["t_issue"] < w.t_end]
    marked = sum(1 for r in issued if r["assembled"])
    pins = {a["read"] for n, _s, a in w.trace.spans if n == "pin"}
    anew = {a["read"] for n, _s, a in w.trace.spans
            if n == "assemble" and a.get("path") in ("splice", "base_splice", "full_concat")}
    assert w.writes and marked > 0
    assert len(pins) == len(issued)
    assert len(pins & anew) == marked
    pct = spec.metric_reader("view_assembler.reassembled_pct").read(w.trace)
    assert pct == pytest.approx(100.0 * marked / len(issued))
