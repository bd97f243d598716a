"""The port's span tree (``repro_torch.obs``): a read's spans share its id
and hang under its root, whatever the threads and the interleaving; with
tracing off nothing is recorded; the assembler names its path; the shard
plane's route is a ``query`` span; and the Chrome trace's profiler clock.
Runs on the CPU at a tiny size, but for the one ``cuda`` test that places
a kernel inside its span on the card."""

import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import RapidStore
from repro_torch.core import analytics as A
from repro_torch.core import view_assembler
from repro_torch.kernels.spmm import spmm_view
from repro_torch.obs import export
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import TRACER

N, P = 256, 16


def _edges(seed=0, m=900):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, N, size=(m, 2))
    return e[e[:, 0] != e[:, 1]]


def _store(plane_shards=0):
    s = RapidStore.from_edges(N, _edges(), undirected=True, partition_size=P, B=16,
                              device="cpu")
    if plane_shards:
        s.attach_shard_plane(n_devices=plane_shards, symmetric=True)
    return s


def _weights(view):
    src, _dst = view.to_coo_device()
    return torch.full((src.shape[0],), 0.75)


KINDS = {
    "pagerank_view": lambda v: A.pagerank_view(v, iters=3),
    "bfs_view": lambda v: A.bfs_view(v, 1),
    "sssp_view": lambda v: A.sssp_view(v, _weights(v), 1),
    "wcc_view": lambda v: A.wcc_view(v),
}
LOOPS = {"bfs_view": A.bfs_coo, "sssp_view": A.sssp_coo, "wcc_view": A.wcc_coo}


@pytest.fixture
def tracing():
    was = TRACER.enabled
    TRACER.clear()
    obs_trace.enable()
    yield TRACER
    obs_trace.enable(was)
    TRACER.clear()


def _args(name):
    return [sp.args for sp in TRACER.spans() if sp.name == name]


def _check_tree(spans):
    """Every span of a read names a parent that exists: the read's root
    (its id is the read's) or a span of the same read on the same thread."""
    by_id = {sp.args["id"]: sp for sp in spans}
    roots = {sp.args["read"] for sp in spans if sp.name == "read"}
    for sp in spans:
        read = sp.args.get("read")
        if not read or sp.name == "read":
            continue
        parent = sp.args["parent"]
        if parent == read:
            assert read in roots, sp
        else:
            up = by_id[parent]
            assert up.args["read"] == read and up.tid == sp.tid, (sp, up)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_one_read_is_one_tree(tracing, kind):
    store = _store()
    h = store.begin_read()
    KINDS[kind](h.view)
    store.end_read(h)
    spans = TRACER.spans()
    rid = h.read_id
    assert rid and h.view.read_id == rid
    for name in ("read", "pin", "query"):
        got = _args(name)
        assert len(got) == 1 and got[0]["read"] == rid, name
    (root,) = _args("read")
    assert root["id"] == rid and "parent" not in root
    (pin,) = _args("pin")
    assert pin["parent"] == rid and pin["chains"] == len(store.chains) and pin["ts"] == h.ts
    (query,) = _args("query")
    assert query["kind"] == kind and query["route"] == "single" and "n_shards" not in query
    under = [sp for sp in spans if sp.name in ("device_wait", "assemble")]
    assert under and all(sp.args["read"] == rid for sp in under)
    assert any(sp.args["parent"] == query["id"] for sp in under)
    # opened spans carry their thread CPU time, a query's covering its children's
    assert all(sp.args["cpu_ns"] >= 0 for sp in under)
    assert query["cpu_ns"] >= sum(sp.args["cpu_ns"] for sp in under
                                  if sp.args["parent"] == query["id"])
    _check_tree(spans)


def test_cpu_time_leaves_out_what_the_thread_waits_for(tracing):
    """``cpu_ns`` is the thread's CPU time: a span that sleeps (as a client
    waiting for the GIL does) records far less of it than its duration."""
    frame = TRACER.open()
    obs_trace.time.sleep(0.05)
    TRACER.close(frame, "sleeper")
    (sp,) = TRACER.spans()
    assert sp.dur_ns >= 50_000_000 and 0 <= sp.args["cpu_ns"] < sp.dur_ns // 2


@pytest.mark.parametrize("kind,extra,ops", [("bfs_view", 1, ["root"]), ("sssp_view", 0, ["root"]),
                                             ("wcc_view", 0, [])])
def test_waits_count_the_loop_flag_reads(tracing, kind, extra, ops):
    """``waits`` is the query's ``device_wait`` children: one flag read an
    iteration (BFS reads one more, the empty frontier that ends it), after
    the root's copy where the loop starts from one."""
    store = _store()
    h = store.begin_read()
    KINDS[kind](h.view)
    store.end_read(h)
    (query,) = _args("query")
    waits = [a for a in _args("device_wait") if a["parent"] == query["id"]]
    assert query["waits"] == len(waits)
    assert [a["op"] for a in waits if "op" in a] == ops
    flags = [a["iter"] for a in waits if "iter" in a]
    assert flags == list(range(LOOPS[kind].iterations + extra)) and len(flags) > 1


def test_pagerank_waits_for_bincount(tracing):
    store = _store()
    h = store.begin_read()
    KINDS["pagerank_view"](h.view)
    store.end_read(h)
    (query,) = _args("query")
    assert query["waits"] == 1
    assert [a.get("op") for a in _args("device_wait")] == ["bincount"]


def test_four_threads_never_mix_ids(tracing):
    """Four clients at once, switching threads as often as the interpreter
    allows: every read and span id is drawn once, and every span of a read
    was recorded on the thread that pinned it."""
    store = _store()
    held = store.begin_read()  # open through the threads' reads: its id is no one else's
    errors = []

    def client(k):
        try:
            for i in range(3):
                h = store.begin_read()
                KINDS[sorted(KINDS)[(k + i) % 4]](h.view)
                store.end_read(h)
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    store.end_read(held)
    assert not errors
    spans = TRACER.spans()
    assert len({sp.args["id"] for sp in spans}) == len(spans)
    pins = {sp.args["read"]: sp.tid for sp in spans if sp.name == "pin"}
    assert len(pins) == 13
    queries = [sp for sp in spans if sp.name == "query"]
    assert len(queries) == 12
    assert len({sp.args["read"] for sp in queries}) == 12
    for sp in spans:
        if sp.name in ("query", "device_wait", "assemble", "upload", "read"):
            assert pins[sp.args["read"]] == sp.tid or sp.name == "read", sp
    _check_tree(spans)


def test_two_reads_interleaved_on_one_thread(tracing):
    store = _store()
    a = store.begin_read()
    b = store.begin_read()
    A.bfs_view(b.view, 1)
    A.wcc_view(a.view)
    # a query of read b run inside an open span of read a nests under b's root
    frame = TRACER.open(a.read_id)
    A.bfs_view(b.view, 2)
    TRACER.close(frame, "outer", cat="read")
    store.end_read(a)
    store.end_read(b)
    spans = TRACER.spans()
    by_kind = {}
    for sp in spans:
        if sp.name == "query":
            by_kind.setdefault(sp.args["kind"], []).append(sp.args)
    assert [q["read"] for q in by_kind["bfs_view"]] == [b.read_id, b.read_id]
    assert [q["parent"] for q in by_kind["bfs_view"]] == [b.read_id, b.read_id]
    assert [q["read"] for q in by_kind["wcc_view"]] == [a.read_id]
    (outer,) = _args("outer")
    assert outer["read"] == outer["parent"] == a.read_id
    _check_tree(spans)
    assert TRACER.current() is None


@pytest.fixture
def untraced():
    was = TRACER.enabled
    obs_trace.enable(False)
    TRACER.clear()
    yield TRACER
    obs_trace.enable(was)


def test_tracing_off_records_nothing_and_makes_no_thread_state(untraced):
    store = _store()
    seen = {}

    def reader():
        assert TRACER.begin() == 0 and TRACER.open(7) == 0
        for kind in sorted(KINDS):
            h = store.begin_read()
            KINDS[kind](h.view)
            store.end_read(h)
        seen["stack"] = hasattr(TRACER._local, "stack")
        seen["read_id"] = h.read_id

    th = threading.Thread(target=reader)
    th.start()
    th.join()
    assert seen["stack"] is False and seen["read_id"] > 0
    assert TRACER.ring.recorded() == 0 and TRACER.counts() == {}


def test_turning_tracing_off_drops_open_frames(tracing):
    frame = TRACER.open()
    assert TRACER.current() is frame
    obs_trace.enable(False)
    assert TRACER.current() is None
    TRACER.close(frame, "late")  # closed after the switch: recorded by no one
    assert TRACER.count("late") == 0


def test_an_exception_closes_the_query_span(tracing):
    store = _store()
    h = store.begin_read()
    with pytest.raises(Exception):
        A.sssp_view(h.view, torch.ones(3), 1)  # weights of the wrong length
    store.end_read(h)
    (query,) = _args("query")
    assert query["kind"] == "sssp_view" and query["read"] == h.read_id
    assert TRACER.current() is None


def _coo_path(view):
    before = {f: getattr(view_assembler.stats, f) for f in view_assembler._PATHS}
    view.to_coo_device()
    moved = [view_assembler._PATHS[f] for f in before
             if getattr(view_assembler.stats, f) != before[f]]
    return moved, _args("assemble")[-1]


def _path_case(store, case):
    first = store.begin_read()
    first.view.to_coo_device()
    store.end_read(first)  # retires a bundle that holds the COO
    if case in ("splice", "base_splice"):
        store.apply(np.array([[1, 2], [2, 1]]), np.empty((0, 2), np.int64))
    h = store.begin_read()
    if case == "full_concat":
        h.view._pred = None
    if case == "base_splice":
        h.view._pred = None
        h.view._base = first.view.assembly
    TRACER.clear()
    return h


@pytest.mark.parametrize("case", ["reuse", "splice", "base_splice", "full_concat"])
def test_assemble_names_the_counter_that_moved(tracing, case):
    store = _store()
    h = _path_case(store, case)
    moved, args = _coo_path(h.view)
    expect = {"reuse": ["reuse"], "splice": ["splice"], "full_concat": ["full_concat"],
              "base_splice": ["splice", "base_splice"]}[case]
    assert sorted(moved) == sorted(expect)
    assert args["path"] == case and args["read"] == h.read_id
    # again on the same view: its own bundle holds the COO, no counter moves
    moved, args = _coo_path(h.view)
    assert moved == [] and "path" not in args
    store.end_read(h)


def test_the_shard_plane_route_is_a_query_span(tracing):
    store = _store(plane_shards=4)
    h = store.begin_read()
    calls = store.shard_plane.stats.collective_calls
    A.bfs_view(h.view, 1)
    spmm_view(h.view, torch.ones(N, 4))
    assert store.shard_plane.stats.collective_calls == calls + 2
    store.end_read(h)
    queries = _args("query")
    assert [q["kind"] for q in queries] == ["bfs_view", "spmm_view"]
    assert all(q["route"] == "plane" and q["n_shards"] == 4 for q in queries)
    bfs = queries[0]
    assert bfs["waits"] == sum(1 for a in _args("device_wait") if a["parent"] == bfs["id"]) > 1
    assert "kernel_dispatch" not in TRACER.counts()


def test_chrome_trace_on_the_profiler_clock(tracing, monkeypatch):
    TRACER.end(1_000_000, "a", args={"k": 1})
    (sp,) = TRACER.spans()
    host = export.chrome_trace()
    (ev,) = host["traceEvents"]
    assert ev["ts"] == sp.start_ns / 1e3 and ev["dur"] == sp.dur_ns / 1e3
    assert ev["args"]["k"] == 1 and ev["args"]["id"] == sp.args["id"]
    # perf 2,000,000 ns is profiler 5,000,000,000 ns: the span starts
    # 1,000,000 ns before, 4,999,000,000 ns, less a base of 4,000,000,000 ns
    monkeypatch.setattr(export, "clock_anchor", lambda: (2_000_000, 5_000_000_000))
    prof = export.chrome_trace(clock="profiler", base_ns=4_000_000_000)
    (ev,) = prof["traceEvents"]
    assert ev["ts"] == 999_000.0 and ev["dur"] == sp.dur_ns / 1e3
    assert prof["baseTimeNanoseconds"] == 4_000_000_000
    with pytest.raises(ValueError):
        export.chrome_trace(clock="gpu")


def test_write_chrome_trace_beside_a_profiler_file(tracing, tmp_path):
    import json

    TRACER.end(obs_trace.time.perf_counter_ns() - 1000, "a")
    beside = tmp_path / "prof.json"
    beside.write_text(json.dumps({"baseTimeNanoseconds": 1_000_000_000,
                                  "traceEvents": [{"name": "k", "ph": "X", "ts": 5.0}]}))
    out = json.loads(open(export.write_chrome_trace(tmp_path / "both.json",
                                                    beside=beside)).read())
    assert out["baseTimeNanoseconds"] == 1_000_000_000
    assert [e["name"] for e in out["traceEvents"]] == ["k", "a"]
    perf_ns, prof_ns = obs_trace.clock_anchor()
    (sp,) = TRACER.spans()
    expect = (sp.start_ns + prof_ns - perf_ns - 1_000_000_000) / 1e3
    assert abs(out["traceEvents"][1]["ts"] - expect) < 1e3  # the two anchors, 1 ms apart at most


@pytest.mark.cuda
def test_a_kernel_lies_inside_its_span_on_the_profiler_clock(tracing):
    """A ~1 ms marker kernel launched inside a span, the span closed after
    a synchronisation: on the exported profiler clock the kernel's event
    lies inside the span, to within 100 us."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tok = TRACER.begin()
        torch.cuda._sleep(2_000_000)  # the longest event
        torch.cuda.synchronize()
        TRACER.end(tok, "marker")
    (ev,) = [e for e in export.chrome_trace(clock="profiler")["traceEvents"]
             if e["name"] == "marker"]
    k = max((e for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA), key=lambda e: e.end_ns() - e.start_ns())
    k0, k1 = k.start_ns() / 1e3, k.end_ns() / 1e3
    assert k1 - k0 > 100.0
    assert ev["ts"] - 100.0 <= k0 and k1 <= ev["ts"] + ev["dur"] + 100.0
