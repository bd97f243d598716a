"""The port's write pipeline and compactor, on the CPU and on the card.

CPU (mirrors ``tests/test_write_pipeline.py`` and ``tests/test_compactor.py``
on ``repro_torch`` with ``device="cpu"``): group commit coalesces with the
last op winning, ``flush`` is a barrier, a batch is visible all or nothing,
async validation raises on the caller's thread, ``detach`` restores
single-shot writes, vertex lifecycle through the pipeline; the fold frees
rows and keeps views, respects a live reader's horizon and deleted-vertex
flags, runs under ``quiesce`` without blocking readers, takes the
base-bundle splice when the predecessor's window was trimmed, uploads
only the repacked subgraphs' tiles afterwards, and keeps ``memory_bytes``
on a plateau under churn.

Card (``cuda`` marker, skipped where torch sees no CUDA device): a tiered
store on the card answers all 11 entry points as the same layout on the
CPU route does, and a pipeline write, a fold and a recovery on the card
give a recovered view that answers as the live one.  This file imports no
JAX, so the card tests collect where JAX is not installed.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from _parity import assert_view_matches_oracles, make_entry_ctx, rand_edges
from _torch_entries import assert_answers_match, port_answers

from repro_torch.core import RapidStore, device_cache
from repro_torch.core import view_assembler as va
from repro_torch.kernels.leaf_search import edge_search_view
from repro_torch.kernels.spmm import leaf_scan_reduce_view

EMPTY = np.empty((0, 2), np.int64)
CPU = dict(device="cpu")
JOIN_S = 60  # every thread's join limit


def make_pipelined(n=128, p=16, B=32, n_shards=4, max_batch=1024, **kw):
    store = RapidStore(n, partition_size=p, B=B, **CPU, **kw)
    store.attach_write_pipeline(n_shards=n_shards, max_batch=max_batch)
    return store


def make_fragmented(n=96, p=16, B=8, ht=4):
    """Hub churn on a plain B=8 pool: full neighbour sets, every other
    edge deleted, so leaves strand half-empty rows the fold repacks."""
    store = RapidStore(n, partition_size=p, high_threshold=ht, leaf_tiers=(B,), **CPU)
    store.insert_edges(rand_edges(n, 300, seed=5))
    for hub in (0, 17, 33):
        full = np.array([[hub, j] for j in range(n) if j != hub], np.int64)
        store.insert_edges(full)
        store.delete_edges(full[::2])
    return store


def join_all(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "a thread hung"


# ---------------------------------------------------------------------------
# The write pipeline
# ---------------------------------------------------------------------------
def test_group_commit_last_op_wins():
    """Queued writes coalesce into one commit; per edge the last op wins."""
    store = make_pipelined(n=256, p=64, n_shards=2)
    wp = store.write_pipeline
    wp.pause()
    tickets = [store.apply_async(np.array([[1, 2 + i]], np.int64), EMPTY)
               for i in range(50)]
    store.apply_async(EMPTY, np.array([[1, 2]], np.int64))  # then deleted
    store.apply_async(np.array([[5, 6]], np.int64), EMPTY)
    store.apply_async(EMPTY, np.array([[5, 6]], np.int64))
    store.apply_async(np.array([[5, 6]], np.int64), EMPTY)  # and back
    wp.resume()
    store.flush()
    assert {t.wait() for t in tickets} == {1}, "one shared commit timestamp"
    assert store.stats["commits"] == 1 and len(store.lineage) == 1
    assert store.lineage.writes_between(0, 1) == 54
    with store.read_view() as view:
        assert view.degree(1) == 49 and not view.search(1, 2)
        assert view.search(5, 6)
    store.detach_write_pipeline()
    store.check_invariants()


def test_flush_is_a_true_barrier():
    store = make_pipelined(n=512, p=16, n_shards=4)
    oracle, lock = set(), threading.Lock()

    def submitter(seed):
        rng = np.random.default_rng(seed)
        for _ in range(40):
            u = int(rng.integers(0, 512))
            e = np.stack([np.full(4, u, np.int64), rng.integers(0, 512, 4)], 1)
            e = e[e[:, 0] != e[:, 1]]
            store.apply_async(e, EMPTY)
            with lock:
                oracle.update((int(a), int(b)) for a, b in e)

    threads = [threading.Thread(target=submitter, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    join_all(threads)
    store.flush()
    assert store.write_pipeline._pending == 0
    with store.read_view() as view:
        assert view.edge_set() == oracle
    store.detach_write_pipeline()


def test_batch_visibility_is_all_or_nothing():
    """One write's edits appear at one timestamp, also across shards."""
    store = make_pipelined(n=512, p=16, n_shards=4)
    for edges in (
        np.array([[0, 1], [1, 2], [64, 3], [65, 4]], np.int64),  # shard 0
        np.array([[0, 9], [16, 9], [32, 9], [48, 9]], np.int64),  # a fence
    ):
        key = {(int(u), int(v)) for u, v in edges}
        stop, partial = threading.Event(), []

        def poll():
            while not stop.is_set():
                with store.read_view() as view:
                    seen = view.edge_set() & key
                    if seen and seen != key:
                        partial.append((view.ts, seen))

        th = threading.Thread(target=poll)
        th.start()
        t = store.apply_async(edges, EMPTY).wait()
        stop.set()
        join_all([th])
        assert t > 0 and not partial, f"partial batch visible: {partial}"
        store.delete_edges(edges)
    assert store.write_pipeline.stats.fences >= 1
    store.detach_write_pipeline()


def test_async_validation_raises_on_caller_thread():
    store = make_pipelined(n=64)
    with pytest.raises(ValueError):
        store.apply_async(np.array([[999, 1]], np.int64), EMPTY)
    with pytest.raises(ValueError):
        store.apply_async(np.array([[-3, 1]], np.int64), EMPTY)
    store.flush()  # the pipeline is unharmed
    assert store.apply_async(np.array([[1, 2]], np.int64), EMPTY).wait() > 0
    store.detach_write_pipeline()


def test_detach_restores_single_shot_semantics():
    store = make_pipelined()
    store.apply_async(np.array([[1, 2]], np.int64), EMPTY)
    store.detach_write_pipeline()  # flushes
    assert store.write_pipeline is None
    with store.read_view() as view:
        assert view.search(1, 2)
    assert store.insert_edge(1, 2) == 0  # a duplicate reports 0 again
    store.attach_write_pipeline()
    with pytest.raises(RuntimeError, match="already attached"):
        store.attach_write_pipeline()
    store.detach_write_pipeline()


def test_vertex_lifecycle_through_pipeline():
    store = make_pipelined(n=64, p=8)
    store.apply_async(np.array([[3, 4], [3, 5]], np.int64), EMPTY)
    store.delete_vertex(3)  # flushes, scans, deletes
    with store.read_view() as view:
        assert view.degree(3) == 0
    assert store.insert_vertex() == 3  # recycled id
    assert store.insert_vertex() == 64  # then the id space grows
    assert store.n_subgraphs == 9
    store.detach_write_pipeline()


def test_pipelined_writes_match_serial_store():
    """More writer threads than cores, each on its own vertex stripe, with
    a short switch interval: the pipeline ends at the serial store's edge
    set (one thread's writes keep their order) and counts every write."""
    n_threads, per_thread, stripe = max(12, 2 * (os.cpu_count() or 1)), 20, 8
    n = n_threads * stripe
    rng = np.random.default_rng(3)
    stripes = [[] for _ in range(n_threads)]
    for k, ops in enumerate(stripes):
        for i in range(per_thread):
            u = stripe * k + rng.integers(0, stripe, 3)
            e = np.stack([u, rng.integers(0, n, 3)], 1).astype(np.int64)
            e = e[e[:, 0] != e[:, 1]]
            ops.append((e, EMPTY) if i % 4 else (EMPTY, e))
    store = make_pipelined(n=n, p=32, B=8, n_shards=4)
    serial = RapidStore(n, partition_size=32, B=8, **CPU)

    def writer(ops):
        for t in [store.apply_async(i, d) for i, d in ops]:
            t.wait(timeout=JOIN_S)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(ops,)) for ops in stripes]
        for t in threads:
            t.start()
        join_all(threads)
    finally:
        sys.setswitchinterval(interval)
    store.flush()
    assert store.write_pipeline.stats.writes == n_threads * per_thread
    for ops in stripes:
        for i, d in ops:
            serial.apply(i, d)
    with store.read_view() as v, serial.read_view() as sv:
        assert v.edge_set() == sv.edge_set()
        assert_view_matches_oracles(v)
    store.detach_write_pipeline()


def test_memory_bytes_counts_queued_pipeline_writes():
    store = RapidStore(96, partition_size=16, B=8, **CPU)
    wp = store.attach_write_pipeline(n_shards=2)
    wp.pause()
    try:
        base = store.memory_bytes()
        tickets = [store.apply_async(np.array([[i % 96, (i + 7) % 96]], np.int64), EMPTY)
                   for i in range(40)]
        queued = wp.queued_bytes()
        assert queued > 0 and store.memory_breakdown()["pipeline"] == queued
        assert store.memory_bytes() >= base + queued
    finally:
        wp.resume()
    store.flush()
    for t in tickets:
        t.wait()
    assert wp.queued_bytes() == 0 == store.memory_breakdown()["pipeline"]
    store.detach_write_pipeline()


# ---------------------------------------------------------------------------
# The compactor
# ---------------------------------------------------------------------------
def test_compact_frees_rows_and_preserves_views():
    store = make_fragmented()
    with store.read_view() as v:
        want_src, want_dst = v.to_coo()
    live_before = store.pool.n_live_rows()
    report = store.attach_compactor(min_waste_rows=1).compact_once()
    assert report.repacked and report.rows_freed > 0
    assert store.pool.n_live_rows() < live_before
    assert store._base_assembly is not None and store._base_assembly.ts == report.base_ts
    base = store._base_assembly
    assert store.memory_breakdown()["base"] in (0, base.host_bytes() + base.device_bytes())
    with store.read_view() as v:
        src, dst = v.to_coo()
        assert np.array_equal(src, want_src) and np.array_equal(dst, want_dst)
        assert_view_matches_oracles(v)
    store.check_invariants()


def test_compact_respects_active_reader_horizon():
    store = make_fragmented()
    h = store.begin_read()  # pin the pre-fold timestamp
    pinned = h.view.edge_set()
    x = torch.randn(96, generator=torch.Generator().manual_seed(0))
    scan0 = leaf_scan_reduce_view(h.view, x)
    store.insert_edges(np.array([[1, 2], [3, 4]], np.int64))
    report = store.attach_compactor(min_waste_rows=1).compact_once()
    assert report.horizon <= h.ts
    # the pinned reader's view answers bit for bit as before the fold
    assert h.view.edge_set() == pinned
    assert torch.equal(leaf_scan_reduce_view(h.view, x), scan0)
    assert store.lineage.base_ts <= h.ts
    store.end_read(h)
    store.check_invariants()


def test_compact_preserves_deleted_vertex_flags():
    store = make_fragmented()
    store.delete_vertex(17)
    store.attach_compactor(min_waste_rows=1).compact_once()
    # the repack rebuilds subgraph 1; the dead flag must survive it
    assert not store.chains[17 // store.p].head.active[17 % store.p]


def test_compact_under_quiesce_never_blocks_readers():
    store = make_fragmented()
    wp = store.attach_write_pipeline(n_shards=2, max_batch=32)
    comp = store.attach_compactor(min_waste_rows=1)
    read = []

    def reader():
        with store.read_view() as v:
            read.append(edge_search_view(v, [0], [1]))

    with wp.quiesce():  # submissions blocked, queues drained
        th = threading.Thread(target=reader)
        th.start()
        join_all([th])
    assert len(read) == 1
    report = comp.compact_once()
    assert report.repacked
    assert store.insert_edges(np.array([[2, 9]], np.int64)) > 0
    with store.read_view() as v:
        assert v.search(2, 9)
        assert_view_matches_oracles(v)
    store.detach_write_pipeline()
    store.check_invariants()


def test_splice_below_horizon_falls_back_to_base():
    """The port's first run of the base-bundle route: a predecessor whose
    lineage window the fold trimmed splices against the frozen base."""
    store = make_fragmented()
    with store.read_view() as v:
        v.to_coo()
        old_bundle = v.assembly
    store.insert_edges(np.array([[1, 2], [5, 9]], np.int64))
    store.attach_compactor(min_waste_rows=1).compact_once()
    assert store.lineage.base_ts > old_bundle.ts
    store.insert_edges(np.array([[7, 11]], np.int64))

    store._retired_assembly = old_bundle  # a stale predecessor, alive
    va.stats.reset()
    with store.read_view() as v:
        assert v._pred() is old_bundle
        v.to_coo()
        assert_view_matches_oracles(v)
        assert v.search(7, 11) and v.search(1, 2)
    assert va.stats.base_splices >= 1
    assert va.stats.fallback_lineage == 0


def test_fold_uploads_only_repacked_tiles():
    """Repacked subgraphs are new snapshots with cold device caches: the
    first device view after the fold uploads their tiles and no others,
    and a warm repeat uploads nothing."""
    store = make_fragmented()
    x = torch.ones(96)
    with store.read_view() as view:
        leaf_scan_reduce_view(view, x)
        view.to_coo_device()
    report = store.attach_compactor(min_waste_rows=1).compact_once()
    assert report.repacked
    with store.read_view() as view:
        before = device_cache.stats.uploads
        leaf_scan_reduce_view(view, x)
        view.to_coo_device()
        # per repacked snapshot: 3 stream arrays + 2 COO arrays
        assert device_cache.stats.uploads - before == 5 * len(report.repacked)
        before = device_cache.stats.uploads
        leaf_scan_reduce_view(view, x)
        view.to_coo_device()
        assert device_cache.stats.uploads == before


def test_background_compactor_runs_cycles():
    store = make_fragmented()
    comp = store.attach_compactor(min_waste_rows=1)
    comp.start(interval=0.05)
    deadline = time.monotonic() + 10
    while comp.cycles == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    store.detach_compactor()  # stop() re-raises background errors
    assert comp.cycles >= 1
    with store.read_view() as v:
        assert_view_matches_oracles(v)


def test_churn_soak_memory_plateaus():
    n, hubs = 128, (0, 33, 70, 101)
    store = RapidStore(n, partition_size=16, high_threshold=4, leaf_tiers=(8,), **CPU)
    control = RapidStore(n, partition_size=16, high_threshold=4, leaf_tiers=(8,), **CPU)
    comp = store.attach_compactor(min_waste_rows=1)

    def churn(s):
        for hub in hubs:
            full = np.array([[hub, j] for j in range(n) if j != hub], np.int64)
            s.insert_edges(full)
            s.delete_edges(full[::2])

    warmup, peak = None, 0
    for r in range(20):
        churn(store)
        churn(control)
        comp.compact_once()
        mem = store.memory_bytes()
        if r == 5:
            warmup = mem
        elif r > 5:
            peak = max(peak, mem)
    assert peak <= 1.5 * warmup, f"memory grew past its plateau: {peak} > 1.5 x {warmup}"
    assert store.memory_bytes() < control.memory_bytes()
    assert store.pool.fill_ratio() > control.pool.fill_ratio()
    assert store.lineage.base_ts > 0
    store.check_invariants()
    with store.read_view() as v, control.read_view() as cv:
        assert v.edge_set() == cv.edge_set()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
TIERED = dict(partition_size=16, B=16, high_threshold=4, leaf_tiers=(8, 16))
LAYOUT_FREE = ("edge_search_view", "spmm_view", "pagerank_view", "bfs_view",
               "sssp_view", "wcc_view", "triangle_count_view")


def _writes(store, seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        e = rng.integers(0, 96, (8, 2))
        e = e[e[:, 0] != e[:, 1]]
        store.apply(e[:6], e[6:])
    full = np.array([[40, w] for w in range(96) if w != 40], np.int64)
    store.insert_edges(full)
    store.delete_edges(full[::2])


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
class TestWriteSideOnCard:
    """The tiered device path and the write side on the card."""

    def test_tiered_store_matches_cpu_route(self):
        edges = rand_edges(96, 900, 1)
        card = RapidStore.from_edges(96, edges, device="cuda", **TIERED)
        host = RapidStore.from_edges(96, edges, **CPU, **TIERED)
        for stage in ("built", "written", "folded"):
            if stage == "written":
                for s in (card, host):
                    _writes(s, 7)
            elif stage == "folded":
                for s in (card, host):
                    s.attach_compactor(min_waste_rows=1).compact_once()
            with card.read_view() as cv, host.read_view() as hv:
                assert sorted(cv.to_leaf_blocks_device().groups) == [8, 16]
                ctx = make_entry_ctx(hv, seed=3)
                got = port_answers(cv, ctx)
                torch.cuda.synchronize()
                assert_answers_match(port_answers(hv, ctx), got)

    def test_pipeline_fold_and_recovery(self, tmp_path):
        store = RapidStore.from_edges(96, rand_edges(96, 900, 2), device="cuda", **TIERED)
        store.attach_wal(tmp_path / "wal.log")
        comp = store.attach_compactor(min_waste_rows=1,
                                      checkpoint_dir=tmp_path / "checkpoints")
        store.attach_write_pipeline(n_shards=4)
        with store.read_view() as v:  # warm device tiles before the writes
            leaf_scan_reduce_view(v, torch.ones(96, device="cuda"))
        _writes(store, 8)
        comp.compact_once(checkpoint=True)
        _writes(store, 9)
        store.flush()
        store.detach_write_pipeline()
        store.detach_wal()
        rec = RapidStore.recover(tmp_path, attach=False)
        assert rec.device.type == "cuda"
        rec_cpu = RapidStore.recover(tmp_path, attach=False, **CPU)
        with store.read_view() as lv, rec.read_view() as rv, rec_cpu.read_view() as hv:
            assert rv.edge_set() == lv.edge_set()
            ctx = make_entry_ctx(lv, seed=4)
            live = port_answers(lv, ctx, LAYOUT_FREE)
            got = port_answers(rv, ctx, LAYOUT_FREE)
            torch.cuda.synchronize()
            assert_answers_match(live, got)
            hctx = make_entry_ctx(hv, seed=5)
            assert_answers_match(port_answers(hv, hctx), port_answers(rv, hctx))
