"""The port's elastic resharding on the CPU: placement epochs, the
migration runtime and the forced-interleaving schedules.

Mirrors ``tests/test_reshard.py`` (its 14 tests) and
``tests/test_property_reshard.py`` (its 2 property tests) on
``repro_torch`` with every shard on ``cpu``.  The reference runs its
four-device schedules in subprocesses with forced host devices; the port's
shards are slots of the plane, so four shards on one device run in
process, and the schedules are forced through the port's own hook points
(``tests/_torch_schedule.py``).  This file imports no JAX.
"""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _parity import assert_view_matches_oracles, bits, hypothesis_examples, rand_edges
from _torch_schedule import Schedule

import repro_torch.core.analytics as A
from repro_torch.core import RapidStore
from repro_torch.core.version_chain import CommitLineage
from repro_torch.core.wal import KIND_MIGRATE, WriteAheadLog
from repro_torch.launch.mesh import shard_devices

CPU = dict(device="cpu")


def same(a, b) -> bool:
    return np.array_equal(bits(a.numpy()), bits(b.numpy()))


# ---------------------------------------------------------------------------
# WAL migrate records (pure host)
# ---------------------------------------------------------------------------
def test_wal_migrate_roundtrip(tmp_path):
    path = tmp_path / "wal.log"
    w = WriteAheadLog(path, start_ts=0)
    w.append_migrate(3, {5: 1, 0: 2}, n_vertices=96)
    w.append_migrate(7, {2: 3}, n_vertices=96)
    w.close()
    _, recs, clean = WriteAheadLog.replay(path)
    assert clean and [r.kind for r in recs] == [KIND_MIGRATE, KIND_MIGRATE]
    assert recs[0].ts == 3 and recs[0].moves == {0: 2, 5: 1}
    assert recs[1].ts == 7 and recs[1].moves == {2: 3}
    assert recs[0].n_vertices == 96


def test_wal_migrate_survives_reset(tmp_path):
    path = tmp_path / "wal.log"
    w = WriteAheadLog(path, start_ts=0)
    w.append_migrate(2, {1: 1}, n_vertices=32)
    w.append_migrate(5, {0: 3}, n_vertices=32)
    w.reset(3)  # drop records at or below ts 3
    w.close()
    _, recs, clean = WriteAheadLog.replay(path)
    assert clean and len(recs) == 1
    assert recs[0].kind == KIND_MIGRATE and recs[0].moves == {0: 3}


# ---------------------------------------------------------------------------
# Lineage placement epochs (pure host)
# ---------------------------------------------------------------------------
def test_lineage_placement_epochs_window_and_trim():
    lin = CommitLineage()
    lin.record_placement(4, {0: 1})
    lin.record_placement(9, {2: 3, 1: 0})
    assert lin.placement_epochs_between(0, 3) == []
    assert lin.placement_epochs_between(0, 4) == [(4, {0: 1})]
    assert lin.placement_epochs_between(4, 9) == [(9, {1: 0, 2: 3})]
    assert lin.placement_epochs_between(9, 4) == [(9, {1: 0, 2: 3})]
    assert lin.placement_epochs_between(5, 5) == []
    lin.record(6, [7])
    lin.trim_below(6)
    assert lin.placement_epochs_between(6, 10) == [(9, {1: 0, 2: 3})]
    assert lin.placement_epochs_between(3, 10) is None


# ---------------------------------------------------------------------------
# Plane epoch bookkeeping
# ---------------------------------------------------------------------------
def _small_store(**kw):
    return RapidStore.from_edges(
        96, rand_edges(96, 500, seed=4), undirected=True,
        partition_size=16, B=16, high_threshold=8, **CPU, **kw,
    )


def test_plane_epochs_versioned_and_monotone():
    s = _small_store()
    plane = s.attach_shard_plane(n_devices=4, symmetric=True)
    S = s.n_subgraphs
    base = plane.placement_at(0, S).copy()
    assert plane.current_epoch == 0
    plane.record_epoch(5, {0: 0})
    assert plane.current_epoch == 5
    assert np.array_equal(plane.placement_at(4, S), base)
    assert np.array_equal(plane.placement_at(5, S), plane.placement_for(S))
    with pytest.raises(ValueError):
        plane.record_epoch(5, {1: 0})  # non-monotone epoch ts
    # destination folds modulo the shard count (recovery portability)
    plane.record_epoch(9, {1: plane.n_shards * 3})
    assert plane.placement_at(9, S)[1] == 0
    assert [ts for ts, _ in plane.placement_epochs()] == [0, 5, 9]


def test_attach_replays_placement_log_and_recover_restores_it(tmp_path):
    s = RapidStore(96, partition_size=16, B=16, high_threshold=8, **CPU)
    s.attach_wal(tmp_path / "wal.log")
    e = rand_edges(96, 400, seed=6)
    s.insert_edges(np.concatenate([e, e[:, ::-1]]))
    # a migrate record written the way the rebalancer writes it
    t = s.clock.next_commit_timestamp()
    s.wal.append_migrate(t, {0: 1, 3: 2}, s.n_vertices)
    s.wal.sync()
    s.lineage.record_placement(t, {0: 1, 3: 2})
    s._placement_log.append((t, {0: 1, 3: 2}))
    s.clock.publish(t)
    with s.read_view() as v:
        ref = v.edge_set()
    s.detach_wal()

    rec = RapidStore.recover(
        tmp_path, attach=False, n_vertices=96, partition_size=16, B=16,
        high_threshold=8, **CPU,
    )
    assert rec._placement_log == [(t, {0: 1, 3: 2})]
    assert rec.lineage.placement_epochs_between(0, t) == [(t, {0: 1, 3: 2})]
    with rec.read_view() as v:
        assert v.edge_set() == ref
    plane = rec.attach_shard_plane(n_devices=4, symmetric=True)
    assert plane.current_epoch == t
    pl = plane.placement_at(t, rec.n_subgraphs)
    assert pl[0] == 1 and pl[3] == 2
    assert plane.placement_at(0, rec.n_subgraphs)[0] == 0


def test_rebalancer_planning_edge_cases():
    s = _small_store()
    plane = s.attach_shard_plane(n_devices=4, symmetric=True)
    rb = s.attach_rebalancer()
    cur = int(plane.placement_for(s.n_subgraphs)[0])
    plan = rb.plan_moves({0: cur})
    assert plan.n_moves == 0 and plan.instructions == []
    assert rb.execute(plan) is None
    sig = rb.shard_signals()
    assert set(sig) == set(range(plane.n_shards))
    with s.read_view() as v:
        assert sum(sig[k]["load"] for k in sig) == v.n_edges
    s.detach_rebalancer()
    assert s.rebalancer is None
    # a one-shard plane has nowhere to move anything
    s.attach_shard_plane(n_devices=1, symmetric=True)
    assert s.attach_rebalancer().propose() is None
    s.detach_shard_plane()


def test_detach_rebalancer_via_detach_shard_plane():
    s = _small_store()
    s.attach_shard_plane(n_devices=4, symmetric=True)
    rb = s.attach_rebalancer()
    rb.start(interval=0.05)
    s.detach_shard_plane()  # must stop + detach the rebalancer first
    assert s.rebalancer is None and s.shard_plane is None
    assert rb._thread is None


# ---------------------------------------------------------------------------
# Shard layout (the reference's mesh entry-point tests)
# ---------------------------------------------------------------------------
def test_default_shards_follow_the_store_device():
    s = _small_store()
    assert s.attach_shard_plane().devices == [torch.device("cpu")]
    assert s.attach_shard_plane(n_devices=4).devices == [torch.device("cpu")] * 4


def test_shard_devices_count_and_repeats():
    assert len(shard_devices(4, "cpu")) == 4
    assert shard_devices(2, torch.device("cpu")) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        shard_devices(1, "meta")


# ---------------------------------------------------------------------------
# Forced schedules on four shards
# ---------------------------------------------------------------------------
def _sched_stores():
    n, p = 96, 16
    e = rand_edges(n, 900, seed=3)
    kw = dict(undirected=True, partition_size=p, B=16, high_threshold=8, **CPU)
    oracle = RapidStore.from_edges(n, e, **kw)  # static placement
    store = RapidStore.from_edges(n, e, **kw)
    oracle.attach_shard_plane(n_devices=4, symmetric=True)
    plane = store.attach_shard_plane(n_devices=4, symmetric=True)
    return n, oracle, store, plane, store.attach_rebalancer()


def _matches_oracle(store, oracle):
    h, ho = store.begin_read(), oracle.begin_read()
    try:
        assert_view_matches_oracles(h.view)
        assert same(A.pagerank_view(h.view), A.pagerank_view(ho.view))
        return h.view.ts
    finally:
        store.end_read(h)
        oracle.end_read(ho)


def test_reader_between_send_and_flip_is_bitwise_static():
    """A reader opening its view while the migration is parked between
    SEND and the flip resolves the old placement and answers bitwise as the
    static-placement oracle."""
    n, oracle, store, plane, rb = _sched_stores()
    plan = rb.plan_moves({0: 1, 2: 3})
    assert plan.n_moves == 2
    old = plane.placement_for(store.n_subgraphs).copy()
    with Schedule() as sched:
        sched.trap("hook_after_send")
        sched.trap("hook_before_flip")
        result = []
        sched.spawn(lambda: result.append(rb.execute(plan)))
        for point in ("hook_after_send", "hook_before_flip"):
            sched.wait(point)
            ts = _matches_oracle(store, oracle)
            assert np.array_equal(plane.placement_at(ts, store.n_subgraphs), old)
            sched.release(point)
        sched.join()
    epoch = result[0]
    assert epoch is not None
    new = plane.placement_at(store.clock.read_timestamp(), store.n_subgraphs)
    assert new[0] == 1 and new[2] == 3
    assert _matches_oracle(store, oracle) >= epoch


def test_commit_lands_mid_migration():
    n, oracle, store, plane, rb = _sched_stores()
    batch = np.array([[3, 70], [70, 3]], np.int64)
    plan = rb.plan_moves({1: 2})
    with Schedule() as sched:
        sched.trap("hook_after_send")
        result = []
        sched.spawn(lambda: result.append(rb.execute(plan)))
        sched.wait("hook_after_send")
        ts_w = store.insert_edges(batch)  # commit mid-migration
        oracle.insert_edges(batch)
        sched.release("hook_after_send")
        sched.join()
    epoch = result[0]
    assert epoch is not None and epoch != ts_w
    assert plane.placement_at(store.clock.read_timestamp(), store.n_subgraphs)[1] == 2
    with store.read_view() as v:
        assert v.search(3, 70)
    _matches_oracle(store, oracle)


def test_compactor_fold_races_flip():
    """A fold + repack while the migration is parked post-SEND: whether the
    runtime aborts on the staleness audit or proceeds, views stay bitwise
    correct and the placement matches the outcome."""
    n, oracle, store, plane, rb = _sched_stores()
    for i in range(6):
        b = rand_edges(n, 40, seed=100 + i)
        sym = np.concatenate([b, b[:, ::-1]])
        store.insert_edges(sym)
        oracle.insert_edges(sym)
    comp = store.attach_compactor(min_waste_rows=0)
    plan = rb.plan_moves({0: 3})
    with Schedule() as sched:
        sched.trap("hook_after_send")
        result = []
        sched.spawn(lambda: result.append(rb.execute(plan)))
        sched.wait("hook_after_send")
        comp.compact_once()  # fold + repack mid-migration
        sched.release("hook_after_send")
        sched.join()
    epoch = result[0]
    pl = plane.placement_at(store.clock.read_timestamp(), store.n_subgraphs)
    assert int(pl[0]) == (0 if epoch is None else 3)
    _matches_oracle(store, oracle)
    store.detach_compactor()


def test_background_rebalancer_converges_on_skew():
    n, p = 96, 8
    rng = np.random.default_rng(0)
    # hot vertex blocks land on sids {0, 4, 8}: all on shard 0 under modulo
    hot = np.concatenate([np.arange(0, 8), np.arange(32, 40), np.arange(64, 72)])
    hub = np.stack([rng.choice(hot, 3000), rng.integers(0, n, 3000)], 1)
    hub = hub[hub[:, 0] != hub[:, 1]]
    e = np.concatenate([rand_edges(n, 600, seed=3), hub])
    kw = dict(undirected=True, partition_size=p, B=16, high_threshold=8, **CPU)
    oracle = RapidStore.from_edges(n, e, **kw)
    store = RapidStore.from_edges(n, e, **kw)
    oracle.attach_shard_plane(n_devices=4, symmetric=True)
    store.attach_shard_plane(n_devices=4, symmetric=True)
    rb = store.attach_rebalancer()

    def imbalance():
        sig = rb.shard_signals()
        loads = [sig[k]["load"] for k in sorted(sig)]
        return max(loads) / (sum(loads) / len(loads))

    assert imbalance() >= rb.imbalance_threshold
    moved = 0
    for _ in range(8):
        if rb.rebalance_once() is None:
            break
        moved += 1
    assert moved >= 1
    assert imbalance() < rb.imbalance_threshold
    assert store.stats["reshard_migrations"] == moved
    assert store.stats["reshard_sids_moved"] >= moved
    _matches_oracle(store, oracle)
    rb.start(interval=0.02)  # already balanced: no-op ticks
    import time

    time.sleep(0.2)
    rb.stop()


def test_clean_shards_reused_by_identity_across_migration():
    n, p = 96, 8
    rng = np.random.default_rng(1)
    e = rng.integers(0, n, size=(300, 2), dtype=np.int64)
    e = e[e[:, 0] != e[:, 1]]
    s = RapidStore.from_edges(n, e, undirected=True, partition_size=p, B=16,
                              high_threshold=8, **CPU)
    plane = s.attach_shard_plane(n_devices=4, symmetric=True)
    rb = s.attach_rebalancer()
    h0 = s.begin_read()
    A.pagerank_view(h0.view)
    pred = h0.view.assembly.sharded.coo
    s.end_read(h0)
    reuses0 = plane.stats.shard_reuses
    uploads0 = list(plane.stats.uploads)
    assert rb.execute(rb.plan_moves({0: 1})) is not None
    h1 = s.begin_read()
    A.pagerank_view(h1.view)
    succ = h1.view.assembly.sharded.coo
    for k in (2, 3):
        assert succ.shards[k] is pred.shards[k], f"shard {k} rebuilt"
    assert succ.shards[0] is not pred.shards[0]
    assert succ.shards[1] is not pred.shards[1]
    delta = [a - b for a, b in zip(plane.stats.uploads, uploads0)]
    assert delta[2] == 0 and delta[3] == 0, delta
    assert plane.stats.shard_reuses - reuses0 == 2
    assert plane.stats.migration_rebuilds == 1
    s.end_read(h1)


# ---------------------------------------------------------------------------
# Property tests (test_property_reshard.py)
# ---------------------------------------------------------------------------
N_VERTICES, PV, BV = 64, 8, 8
RESHARD_LIVE = os.environ.get("REPRO_RESHARD_LIVE", "") == "1"

edge = st.tuples(
    st.integers(0, N_VERTICES - 1), st.integers(0, N_VERTICES - 1)
).filter(lambda e: e[0] != e[1])

step = st.one_of(
    st.tuples(st.just("write"), st.lists(edge, min_size=1, max_size=6),
              st.lists(edge, min_size=0, max_size=4)),
    st.tuples(st.just("migrate"), st.integers(0, 7), st.integers(1, 3)),
    st.tuples(st.just("compact")),
    st.tuples(st.just("read")),
)


def _sym(pairs):
    if not pairs:
        return np.empty((0, 2), np.int64)
    a = np.array(pairs, np.int64)
    return np.concatenate([a, a[:, ::-1]])


def _collectives_match_single_route(view, plane):
    """The five collectives bitwise-equal to the single-device route on the
    same view (a symmetric store on the CPU)."""
    src, dst = view.to_coo_device()
    n = view.n_vertices
    w = torch.linspace(0.1, 1.1, int(src.shape[0]))
    h = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3) / n
    from repro_torch.kernels.spmm import leaf_spmm

    blocks = view.to_leaf_blocks_device()
    spmm = torch.zeros(n, 3).index_add_(0, blocks.src, leaf_spmm(blocks.rows, h, blocks.length))
    assert same(plane.pagerank(view), A.pagerank_coo(src, dst, n))
    assert same(plane.bfs(view, 0), A.bfs_coo(src, dst, n, 0))
    assert same(plane.sssp(view, w, 0), A.sssp_coo(src, dst, w, n, 0))
    assert same(plane.wcc(view), A.wcc_coo(src, dst, n))
    assert same(plane.spmm(view, h), spmm)


@settings(max_examples=hypothesis_examples(20), deadline=None)
@given(steps=st.lists(step, min_size=3, max_size=16))
def test_random_migrate_interleavings_bitmatch_oracles(steps):
    store = RapidStore(N_VERTICES, partition_size=PV, B=BV, high_threshold=4, **CPU)
    plane = store.attach_shard_plane(n_devices=4, symmetric=True)
    rb = store.attach_rebalancer()
    comp = store.attach_compactor(min_waste_rows=0)
    if RESHARD_LIVE:
        rb.start(interval=0.01)
    oracle = set()
    epochs0 = len(plane.placement_epochs())
    try:
        for s in steps:
            if s[0] == "write":
                _, ins, dels = s
                store.apply(_sym(ins), _sym(dels))
                oracle |= {tuple(map(int, e)) for e in ins}
                oracle |= {(int(v), int(u)) for u, v in ins}
                oracle -= {tuple(map(int, e)) for e in dels}
                oracle -= {(int(v), int(u)) for u, v in dels}
            elif s[0] == "migrate":
                _, sid, delta = s
                cur = int(plane.placement_for(store.n_subgraphs)[sid])
                rb.execute(rb.plan_moves({sid: (cur + delta) % plane.n_shards}))
            elif s[0] == "compact":
                comp.compact_once()
            else:
                with store.read_view() as view:
                    assert_view_matches_oracles(view)
                    assert view.edge_set() == oracle
        with store.read_view() as view:
            assert_view_matches_oracles(view)
            assert view.edge_set() == oracle
            _collectives_match_single_route(view, plane)
        hist = plane.placement_epochs()
        ts_list = [ts for ts, _ in hist]
        assert ts_list == sorted(ts_list) and len(set(ts_list)) == len(ts_list)
        assert len(store._placement_log) == len(hist) - epochs0
        store.check_invariants()
    finally:
        if RESHARD_LIVE:
            rb.stop()
        store.detach_compactor()


@settings(max_examples=hypothesis_examples(10), deadline=None)
@given(steps=st.lists(step, min_size=2, max_size=10), seed=st.integers(0, 99))
def test_old_views_pinned_across_migrations(steps, seed):
    """A view pinned before a run of migrations/writes keeps resolving its
    own placement and answers as it did: no splice wrote into a
    predecessor's tensors."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, N_VERTICES, size=(120, 2), dtype=np.int64)
    e = e[e[:, 0] != e[:, 1]]
    store = RapidStore.from_edges(
        N_VERTICES, e, undirected=True, partition_size=PV, B=BV, high_threshold=4, **CPU
    )
    plane = store.attach_shard_plane(n_devices=4, symmetric=True)
    rb = store.attach_rebalancer()
    h = store.begin_read()
    pinned_ts = h.view.ts
    frozen = h.view.edge_set()
    placement0 = plane.placement_at(pinned_ts, store.n_subgraphs).copy()
    pr0 = A.pagerank_view(h.view).clone()
    wcc0 = A.wcc_view(h.view).clone()
    # make the pinned view's bundle the splice source of the next view, as
    # end_read would: a splice that wrote into it would change its answers
    store._retire_view(h.view)
    try:
        for s in steps:
            if s[0] == "write":
                _, ins, dels = s
                store.apply(_sym(ins), _sym(dels))
            elif s[0] == "migrate":
                _, sid, delta = s
                cur = int(plane.placement_for(store.n_subgraphs)[sid])
                rb.execute(rb.plan_moves({sid: (cur + delta) % plane.n_shards}))
            # a fresh view splices against the newest retired bundle
            with store.read_view() as v:
                A.pagerank_view(v)
                A.wcc_view(v)
        assert h.view.edge_set() == frozen
        assert_view_matches_oracles(h.view)
        assert np.array_equal(
            plane.placement_at(pinned_ts, store.n_subgraphs)[: len(placement0)],
            placement0,
        )
        # the pinned view's own sharded bundles still answer as before
        assert same(A.pagerank_view(h.view), pr0)
        assert same(A.wcc_view(h.view), wcc0)
    finally:
        store.end_read(h)
