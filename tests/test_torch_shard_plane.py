"""The port's shard plane on the CPU, and four shards on one card.

CPU (mirrors ``tests/test_shard_plane.py`` on ``repro_torch`` with every
shard on ``cpu``): placement policies; bitwise parity of the collectives
with the single-device ``*_view`` functions on one shard and on four;
assembly reuse and splice counters; splice parity after a write; capacity
growth and re-pad; vertex append extending placement; the env switch and
detach; memory accounting; GC releasing shard tiles; one-shard write
isolation (clean shards upload nothing and keep their bundles by identity);
degree-balanced placement with the SpMM splice, and a re-attach with
another shard count.  Also mirrored: ``tests/test_dist_small.py``'s padding
test and ``tests/test_obs.py``'s check that detach leaves the registry and
``memory_bytes`` as it found them.

Card (``cuda`` marker, skipped where torch sees no CUDA device): four shards
on ``cuda:0`` against the single-device route on the same view — BFS, SSSP
and WCC bitwise, PageRank within 1e-5 and SpMM within 1e-4 (atomics), and
``leaf_spmm`` launching once per shard.  This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from _parity import bits as _bits
from _parity import rand_edges

import repro_torch.core.analytics as A
from repro_torch.core import RapidStore, shard_plane
from repro_torch.core.distributed import make_bfs, make_pagerank, shard_edges
from repro_torch.core.shard_plane import degree_balanced_placement, modulo_placement
from repro_torch.kernels.spmm import leaf_spmm, spmm_view
from repro_torch.launch.mesh import shard_devices

N, P = 96, 8
CPU = torch.device("cpu")


def bits(a):
    return _bits(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)


def same(a, b) -> bool:
    return np.array_equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# Placement policies (pure host logic)
# ---------------------------------------------------------------------------
def test_modulo_placement():
    w = np.ones(10, np.int64)
    assert np.array_equal(modulo_placement(w, 4), np.arange(10) % 4)


def test_degree_balanced_placement_balances_skew():
    w = np.array([1000, 10, 10, 10, 10, 10, 10, 10], np.int64)
    a = degree_balanced_placement(w, 4)
    loads = np.bincount(a, weights=w, minlength=4)
    assert loads.max() == 1000  # the hub shares with nothing
    assert np.array_equal(a, degree_balanced_placement(w, 4))
    assert len(np.unique(a)) == 4


def test_degree_balanced_no_worse_than_modulo():
    rng = np.random.default_rng(0)
    w = (rng.pareto(1.0, size=32) * 50).astype(np.int64) + 1
    lb = np.bincount(degree_balanced_placement(w, 4), weights=w, minlength=4).max()
    lm = np.bincount(modulo_placement(w, 4), weights=w, minlength=4).max()
    assert lb <= lm


def test_shard_devices_layout():
    """Shard k on card k % n_cards; on the CPU every shard is cpu and the
    default is one shard."""
    assert shard_devices(device="cpu") == [CPU]
    assert shard_devices(4, "cpu") == [CPU] * 4
    with pytest.raises(ValueError):
        shard_devices(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            shard_devices(4)  # the default device is the card


# ---------------------------------------------------------------------------
# In-process planes
# ---------------------------------------------------------------------------
def _edges(seed=0, m=900):
    return rand_edges(N, m, seed=seed)


def _mk_store(e, plane=False, n_devices=1, **plane_kw):
    s = RapidStore.from_edges(
        N, e, undirected=True, partition_size=P, B=16, high_threshold=8, device="cpu"
    )
    if plane:
        s.attach_shard_plane(n_devices=n_devices, symmetric=True, **plane_kw)
    return s


def _five(view, w, h):
    return {
        "pagerank": A.pagerank_view(view),
        "bfs": A.bfs_view(view, 0),
        "sssp": A.sssp_view(view, w, 0),
        "wcc": A.wcc_view(view),
        "spmm": spmm_view(view, h),
    }


@pytest.mark.parametrize("n_shards", [1, 4])
def test_plane_parity(n_shards):
    """All five collectives bitwise-equal to the single-device route, on
    one shard and on four (the reference's one-device and four-device
    parity tests)."""
    e = _edges()
    rng = np.random.default_rng(1)
    oracle = _mk_store(e)
    s = _mk_store(e, plane=True, n_devices=n_shards)
    assert s.shard_plane.n_shards == n_shards
    with oracle.read_view() as vo, s.read_view() as vp:
        w = (rng.random(vo.n_edges) + 0.1).astype(np.float32)
        h = torch.from_numpy(rng.normal(size=(N, 12)).astype(np.float32))
        got, want = _five(vp, w, h), _five(vo, w, h)
    for name in want:
        assert same(got[name], want[name]), name
    assert s.shard_plane.stats.collective_calls == 5


def test_plane_parity_explicit_devices():
    """An explicit ``devices=`` list with repeats (the reference's
    all-visible-devices test: here four shards on one device)."""
    e = _edges(m=400)
    oracle = _mk_store(e)
    s = _mk_store(e)
    plane = s.attach_shard_plane(devices=["cpu"] * 4, symmetric=True)
    assert plane.n_shards == 4 and plane.devices == [CPU] * 4
    h = torch.from_numpy(np.random.default_rng(2).normal(size=(N, 8)).astype(np.float32))
    with oracle.read_view() as vo, s.read_view() as vp:
        assert same(A.pagerank_view(vp), A.pagerank_view(vo))
        assert same(A.wcc_view(vp), A.wcc_view(vo))
        assert same(spmm_view(vp, h), spmm_view(vo, h))
    with pytest.raises(ValueError):
        s.attach_shard_plane(devices=["cpu"] * 2, n_devices=4)
    with pytest.raises(ValueError):  # no shard on another kind of device
        s.attach_shard_plane(devices=["cpu", "cuda"])


def test_plane_assembly_reuse_and_splice_counters():
    e = _edges()
    s = _mk_store(e, plane=True)
    plane = s.shard_plane
    S = s.n_subgraphs

    h1 = s.begin_read()
    A.pagerank_view(h1.view)
    assert plane.stats.full_builds == 1
    assert plane.stats.uploads[0] == S  # one COO upload per subgraph
    A.pagerank_view(h1.view)  # memoized on the view
    assert plane.stats.full_builds == 1 and plane.stats.splices == 0
    s.end_read(h1)

    u0 = list(plane.stats.uploads)
    with s.read_view() as v2:  # no writes: wholesale reuse, zero uploads
        A.pagerank_view(v2)
    assert plane.stats.reuses >= 1
    assert plane.stats.uploads == u0

    # a write dirtying exactly 2 subgraphs: splice, upload delta == 2
    s.insert_edges(np.array([[3, 70], [70, 3]], np.int64))
    with s.read_view() as v3:
        A.pagerank_view(v3)
    assert plane.stats.splices == 1
    assert plane.stats.spliced_segments == 2
    assert plane.stats.uploads[0] == u0[0] + 2
    assert plane.stats.full_builds == 1


def test_plane_splice_parity_after_write():
    e = _edges()
    oracle = _mk_store(e)
    s = _mk_store(e, plane=True)
    with oracle.read_view() as v:
        A.pagerank_view(v)
    with s.read_view() as v:
        A.pagerank_view(v)
    for batch in (
        np.array([[3, 70], [70, 3]], np.int64),
        np.array([[11, 50], [50, 11]], np.int64),
    ):
        oracle.insert_edges(batch)
        s.insert_edges(batch)
        with oracle.read_view() as vo, s.read_view() as vp:
            assert same(A.pagerank_view(vp), A.pagerank_view(vo))
            assert same(A.wcc_view(vp), A.wcc_view(vo))
    assert s.shard_plane.stats.splices >= 2


def test_plane_capacity_growth_repad():
    """Outgrowing the power-of-two capacity regrows the shard tensors and
    keeps results correct (no silent truncation)."""
    e = _edges(m=120)
    oracle = _mk_store(e)
    s = _mk_store(e, plane=True)
    with s.read_view() as v:
        A.pagerank_view(v)
    cap0 = v.assembly.sharded.coo.cap
    rng = np.random.default_rng(7)
    extra = rng.integers(0, N, size=(cap0 * 2, 2), dtype=np.int64)
    extra = extra[extra[:, 0] != extra[:, 1]]
    both = np.concatenate([extra, extra[:, ::-1]])
    oracle.insert_edges(both)
    s.insert_edges(both)
    with oracle.read_view() as vo, s.read_view() as vp:
        assert same(A.pagerank_view(vp), A.pagerank_view(vo))
        assert vp.assembly.sharded.coo.cap > cap0


def test_plane_vertex_append_extends_placement():
    e = _edges(m=300)
    oracle = _mk_store(e)
    s = _mk_store(e, plane=True)
    with s.read_view() as v:
        A.pagerank_view(v)
    S0 = s.n_subgraphs
    for store in (oracle, s):
        vids = [store.insert_vertex() for _ in range(P + 1)]
        u = vids[-1]
        store.insert_edges(np.array([[u, 0], [0, u]], np.int64))
    assert s.n_subgraphs > S0
    with oracle.read_view() as vo, s.read_view() as vp:
        assert same(A.pagerank_view(vp), A.pagerank_view(vo))
    assert len(s.shard_plane.placement_for(s.n_subgraphs)) == s.n_subgraphs


def test_plane_env_disable_and_detach(monkeypatch):
    e = _edges(m=300)
    s = _mk_store(e, plane=True)
    plane = s.shard_plane
    monkeypatch.setenv("REPRO_DISABLE_SHARD_PLANE", "1")
    with s.read_view() as v:
        assert shard_plane.active_plane(v) is None
        A.pagerank_view(v)  # single-device path
        spmm_view(v, torch.ones(N, 4))
    assert plane.stats.collective_calls == 0
    monkeypatch.delenv("REPRO_DISABLE_SHARD_PLANE")
    with s.read_view() as v:
        A.pagerank_view(v)
    assert plane.stats.collective_calls == 1
    s.detach_shard_plane()
    assert s.shard_plane is None
    with s.read_view() as v:
        assert shard_plane.active_plane(v) is None
        A.pagerank_view(v)
    assert plane.stats.collective_calls == 1


def test_plane_memory_accounted():
    e = _edges()
    s = _mk_store(e, plane=True)
    base = s.memory_bytes()
    with s.read_view() as v:
        A.pagerank_view(v)
        grown = s.memory_bytes()
        assert v.assembly.sharded.device_bytes() > 0
    # the retired bundle keeps the shard tensors accounted after end_read
    assert s.memory_bytes() >= base + v.assembly.sharded.coo.nbytes()
    assert grown > base


def test_plane_gc_releases_shard_tiles():
    """Writer-driven GC drops per-shard tiles with the snapshot."""
    e = _edges(m=300)
    s = _mk_store(e, plane=True)
    with s.read_view() as v:
        A.pagerank_view(v)
        snap0 = v.snaps[0]
        assert snap0._shard_dev_cache  # resident
    s.insert_edges(np.array([[1, 90], [2, 91]], np.int64))
    s.insert_edges(np.array([[1, 92], [2, 93]], np.int64))
    assert snap0._released and snap0._shard_dev_cache is None


def test_sharded_parity_and_one_shard_isolation_4shards():
    """Four shards on one device: a write dirtying subgraphs resident on
    shard 1 only uploads to shard 1 (``len(dirty_sids)`` uploads), shards
    0, 2 and 3 upload nothing and keep the predecessor's bundles by object
    identity, and the answers stay bitwise-equal."""
    rng = np.random.default_rng(0)
    e = rng.integers(0, N, size=(900, 2), dtype=np.int64)
    e = e[e[:, 0] != e[:, 1]]
    oracle = _mk_store(e)
    s = _mk_store(e, plane=True, n_devices=4)
    plane = s.shard_plane
    h = torch.from_numpy(rng.normal(size=(N, 12)).astype(np.float32))
    ho, hp = oracle.begin_read(), s.begin_read()
    vo, vp = ho.view, hp.view
    w = (rng.random(vo.n_edges) + 0.1).astype(np.float32)
    got, want = _five(vp, w, h), _five(vo, w, h)
    for name in want:
        assert same(got[name], want[name]), name
    oracle.end_read(ho)
    s.end_read(hp)

    # modulo placement: shard 1 owns sids {1, 5, 9}
    placement = plane.placement_for(s.n_subgraphs)
    batch = np.array([[9, 44], [44, 9], [10, 75], [75, 10]], np.int64)
    dirty_sids = {int(u) // P for u in batch[:, 0]}
    assert {int(placement[sid]) for sid in dirty_sids} == {1}
    for store in (oracle, s):
        store.insert_edges(batch)
    u0 = list(plane.stats.uploads)
    ho, hp2 = oracle.begin_read(), s.begin_read()
    assert same(A.pagerank_view(hp2.view), A.pagerank_view(ho.view))
    delta = [a - b for a, b in zip(plane.stats.uploads, u0)]
    assert delta == [0, len(dirty_sids), 0, 0], delta
    pred, succ = vp.assembly.sharded.coo, hp2.view.assembly.sharded.coo
    for k in (0, 2, 3):
        assert succ.shards[k] is pred.shards[k], k
    assert succ.shards[1] is not pred.shards[1]
    assert plane.stats.splices == 1
    oracle.end_read(ho)
    s.end_read(hp2)
    # a write that keeps every dirty segment's size patches a clone of the
    # predecessor's shard-1 columns: the older view still answers as before
    before = {k: (s_.cols, s_.valid) for k, s_ in enumerate(succ.shards)}
    pr_before = A.pagerank_view(hp2.view).clone()
    swap = (np.array([[9, 45], [45, 9]], np.int64), np.array([[9, 44], [44, 9]], np.int64))
    for store in (oracle, s):
        store.apply(*swap)
    ho, hp3 = oracle.begin_read(), s.begin_read()
    assert same(A.pagerank_view(hp3.view), A.pagerank_view(ho.view))
    succ3 = hp3.view.assembly.sharded.coo
    assert succ3.shards[1].valid is before[1][1]  # same layout: clone + patch
    assert all(a is not b for a, b in zip(succ3.shards[1].cols, before[1][0]))
    assert same(A.pagerank_view(hp2.view), pr_before)
    oracle.end_read(ho)
    s.end_read(hp3)


def test_sharded_degree_balanced_and_spmm_splice_4shards():
    rng = np.random.default_rng(5)
    hub = np.stack([np.zeros(60, np.int64), rng.integers(1, N, 60)], 1)
    e = np.concatenate([hub, rng.integers(0, N, size=(300, 2), dtype=np.int64)])
    e = e[e[:, 0] != e[:, 1]]
    oracle = _mk_store(e)
    s = _mk_store(e, plane=True, n_devices=4, policy="degree_balanced")
    plane = s.shard_plane
    placement = plane.placement_for(s.n_subgraphs)
    assert len(np.unique(placement)) == 4
    h = torch.from_numpy(rng.normal(size=(N, 12)).astype(np.float32))
    with oracle.read_view() as vo, s.read_view() as vp:
        assert same(A.pagerank_view(vp), A.pagerank_view(vo))
        assert same(spmm_view(vp, h), spmm_view(vo, h))

    # leaf-tile splice after a write: SpMM stays bitwise-equal and only the
    # written subgraph's shard uploads
    batch = np.array([[17, 20], [20, 17]], np.int64)
    sidk = int(placement[17 // P])
    for store in (oracle, s):
        store.insert_edges(batch)
    u0 = list(plane.stats.uploads)
    with oracle.read_view() as vo, s.read_view() as vp:
        assert same(spmm_view(vp, h), spmm_view(vo, h))
    delta = [a - b for a, b in zip(plane.stats.uploads, u0)]
    for k in range(4):
        if k != sidk:
            assert delta[k] == 0, (k, delta)
    assert delta[sidk] >= 1

    # a re-attach with ANOTHER shard count must not splice the retired
    # 4-shard bundle (full rebuild instead)
    plane2 = s.attach_shard_plane(n_devices=2, policy="degree_balanced", symmetric=True)
    with oracle.read_view() as vo, s.read_view() as vp:
        assert same(A.pagerank_view(vp), A.pagerank_view(vo))
    assert plane2.stats.full_builds >= 1 and plane2.stats.splices == 0

    # appended subgraphs spread across shards (loads charged per append)
    base_S = s.n_subgraphs
    for _ in range(4 * P):
        s.insert_vertex()
    pl2 = plane2.placement_for(s.n_subgraphs)
    assert s.n_subgraphs - base_S >= 4
    assert len({int(x) for x in pl2[base_S:]}) > 1, pl2[base_S:]


# ---------------------------------------------------------------------------
# The padding contract of core.distributed (test_dist_small.py's test)
# ---------------------------------------------------------------------------
def test_shard_padding_masked():
    """Pad slots are self-loops on vertex 0; an unmasked reduction would
    count them into vertex 0's degree/rank.  13 edges over 8 shards leave 3
    pad slots, and vertex 0 carries real edges so the corruption shows."""
    n = 32
    src = np.array([0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10], np.int64)
    dst = np.array([1, 2, 3, 0, 0, 4, 5, 6, 7, 8, 9, 10, 0], np.int32)
    s_sh, d_sh, valid = shard_edges(src, dst, 8)
    assert valid.sum() == len(src) and (~valid).sum() == 3
    assert np.all(s_sh[~valid] == 0) and np.all(d_sh[~valid] == 0)
    shards = [torch.from_numpy(np.ascontiguousarray(a)) for a in s_sh]
    dshards = [torch.from_numpy(np.ascontiguousarray(a)) for a in d_sh]
    vshards = [torch.from_numpy(np.ascontiguousarray(a)) for a in valid]
    s_t, d_t = torch.from_numpy(src), torch.from_numpy(dst)
    pr_d = make_pagerank(n)(shards, dshards, vshards)
    pr_s = A.pagerank_coo(s_t, d_t, n)
    torch.testing.assert_close(pr_d, pr_s, rtol=1e-6, atol=1e-9)
    # the test has teeth: an all-true mask miscounts vertex 0
    ones = [torch.ones_like(v) for v in vshards]
    pr_bad = make_pagerank(n)(shards, dshards, ones)
    assert float((pr_bad - pr_s).abs().max()) > 1e-4
    lv_d = make_bfs(n)(shards, dshards, vshards, 3)
    assert torch.equal(lv_d, A.bfs_coo(s_t, d_t, n, 3))


def test_out_of_range_pad_ids_never_fault():
    """The plane's pad slots hold SENTINEL ids (out of range for every
    vertex count): with ``valid`` false they are neither gathered nor
    scattered, on either side."""
    n = 8
    sentinel = 2**31 - 1
    src = torch.tensor([0, 1, 2, sentinel, sentinel], dtype=torch.int32)
    dst = torch.tensor([1, 2, 0, sentinel, sentinel], dtype=torch.int32)
    valid = torch.tensor([True, True, True, False, False])
    got = make_pagerank(n)([src], [dst], [valid])
    want = A.pagerank_coo(src[:3], dst[:3], n)
    assert same(got, want)


# ---------------------------------------------------------------------------
# Detach retracts telemetry + residency (test_obs.py's test)
# ---------------------------------------------------------------------------
def test_detach_shard_plane_unregisters_metrics_and_frees_memory():
    store = RapidStore(96, partition_size=16, B=8, high_threshold=4, device="cpu")
    rng = np.random.default_rng(3)
    e = rng.integers(0, 96, (200, 2), dtype=np.int64)
    store.insert_edges(e[e[:, 0] != e[:, 1]])

    def assemble():
        plane = store.shard_plane
        with store.read_view() as v:
            plane.sharded_coo(v)
            plane.sharded_blocks(v)

    store.attach_shard_plane()
    assemble()
    store.detach_shard_plane()

    pre_mem = store.memory_bytes()
    pre_metrics = [(m.name, m.labels) for m in store.registry.collect()]
    assert not any(n.startswith("shard_plane_") for n, _ in pre_metrics)

    store.attach_shard_plane()
    assemble()
    mid_names = {m.name for m in store.registry.collect()}
    assert any(n.startswith("shard_plane_") for n in mid_names)
    assert store.memory_bytes() > pre_mem

    store.detach_shard_plane()
    assert [(m.name, m.labels) for m in store.registry.collect()] == pre_metrics
    assert store.memory_bytes() == pre_mem


# ---------------------------------------------------------------------------
# Four shards on one card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
class TestShardPlaneOnCard:
    @pytest.mark.parametrize("symmetric", [True, False])
    def test_four_shards_match_single_route(self, symmetric):
        e = _edges(m=2000)
        store = RapidStore.from_edges(N, e, undirected=symmetric, partition_size=P,
                                      B=16, high_threshold=8, device="cuda")
        rng = np.random.default_rng(4)
        h = torch.from_numpy(rng.normal(size=(N, 16)).astype(np.float32)).cuda()
        with store.read_view() as v:
            w = torch.from_numpy((rng.random(v.n_edges) + 0.1).astype(np.float32)).cuda()
            want = _five(v, w, h)
        plane = store.attach_shard_plane(n_devices=4, symmetric=symmetric)
        assert plane.devices == [torch.device("cuda", k % torch.cuda.device_count())
                                 for k in range(4)]
        with store.read_view() as v:
            n0 = leaf_spmm.launches
            got = _five(v, w, h)
            torch.cuda.synchronize()
            assert leaf_spmm.launches - n0 >= 4
        for name in ("bfs", "sssp", "wcc"):
            assert torch.equal(got[name], want[name]), name
        torch.testing.assert_close(got["pagerank"], want["pagerank"], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["spmm"], want["spmm"], rtol=1e-4, atol=1e-4)
        store.detach_shard_plane()

    def test_cuda_store_refuses_cpu_shards(self):
        store = RapidStore.from_edges(N, _edges(m=300), partition_size=P, B=16,
                                      device="cuda")
        with pytest.raises(ValueError):
            store.attach_shard_plane(devices=["cuda", "cpu"])
