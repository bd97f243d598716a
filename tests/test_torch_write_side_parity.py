"""The port's write side against the JAX reference, CPU only.

- One seeded operation sequence through both packages: synchronous writes
  through an attached write pipeline (a group of one each, so the layout
  is deterministic), deletes, ``insert_vertex``/``delete_vertex``, a
  compactor fold, then more writes.  Before and after the fold the leaf
  streams must be bitwise identical and the 11 entry points of
  ``test_torch_parity.ENTRIES`` equal within its tolerances; the
  ``CompactionReport`` fields must agree.  The tiered store takes
  ``high_threshold=4`` rather than the parity file's 8: with tiers (8, 16)
  a C-ART vertex (degree above the threshold) can only sit in the 8-wide
  tier when the threshold is below 8, and the sequence grows one across
  the tier boundary so that the fold migrates it.
- Recovery across packages, both ways: one package writes a durability
  directory (WAL + checkpoint) with an async pipeline of 4 writer threads,
  a checkpointing fold and more writes; both packages recover from it.
  The group commits depend on thread timing, but replay runs at the
  original timestamps, so the two recoveries agree bitwise.
- The WAL's bytes and the checkpoint files are the same in both packages.
"""

import os
import threading

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from _parity import make_entry_ctx, rand_edges
from _torch_entries import assert_answers_match, port_answers
from test_torch_parity import ENTRIES, N

import repro.core as rc
import repro.core.wal as rwal
from repro.checkpoint import manager as rckpt

import repro_torch.core as tc
import repro_torch.core.wal as twal
from repro_torch.checkpoint import manager as tckpt

STORES = {
    "single": dict(partition_size=16, B=16, high_threshold=8),
    "tiered": dict(partition_size=16, B=16, high_threshold=4, leaf_tiers=(8, 16)),
}
EMPTY = np.empty((0, 2), np.int64)
JOIN_S = 60  # every writer thread's join limit


def _port(**kw):
    return dict(kw, device="cpu")


def _stream(view):
    s = view.to_leaf_stream()
    return (s.data, s.leaf_offsets, s.leaf_lens, s.leaf_keys, s.leaf_tiers)


def _assert_streams_equal(rv, tv):
    for w, g in zip(_stream(rv), _stream(tv)):
        if w is None or g is None:
            assert w is None and g is None
            continue
        assert w.dtype == g.dtype and np.array_equal(w, g)


def _answers(rv, tv, seed):
    """(reference answers, port answers) of the 11 entry points."""
    ctx = make_entry_ctx(rv, seed=seed)
    want = {name: np.asarray(r_call(rv, ctx)) for name, (r_call, _, _) in ENTRIES.items()}
    return want, port_answers(tv, ctx)


# ---------------------------------------------------------------------------
# One operation sequence, both packages
# ---------------------------------------------------------------------------
def _plan(store, tiered):
    """The sequence's vertices, read off the reference store's layout: a
    vertex ``g`` to grow (a C-ART vertex in the 8-wide tier on the tiered
    store), a hub ``h`` in g's subgraph to churn (stranded half-empty
    leaves, so the fold repacks that subgraph), and a vertex ``d`` to
    delete."""
    p = store.p
    if tiered:
        g = next(sid * p + lu for sid, chain in enumerate(store.chains)
                 for lu, dr in sorted(chain.head.dirs.items()) if dr.tier == 8)
    else:
        g = 20
    sid = g // p
    h = sid * p + (g - sid * p + 1) % p
    return g, h, (sid + 2) * p + 3


def _run_sequence(store, g, h, d, out):
    """Phase 1 of the sequence (before the fold), through the pipeline."""
    rng = np.random.default_rng(11)
    store.attach_write_pipeline(n_shards=2)
    with store.read_view() as v:
        src, dst = v.to_coo_uncached()
    pick = rng.choice(len(src), 12, replace=False)
    dels = np.stack([src[pick], dst[pick].astype(np.int64)], 1)
    ins = rng.integers(0, N, (24, 2))
    ins = ins[ins[:, 0] != ins[:, 1]]
    store.apply(ins[:12], dels[:6])
    store.insert_edges(ins[12:])
    store.delete_edges(dels[6:])
    with store.read_view() as v:
        nbrs = set(v.scan(g).tolist())
    grow = [w for w in range(N) if w != g and w not in nbrs][:8]
    store.insert_edges(np.array([[g, w] for w in grow], np.int64))
    full = np.array([[h, w] for w in range(N) if w != h], np.int64)
    store.insert_edges(full)
    store.delete_edges(full[::2])
    out["vid"] = store.insert_vertex()
    store.insert_edges(np.array([[out["vid"], 3], [out["vid"], 5], [7, out["vid"]]]))
    store.delete_vertex(d)


def _run_more(store, d):
    """Phase 2, after the fold: more writes, and the freed id comes back."""
    rng = np.random.default_rng(12)
    ins = rng.integers(0, N, (16, 2))
    ins = ins[ins[:, 0] != ins[:, 1]]
    store.insert_edges(ins)
    assert store.insert_vertex() == d
    store.insert_edges(np.array([[d, 1], [d, 2]], np.int64))
    store.detach_write_pipeline()


@pytest.fixture(scope="module", params=list(STORES))
def sequence(request):
    kw = STORES[request.param]
    tiered = "leaf_tiers" in kw
    edges = rand_edges(N, 900, 1)
    r_store = rc.RapidStore.from_edges(N, edges, **kw)
    t_store = tc.RapidStore.from_edges(N, edges, **_port(**kw))
    g, h, d = _plan(r_store, tiered)
    outs = ({}, {})
    for store, out in zip((r_store, t_store), outs):
        _run_sequence(store, g, h, d, out)
    res = {"vid": (outs[0]["vid"], outs[1]["vid"])}
    with r_store.read_view() as rv, t_store.read_view() as tv:
        _assert_streams_equal(rv, tv)
        res["before"] = _answers(rv, tv, seed=3)
    reports = [s.attach_compactor(min_waste_rows=1).compact_once()
               for s in (r_store, t_store)]
    res["reports"] = reports
    res["migrations"] = [s.stats.get("tier_migrations", 0) for s in (r_store, t_store)]
    with r_store.read_view() as rv, t_store.read_view() as tv:
        _assert_streams_equal(rv, tv)
    for store in (r_store, t_store):
        _run_more(store, d)
    with r_store.read_view() as rv, t_store.read_view() as tv:
        _assert_streams_equal(rv, tv)
        res["after"] = _answers(rv, tv, seed=4)
    return request.param, res


def test_sequence_vertex_lifecycle_agrees(sequence):
    _, res = sequence
    assert res["vid"][0] == res["vid"][1] == N


def test_sequence_compaction_reports_agree(sequence):
    config, res = sequence
    want, got = res["reports"]
    assert want.repacked, "the churned hub should make the fold repack"
    for field in ("repacked", "versions_reclaimed", "rows_freed", "tier_migrations",
                  "horizon", "base_ts", "lineage_trimmed"):
        assert getattr(got, field) == getattr(want, field), field
    assert res["migrations"][0] == res["migrations"][1]
    if config == "tiered":
        assert res["migrations"][1] > 0, "the grown vertex should change tier"


@pytest.mark.parametrize("phase", ["before", "after"])
def test_sequence_entry_points_agree(sequence, phase):
    assert_answers_match(*sequence[1][phase])


# ---------------------------------------------------------------------------
# Recovery across packages
# ---------------------------------------------------------------------------
def _writers(store, batches, n_threads=4):
    """``batches`` split over ``n_threads`` threads, each submitting its
    share with ``apply_async`` and waiting for every ticket."""
    errors = []

    def work(k):
        try:
            tickets = [store.apply_async(ins, dels) for ins, dels in batches[k::n_threads]]
            for t in tickets:
                t.wait()
        except BaseException as exc:  # re-raised on the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "a writer thread hung"
    if errors:
        raise errors[0]


def _batches(seed, n_txn):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_txn):
        e = rng.integers(0, N, (6, 2))
        e = e[e[:, 0] != e[:, 1]]
        out.append((e[:4], e[4:]))
    return out


def _churn(store, hub):
    full = np.array([[hub, w] for w in range(N) if w != hub], np.int64)
    store.insert_edges(full)
    store.delete_edges(full[::2])


def write_durability_dir(pkg, root, kw):
    """A durability directory written by ``pkg``'s store: WAL, an async
    pipeline of 4 writers, a checkpointing fold, more writes, a fold whose
    repack record lands in the WAL after the checkpoint, a vertex insert
    and delete.  Returns the live store's edge set."""
    store = pkg.RapidStore.from_edges(N, rand_edges(N, 600, 2), **kw)
    store.attach_wal(os.path.join(root, "wal.log"))
    comp = store.attach_compactor(min_waste_rows=1,
                                  checkpoint_dir=os.path.join(root, "checkpoints"))
    store.attach_write_pipeline(n_shards=4, max_batch=8)
    _writers(store, _batches(21, 40))
    _churn(store, 5)
    store.flush()
    report = comp.compact_once(checkpoint=True)
    assert report.checkpoint_ts is not None
    _writers(store, _batches(22, 20))
    _churn(store, 40)
    assert comp.compact_once().repacked
    vid = store.insert_vertex()
    store.insert_edges(np.array([[vid, 1], [2, vid]], np.int64))
    store.delete_vertex(9)
    store.flush()
    with store.read_view() as v:
        want = v.edge_set()
    store.detach_write_pipeline()
    store.detach_wal()
    return want


@pytest.fixture(scope="module", params=["repro_writes", "port_writes"])
def recovered(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(request.param))
    kw = STORES["tiered"]
    if request.param == "repro_writes":
        want = write_durability_dir(rc, root, kw)
    else:
        want = write_durability_dir(tc, root, _port(**kw))
    _, records, _ = rwal.WriteAheadLog.replay(os.path.join(root, "wal.log"))
    assert any(r.kind == rwal.KIND_REPACK for r in records)
    r_store = rc.RapidStore.recover(root, attach=False)
    t_store = tc.RapidStore.recover(root, attach=False, device="cpu")
    return want, r_store, t_store


def test_recovery_across_packages_bitwise(recovered):
    want, r_store, t_store = recovered
    assert r_store.stats["wal_replayed"] == t_store.stats["wal_replayed"] > 0
    assert r_store.clock.read_timestamp() == t_store.clock.read_timestamp()
    assert r_store._free_vids == t_store._free_vids
    with r_store.read_view() as rv, t_store.read_view() as tv:
        assert rv.edge_set() == tv.edge_set() == want
        _assert_streams_equal(rv, tv)
        assert_answers_match(*_answers(rv, tv, seed=5))


# ---------------------------------------------------------------------------
# File formats
# ---------------------------------------------------------------------------
def _wal_appends(wal):
    wal.append_commit(4, np.array([[0, 1], [2, 3]], np.int64), EMPTY, {7: True}, 96)
    wal.append_repack(5, [0, 2], 96)
    wal.append_migrate(6, {0: 1, 5: 2}, 96)
    wal.append_commit(7, EMPTY, np.array([[0, 1]], np.int64), {3: False, 9: True}, 97)
    wal.sync()
    wal.close()


def test_wal_bytes_identical_across_packages(tmp_path):
    paths = {}
    for name, mod in (("repro", rwal), ("port", twal)):
        paths[name] = tmp_path / f"{name}.log"
        _wal_appends(mod.WriteAheadLog(paths[name], start_ts=3))
    assert paths["repro"].read_bytes() == paths["port"].read_bytes()
    ins, dels = np.array([[1, 2]], np.int64), np.array([[3, 4]], np.int64)
    assert rwal._encode_commit(8, ins, dels, {1: True}, 12) == \
        twal._encode_commit(8, ins, dels, {1: True}, 12)
    assert rwal._encode_repack(9, [3], 12) == twal._encode_repack(9, [3], 12)
    assert rwal._encode_migrate(10, {1: 0}, 12) == twal._encode_migrate(10, {1: 0}, 12)
    # each package replays the other's log to the same records
    for path in paths.values():
        (rs, rrecs, rclean), (ts, trecs, tclean) = (
            rwal.WriteAheadLog.replay(path), twal.WriteAheadLog.replay(path))
        assert (rs, rclean) == (ts, tclean) == (3, True)
        for a, b in zip(rrecs, trecs, strict=True):
            assert (a.kind, a.ts, a.n_vertices, a.sids, a.vset, a.moves) == \
                (b.kind, b.ts, b.n_vertices, b.sids, b.vset, b.moves)
            assert np.array_equal(a.ins, b.ins) and np.array_equal(a.dels, b.dels)


def _ckpt_tree(bf16):
    rng = np.random.default_rng(0)
    return {
        "z": {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "ids": np.arange(5, dtype=np.int64)},
        "layers": [rng.normal(size=2).astype(np.float32), {"b": np.array([True, False])}],
        "a": bf16,
    }


def test_checkpoint_files_cross_packages(tmp_path):
    vals = np.random.default_rng(1).normal(size=(2, 3)).astype(np.float32)
    extra = {"kind": "test", "ts": 3}
    rckpt.save(tmp_path / "repro", 3, _ckpt_tree(jnp.asarray(vals, jnp.bfloat16)), extra)
    tckpt.save(tmp_path / "port", 3, _ckpt_tree(torch.from_numpy(vals).bfloat16()), extra)
    keys = ["a", "layers/0", "layers/1/b", "z/ids", "z/w"]
    for writer in ("repro", "port"):
        d = tmp_path / writer
        (r_arr, r_meta), (t_arr, t_meta) = rckpt.restore_raw(d), tckpt.restore_raw(d)
        assert r_meta == t_meta and r_meta["extra"] == extra
        assert list(r_arr) == list(t_arr) == keys == r_meta["keys"]
        for k in keys:
            assert r_arr[k].dtype == t_arr[k].dtype and r_arr[k].shape == t_arr[k].shape
            assert np.array_equal(r_arr[k], t_arr[k]), k
        assert t_arr["a"].dtype == np.float32  # bf16 widened in the file
    # the same tree saves to the same bytes in both packages
    for k in keys:
        fn = k.replace("/", "__") + ".npy"
        assert (tmp_path / "repro/step_000000003/arrays" / fn).read_bytes() == \
            (tmp_path / "port/step_000000003/arrays" / fn).read_bytes(), k
    assert (tmp_path / "repro/step_000000003/meta.json").read_bytes() == \
        (tmp_path / "port/step_000000003/meta.json").read_bytes()
