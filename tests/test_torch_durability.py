"""The port's WAL, checkpoints and crash recovery, CPU only.

Mirrors ``tests/test_wal_recovery.py`` on ``repro_torch``: the framed
log's round trip, torn-tail truncation, a corrupt CRC and ``reset``;
checkpoint-bounded and WAL-only recovery against a serial oracle;
subprocess SIGKILLs during a single-shot commit (record synced and not
yet published, record buffered only) and during a group commit, each
recovered to a consistent store.  The crash children import only
``repro_torch`` and run with ``device="cpu"``.  Also the port's
checkpoint manager: the reference's key order, bf16 tensors widened to
f32 and cast back by ``restore``.
"""

import os

import numpy as np
import pytest
import torch

from _parity import assert_view_matches_oracles
from _subproc import run_sub_killable

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import RapidStore
from repro_torch.core.wal import _HEADER, KIND_COMMIT, KIND_REPACK, WriteAheadLog

CPU = dict(device="cpu")
EMPTY = np.empty((0, 2), np.int64)
CHILD_S = 120  # every crash child's time limit


def rand_ops(n, rounds, seed=7):
    """Deterministic mixed op stream shared by crash children and oracles."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(rounds):
        e = rng.integers(0, n, (6, 2), dtype=np.int64)
        ops.append(("-", e[:2]) if i % 3 == 2 else ("+", e))
    return ops


def apply_ops(store, ops):
    for kind, e in ops:
        if kind == "+":
            store.insert_edges(e)
        else:
            store.delete_edges(e)


def assert_same_layout(v, ov):
    assert v.edge_set() == ov.edge_set()
    for a, b in zip(v.to_coo(), ov.to_coo()):
        assert np.array_equal(a, b)
    lb, olb = v.to_leaf_blocks(), ov.to_leaf_blocks()
    assert np.array_equal(lb.src, olb.src)
    assert np.array_equal(lb.rows, olb.rows)
    assert np.array_equal(lb.length, olb.length)


# ---------------------------------------------------------------------------
# WAL file format
# ---------------------------------------------------------------------------
def test_wal_roundtrip(tmp_path):
    path = tmp_path / "wal.log"
    wal = WriteAheadLog(path, start_ts=3)
    wal.append_commit(4, np.array([[0, 1], [2, 3]], np.int64), EMPTY, {7: True}, 96)
    wal.append_repack(5, [0, 2], 96)
    wal.append_commit(6, EMPTY, np.array([[0, 1]], np.int64), None, 96)
    wal.sync()
    assert wal.backlog_bytes() == 0
    wal.close()

    start_ts, records, clean = WriteAheadLog.replay(path)
    assert (start_ts, clean) == (3, True)
    assert [r.ts for r in records] == [4, 5, 6]
    assert np.array_equal(records[0].ins, [[0, 1], [2, 3]])
    assert records[0].vset == {7: True}
    assert records[1].kind == KIND_REPACK and records[1].sids == [0, 2]
    assert np.array_equal(records[2].dels, [[0, 1]])


def test_wal_torn_tail_truncated_on_reopen(tmp_path):
    path = tmp_path / "wal.log"
    wal = WriteAheadLog(path, start_ts=0)
    for ts in (1, 2, 3):
        wal.append_commit(ts, np.array([[ts, ts + 1]], np.int64), EMPTY, None, 96)
    wal.sync()
    wal.close()

    size = os.path.getsize(path)
    frame = (size - _HEADER.size) // 3
    with open(path, "r+b") as f:  # tear mid-way through the last frame
        f.truncate(size - frame // 2)
    _, records, clean = WriteAheadLog.replay(path)
    assert not clean
    assert [r.ts for r in records] == [1, 2]

    # reopen physically truncates the torn bytes; appends resume cleanly
    wal = WriteAheadLog(path)
    wal.append_commit(9, np.array([[5, 6]], np.int64), EMPTY, None, 96)
    wal.sync()
    wal.close()
    _, records, clean = WriteAheadLog.replay(path)
    assert clean and [r.ts for r in records] == [1, 2, 9]


def test_wal_corrupt_crc_stops_scan(tmp_path):
    path = tmp_path / "wal.log"
    wal = WriteAheadLog(path, start_ts=0)
    for ts in (1, 2):
        wal.append_commit(ts, np.array([[ts, 0]], np.int64), EMPTY, None, 8)
    wal.sync()
    wal.close()
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size - 3)
        f.write(b"\xff")  # flip payload bytes of record 2
    _, records, clean = WriteAheadLog.replay(path)
    assert not clean and [r.ts for r in records] == [1]


def test_wal_reset_keeps_suffix(tmp_path):
    path = tmp_path / "wal.log"
    wal = WriteAheadLog(path, start_ts=0)
    for ts in (1, 2, 3, 4):
        wal.append_commit(ts, np.array([[ts, 0]], np.int64), EMPTY, None, 8)
    wal.sync()
    wal.reset(2)  # checkpoint at ts=2: 1, 2 covered; 3, 4 must survive
    wal.append_commit(5, np.array([[5, 0]], np.int64), EMPTY, None, 8)
    wal.sync()
    wal.close()
    start_ts, records, clean = WriteAheadLog.replay(path)
    assert (start_ts, clean) == (2, True)
    assert [r.ts for r in records] == [3, 4, 5]


# ---------------------------------------------------------------------------
# Checkpoint + replay (in-process)
# ---------------------------------------------------------------------------
def test_recover_wal_only_matches_serial_oracle(tmp_path):
    store = RapidStore(96, partition_size=16, B=8, high_threshold=4, **CPU)
    store.attach_wal(tmp_path / "wal.log")
    ops = rand_ops(96, 30)
    apply_ops(store, ops)
    store.detach_wal()

    rec = RapidStore.recover(tmp_path, n_vertices=96, partition_size=16, B=8,
                             high_threshold=4, **CPU)
    oracle = RapidStore(96, partition_size=16, B=8, high_threshold=4, **CPU)
    apply_ops(oracle, ops)
    assert rec.device == torch.device("cpu")
    with rec.read_view() as v, oracle.read_view() as ov:
        assert_same_layout(v, ov)
        assert_view_matches_oracles(v)
    assert rec.clock.read_timestamp() == store.clock.read_timestamp()
    # the recovered store keeps serving durable writes (WAL re-attached)
    rec.insert_edges(np.array([[0, 1]], np.int64))
    rec.detach_wal()
    _, records, _ = WriteAheadLog.replay(tmp_path / "wal.log")
    assert records[-1].ts == rec.clock.read_timestamp()


@pytest.mark.parametrize("tiers", [(8,), (8, 64)])
def test_recover_from_checkpoint_bounds_replay(tmp_path, tiers):
    store = RapidStore(96, partition_size=16, high_threshold=4, leaf_tiers=tiers, **CPU)
    store.attach_wal(tmp_path / "wal.log")
    ops = rand_ops(96, 24, seed=11)
    apply_ops(store, ops[:16])
    ckpt_ts = store.checkpoint(tmp_path / "checkpoints")
    store.wal.reset(ckpt_ts)
    apply_ops(store, ops[16:])
    with store.read_view() as v:
        want = v.edge_set()
    store.detach_wal()

    rec = RapidStore.recover(tmp_path, attach=False, **CPU)
    # config restored from the checkpoint, replay bounded to the suffix
    assert (rec.p, rec.B, rec.high_threshold) == (16, tiers[-1], 4)
    assert (rec.leaf_tiers or (rec.B,)) == tiers
    assert 0 < rec.stats["wal_replayed"] <= len(ops) - 16
    with rec.read_view() as v:
        assert v.edge_set() == want
        assert_view_matches_oracles(v)


def test_recover_vertex_lifecycle(tmp_path):
    store = RapidStore(32, partition_size=16, B=8, **CPU)
    store.attach_wal(tmp_path / "wal.log")
    vid = store.insert_vertex()
    assert vid == 32  # grows the id space into a fresh subgraph
    store.insert_edges(np.array([[vid, 3], [5, 6]], np.int64))
    store.delete_vertex(5)
    store.detach_wal()

    rec = RapidStore.recover(tmp_path, n_vertices=32, partition_size=16, B=8, **CPU)
    assert rec.n_vertices == 33
    assert rec._free_vids == [5]
    assert not rec.chains[0].head.active[5]
    with rec.read_view() as v:
        assert v.search(vid, 3) and not v.search(5, 6)
    assert rec.insert_vertex() == 5  # the recycled id comes back
    rec.detach_wal()


def test_recover_is_deterministic_with_tier_migrations(tmp_path):
    """Repack records on a tiered store replay the tier migrations too."""
    store = RapidStore(96, partition_size=16, high_threshold=4, leaf_tiers=(8, 64), **CPU)
    store.attach_wal(tmp_path / "wal.log")
    for hub in (0, 17, 33):
        nbrs = np.array([[hub, j] for j in range(96) if j != hub], np.int64)
        store.insert_edges(nbrs[:6])    # promote into tier 8
        store.insert_edges(nbrs[6:])    # drift far past the boundary
        store.delete_edges(nbrs[1::2])
    report = store.attach_compactor(min_waste_rows=0).compact_once()
    assert report.repacked and store.stats.get("tier_migrations", 0) > 0
    apply_ops(store, rand_ops(96, 6, seed=4))
    want_tiers = {sid: {int(lu): d.tier for lu, d in store.chains[sid].head.dirs.items()}
                  for sid in range(store.n_subgraphs)}
    store.detach_wal()

    kw = dict(n_vertices=96, partition_size=16, high_threshold=4, leaf_tiers=(8, 64),
              attach=False, **CPU)
    rec1 = RapidStore.recover(tmp_path, **kw)
    rec2 = RapidStore.recover(tmp_path, **kw)
    for sid, tiers in want_tiers.items():
        assert {int(lu): d.tier for lu, d in rec1.chains[sid].head.dirs.items()} == tiers
    with rec1.read_view() as v1, rec2.read_view() as v2, store.read_view() as lv:
        assert_same_layout(v1, v2)
        assert_same_layout(v1, lv)
        assert_view_matches_oracles(v1)


def test_replay_of_a_migrate_record_keeps_the_placement(tmp_path):
    """A sharded store logs placement flips; the port has no shard plane
    yet but replays them into its placement log and lineage."""
    wal = WriteAheadLog(tmp_path / "wal.log", start_ts=0)
    wal.append_commit(1, np.array([[0, 1], [20, 3]], np.int64), EMPTY, None, 64)
    wal.append_migrate(2, {0: 1, 3: 2}, 64)
    wal.append_commit(3, np.array([[40, 2]], np.int64), EMPTY, None, 64)
    wal.sync()
    wal.close()
    rec = RapidStore.recover(tmp_path, n_vertices=64, partition_size=16, B=8,
                             attach=False, **CPU)
    assert rec.shard_plane is None and rec.rebalancer is None
    assert rec._placement_log == [(2, {0: 1, 3: 2})]
    assert rec.lineage.placement_epochs_between(0, 3) == [(2, {0: 1, 3: 2})]
    assert rec.stats["wal_replayed"] == 3 and rec.clock.read_timestamp() == 3
    with rec.read_view() as v:
        assert v.edge_set() == {(0, 1), (20, 3), (40, 2)}


# ---------------------------------------------------------------------------
# SIGKILL crash tests (subprocess, injected kill points)
# ---------------------------------------------------------------------------
_CRASH_CHILD = """
import os, signal
import numpy as np
from repro_torch.core import RapidStore

store = RapidStore(96, partition_size=16, B=8, high_threshold=4, device="cpu")
store.attach_wal(os.path.join({root!r}, "wal.log"))

count = [0]
def die():
    count[0] += 1
    if count[0] >= {kill_at}:
        os.kill(os.getpid(), signal.SIGKILL)
store.wal.{hook} = die

rng = np.random.default_rng(7)
for i in range(200):
    e = rng.integers(0, 96, (6, 2), dtype=np.int64)
    if i % 3 == 2:
        store.delete_edges(e[:2])
    else:
        store.insert_edges(e)
raise SystemExit("child outlived its kill point")
"""


@pytest.mark.parametrize("hook,kill_at", [
    ("hook_after_sync", 9),    # record durable, publish never happened
    ("hook_before_sync", 9),   # record buffered only: lost, not replayed
])
def test_sigkill_single_shot_recovers_to_serial_oracle(tmp_path, hook, kill_at):
    root = str(tmp_path)
    res = run_sub_killable(_CRASH_CHILD.format(root=root, kill_at=kill_at, hook=hook),
                           timeout=CHILD_S)
    assert res.returncode == -9, f"child survived: {res.stdout} {res.stderr}"

    rec = RapidStore.recover(root, n_vertices=96, partition_size=16, B=8,
                             high_threshold=4, attach=False, **CPU)
    k = rec.stats["wal_replayed"]
    if hook == "hook_after_sync":
        assert k == kill_at  # every synced commit survived
    else:
        assert k < kill_at  # the unsynced tail did not

    # serial oracle: the child's op stream up to its k-th commit
    oracle = RapidStore(96, partition_size=16, B=8, high_threshold=4, **CPU)
    for kind, e in rand_ops(96, 200):
        if oracle.stats["commits"] >= k:
            break
        apply_ops(oracle, [(kind, e)])
    assert oracle.stats["commits"] == k
    with rec.read_view() as v, oracle.read_view() as ov:
        assert_same_layout(v, ov)
        assert_view_matches_oracles(v)


_CRASH_CHILD_PIPELINE = """
import os, signal
import numpy as np
from repro_torch.core import RapidStore

store = RapidStore(96, partition_size=16, B=8, high_threshold=4, device="cpu")
store.attach_wal(os.path.join({root!r}, "wal.log"))
store.attach_write_pipeline(n_shards=2, max_batch=16)

count = [0]
def die():
    count[0] += 1
    if count[0] >= {kill_at}:
        os.kill(os.getpid(), signal.SIGKILL)
store.wal.hook_before_sync = die

rng = np.random.default_rng(13)
for i in range(400):
    e = rng.integers(0, 96, (4, 2), dtype=np.int64)
    if i % 3 == 2:
        store.apply_async(np.empty((0, 2), np.int64), e[:2])
    else:
        store.apply_async(e, np.empty((0, 2), np.int64))
store.flush()
raise SystemExit("child outlived its kill point")
"""


def test_sigkill_mid_group_commit_recovers_consistently(tmp_path):
    """Kill inside a group-commit drain, before its durability barrier:
    the surviving records replay to their set-semantics edge set, every
    layout matches its uncached oracle, and recovery is deterministic."""
    root = str(tmp_path)
    res = run_sub_killable(_CRASH_CHILD_PIPELINE.format(root=root, kill_at=3),
                           timeout=CHILD_S)
    assert res.returncode == -9, f"child survived: {res.stdout} {res.stderr}"

    _, records, _ = WriteAheadLog.replay(os.path.join(root, "wal.log"))
    assert records and all(r.kind == KIND_COMMIT for r in records)
    want = set()
    for r in records:
        want |= {(int(u), int(v)) for u, v in r.ins}
        want -= {(int(u), int(v)) for u, v in r.dels}

    kw = dict(n_vertices=96, partition_size=16, B=8, high_threshold=4, attach=False, **CPU)
    rec1 = RapidStore.recover(root, **kw)
    rec2 = RapidStore.recover(root, **kw)
    assert rec1.stats["wal_replayed"] == len(records)
    with rec1.read_view() as v1, rec2.read_view() as v2:
        assert v1.edge_set() == want
        assert_same_layout(v1, v2)
        assert_view_matches_oracles(v1)


def test_recover_without_device_raises_when_cuda_absent(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    store = RapidStore(32, partition_size=16, B=8, **CPU)
    store.attach_wal(tmp_path / "wal.log")
    store.insert_edges(np.array([[1, 2]], np.int64))
    store.checkpoint(tmp_path / "checkpoints")
    store.detach_wal()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RapidStore.recover(tmp_path)
    assert RapidStore.recover(tmp_path, attach=False, **CPU).device == torch.device("cpu")


# ---------------------------------------------------------------------------
# The checkpoint manager
# ---------------------------------------------------------------------------
def test_checkpoint_keys_order_and_restore(tmp_path):
    w = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    tree = {"opt": {"mu": w.bfloat16(), "step": np.int64(7)},
            "layers": [w[0], (np.arange(3), None)], "a": np.ones(2, np.float32)}
    ckpt.save(tmp_path, 5, tree, extra={"k": 1})
    arrays, meta = ckpt.restore_raw(tmp_path)
    assert meta["keys"] == ["a", "layers/0", "layers/1/0", "opt/mu", "opt/step"]
    assert list(arrays) == meta["keys"] and meta["extra"] == {"k": 1}
    assert arrays["opt/mu"].dtype == np.float32  # bf16 widened in the file
    assert ckpt.latest_step(tmp_path) == 5

    back, _ = ckpt.restore(tmp_path, tree)
    assert back["opt"]["mu"].dtype == torch.bfloat16
    assert torch.equal(back["opt"]["mu"], tree["opt"]["mu"])
    assert torch.equal(back["layers"][0], w[0])
    assert isinstance(back["layers"][1], tuple) and back["layers"][1][1] is None
    assert np.array_equal(back["layers"][1][0], np.arange(3))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(tmp_path, dict(tree, a=np.ones(3, np.float32)))


def test_async_checkpointer_snapshots_and_prunes(tmp_path):
    saver = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    w = torch.zeros(4)
    for step in range(1, 4):
        w += 1  # the saved value is the one at save(), not at write time
        saver.save(step, {"w": w})
    saver.wait()
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_000000002", "step_000000003"]
    arrays, _ = ckpt.restore_raw(tmp_path)
    assert np.array_equal(arrays["w"], np.full(4, 3.0, np.float32))
    arrays, _ = ckpt.restore_raw(tmp_path, step=2)
    assert np.array_equal(arrays["w"], np.full(4, 2.0, np.float32))
