"""The shard plane and the collectives over processes (``torch.distributed``).

1. The flag-off cases of ``tests/test_reshard.py``: with ``REPRO_MULTIHOST``
   unset nothing joins a group and ``distributed_shard_mesh`` is
   ``make_shard_mesh``; in a child process, the flag on with no address
   comes up as a single-process group whose mesh holds every shard.
2. Four gloo ranks on the CPU, joined through a ``file://`` store in
   ``tmp_path``, each a child process with a timeout
   (``launch.plane.spawn_ranks``: a rank that exits non-zero or outlives
   the timeout fails the run).  Each rank builds the same store and runs
   ``launch.plane.drive`` over a 4-shard plane whose shard ``k`` it holds
   only if ``k % 4`` is its rank: PageRank (pull and push), BFS, SSSP, WCC
   and SpMM, 3 transactions on shard 1, the same again, then a migration
   whose every move crosses ranks (``launch.plane.cross_moves``, run by
   every rank through ``plan_moves`` and ``execute``), 3 transactions on
   the moved subgraphs, and the same a third time.  Held against the
   port's one-process plane on the same store (every answer bitwise, the
   push form within 1e-5: across ranks its overlapping partials add in
   gloo's order) and against the reference's single-device ``*_view``
   (BFS, SSSP and WCC bitwise, PageRank within 1e-5, SpMM within 1e-4, the
   limits of ``tests/test_torch_shard_parity.py``).  Each rank also runs
   ``psum``, ``pmax``, ``psum_scatter`` and ``all_gather`` on a 2 x 2 mesh
   spread over the ranks, held bitwise against the one-process mesh on
   integer-valued inputs (whose sums are exact in any order).
3. The card (``cuda`` marker): two gloo ranks sharing ``cuda:0`` and one
   nccl rank a visible card, against the one-process plane on the card in
   deterministic mode (``index_add_`` then sums in a fixed order).

The reference is imported inside its fixture, so the card tests run
without JAX.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _parity import rand_edges

from repro_torch.core import RapidStore
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.collectives import P, all_gather, pmax, psum, psum_scatter, shard
from repro_torch.launch.plane import (
    BITWISE,
    STEPS,
    drive,
    operands,
    spawn_ranks,
    summary,
)

TESTS = Path(__file__).resolve().parent
SRC = str(TESTS.parent / "src")
N, M, PS, B, HT = 96, 900, 8, 16, 8  # vertices, edges, |P|, B, high threshold
WORLD, SHARDS, TXNS, D, SEED = 4, 4, 3, 8, 5
RANK_TIMEOUT = 300  # seconds for all ranks of one run

WORKER = """
import os, sys
sys.path.insert(0, {tests!r})
import numpy as np, torch
from _parity import rand_edges
from repro_torch.core import RapidStore
from repro_torch.launch.collectives import RankGroup, P, all_gather, pmax, psum, psum_scatter, shard
from repro_torch.launch.mesh import Mesh, distributed_shard_mesh, init_distributed
from repro_torch.launch.plane import drive

init_distributed(coordinator_address={init!r}, backend="gloo")
mesh = distributed_shard_mesh({shards}, device="cpu", backend="gloo")
ranks = mesh.ranks
assert ranks.world == {world} and ranks.backend == "gloo"
store = RapidStore.from_edges({n}, rand_edges({n}, {m}, seed=1), undirected=True,
                              partition_size={ps}, B={b}, high_threshold={ht}, device="cpu")
run = drive(store, mesh, {seed}, {txns}, {d})
del run["writes"]  # numpy batches: the one-process run keeps them
with store.read_view() as v:  # after the detach: nothing of the plane is left
    assert getattr(v, "_plane", None) is None
m2 = Mesh([torch.device("cpu")] * 4, (2, 2), ("data", "model"), ranks=ranks)
x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4 * 6, 8) % 97 - 40
xs = shard(x, m2, P(("data", "model"), None))
coll = {{"local": m2.local_shards,
         "psum_model": psum(xs, m2, "model"),
         "pmax_data": pmax(xs, m2, "data"),
         "pmax_int": pmax([None if p is None else p.int() for p in xs], m2, ("data", "model")),
         "psum_bf16": psum([None if p is None else p.bfloat16() for p in xs], m2, "data"),
         "psum_scatter_model": psum_scatter(xs, m2, "model", scatter_dimension=0, tiled=True),
         "all_gather_all": all_gather(xs, m2, ("data", "model"), axis=0, tiled=True),
         "all_gather_stack": all_gather(xs, m2, "model", axis=0, tiled=False)}}
torch.save({{"run": run, "coll": coll}}, os.path.join({out!r}, f"rank{{ranks.rank}}.pt"))
import torch.distributed as dist
dist.destroy_process_group()
"""


def small_store():
    return RapidStore.from_edges(N, rand_edges(N, M, seed=1), undirected=True,
                                 partition_size=PS, B=B, high_threshold=HT, device="cpu")


def child_env():
    """The test's environment without any group address: a rank takes
    only what it is given."""
    drop = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "REPRO_MULTIHOST")
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["PYTHONPATH"] = SRC
    return env


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four gloo CPU ranks through ``drive``, run once: each rank's run and
    collectives."""
    d = tmp_path_factory.mktemp("ranks")
    code = WORKER.format(tests=str(TESTS), init=f"file://{d / 'init'}", shards=SHARDS,
                         world=WORLD, n=N, m=M, ps=PS, b=B, ht=HT, seed=SEED, txns=TXNS,
                         d=D, out=str(d))
    spawn_ranks([sys.executable, "-c", code], WORLD, RANK_TIMEOUT, env=child_env())
    return [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_process():
    """The same sequence on the port's one-process 4-shard plane, with the
    transactions it committed."""
    store = small_store()
    mesh = lmesh.make_shard_mesh(SHARDS, device="cpu")
    return drive(store, mesh, SEED, TXNS, D), store


@pytest.fixture(scope="module")
def reference(one_process):
    """The reference's single-device ``*_view`` on the same edges, at each
    step of the same sequence (the same transactions; no migration: the
    reference's store has no plane)."""
    from repro.core import RapidStore as RStore
    from repro.core.analytics import bfs_view, pagerank_view, sssp_view, wcc_view
    from repro.kernels.spmm import spmm_view

    run, port_store = one_process
    store = RStore.from_edges(N, rand_edges(N, M, seed=1), undirected=True,
                              partition_size=PS, B=B, high_threshold=HT)

    def answers(seed):
        with store.read_view() as v:
            w, h = operands(v, seed, D, torch.device("cpu"))
            return {"pagerank": np.asarray(pagerank_view(v)), "bfs": np.asarray(bfs_view(v, 0)),
                    "sssp": np.asarray(sssp_view(v, w, 0)), "wcc": np.asarray(wcc_view(v)),
                    "spmm": np.asarray(spmm_view(v, h.numpy()))}

    out = {"before": answers(SEED)}
    for i, step in enumerate(STEPS[1:], 1):
        for ins, dels in run["writes"][step]:
            store.apply(ins, dels)
        out[step] = answers(SEED + 2 * i)
    with store.read_view() as v, port_store.read_view() as pv:
        for got, want in zip(v.to_coo(), pv.to_coo()):
            assert np.array_equal(got, want)
    return out


# ---------------------------------------------------------------------------
# 1. The flag off, and a single-process group
# ---------------------------------------------------------------------------
def test_distributed_shard_mesh_flag_off_matches_local(monkeypatch):
    monkeypatch.delenv("REPRO_MULTIHOST", raising=False)
    assert not lmesh.multihost_enabled()
    assert lmesh.init_distributed() is False
    m = lmesh.distributed_shard_mesh(device="cpu")
    assert list(m.devices.flat) == list(lmesh.make_shard_mesh(device="cpu").devices.flat)
    assert m.ranks is None and m.local_shards == [0]


def test_distributed_shard_mesh_subprocess_4dev():
    """Flag off: the local mesh of 4 (and 2) CPU shards.  Flag on with no
    address: a single-process gloo group whose mesh holds all 4 shards; a
    second ``init_distributed`` does nothing."""
    code = """
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh

    m = lmesh.distributed_shard_mesh(4, device="cpu")
    assert list(m.devices.flat) == [torch.device("cpu")] * 4 and m.ranks is None
    assert lmesh.distributed_shard_mesh(n_devices=2, device="cpu").devices.size == 2
    assert lmesh.make_production_mesh(device="cpu").shape == {"data": 16, "model": 16}
    assert lmesh.make_production_mesh(multi_pod=True, device="cpu").shape == \\
        {"pod": 2, "data": 16, "model": 16}
    assert not dist.is_initialized()

    os.environ["REPRO_MULTIHOST"] = "1"
    assert lmesh.multihost_enabled()
    m2 = lmesh.distributed_shard_mesh(4, device="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert m2.ranks.world == 1 and m2.ranks.backend == "gloo"
    assert m2.local_shards == [0, 1, 2, 3] and m2.devices.size == 4
    assert lmesh.init_distributed() is True  # already up: nothing more
    dist.destroy_process_group()
    print("mesh OK")
    """
    import textwrap

    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=120, env=child_env())
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mesh OK" in res.stdout


def test_rebalancer_over_ranks_refuses_timer_and_queue_weight():
    """On a plane over ranks the rebalancer runs in step on every rank:
    its timer and its queue weight (a rank's own signals) are refused;
    ``plan_moves`` and ``execute`` run."""
    code = f"""
    import os, sys
    sys.path.insert(0, {str(TESTS)!r})
    import torch.distributed as dist
    from _parity import rand_edges
    from repro_torch.core import RapidStore
    from repro_torch.core.reshard import Rebalancer
    from repro_torch.launch import mesh as lmesh

    os.environ["REPRO_MULTIHOST"] = "1"
    store = RapidStore.from_edges({N}, rand_edges({N}, {M}, seed=1), undirected=True,
                                  partition_size={PS}, B={B}, high_threshold={HT}, device="cpu")
    plane = store.attach_shard_plane(symmetric=True, mesh=lmesh.distributed_shard_mesh(
        4, device="cpu"))
    rb = store.attach_rebalancer()
    try:
        rb.start()
        raise SystemExit("start() ran over ranks")
    except RuntimeError as exc:
        assert "over ranks" in str(exc)
    try:
        Rebalancer(store, queue_weight=1.0)
        raise SystemExit("queue_weight taken over ranks")
    except ValueError as exc:
        assert "queue_weight" in str(exc)
    assert rb.execute(rb.plan_moves({{0: 3}})) is not None
    assert plane.placement_for(1)[0] == 3
    store.detach_shard_plane()
    dist.destroy_process_group()
    print("rebalancer OK")
    """
    import textwrap

    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=120, env=child_env())
    assert res.returncode == 0, res.stderr[-3000:]
    assert "rebalancer OK" in res.stdout


def test_spawn_ranks_fails_on_a_failed_rank():
    """A rank that exits non-zero fails the run at once; the others, still
    running, are killed."""
    code = "import os, sys, time; sys.exit(3) if os.environ['RANK'] == '2' else time.sleep(60)"
    with pytest.raises(RuntimeError, match="rank 2 of 4 exited 3"):
        spawn_ranks([sys.executable, "-c", code], 4, 30, env=child_env())


def test_spawn_ranks_times_out():
    code = "import time; time.sleep(60)"
    with pytest.raises(TimeoutError):
        spawn_ranks([sys.executable, "-c", code], 2, 1, env=child_env())


# ---------------------------------------------------------------------------
# 2. Four gloo ranks on the CPU
# ---------------------------------------------------------------------------
def test_each_rank_holds_only_its_shards(ranks, one_process):
    one = one_process[0]
    for r, got in enumerate(ranks):
        run = got["run"]
        for step in STEPS:
            key = f"uploads_{step}"
            assert [u for k, u in enumerate(run[key]) if k != r] == [0] * (SHARDS - 1)
            assert run[key][r] == one[key][r] > 0
    # the transactions touch shard 1 only: only rank 1 uploads again
    grew = [got["run"]["uploads_after"][r] - got["run"]["uploads_before"][r]
            for r, got in enumerate(ranks)]
    assert grew[1] > 0 and grew[0] == grew[2] == grew[3] == 0


def test_migration_crosses_ranks(ranks, one_process):
    """Every rank flipped the same epoch: the same moves, each from one
    rank's shard to another rank's, and the same placement after it."""
    one = one_process[0]
    moves, moved_from = one["moves"], one["moved_from"]
    assert len(moves) >= 2
    for sid, dst in moves.items():
        assert moved_from[sid] % WORLD != dst % WORLD
        assert one["placement_migrated"][sid] == dst
    for got in ranks:
        run = got["run"]
        assert run["moves"] == moves and run["moved_from"] == moved_from
        assert run["placement_migrated"] == one["placement_migrated"]
        # the migrated view spliced across the epoch (coo and blocks)
        assert run["migration_rebuilds"] == one["migration_rebuilds"] == 2


@pytest.mark.parametrize("step", STEPS)
def test_ranks_agree_bitwise(ranks, step):
    first = summary(ranks[0]["run"])
    for got in ranks[1:]:
        s = summary(got["run"])
        assert s[f"{step}_digest"] == first[f"{step}_digest"]


@pytest.mark.parametrize("step", STEPS)
def test_ranks_match_one_process_plane(ranks, one_process, step):
    want = one_process[0][step]
    got = ranks[0]["run"][step]
    for key in BITWISE:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    torch.testing.assert_close(got["pagerank_push"], want["pagerank_push"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("step", STEPS)
def test_ranks_match_reference_single_device(ranks, reference, step):
    got, want = ranks[0]["run"][step], reference[step]
    for key in ("bfs", "sssp", "wcc"):
        assert np.array_equal(got[key].numpy(), want[key]), key
        assert got[key].numpy().dtype == want[key].dtype, key
    forms = ("pagerank_push", "pagerank_pull") if step == "before" else ("pagerank_push",)
    for key in forms:  # after the one-way writes the pull form is the transpose's
        np.testing.assert_allclose(got[key].numpy(), want["pagerank"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["spmm"].numpy(), want["spmm"], rtol=1e-4, atol=1e-4)


def one_process_collectives():
    m2 = lmesh.make_host_mesh((2, 2), ("data", "model"))
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4 * 6, 8) % 97 - 40
    xs = shard(x, m2, P(("data", "model"), None))
    return {"psum_model": psum(xs, m2, "model"),
            "pmax_data": pmax(xs, m2, "data"),
            "pmax_int": pmax([p.int() for p in xs], m2, ("data", "model")),
            "psum_bf16": psum([p.bfloat16() for p in xs], m2, "data"),
            "psum_scatter_model": psum_scatter(xs, m2, "model", scatter_dimension=0,
                                               tiled=True),
            "all_gather_all": all_gather(xs, m2, ("data", "model"), axis=0, tiled=True),
            "all_gather_stack": all_gather(xs, m2, "model", axis=0, tiled=False)}


@pytest.mark.parametrize("name", ["psum_model", "pmax_data", "pmax_int", "psum_bf16",
                                  "psum_scatter_model", "all_gather_all", "all_gather_stack"])
def test_collectives_across_ranks_match_one_process_mesh(ranks, name):
    want = one_process_collectives()[name]
    for r, got in enumerate(ranks):
        coll = got["coll"]
        assert coll["local"] == [r]
        for k, part in enumerate(coll[name]):
            if k == r:
                assert part.dtype == want[k].dtype and torch.equal(part, want[k]), (name, k)
            else:
                assert part is None


# ---------------------------------------------------------------------------
# 3. The card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
class TestCard:
    SCALE, TXNS = 12, 4

    def launch(self, tmp_path, world, backend):
        out = tmp_path / backend
        cmd = [sys.executable, "-m", "repro_torch.launch.plane", "--scale", str(self.SCALE),
               "--seed", str(SEED), "--txns", str(self.TXNS), "--backend", backend,
               "--deterministic", "--init", f"file://{tmp_path / (backend + '.init')}",
               "--out", str(out)]
        spawn_ranks(cmd, world, RANK_TIMEOUT, env=child_env())
        return [torch.load(out / f"rank{r}.pt") for r in range(world)]

    def one_process(self):
        from repro_torch.launch.plane import rmat_store

        torch.use_deterministic_algorithms(True)
        try:
            store, _ = rmat_store(self.SCALE, SEED, torch.device("cuda", 0))
            return summary(drive(store, lmesh.make_shard_mesh(SHARDS, device="cuda"), SEED,
                                 self.TXNS, 128))
        finally:
            torch.use_deterministic_algorithms(False)

    def hold(self, got, want):
        for step in STEPS:
            d_got, d_want = got[f"{step}_digest"], want[f"{step}_digest"]
            for key in BITWISE:
                assert d_got[key] == d_want[key], (step, key)
            torch.testing.assert_close(got[f"{step}_pagerank_push"],
                                       want[f"{step}_pagerank_push"], rtol=1e-5, atol=1e-5)
        assert got["leaf_spmm_launches"] > 0

    def test_gloo_ranks_share_one_card(self, tmp_path):
        runs = self.launch(tmp_path, 2, "gloo")
        want = self.one_process()
        for got in runs:
            self.hold(got, want)

    def test_nccl_one_rank_a_card(self, tmp_path):
        runs = self.launch(tmp_path, torch.cuda.device_count(), "nccl")
        want = self.one_process()
        for got in runs:
            self.hold(got, want)
