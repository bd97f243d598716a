"""The port's shard plane against the JAX reference's, on the CPU.

1. Placement: both packages' policies return equal arrays.
2. The reference's own 4-device plane (forced host devices) runs in one
   module-scoped subprocess, once on a symmetric store (pull PageRank) and
   once on a directed one (push PageRank): the collectives on a view,
   again after a write dirtying subgraphs of shard 1 only, and again after
   ``plan_moves({0: 1, 2: 3})`` + ``execute``.  The port's 4-shard plane
   runs the same sequences on the same edges: BFS levels, SSSP distances
   and WCC labels equal bit for bit, PageRank within 1e-5 (the two
   packages' f32 updates round apart), and the placement epochs, per-shard
   upload deltas, staged bytes and WAL bytes (the one-shard commit and the
   migrate record) equal.
3. SpMM: the reference's plane cannot answer it under this JAX (its Pallas
   call inside ``shard_map`` raises), so the port's sharded SpMM is held
   within 1e-4 of the reference's single-device ``spmm_view``, which the
   reference documents as equal to its plane's bit for bit.
4. The port's plane against the port's single-device route: bitwise for
   all five collectives on a symmetric store (pull PageRank); on a directed
   store (push PageRank) BFS, SSSP, WCC and SpMM bitwise, PageRank within
   1e-5 (the push form merges overlapping partials in another order).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from _parity import rand_edges
from _subproc import run_sub
from _torch_shard_sequence import N, P, PHASES, features, run_sequence, weights

import repro.core.shard_plane as rsp
import repro_torch.core.analytics as A
import repro_torch.core.shard_plane as tsp
from repro_torch.core import RapidStore
from repro_torch.kernels.spmm import spmm_view

TESTS = str(Path(__file__).resolve().parent)


def _port_answers(v):
    return {
        "pagerank": A.pagerank_view(v),
        "bfs": A.bfs_view(v, 0),
        "sssp": A.sssp_view(v, weights(v.n_edges), 0),
        "wcc": A.wcc_view(v),
    }


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's 4-device plane, run once in a subprocess."""
    d = tmp_path_factory.mktemp("ref_plane")
    out_path = d / "answers.npz"
    run_sub(f"""
    import os, sys
    sys.path.insert(0, {TESTS!r})
    import jax
    assert len(jax.devices()) == 4
    import numpy as np
    from _torch_shard_sequence import features, run_sequence, weights
    from repro.core import RapidStore
    from repro.core.analytics import bfs_view, pagerank_view, sssp_view, wcc_view
    from repro.kernels.spmm import spmm_view

    def answers(v):
        return {{"pagerank": pagerank_view(v), "bfs": bfs_view(v, 0),
                 "sssp": sssp_view(v, weights(v.n_edges), 0), "wcc": wcc_view(v)}}

    _, directed = run_sequence(RapidStore.from_edges, answers, {str(d / "wal_d.log")!r},
                               symmetric=False)
    store, out = run_sequence(RapidStore.from_edges, answers, {str(d / "wal.log")!r})
    out.update({{f"directed_{{k}}": a for k, a in directed.items()}})
    # SpMM: the single-device route (the plane's Pallas call fails here)
    os.environ["REPRO_DISABLE_SHARD_PLANE"] = "1"
    with store.read_view() as v:
        out["spmm_single"] = np.asarray(spmm_view(v, features()))
    np.savez({str(out_path)!r}, **out)
    print("reference plane OK")
    """, devices=4)
    with np.load(out_path) as z:
        return dict(z)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_plane")

    def make_store(*a, **kw):
        return RapidStore.from_edges(*a, device="cpu", **kw)

    _, directed = run_sequence(make_store, _port_answers, str(d / "wal_d.log"),
                               symmetric=False)
    store, out = run_sequence(make_store, _port_answers, str(d / "wal.log"))
    out.update({f"directed_{k}": a for k, a in directed.items()})
    with store.read_view() as v:
        out["spmm_plane"] = spmm_view(v, torch.from_numpy(features())).numpy()
    return out


# ---------------------------------------------------------------------------
def test_placement_policies_equal():
    rng = np.random.default_rng(0)
    for w in (np.ones(10, np.int64),
              np.array([1000, 10, 10, 10, 10, 10, 10, 10], np.int64),
              (rng.pareto(1.0, size=64) * 50).astype(np.int64) + 1):
        for k in (1, 3, 4):
            assert np.array_equal(tsp.modulo_placement(w, k), rsp.modulo_placement(w, k))
            assert np.array_equal(tsp.degree_balanced_placement(w, k),
                                  rsp.degree_balanced_placement(w, k))


def _collectives_match(reference, port, pre, phase):
    for key in ("bfs", "sssp", "wcc"):
        got, want = port[f"{pre}{key}_{phase}"], reference[f"{pre}{key}_{phase}"]
        assert got.dtype == want.dtype and np.array_equal(got, want), key
    np.testing.assert_allclose(port[f"{pre}pagerank_{phase}"],
                               reference[f"{pre}pagerank_{phase}"], rtol=1e-5, atol=1e-5)


def _epochs_staging_and_wal_match(reference, port, pre):
    for key in ("epoch", "epoch_ts", "epoch_placements", "wal"):
        assert np.array_equal(port[pre + key], reference[pre + key]), key
    assert int(port[f"{pre}staged"]) == int(reference[f"{pre}staged"]) > 0
    # the one-shard write dirties sids 1, 5 and 9, all on shard 1
    assert port[f"{pre}uploads_write"].tolist() == [0, 3, 0, 0]


@pytest.mark.parametrize("phase", PHASES)
def test_collectives_match_reference_plane(reference, port, phase):
    _collectives_match(reference, port, "", phase)


@pytest.mark.parametrize("phase", PHASES)
def test_directed_collectives_match_reference_plane(reference, port, phase):
    """The directed store's push PageRank, BFS, SSSP and WCC."""
    _collectives_match(reference, port, "directed_", phase)


@pytest.mark.parametrize("phase", PHASES)
def test_upload_deltas_match_reference_plane(reference, port, phase):
    assert np.array_equal(port[f"uploads_{phase}"], reference[f"uploads_{phase}"])


@pytest.mark.parametrize("phase", PHASES)
def test_directed_upload_deltas_match_reference_plane(reference, port, phase):
    assert np.array_equal(port[f"directed_uploads_{phase}"],
                          reference[f"directed_uploads_{phase}"])


def test_epochs_staging_and_wal_match_reference(reference, port):
    _epochs_staging_and_wal_match(reference, port, "")


def test_directed_epochs_staging_and_wal_match_reference(reference, port):
    _epochs_staging_and_wal_match(reference, port, "directed_")


def test_sharded_spmm_matches_reference_single_device(reference, port):
    np.testing.assert_allclose(port["spmm_plane"], reference["spmm_single"],
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The port's plane against the port's single-device route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("symmetric", [True, False])
def test_plane_against_single_route(symmetric):
    e = rand_edges(N, 900, seed=1)
    store = RapidStore.from_edges(N, e, undirected=symmetric, partition_size=P, B=16,
                                  high_threshold=8, device="cpu")
    h = torch.from_numpy(features())
    with store.read_view() as v:
        single = dict(_port_answers(v), spmm=spmm_view(v, h))
    store.attach_shard_plane(n_devices=4, symmetric=symmetric)
    with store.read_view() as v:
        sharded = dict(_port_answers(v), spmm=spmm_view(v, h))
        assert tsp.active_plane(v) is store.shard_plane
    for key in ("bfs", "sssp", "wcc", "spmm"):
        assert torch.equal(sharded[key], single[key]), key
    if symmetric:  # pull form: the merge adds exact zeros
        assert torch.equal(sharded["pagerank"], single["pagerank"])
    else:  # push form: overlapping partials merge in another order
        torch.testing.assert_close(sharded["pagerank"], single["pagerank"],
                                   rtol=1e-5, atol=1e-5)
