"""The port against the JAX reference on the same store, CPU only.

Both packages build a store from the same numpy edges
(``_parity.make_store`` parameters, single-tier and tiered), take the same
write batches, and answer the 11 view-level entry points of
``_parity.ENTRY_CASES`` on the same operands before and after the writes.
The leaf streams must be bitwise identical; integer answers must match
bitwise and float answers within the tolerances of ``tests/test_kernels.py``
(scan-reduce and PageRank 1e-5, SpMM 1e-4: the sums run in another order).
The post-write views splice against their retired predecessor, which is
asserted on the port's assembler counters.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from _parity import ENTRY_CASES, make_entry_ctx, rand_edges

import repro.core as rc
import repro.core.analytics as ra
from repro.kernels.intersect import intersect_tiles_view as r_intersect
from repro.kernels.intersect import sum_intersect_tiles_view as r_sum_intersect
from repro.kernels.leaf_search import edge_search_view as r_edge_search
from repro.kernels.spmm import leaf_scan_reduce_view as r_scan
from repro.kernels.spmm import leaf_spmm_view as r_leaf_spmm
from repro.kernels.spmm import spmm_view as r_spmm

import repro_torch.core as tc
from repro_torch.core import view_assembler as t_assembler
from repro_torch.kernels.intersect import intersect_tiles_view as t_intersect
from repro_torch.kernels.intersect import sum_intersect_tiles_view as t_sum_intersect
from repro_torch.kernels.leaf_search import edge_search_view as t_edge_search

from _torch_entries import PORT_ENTRIES

N = 96
STORE_KW = dict(partition_size=16, B=16, high_threshold=8)
CONFIGS = {"single": None, "tiered": (8, 16)}
# the reference's side of each entry point; the port's is _torch_entries'
_REF_CALLS = {
    "edge_search_view":
        lambda v, c: r_edge_search(v, c["queries"][:, 0], c["queries"][:, 1]),
    "intersect_tiles_view": lambda v, c: r_intersect(v, c["ia"], c["ib"]),
    "sum_intersect_tiles_view":
        lambda v, c: r_sum_intersect(v, c["ia"], c["ib"], batch=16),
    "leaf_scan_reduce_view": lambda v, c: r_scan(v, jnp.asarray(c["x"])),
    "leaf_spmm_view": lambda v, c: r_leaf_spmm(v, jnp.asarray(c["H"])),
    "spmm_view": lambda v, c: r_spmm(v, jnp.asarray(c["H"])),
    "pagerank_view": lambda v, c: ra.pagerank_view(v),
    "bfs_view": lambda v, c: ra.bfs_view(v, 0),
    "sssp_view": lambda v, c: ra.sssp_view(v, c["w"], 0),
    "wcc_view": lambda v, c: ra.wcc_view(v),
    "triangle_count_view": lambda v, c: ra.triangle_count_view(v),
}
# name -> (repro call, port call, tolerance or None for exact)
ENTRIES = {name: (_REF_CALLS[name], *PORT_ENTRIES[name]) for name in _REF_CALLS}
assert set(ENTRIES) == set(ENTRY_CASES)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def _write_batches(view):
    """Two write batches confined to subgraph 1 (so the next view splices)
    and a mixed one, drawn from the reference view's edges."""
    rng = np.random.default_rng(5)
    src, dst = view.to_coo_uncached()
    in_sg1 = np.nonzero((src >= 16) & (src < 32))[0]
    dels = np.stack([src[in_sg1], dst[in_sg1].astype(np.int64)], 1)[:6]
    ins = np.stack([rng.integers(16, 32, 12), rng.integers(0, N, 12)], 1)
    ins = ins[ins[:, 0] != ins[:, 1]]
    return [(ins[:6], dels[:3]), (ins[6:], dels[3:])]


def _stream(view):
    s = view.to_leaf_stream()
    return (s.data, s.leaf_offsets, s.leaf_lens, s.leaf_keys, s.leaf_tiers)


def _phase(results, name, r_view, t_view):
    ctx = make_entry_ctx(r_view, seed=3)
    results[name] = {"stream": (_stream(r_view), _stream(t_view))}
    for entry, (r_call, t_call, _tol) in ENTRIES.items():
        results[name][entry] = (_np(r_call(r_view, ctx)), _np(t_call(t_view, ctx)))


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    tiers = CONFIGS[request.param]
    edges = rand_edges(N, 900, 1)
    r_store = rc.RapidStore.from_edges(N, edges, leaf_tiers=tiers, **STORE_KW)
    t_store = tc.RapidStore.from_edges(N, edges, leaf_tiers=tiers, device="cpu",
                                       **STORE_KW)
    results = {}
    with r_store.read_view() as rv, t_store.read_view() as tv:
        _phase(results, "before", rv, tv)
        batches = _write_batches(rv)
    for ins, dels in batches:
        r_store.apply(ins, dels)
        t_store.apply(ins, dels)
    splices = t_assembler.stats.splices
    with r_store.read_view() as rv, t_store.read_view() as tv:
        _phase(results, "after", rv, tv)
    results["port_splices"] = t_assembler.stats.splices - splices
    return request.param, results


@pytest.mark.parametrize("phase", ["before", "after"])
def test_leaf_streams_bitwise_identical(runs, phase):
    _, results = runs
    want, got = results[phase]["stream"]
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        assert np.array_equal(w, g)


def test_post_write_view_splices(runs):
    _, results = runs
    assert results["port_splices"] > 0


@pytest.mark.parametrize("phase", ["before", "after"])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_point_matches_reference(runs, entry, phase):
    want, got = runs[1][phase][entry]
    tol = ENTRIES[entry][2]
    assert np.shape(want) == np.shape(got)
    if tol is None:
        assert np.array_equal(want, got)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_edge_search_view_on_odd_queries(config):
    """Queries from vertices without tiles and from ids outside the view
    answer False, as in the reference; every pair through both packages."""
    tiers = CONFIGS[config]
    edges = rand_edges(N, 300, 2)
    r_store = rc.RapidStore.from_edges(N, edges, leaf_tiers=tiers, **STORE_KW)
    t_store = tc.RapidStore.from_edges(N, edges, leaf_tiers=tiers, device="cpu",
                                       **STORE_KW)
    rng = np.random.default_rng(9)
    us = np.concatenate([edges[:40, 0], [-1, N, N + 3], rng.integers(0, N, 40)])
    vs = np.concatenate([edges[:40, 1], [0, 1, 2], rng.integers(0, N, 40)])
    with r_store.read_view() as rv, t_store.read_view() as tv:
        want = np.asarray(r_edge_search(rv, us, vs))
        got = t_edge_search(tv, us, vs)
    assert got.dtype == bool and np.array_equal(got, want)
    assert got[:40].all() and not got[40:43].any()


@pytest.mark.parametrize("batch", [1, 5, 1 << 20])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_sum_intersect_batches_agree(config, batch):
    """The batched device sum equals the reference's at every batch size
    (one pair per launch, a ragged last batch, all pairs in one), and the
    per-pair counts' sum."""
    tiers = CONFIGS[config]
    edges = rand_edges(N, 900, 4)
    r_store = rc.RapidStore.from_edges(N, edges, leaf_tiers=tiers, **STORE_KW)
    t_store = tc.RapidStore.from_edges(N, edges, leaf_tiers=tiers, device="cpu",
                                       **STORE_KW)
    with r_store.read_view() as rv, t_store.read_view() as tv:
        ctx = make_entry_ctx(rv, seed=6)
        want = r_sum_intersect(rv, ctx["ia"], ctx["ib"], batch=16)
        got = t_sum_intersect(tv, ctx["ia"], ctx["ib"], batch=batch)
        per_pair = t_intersect(tv, ctx["ia"], ctx["ib"])
    assert isinstance(got, int) and got == want == int(per_pair.sum())
    assert want > 0
