"""The plain reference on hand-built graphs, and against the program's CPU
route at a tiny scale (the test may import both; the reference does not)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from rsbench import gen  # noqa: E402
from rsbench.reference import graph  # noqa: E402

# 0 -> 1 -> 2 -> 3, 0 -> 2, 4 -> 5 (another component), 6 alone
SRC = torch.tensor([0, 1, 2, 0, 4])
DST = torch.tensor([1, 2, 3, 2, 5])
N = 7


def test_bfs_levels_by_hand():
    assert graph.bfs(SRC, DST, N, 0).tolist() == [0, 1, 1, 2, -1, -1, -1]
    assert graph.bfs(SRC, DST, N, 4).tolist() == [-1, -1, -1, -1, 0, 1, -1]


def test_sssp_takes_the_lighter_path_in_float32():
    w = torch.tensor([0.5, 0.5, 1.25, 1.5, 0.75], dtype=torch.float32)
    dist = graph.sssp(SRC, DST, w, N, 0)
    assert dist.dtype == torch.float32
    assert dist[:4].tolist() == [0.0, 0.5, 1.0, 2.25]
    assert torch.isinf(dist[4:]).all()


def test_wcc_labels_are_least_ids():
    assert graph.wcc(SRC, DST, N).tolist() == [0, 0, 0, 0, 4, 4, 6]


def test_pagerank_by_hand():
    n, d = 3, 0.85
    src, dst = torch.tensor([0, 0, 1]), torch.tensor([1, 2, 2])  # 2 has no out-edges
    p = np.full(n, 1 / n)
    for _ in range(2):
        agg = np.zeros(n)
        agg[1] += p[0] / 2
        agg[2] += p[0] / 2 + p[1]
        p = (1 - d) / n + d * (agg + p[2] / n)
    got = graph.pagerank(src, dst, n, 2)
    np.testing.assert_allclose(got.numpy(), p, rtol=1e-14)


def test_neighbor_sum_rows_and_magnitudes():
    vals = torch.tensor([[1.0, -2.0], [3.0, 4.0], [-5.0, 6.0], [7.0, 8.0],
                         [0.0, 1.0], [2.0, 2.0], [9.0, 9.0]])
    total, mag = graph.neighbor_sum(SRC, DST, vals, N)
    assert total[0].tolist() == [-2.0, 10.0]  # rows 1 and 2
    assert mag[0].tolist() == [8.0, 10.0]
    assert total[6].tolist() == [0.0, 0.0]
    rows = torch.tensor([2, 0])
    sub, _ = graph.neighbor_sum(SRC, DST, vals, N, rows=rows)
    assert sub.tolist() == [total[2].tolist(), total[0].tolist()]


def _keys(pairs):
    return torch.tensor(sorted((u << 32) | v for u, v in pairs), dtype=torch.int64)


def test_replay_orders_transactions_by_commit_timestamp():
    base = _keys([(0, 1), (1, 2), (2, 3)])
    ins = lambda *e: np.array(e, np.int64).reshape(-1, 2)  # noqa: E731
    txns = [(7, ins((0, 1)), ins()),          # re-insert after the delete at 5
            (5, ins((4, 5)), ins((0, 1))),
            (9, ins(), ins((4, 5))),
            (0, ins((6, 6)), ins())]          # ts 0: never committed, never replayed
    want = {3: [(0, 1), (1, 2), (2, 3)], 5: [(1, 2), (2, 3), (4, 5)],
            7: [(0, 1), (1, 2), (2, 3), (4, 5)], 9: [(0, 1), (1, 2), (2, 3)]}
    for ts, pairs in want.items():
        got = graph.replay(base, txns, ts)
        assert sorted(got.tolist()) == _keys(pairs).tolist(), ts


@pytest.fixture(scope="module")
def tiny_view():
    """A scale-10 R-MAT store of the program on the CPU, pinned."""
    from repro_torch.core import RapidStore

    cfg = {"scale": 10, "generator": {"a": 0.57, "b": 0.19, "c": 0.19, "edge_factor": 16,
                                      "directed": True}}
    edges, keys = gen.base_graph(cfg, 7, torch.device("cpu"))
    store = RapidStore.from_edges(1 << 10, edges.numpy(), partition_size=64, B=64,
                                  leaf_tiers=[16, 64], device="cpu")
    h = store.begin_read()
    yield h.view, keys
    store.end_read(h)


def test_reference_against_the_program_cpu_route(tiny_view):
    from repro_torch.core import analytics
    from repro_torch.kernels.spmm import leaf_scan_reduce_view, spmm_view
    from rsbench import queries

    view, keys = tiny_view
    n = view.n_vertices
    src, dst = graph.split_keys(keys)
    psrc, pdst = view.to_coo_device()
    assert gen.fingerprint_keys(gen.edge_keys(psrc, pdst)) == gen.fingerprint_keys(keys)
    assert queries.tiles_fingerprint(view.to_leaf_blocks_device()) == \
        gen.normalize(gen.fingerprint_keys(keys))
    root = int(src[0])
    assert torch.equal(analytics.bfs_view(view, root), graph.bfs(src, dst, n, root))
    assert torch.equal(analytics.wcc_view(view), graph.wcc(src, dst, n))
    w = gen.edge_weight(psrc, pdst, 3)
    assert torch.equal(analytics.sssp_view(view, w, root),
                       graph.sssp(src, dst, gen.edge_weight(src, dst, 3), n, root))
    pr = graph.pagerank(src, dst, n, 10)
    assert float(((analytics.pagerank_view(view) - pr).abs() / pr).max()) < 1e-5
    g = torch.Generator().manual_seed(1)
    h, x = torch.randn(n, 8, generator=g), torch.randn(n, generator=g)
    want, mag = graph.neighbor_sum(src, dst, h, n)
    assert float(((spmm_view(view, h) - want).abs() / mag.clamp(min=1e-30)).max()) < 1e-5
    y = leaf_scan_reduce_view(view, x)
    per_vertex = torch.zeros(n, dtype=torch.float64).index_add_(
        0, queries.tile_src(view.to_leaf_blocks_device()).long(), y.double())
    want, mag = graph.neighbor_sum(src, dst, x, n)
    assert float(((per_vertex - want).abs() / mag.clamp(min=1e-30)).max()) < 1e-5
