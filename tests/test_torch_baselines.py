"""The paper's comparison stores in the port against the reference's.

``repro_torch.core.baselines`` is a copy of ``repro.core.baselines`` (host
numpy, as the paper's CPU baselines are) bound to the port's own clock.
Both packages' stores take the same seeded edges and the same writes, and
every answer is held bitwise: the CSR arrays, searches, scans (at the
newest timestamp and at each older one), the commit timestamps, what
``gc`` keeps and ``memory_bytes``.
"""

import numpy as np
import pytest

from repro.core import baselines as R
from repro_torch.core import baselines as T

N = 300
M = 2400


def edges(seed=0, n=N, m=M):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(m, 2), dtype=np.int64)
    e[: m // 4, 0] = rng.integers(0, 8, size=m // 4)  # a few hubs
    return e


def queries(seed=1, n=N, k=500):
    """Half present (drawn from ``edges()``), half random pairs."""
    rng = np.random.default_rng(seed)
    e = edges()
    present = e[rng.integers(0, len(e), k // 2)]
    rand = rng.integers(0, n, size=(k - k // 2, 2))
    q = np.concatenate([present, rand])
    return q[:, 0].astype(np.int64), q[:, 1].astype(np.int64)


def writes(seed=2, n=N, n_txn=12, k=20):
    """(inserts, deletes) per transaction; deletes take live edges and
    some of the transaction's own earlier inserts."""
    rng = np.random.default_rng(seed)
    e = edges()
    out = []
    for i in range(n_txn):
        ins = rng.integers(0, n, size=(k, 2), dtype=np.int64)
        dels = np.concatenate([e[rng.integers(0, len(e), k // 2)], ins[: k // 4]])
        out.append((ins, dels))
    return out


def same_arrays(a, b):
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("undirected", [False, True])
def test_csr_from_edges_search_and_scan(undirected):
    e = edges()
    r = R.CSRGraph.from_edges(N, e, undirected=undirected)
    t = T.CSRGraph.from_edges(N, e, undirected=undirected)
    same_arrays(t.offsets, r.offsets)
    same_arrays(t.indices, r.indices)
    assert (t.n_vertices, t.n_edges) == (r.n_vertices, r.n_edges)
    us, vs = queries()
    found = t.search_many(us, vs)
    same_arrays(found, r.search_many(us, vs))
    assert 0 < found.sum() < len(found)
    assert [t.search(int(u), int(v)) for u, v in zip(us[:50], vs[:50])] == \
        [r.search(int(u), int(v)) for u, v in zip(us[:50], vs[:50])]
    for u in range(0, N, 7):
        same_arrays(t.neighbors(u), r.neighbors(u))


def test_csr_from_no_edges():
    t = T.CSRGraph.from_edges(5, np.empty((0, 2), np.int64))
    r = R.CSRGraph.from_edges(5, np.empty((0, 2), np.int64))
    same_arrays(t.offsets, r.offsets)
    same_arrays(t.indices, r.indices)


def replay(mod, undirected=False):
    """A per-edge versioned store of ``mod`` after ``writes()``, with each
    commit's timestamp and the scans and searches at it."""
    s = mod.PerEdgeVersionedAdjacency.from_edges(N, edges(), undirected=undirected)
    us, vs = queries()
    seen = [(0, [s.scan(u, 0) for u in range(N)], [s.search(int(u), int(v), 0)
                                                  for u, v in zip(us, vs)])]
    for ins, dels in writes():
        t_ins = s.insert_edges(ins)
        t_del = s.delete_edges(dels)
        for ts in (t_ins, t_del):
            seen.append((ts, [s.scan(u, ts) for u in range(N)],
                         [s.search(int(u), int(v), ts) for u, v in zip(us, vs)]))
    return s, seen


@pytest.mark.parametrize("undirected", [False, True])
def test_per_edge_versioned_writes_and_old_scans(undirected):
    t, t_seen = replay(T, undirected)
    r, r_seen = replay(R, undirected)
    assert [ts for ts, _, _ in t_seen] == [ts for ts, _, _ in r_seen]
    assert [ts for ts, _, _ in t_seen] == list(range(len(t_seen)))
    for (ts, t_scans, t_found), (_, r_scans, r_found) in zip(t_seen, r_seen):
        for a, b in zip(t_scans, r_scans):
            same_arrays(a, b)
        assert t_found == r_found
    # scans at every older timestamp still read that commit's state
    for ts, _, _ in r_seen[::5]:
        for u in range(0, N, 11):
            same_arrays(t.scan(u, ts), r.scan(u, ts))
    # newest-timestamp reads with t omitted
    for u in range(0, N, 3):
        same_arrays(t.scan(u), r.scan(u))
    us, vs = queries()
    assert [t.search(int(u), int(v)) for u, v in zip(us, vs)] == \
        [r.search(int(u), int(v)) for u, v in zip(us, vs)]
    assert t.memory_bytes() == r.memory_bytes()
    for u in range(N):
        same_arrays(t.created[u], r.created[u])
        same_arrays(t.deleted[u], r.deleted[u])


def test_per_edge_versioned_gc():
    t, _ = replay(T)
    r, _ = replay(R)
    before = t.memory_bytes()
    t.gc()
    r.gc()
    assert t.memory_bytes() == r.memory_bytes() < before
    for u in range(N):
        same_arrays(t.vals[u], r.vals[u])
        same_arrays(t.created[u], r.created[u])
        same_arrays(t.deleted[u], r.deleted[u])
        assert not (t.deleted[u] != T.PerEdgeVersionedAdjacency.LIVE).any()
        same_arrays(t.scan(u), r.scan(u))


@pytest.mark.parametrize("partition_size", [64, 16])
def test_vec_store(partition_size):
    t = T.VecStore.from_edges(N, edges(), partition_size=partition_size)
    r = R.VecStore.from_edges(N, edges(), partition_size=partition_size)
    assert t.n_subgraphs == r.n_subgraphs
    assert t.memory_bytes() == r.memory_bytes()
    us, vs = queries()
    stamps = []
    for ins, _ in writes():
        stamps.append((t.insert_edges(ins), r.insert_edges(ins)))
        assert t.clock.read_timestamp() == r.clock.read_timestamp()
    assert [a for a, _ in stamps] == [b for _, b in stamps] == list(range(1, len(stamps) + 1))
    for u in range(N):
        same_arrays(t.scan(u), r.scan(u))
    assert [t.search(int(u), int(v)) for u, v in zip(us, vs)] == \
        [r.search(int(u), int(v)) for u, v in zip(us, vs)]
    assert t.memory_bytes() == r.memory_bytes()


def test_port_baselines_import_nothing_of_the_reference():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(T))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("repro", "jax")]
    assert T.LogicalClock.__module__ == "repro_torch.core.clock"
