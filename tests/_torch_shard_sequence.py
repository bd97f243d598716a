"""One shard-plane operation sequence, run by both packages.

``tests/test_torch_shard_parity.py`` runs :func:`run_sequence` on the
port's 4-shard plane in process and on the reference's 4-device plane in a
subprocess (forced host devices), so both walk the same steps.  Imports
neither package: the caller passes its store class and answer function.
"""

from pathlib import Path

import numpy as np

from _parity import rand_edges

N, P = 96, 8
STORE = dict(partition_size=P, B=16, high_threshold=8)
WRITE = np.array([[9, 44], [44, 9], [10, 75], [75, 10]], np.int64)  # shard 1 only
MOVES = {0: 1, 2: 3}
PHASES = ("attach", "write", "migrate")


def weights(m: int) -> np.ndarray:
    """SSSP edge weights in global COO order, the same in both packages."""
    return ((np.arange(m) % 7 + 1) * 0.25).astype(np.float32)


def features() -> np.ndarray:
    return np.random.default_rng(5).normal(size=(N, 12)).astype(np.float32)


def run_sequence(make_store, answers, wal_path, n_shards: int = 4, symmetric: bool = True):
    """Build the store with ``make_store(n, edges, undirected=symmetric,
    **STORE)``, attach a WAL and an ``n_shards`` plane (``symmetric``: pull
    PageRank on the undirected store, else push PageRank on the directed
    one), and record ``answers(view)``
    (a dict of arrays) and the per-shard upload deltas after the attach,
    after a write dirtying subgraphs of shard 1 only, and after migrating
    ``MOVES``; then the placement epochs, the staged bytes and the WAL's
    bytes.  Returns ``(store, record)``."""
    store = make_store(N, rand_edges(N, 900, seed=0), undirected=symmetric, **STORE)
    store.attach_wal(wal_path)
    plane = store.attach_shard_plane(n_devices=n_shards, symmetric=symmetric)
    out = {}

    def phase(name):
        u0 = list(plane.stats.uploads)
        with store.read_view() as v:
            for key, val in answers(v).items():
                out[f"{key}_{name}"] = np.asarray(val)
        out[f"uploads_{name}"] = np.array(plane.stats.uploads) - np.array(u0)

    phase("attach")
    store.insert_edges(WRITE)
    phase("write")
    rb = store.attach_rebalancer()
    out["epoch"] = np.array(rb.execute(rb.plan_moves(MOVES)))
    phase("migrate")
    hist = plane.placement_epochs()
    out["epoch_ts"] = np.array([ts for ts, _ in hist])
    out["epoch_placements"] = np.stack([pl for _, pl in hist])
    out["staged"] = np.array(store.stats["reshard_bytes_staged"])
    store.detach_wal()
    out["wal"] = np.frombuffer(Path(wal_path).read_bytes(), np.uint8)
    return store, out
