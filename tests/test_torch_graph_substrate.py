"""The port's graph substrate against the reference, CPU only: the neighbor
sampler over each package's own store snapshot (bitwise), ``pad_subgraph``,
batching and the data pipelines; then the port's dynamic-graph GNN
training end to end and its launcher."""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import RapidStore as RStore
from repro.data import pipeline as RP
from repro.graph.batching import batch_graphs as r_batch_graphs
from repro.graph.generators import uniform_edges
from repro.graph.sampler import NeighborSampler as RSampler
from repro.graph.sampler import pad_subgraph as r_pad

from repro_torch.configs import registry
from repro_torch.core import RapidStore
from repro_torch.data import pipeline as TP
from repro_torch.data.pipeline import GraphUpdateStream
from repro_torch.graph.batching import batch_graphs
from repro_torch.graph.sampler import NeighborSampler, pad_subgraph
from repro_torch.models import gnn as G
from repro_torch.optim import adamw
from repro_torch.train.step import make_gnn_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
KW = dict(partition_size=16, B=16)


def assert_same(a, b):
    """Equal arrays, dtypes and shapes included."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _both_stores(n=200, seed=3):
    edges = uniform_edges(n, 3000, seed=seed)
    return (RStore.from_edges(n, edges, **KW),
            RapidStore.from_edges(n, edges, device="cpu", **KW))


@pytest.mark.parametrize("after_writes", (False, True))
def test_sampler_over_each_store_matches_bitwise(after_writes):
    rs, ts = _both_stores()
    if after_writes:
        stream = GraphUpdateStream(200, batch=64, seed=9)
        for i in range(5):
            u = stream[i]
            for s in (rs, ts):
                s.insert_edges(u["insert"])
                s.delete_edges(u["delete"])
    seeds = np.random.default_rng(1).choice(200, 12, replace=False).astype(np.int64)
    with rs.read_view() as rv, ts.read_view() as tv:
        want = RSampler(rv.scan, fanouts=[5, 3], seed=7).sample(seeds)
        got = NeighborSampler(tv.scan, fanouts=[5, 3], seed=7).sample(seeds)
    assert got.n_seeds == want.n_seeds and len(got.blocks) == len(want.blocks)
    assert_same(got.nodes, want.nodes)
    for gb, wb in zip(got.blocks, want.blocks):
        assert gb.n_edges == wb.n_edges > 0
        assert_same(gb.src, wb.src)
        assert_same(gb.dst, wb.dst)
    for g, w in zip(pad_subgraph(got, 512, 256), r_pad(want, 512, 256)):
        assert_same(g, w)


def test_pad_subgraph_overflow_raises():
    sub = NeighborSampler(lambda u: np.arange(5, dtype=np.int32), [5], 0).sample(
        np.arange(3, dtype=np.int64))
    with pytest.raises(ValueError, match="static bounds"):
        pad_subgraph(sub, 2, 100)
    with pytest.raises(ValueError, match="static bounds"):
        pad_subgraph(sub, 100, 4)


def test_batch_graphs_matches_reference():
    got, want = batch_graphs(4, 5, 6, seed=2, d_feat=3), r_batch_graphs(4, 5, 6, seed=2, d_feat=3)
    assert got.keys() == want.keys()
    for k in want:
        assert_same(got[k], want[k])


def test_pipelines_match_reference():
    for i in (0, 3):
        for got, want in ((TP.SyntheticTokens(100, 4, 8, seed=1)[i],
                           RP.SyntheticTokens(100, 4, 8, seed=1)[i]),
                          (TP.SyntheticTokens(100, 4, 8).shard(i, 1, 2),
                           RP.SyntheticTokens(100, 4, 8).shard(i, 1, 2)),
                          (TP.GraphUpdateStream(50, batch=32, seed=5)[i],
                           RP.GraphUpdateStream(50, batch=32, seed=5)[i]),
                          (TP.RecsysBatches(1000, 8, seed=2)[i],
                           RP.RecsysBatches(1000, 8, seed=2)[i])):
            assert got.keys() == want.keys()
            for k in want:
                assert_same(got[k], want[k])


def test_prefetcher_matches_reference():
    src = TP.SyntheticTokens(100, 2, 4)
    got, want = TP.Prefetcher(src, start=5, depth=2), RP.Prefetcher(src, start=5, depth=2)
    try:
        for _ in range(3):
            assert_same(next(got)["tokens"], next(want)["tokens"])
    finally:
        got.close()
        want.close()


def test_dynamic_graph_gnn_training_end_to_end():
    """Writers mutate the store while a reader-trainer samples snapshots and
    takes GNN steps — loss must stay finite and decrease on fixed labels."""
    n = 256
    store = RapidStore.from_edges(n, uniform_edges(n, 3000, seed=0), partition_size=32,
                                  B=32, tracer_k=8, device="cpu")
    cfg = registry.get_smoke_config("gin-tu")
    d_feat = 8
    rng = np.random.default_rng(0)
    feat_table = rng.normal(size=(n, d_feat)).astype(np.float32)
    label_table = (feat_table.sum(1) > 0).astype(np.int32)  # learnable signal

    params = G.init_gnn(cfg, torch.Generator().manual_seed(0), d_feat, device="cpu")
    opt = adamw.init(params)
    MAX_N, MAX_E = 512, 1024
    step = make_gnn_train_step(cfg, n_nodes=MAX_N, lr=5e-3)

    stop = threading.Event()
    write_errors = []

    def writer():
        stream = GraphUpdateStream(n, batch=64, seed=9)
        i = 0
        try:
            while not stop.is_set() and i < 50:
                u = stream[i]
                store.insert_edges(u["insert"])
                store.delete_edges(u["delete"])
                i += 1
        except Exception as e:  # pragma: no cover
            write_errors.append(e)

    w = threading.Thread(target=writer)
    w.start()
    losses = []
    try:
        for it in range(12):
            with store.read_view() as view:
                sampler = NeighborSampler(view.scan, fanouts=[4, 3], seed=it)
                seeds = rng.choice(n, 24, replace=False).astype(np.int64)
                sub = sampler.sample(seeds)
                nodes, src, dst, nmask, emask = pad_subgraph(sub, MAX_N, MAX_E)
            feats = feat_table[nodes] * nmask[:, None]
            labels = label_table[nodes]
            lmask = np.zeros(MAX_N, np.float32)
            lmask[: sub.n_seeds] = 1.0  # supervise seeds only
            params, opt, metrics = step(
                params, opt, torch.from_numpy(feats), torch.from_numpy(src),
                torch.from_numpy(dst), torch.from_numpy(emask), torch.from_numpy(labels),
                torch.from_numpy(lmask))
            losses.append(float(metrics["loss"]))
    finally:
        stop.set()
        w.join(timeout=60)
    assert not w.is_alive()
    assert not write_errors
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # learned something on a moving graph
    store.check_invariants()


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train_gnn", *args],
                          env=env, capture_output=True, text=True, timeout=300)


def test_train_gnn_launcher_on_cpu_and_resume(tmp_path):
    out = _launch("--device", "cpu", "--smoke", "--steps", "3", "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "done: 3 steps" in out.stdout and out.stdout.rstrip().endswith("OK")
    assert (tmp_path / "step_000000002" / "_COMPLETE").exists()
    # resume restores (params, AdamWState) from the checkpoint it wrote
    out = _launch("--device", "cpu", "--smoke", "--steps", "5", "--ckpt-dir", str(tmp_path),
                  "--resume")
    assert out.returncode == 0, out.stderr
    assert "resumed from step 2" in out.stdout and "done: 2 steps" in out.stdout


def test_train_gnn_launcher_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from repro_torch.launch import train_gnn

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_gnn.main(["--smoke", "--steps", "1"])
