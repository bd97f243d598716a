"""GNN training on the card (``cuda`` marker; skipped where torch sees no
CUDA device).  Imports no JAX, so it collects where only torch is
installed: the card's segment ops, gradients and launcher against the
port's own CPU route."""

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.graph import segment_ops as S
from repro_torch.graph.sampler import NeighborSampler, pad_subgraph
from repro_torch.models import gnn as G
from repro_torch.optim.tree import tree_leaves, tree_map
from repro_torch.train.step import gnn_value_and_grad

ARCHS = ("gcn-cora", "gin-tu", "gatedgcn", "pna")
OPS = ("segment_sum", "segment_max", "segment_min", "segment_mean", "segment_std",
       "segment_softmax")
GRAD_TOL = 1e-4  # of each leaf's largest magnitude
D_FEAT, MAX_N, MAX_E = 6, 96, 160

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")]


def leaf_errs(got, want):
    return [float((g - w).abs().max() / max(float(w.abs().max()), 1e-30))
            for g, w in zip(got, want)]


@pytest.mark.parametrize("name", OPS)
def test_segment_op_on_card_matches_cpu(name):
    """Empty segments (7, 8) and planted ties at segment 2's max and min."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 7, size=40).astype(np.int32)
    ids[:4] = 2
    data = rng.normal(size=(40, 3)).astype(np.float32)
    data[:2], data[2:4] = 9.0, -9.0
    if name == "segment_softmax":
        data = data[:, 0]
    cot = rng.normal(size=(9,) + data.shape[1:]).astype(np.float32)
    if name == "segment_softmax":
        cot = rng.normal(size=data.shape).astype(np.float32)
    res = []
    for dev in ("cpu", "cuda"):
        x = torch.from_numpy(data).to(dev).requires_grad_()
        out = getattr(S, name)(x, torch.from_numpy(ids).to(dev), 9)
        g, = torch.autograd.grad(torch.sum(torch.where(
            torch.isfinite(out), out, 0.0) * torch.from_numpy(cot).to(dev)), x)
        res.append((out.detach().cpu(), g.cpu()))
    (want, want_g), (got, got_g) = res
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_grads_on_card_match_cpu(arch):
    """As the chip script's step-0 check: the loss within 1e-4, every leaf
    within 1e-4 of its largest magnitude or ten times the CPU route's own
    f32 error (against float64), whichever is larger."""
    cfg = registry.get_smoke_config(arch)
    rng = np.random.default_rng(1)
    adj = [np.unique(rng.integers(0, 60, size=rng.integers(0, 8))) for _ in range(60)]
    sub = NeighborSampler(lambda u: adj[u], [4, 3], seed=1).sample(np.arange(8, dtype=np.int64))
    nodes, src, dst, nmask, emask = pad_subgraph(sub, MAX_N, MAX_E)
    feat = torch.from_numpy(rng.normal(size=(MAX_N, D_FEAT)).astype(np.float32) * nmask[:, None])
    labels = torch.from_numpy(rng.integers(0, cfg.n_classes, size=MAX_N))
    lmask = (torch.arange(MAX_N) < 8).float()
    params = G.init_gnn(cfg, torch.Generator().manual_seed(0), D_FEAT, device="cpu")
    out = {}
    for dev, dtype in (("cpu", torch.float64), ("cpu", torch.float32), ("cuda", torch.float32)):
        p = tree_map(lambda t: t.to(dev, dtype), params)
        loss, grads = gnn_value_and_grad(
            cfg, p, feat.to(dev, dtype), torch.from_numpy(src).to(dev),
            torch.from_numpy(dst).to(dev), torch.from_numpy(emask).to(dev), labels.to(dev),
            lmask.to(dev, dtype), MAX_N)
        out[dev, dtype] = (float(loss), [g.double().cpu() for g in tree_leaves(grads)])
    (_, g64), (l32, g32), (lc, gc) = (out["cpu", torch.float64], out["cpu", torch.float32],
                                      out["cuda", torch.float32])
    np.testing.assert_allclose(lc, l32, rtol=1e-4)
    limits = [max(GRAD_TOL, 10 * e) for e in leaf_errs(g32, g64)]
    errs = leaf_errs(gc, g32)
    assert all(e <= lim for e, lim in zip(errs, limits)), (errs, limits)


def test_train_gnn_launcher_on_card(tmp_path):
    from repro_torch.launch import train_gnn

    out = train_gnn.main(["--smoke", "--steps", "3", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert all(t.device.type == "cuda" for t in tree_leaves(out["params"]))
