"""The model side of the mesh on the card (``cuda`` marker; skipped where
torch sees no CUDA device).  Imports no JAX: each sharded form runs on
four shards on the card (all on ``cuda:0`` with one card) and on four CPU
shards, on the same inputs (``_torch_dist_cases``), and the two are held
against each other.  The card's segment sums and ``index_add_`` add with
atomics, so f32 sums agree within f32 rounding of their order, and bf16
wire sums within ``bf16_sum_bound``."""

import numpy as np
import pytest
import torch

import _torch_dist_cases as C

from repro_torch.checkpoint.elastic import reshard
from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.launch.collectives import P, shard, unshard
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as TM
from repro_torch.models.bst import make_sharded_lookup
from repro_torch.models.gnn import make_shardmap_gather, make_shardmap_scatter
from repro_torch.optim.compression import psum_compressed, quantize_int8
from repro_torch.serve.decode import make_sp_attn_fn

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")]


def meshes(shape=(2, 2), axes=("data", "model")):
    return [make_mesh(shape, axes, device=d) for d in ("cpu", "cuda")]


def both(fn, *arrays):
    """``fn(mesh, *tensors)`` on four CPU shards and on four card shards."""
    return [fn(m, *[torch.from_numpy(np.ascontiguousarray(a)).to(m.flat_devices[0])
                    for a in arrays]) for m in meshes()]


def test_mesh_puts_shard_k_on_card_k_mod_n():
    mesh = make_mesh((2, 2), ("data", "model"))
    n = torch.cuda.device_count()
    assert [d.index for d in mesh.flat_devices] == [k % n for k in range(4)]


def test_sharded_lookup_on_card():
    table, ids, cot = C.lookup_inputs()

    def run(mesh, tab, i, g):
        tab = tab.requires_grad_()
        n0 = embedding_bag.launches
        out = make_sharded_lookup(mesh, "model", batch_axes="data")(tab, i)
        launches = embedding_bag.launches - n0
        (grad,) = torch.autograd.grad(out, tab, g)
        return out.detach().cpu(), grad.cpu(), launches

    cpu, card = both(run, table, ids, cot)
    assert torch.equal(card[0], cpu[0]) and card[2] == 4  # one kernel launch a shard
    torch.testing.assert_close(card[1], cpu[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(C.SP_ATTN))
def test_sp_attention_on_card(name):
    _, seq, batch, pos, win, cap = C.SP_ATTN[name]

    def run(mesh, q, k, v):
        return make_sp_attn_fn(mesh, seq, batch_axes=batch)(q, k, v, pos, win, cap).cpu()

    cpu, card = both(run, *C.attn_inputs())
    torch.testing.assert_close(card, cpu, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("form", ["sharded", "stationary"])
def test_sharded_moe_on_card(form):
    lw, x = C.moe_inputs()
    cfg = LMConfig(**C.MOE_LM, moe=MoEConfig(**C.MOE))
    make = TM.make_sharded_moe_ffn if form == "sharded" else TM.make_weight_stationary_moe_ffn
    keys = sorted(lw)

    def run(mesh, x, *w):
        return make(cfg, mesh, "data", "model")(dict(zip(keys, w)), x).cpu()

    cpu, card = both(run, x, *[lw[k] for k in keys])
    torch.testing.assert_close(card, cpu, rtol=1e-5, atol=1e-5)


def test_shardmap_gather_and_scatter_on_card():
    h, idx, msgs, g_edges, g_nodes = C.gather_inputs()
    axes = ("data", "model")

    def run(mesh, h, idx, msgs, ge, gn):
        h, msgs = h.requires_grad_(), msgs.requires_grad_()
        y = make_shardmap_gather(mesh, axes, axes)(h, idx)
        z = make_shardmap_scatter(mesh, axes, axes, C.N_NODES)(msgs, idx)
        (gh,) = torch.autograd.grad(y, h, ge)
        (gm,) = torch.autograd.grad(z, msgs, gn)
        return [t.detach().cpu().double().numpy() for t in (y, gh, z, gm)]

    cpu, card = both(run, h, idx, msgs, g_edges, g_nodes)
    assert np.array_equal(card[0], cpu[0]) and np.array_equal(card[3], cpu[3])
    n = 4
    per = C.N_EDGES // n
    for got, want, rows in ((card[1], cpu[1], g_edges), (card[2], cpu[2], msgs)):
        partials = np.zeros((n, C.N_NODES, C.D))
        for k in range(n):
            np.add.at(partials[k], idx[k * per:(k + 1) * per], rows[k * per:(k + 1) * per])
        assert np.all(np.abs(got - want) <= C.bf16_sum_bound(partials))


def test_psum_compressed_and_reshard_on_card():
    g = C.grad_rows()[:4]

    def run(mesh, g):
        rows = shard(g, mesh, P(("data", "model"), None))
        pairs = [quantize_int8(r[0]) for r in rows]
        means = psum_compressed([{"g": q} for q, _ in pairs], [{"g": s} for _, s in pairs],
                                mesh, "data")
        return unshard([m["g"][None] for m in means], mesh, P(("data", "model"), None)).cpu()

    cpu, card = both(run, g)
    torch.testing.assert_close(card, cpu, rtol=1e-6, atol=1e-7)
    tree, specs = C.elastic_tree(), {"w": P("data", None), "b": P()}
    for shape in ((4,), (2,)):
        mesh = make_mesh(shape, ("data",))
        placed = reshard(tree, specs, mesh)
        assert all(p.is_cuda for p in placed["w"])
        for k in tree:
            assert np.array_equal(unshard(placed[k], mesh, specs[k]).cpu().numpy(), tree[k])
