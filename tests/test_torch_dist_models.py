"""The port's sharded model forms against the reference's own, on the CPU.

The reference's ``shard_map`` forms run once per module, in one subprocess
with eight forced host devices (``_subproc.run_sub``): the row-sharded
lookup, the sequence-parallel decode attention, the two sharded MoE forms,
the bf16-wire GNN gather and scatter with their VJPs, a GNN train step
through them, the int8 compressed reduce and the elastic reshard, on the
inputs of ``_torch_dist_cases`` (numpy, fixed seeds).  Every output and
gradient goes into one ``.npz``; the port runs the same cases on CPU
shards of a mesh of the same shape and is held against it here.

Limits, per case:
- lookup: output bitwise; table gradient within f32 ``rtol=1e-6``;
- SP attention: ``rtol=2e-4, atol=2e-5`` (the reference's own test);
- sharded MoE: ``rtol=3e-4, atol=3e-5`` (the reference's own test);
- gather forward: bitwise (both take ``h.bfloat16()[idx]``); the scatter
  backward: bitwise (an all-gather and a take, no sum); the gather
  backward and the scatter forward sum bf16 partials: bitwise too.  Both
  packages accumulate the partials in f32 in shard order and round to
  bf16 once (XLA's CPU all-reduce does; the port's ``psum`` and
  ``psum_scatter`` do the same for bf16 and f16 parts), and the scatter's
  result is not the exact sum of the f32 partials: the wire really is
  bf16;
- the GNN step (gin-smoke, 2 layers, f32 AdamW moments): loss within
  ``GNN_LOSS_RTOL`` and each first moment (0.1 x the gradient) within
  ``GNN_GRAD_TOL`` of its leaf's largest magnitude.  With the wire sums
  bitwise, the loss is equal and the leaves differ by up to 1.3e-6 of
  their largest magnitude (measured: f32 sums inside the layers differ);
  the limits are 2^-6 and 1e-3.  Two controls fall outside: the
  reference's own unsharded step (f32 sums, no bf16 wire: 0.14 in a
  leaf) and the port's step with its edges reversed (3e-2 in the loss);
- compressed reduce: each shard's mean within 1e-6 of the reference's
  largest magnitude, and within the reference's ``2 x scale`` of the
  plain f32 mean;
- elastic reshard from 8 shards to 2: every block bitwise.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist_cases as C
from _subproc import run_sub

from repro_torch.checkpoint.elastic import reshard
from repro_torch.configs import registry
from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.launch.collectives import P, shard, unshard
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.models.bst import make_sharded_lookup, place_table
from repro_torch.models.gnn import make_shardmap_gather, make_shardmap_scatter
from repro_torch.models.params import gnn_params_from_numpy
from repro_torch.optim import adamw
from repro_torch.optim.compression import psum_compressed, quantize_int8
from repro_torch.optim.tree import tree_leaves
from repro_torch.roofline.comm import CommCounter
from repro_torch.serve.decode import (init_sp_cache, make_decode_step, make_sp_attn_fn,
                                      place_sp_cache, sp_cache_spec)
from repro_torch.train.step import make_gnn_train_step

TESTS = str(Path(__file__).resolve().parent)
GNN_LOSS_RTOL = 1e-3
GNN_GRAD_TOL = 2.0 ** -6  # of each leaf's largest magnitude

REFERENCE = """
import sys
sys.path.insert(0, {tests!r})
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
assert len(jax.devices()) == 8
import _torch_dist_cases as C
from repro.checkpoint.elastic import reshard
from repro.configs import registry
from repro.configs.base import LMConfig, MoEConfig
from repro.jax_compat import shard_map
from repro.launch.mesh import make_mesh
from repro.models.bst import make_sharded_lookup
from repro.models.gnn import init_gnn, make_shardmap_gather, make_shardmap_scatter
from repro.models.moe import make_sharded_moe_ffn, make_weight_stationary_moe_ffn
from repro.optim import adamw
from repro.optim.compression import psum_compressed, quantize_int8
from repro.serve.decode import make_sp_attn_fn
from repro.train.step import make_gnn_train_step

out = {{}}
meshes = {{n: make_mesh(s, a) for n, (s, a) in C.MESHES.items()}}

def save_tree(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

table, ids, cot = C.lookup_inputs()
for name, (m, axis, batch) in C.LOOKUPS.items():
    fn = make_sharded_lookup(meshes[m], axis, batch_axes=batch)
    with meshes[m]:
        y, vjp = jax.vjp(lambda t: fn(t, ids), table)
        out["lookup_" + name], out["lookup_grad_" + name] = np.asarray(y), np.asarray(vjp(cot)[0])

q, kc, vc = C.attn_inputs()
for name, (m, seq, batch, pos, win, cap) in C.SP_ATTN.items():
    fn = make_sp_attn_fn(meshes[m], seq, batch_axes=batch)
    with meshes[m]:
        out["attn_" + name] = np.asarray(jax.jit(lambda *a: fn(*a, cap))(
            q, kc, vc, jnp.int32(pos), jnp.int32(win)))

lw, x = C.moe_inputs()
cfg = LMConfig(**C.MOE_LM, moe=MoEConfig(**C.MOE))
mesh = meshes["m24"]
with mesh:
    out["moe_sharded"] = np.asarray(jax.jit(make_sharded_moe_ffn(cfg, mesh, "data", "model"))(lw, x))
    out["moe_stationary"] = np.asarray(jax.jit(
        make_weight_stationary_moe_ffn(cfg, mesh, "data", "model"))(lw, x))

h, idx, msgs, g_edges, g_nodes = C.gather_inputs()
for name, (m, node_axes, edge_axes) in C.GATHER.items():
    gf = make_shardmap_gather(meshes[m], node_axes, edge_axes)
    sf = make_shardmap_scatter(meshes[m], node_axes, edge_axes, C.N_NODES)
    with meshes[m]:
        y, vjp = jax.vjp(lambda t: gf(t, idx), h)
        out["gather_" + name], out["gather_grad_" + name] = np.asarray(y), np.asarray(vjp(g_edges)[0])
        y, vjp = jax.vjp(lambda t: sf(t, idx), msgs)
        out["scatter_" + name], out["scatter_grad_" + name] = np.asarray(y), np.asarray(vjp(g_nodes)[0])

gcfg = registry.get_smoke_config(C.GNN_ARCH)
params = init_gnn(gcfg, jax.random.PRNGKey(3), C.GNN_D_FEAT)
b = C.gnn_batch()
args = (b["feats"], b["src"], b["dst"], b["emask"], b["labels"], b["lmask"])
axes = ("data", "model")
step = make_gnn_train_step(gcfg, C.N_NODES, lr=C.GNN_LR,
                           gather_fn=make_shardmap_gather(mesh, axes, axes),
                           scatter_fn=make_shardmap_scatter(mesh, axes, axes, C.N_NODES))
plain = make_gnn_train_step(gcfg, C.N_NODES, lr=C.GNN_LR)
save_tree("gnn_params/", params)
for name, fn in (("sharded", step), ("plain", plain)):
    with mesh:
        p1, o1, met = jax.jit(fn)(params, adamw.init(params, moment_dtype=jnp.float32), *args)
    out[f"gnn_{{name}}_loss"] = np.asarray(met["loss"])
    save_tree(f"gnn_{{name}}_mu/", o1.mu)

g = C.grad_rows()
for name, spec, axis in (("pod4", P("pod", None), "pod"),
                         ("m24", P(("data", "model"), None), "data")):
    m = meshes[name]

    @partial(shard_map, mesh=m, in_specs=spec, out_specs=spec, check_vma=False)
    def reduce_fn(g_local):
        q, s = quantize_int8(g_local[0])
        return psum_compressed({{"g": q}}, {{"g": s}}, axis)["g"][None]

    with m:
        out["psum_" + name] = np.asarray(jax.jit(reduce_fn)(g[:m.devices.size]))

tree = C.elastic_tree()
specs = {{"w": P("data", None), "b": P()}}
placed = reshard(tree, specs, meshes["d8"])
placed2 = reshard(jax.tree.map(np.asarray, placed), specs, meshes["d2"])
for s in placed2["w"].addressable_shards:
    out[f"elastic_w_from_row{{s.index[0].start}}"] = np.asarray(s.data)
out["elastic_w"], out["elastic_b"] = np.asarray(placed2["w"]), np.asarray(placed2["b"])
np.savez({path!r}, **out)
print("reference mesh forms OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's sharded forms on eight forced host devices, run once."""
    path = tmp_path_factory.mktemp("ref_mesh") / "forms.npz"
    run_sub(REFERENCE.format(tests=TESTS, path=str(path)), devices=8)
    with np.load(path) as z:
        return dict(z)


def mesh_of(name):
    shape, axes = C.MESHES[name]
    return make_host_mesh(shape, axes)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(C.LOOKUPS))
def test_sharded_lookup_matches_reference(ref, name):
    m, axis, batch = C.LOOKUPS[name]
    table, ids, cot = C.lookup_inputs()
    tab = t(table).requires_grad_()
    out = make_sharded_lookup(mesh_of(m), axis, batch_axes=batch)(tab, t(ids))
    (grad,) = torch.autograd.grad(out, tab, t(cot))
    assert np.array_equal(out.detach().numpy(), ref["lookup_" + name])
    assert np.array_equal(ref["lookup_" + name], table[ids])
    want = ref["lookup_grad_" + name]
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", list(C.SP_ATTN))
def test_sp_attention_matches_reference(ref, name):
    m, seq, batch, pos, win, cap = C.SP_ATTN[name]
    q, kc, vc = map(t, C.attn_inputs())
    out = make_sp_attn_fn(mesh_of(m), seq, batch_axes=batch)(q, kc, vc, pos, win, cap)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), ref["attn_" + name], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("form", ["sharded", "stationary"])
def test_sharded_moe_matches_reference(ref, form):
    lw, x = C.moe_inputs()
    cfg = LMConfig(**C.MOE_LM, moe=MoEConfig(**C.MOE))
    make = TM.make_sharded_moe_ffn if form == "sharded" else TM.make_weight_stationary_moe_ffn
    out = make(cfg, mesh_of("m24"), "data", "model")({k: t(v) for k, v in lw.items()}, t(x))
    np.testing.assert_allclose(out.numpy(), ref["moe_" + form], rtol=3e-4, atol=3e-5)


def edge_partials(mesh, edge_axes, idx, rows, n_total):
    """Each edge shard's float64 segment sum of its ``rows`` onto
    ``n_total`` nodes: [n_edge_shards, n_total, d]."""
    n = mesh.axis_size(edge_axes)
    per = len(idx) // n
    out = np.zeros((n, n_total, rows.shape[1]))
    for k in range(n):
        np.add.at(out[k], idx[k * per:(k + 1) * per], rows[k * per:(k + 1) * per])
    return out


@pytest.mark.parametrize("name", list(C.GATHER))
def test_shardmap_gather_matches_reference(ref, name):
    m, node_axes, edge_axes = C.GATHER[name]
    mesh = mesh_of(m)
    h, idx, _, g_edges, _ = C.gather_inputs()
    ht = t(h).requires_grad_()
    out = make_shardmap_gather(mesh, node_axes, edge_axes)(ht, t(idx))
    (grad,) = torch.autograd.grad(out, ht, t(g_edges))
    assert np.array_equal(out.detach().numpy(), ref["gather_" + name])
    # the backward: bf16 sums of the edge shards' partials, rounded once
    assert np.array_equal(grad.numpy(), ref["gather_grad_" + name])


@pytest.mark.parametrize("name", list(C.GATHER))
def test_shardmap_scatter_matches_reference(ref, name):
    m, node_axes, edge_axes = C.GATHER[name]
    mesh = mesh_of(m)
    _, idx, msgs, _, g_nodes = C.gather_inputs()
    mt = t(msgs).requires_grad_()
    out = make_shardmap_scatter(mesh, node_axes, edge_axes, C.N_NODES)(mt, t(idx))
    (grad,) = torch.autograd.grad(out, mt, t(g_nodes))
    got = out.detach().numpy()
    assert np.array_equal(got, ref["scatter_" + name])
    # within a bf16 sum's bound of the exact sum, and not equal to it: the
    # wire really is bf16-rounded
    partials = edge_partials(mesh, edge_axes, idx, msgs, C.N_NODES)
    exact = partials.sum(axis=0)
    got = got.astype(np.float64)
    assert np.all(np.abs(got - exact) <= C.bf16_sum_bound(partials))
    assert not np.array_equal(got, exact)
    assert np.array_equal(grad.numpy(), ref["scatter_grad_" + name])


def shard_sizes_checked(mesh):
    """A node or edge count that does not divide raises; nothing pads."""
    h = torch.zeros(C.N_NODES + 2, C.D)
    with pytest.raises(ValueError, match="not divisible"):
        make_shardmap_gather(mesh, ("data", "model"), ("data", "model"))(
            h, torch.zeros(C.N_EDGES, dtype=torch.long))
    with pytest.raises(ValueError, match="not divisible"):
        make_shardmap_scatter(mesh, ("data", "model"), ("data", "model"), C.N_NODES)(
            torch.zeros(C.N_EDGES - 4, C.D), torch.zeros(C.N_EDGES - 4, dtype=torch.long))


def test_shardmap_forms_refuse_sizes_that_do_not_divide():
    shard_sizes_checked(mesh_of("m24"))


def unflatten(ref, prefix):
    tree = {}
    for key, leaf in ref.items():
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[last] = leaf
    return tree


def test_gnn_train_step_through_shardmap_forms_matches_reference(ref):
    cfg = registry.get_smoke_config(C.GNN_ARCH)
    mesh = mesh_of("m24")
    axes = ("data", "model")
    params = gnn_params_from_numpy(cfg, unflatten(ref, "gnn_params/"), C.GNN_D_FEAT,
                                   device="cpu")
    b = {k: t(v) for k, v in C.gnn_batch().items()}
    step = make_gnn_train_step(cfg, C.N_NODES, lr=C.GNN_LR,
                               gather_fn=make_shardmap_gather(mesh, axes, axes),
                               scatter_fn=make_shardmap_scatter(mesh, axes, axes, C.N_NODES))
    def run(src, dst):
        return step(params, adamw.init(params, moment_dtype=torch.float32),
                    b["feats"], src, dst, b["emask"], b["labels"], b["lmask"])

    _, opt, met = run(b["src"], b["dst"])
    want_loss = float(ref["gnn_sharded_loss"])
    assert abs(float(met["loss"]) - want_loss) <= GNN_LOSS_RTOL * abs(want_loss)
    reversed_loss = float(run(b["dst"], b["src"])[2]["loss"])
    assert abs(reversed_loss - want_loss) > GNN_LOSS_RTOL * abs(want_loss)

    def errs(mu_prefix):
        want = tree_leaves(unflatten(ref, mu_prefix))
        return [float(np.abs(g.numpy().astype(np.float64) - w).max() / np.abs(w).max())
                for g, w in zip(tree_leaves(opt.mu), want)]

    assert len(errs("gnn_sharded_mu/")) == len(tree_leaves(params))
    assert max(errs("gnn_sharded_mu/")) <= GNN_GRAD_TOL
    # the control: the unsharded step (f32 sums, no bf16 wire) falls outside
    assert max(errs("gnn_plain_mu/")) > GNN_GRAD_TOL


@pytest.mark.parametrize("name,spec,axis", [("pod4", P("pod", None), "pod"),
                                            ("m24", P(("data", "model"), None), "data")])
def test_psum_compressed_matches_reference(ref, name, spec, axis):
    mesh = mesh_of(name)
    g = C.grad_rows()[:mesh.size]
    rows = shard(t(g), mesh, spec)
    pairs = [quantize_int8(r[0]) for r in rows]
    means = psum_compressed([{"g": q} for q, _ in pairs], [{"g": s} for _, s in pairs],
                            mesh, axis)
    got = unshard([m["g"][None] for m in means], mesh, spec).numpy()
    want = ref["psum_" + name]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    # within the reference's 2 x scale of the plain mean over each group
    scale = np.abs(g).max() / 127
    for group in mesh.groups(axis):
        plain = g[group].mean(axis=0)
        assert np.all(np.abs(got[group] - plain) < 2 * scale)


def test_elastic_reshard_8_to_2_bitwise(ref):
    tree, specs = C.elastic_tree(), {"w": P("data", None), "b": P()}
    mesh8, mesh2 = mesh_of("d8"), mesh_of("d2")
    placed = reshard(tree, specs, mesh8)
    assert len(placed["w"]) == 8 and all(p.shape == (1, 4) for p in placed["w"])
    back = {k: unshard(placed[k], mesh8, specs[k]).numpy() for k in tree}
    placed2 = reshard(back, specs, mesh2)
    for k, blk in enumerate(placed2["w"]):
        assert np.array_equal(blk.numpy(), ref[f"elastic_w_from_row{4 * k}"])
    for k in tree:
        got = unshard(placed2[k], mesh2, specs[k]).numpy()
        assert np.array_equal(got, ref["elastic_" + k]) and np.array_equal(got, tree[k])


# ---------------------------------------------------------------------------
# placed state: the same forms, their tables, expert weights and caches
# cut once (``collectives.place``), bitwise the per-call route on four
# CPU shards (which the tests above hold against the reference)
FOUR = {"model4": ((4,), ("model",)), "d2m2": ((2, 2), ("data", "model"))}


@pytest.mark.parametrize("name", list(FOUR))
def test_placed_lookup_bitwise_the_per_call_route(name):
    mesh = make_host_mesh(*FOUR[name])
    table, ids, _ = C.lookup_inputs()
    batch = "data" if "data" in mesh.shape else None
    lookup = make_sharded_lookup(mesh, "model", batch_axes=batch)
    placed = place_table(t(table), mesh)
    with CommCounter() as c:
        got = lookup(placed, t(ids))
    assert torch.equal(got, lookup(t(table), t(ids)))
    assert "shard-copy" not in c.stats()["counts"]  # one device: nothing copied


@pytest.mark.parametrize("form", ["sharded", "stationary"])
def test_placed_moe_forms_bitwise_the_per_call_route(form):
    """Both forms on a (data=2, model=2) mesh, each of two stacked layers'
    weights placed by the form's specs, against the same weights whole."""
    mesh = make_host_mesh(*FOUR["d2m2"])
    lw, x = C.moe_inputs()
    cfg = LMConfig(**C.MOE_LM, moe=MoEConfig(**C.MOE))
    rng = np.random.default_rng(11)
    layers = {k: torch.stack([t(v), t(v + 0.1 * rng.normal(size=v.shape).astype(v.dtype))])
              for k, v in lw.items()}
    if form == "sharded":
        make, specs = TM.make_sharded_moe_ffn, TM.sharded_specs("model")
    else:
        make, specs = TM.make_weight_stationary_moe_ffn, TM.weight_stationary_specs("data")
    moe_fn = make(cfg, mesh, "data", "model")
    placed = TM.place_experts({"layers": layers}, mesh, specs)["layers"]
    for i in range(2):
        got = moe_fn({k: v[i] for k, v in placed.items()}, t(x))
        assert torch.equal(got, moe_fn({k: v[i] for k, v in layers.items()}, t(x)))


def granite_smoke():
    cfg = registry.get_smoke_config("granite-moe-3b-a800m")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def test_placed_sp_decode_bitwise_the_per_call_route():
    """Granite's SMOKE config on (data=2, model=2): SP attention over
    ``model`` and the weight-stationary MoE, with the experts placed and
    the cache allocated per shard (``init_sp_cache``), against the same
    step on the whole weights and cache: logits bitwise at every step,
    across the cache's slice boundaries (16 positions, 8 a slice), and the
    two caches equal at the end."""
    mesh = make_host_mesh(*FOUR["d2m2"])
    cfg, params = granite_smoke()
    step = make_decode_step(cfg, torch.float32, attn_fn=make_sp_attn_fn(mesh, ("model",), "data"),
                            moe_fn=TM.make_weight_stationary_moe_ffn(cfg, mesh, "data", "model"))
    placed = TM.place_experts(params, mesh, TM.weight_stationary_specs("data", "model"))
    whole = T.init_cache(cfg, 4, 16, dtype=torch.float32, device="cpu")
    per_shard = init_sp_cache(cfg, 4, 16, mesh, ("model",), "data", dtype=torch.float32)
    assert [tuple(p.shape) for p in per_shard["k"].parts] == \
        [(cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.d_head)] * 4
    tok = torch.from_numpy(np.random.default_rng(12).integers(0, cfg.vocab, (4, 1), dtype=np.int32))
    for pos in range(12):
        want, nxt, _ = step(params, whole, tok, pos)
        got, _, _ = step(placed, per_shard, tok, pos)
        assert torch.equal(got, want), pos
        tok = nxt[:, None]
    spec = sp_cache_spec(("model",), "data")
    for name in ("k", "v"):
        assert torch.equal(unshard(per_shard[name].parts, mesh, spec), whole[name])
    # a whole cache placed once continues the same decode
    again = place_sp_cache(whole, mesh, ("model",), "data")
    want, _, _ = step(params, whole, tok, 12)
    got, _, _ = step(placed, again, tok, 12)
    assert torch.equal(got, want)


def test_placed_decode_cache_write_lands_in_the_slice_that_owns_pos():
    """Positions 7, 8 and 15 of a 16-position cache over 4 seq shards
    (slices of 4): each step writes its token's K/V into one slice only."""
    mesh = make_host_mesh((4,), ("model",))
    cfg, params = granite_smoke()
    step = make_decode_step(cfg, torch.float32, attn_fn=make_sp_attn_fn(mesh, ("model",)))
    cache = init_sp_cache(cfg, 2, 16, mesh, ("model",), dtype=torch.float32)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for pos in (3, 4, 7, 8, 15):
        before = [p.clone() for p in cache["k"].parts]
        step(params, cache, tok, pos)
        changed = [k for k, (a, b) in enumerate(zip(before, cache["k"].parts))
                   if not torch.equal(a, b)]
        assert changed == [pos // 4], pos
        assert cache["k"].parts[pos // 4][:, :, pos % 4].abs().sum() > 0
