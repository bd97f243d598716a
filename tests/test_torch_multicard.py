"""The port across four cards (``cuda`` marker; skipped where torch sees
fewer than four CUDA devices).  Imports no JAX: each path on four cards
(shard ``k`` on ``cuda:k``) against the same path with every shard on
``cuda:0``, and each kernel on ``cuda:1..3`` against its plain version.

- the six kernels on ``cuda:1``, ``cuda:2`` and ``cuda:3`` (the current
  card left at ``cuda:0``), at ``test_torch_kernels.py``'s tolerances;
  each launch counts on its tensor's card; operands on two cards raise;
- the shard plane over four cards against four shards on ``cuda:0``, in
  deterministic mode (``index_add_`` in a fixed order): all five
  collectives bitwise, and BFS, SSSP and WCC bitwise the single route;
- the sharded lookup with its table placed on the four cards, bitwise the
  same lookup on one card, moving only the ids between cards;
- granite's SMOKE config decoding sequence-parallel with placed experts
  and a per-card cache, within ``MESH_LOGITS_TOL`` (3e-4) of the same
  forms on one card; its copies between cards do not grow with the cache
  or the experts;
- gin's SMOKE step through the bf16-wire gather and scatter over four
  cards against four shards on ``cuda:0``, in deterministic mode.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import _torch_dist_cases as C
from _parity import rand_edges
from test_torch_kernels import (
    bag_inputs,
    decode_inputs,
    gather_inputs,
    intersect_inputs,
    search_inputs,
    spmm_order_bound,
    sum_order_bound,
)

import repro_torch.core.analytics as A
from repro_torch.configs import registry
from repro_torch.core import RapidStore
from repro_torch.kernels import runtime
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.intersect import intersect_count
from repro_torch.kernels.intersect.ref import intersect_count_ref
from repro_torch.kernels.leaf_search import leaf_search
from repro_torch.kernels.leaf_search.ref import leaf_search_ref
from repro_torch.kernels.spmm import leaf_scan_reduce, leaf_spmm, spmm_view
from repro_torch.kernels.spmm.ref import leaf_scan_reduce_ref, leaf_spmm_ref
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import gnn as G
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.models.bst import make_sharded_lookup, place_table
from repro_torch.optim import adamw
from repro_torch.optim.tree import tree_leaves
from repro_torch.roofline.comm import CommCounter
from repro_torch.serve.decode import init_sp_cache, make_decode_step, make_sp_attn_fn
from repro_torch.train.step import make_gnn_train_step

pytestmark = pytest.mark.cuda
CARDS = 4
MESH_LOGITS_TOL = 3e-4  # chip_smoke.py's limit for granite's f32 sharded decode


@pytest.fixture(autouse=True)
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        pytest.skip(f"needs {CARDS} CUDA devices")
    torch.cuda.set_device(0)


def one_card(mesh: Mesh) -> Mesh:
    """``mesh``'s shape and axes with every shard on ``cuda:0``."""
    return Mesh([torch.device("cuda", 0)] * mesh.size, tuple(mesh.shape.values()),
                mesh.axis_names)


def launched_on(fn):
    """``fn()`` and the launches it made per card."""
    runtime.drain()
    before = runtime.card_launches()
    out = fn()
    runtime.drain()
    after = runtime.card_launches()
    return out, {k: after.get(k, 0) - before.get(k, 0) for k in range(CARDS)}


def on(card: int, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(f"cuda:{card}") for a in arrays]


# ---------------------------------------------------------------------------
# the six kernels on cuda:1..3
def check_leaf_search(card):
    rows, targets = on(card, *search_inputs(128))
    (f, p), counts = launched_on(lambda: leaf_search(rows, targets))
    fr, pr = leaf_search_ref(rows, targets)
    assert torch.equal(f, fr) and torch.equal(p, pr)
    return f, counts


def check_leaf_scan_reduce(card):
    rows, x, _ = on(card, *gather_inputs(128))
    got, counts = launched_on(lambda: leaf_scan_reduce(rows, x))
    torch.testing.assert_close(got, leaf_scan_reduce_ref(rows, x), rtol=1e-5, atol=1e-5)
    return got, counts


def check_leaf_spmm(card):
    rows, _, h = on(card, *gather_inputs(128, d=160))
    length = (rows != np.iinfo(np.int32).max).sum(1).to(torch.int32)
    got, counts = launched_on(lambda: leaf_spmm(rows, h, length))
    want = leaf_spmm_ref(rows, h, length)
    assert ((got - want).abs() <= spmm_order_bound(rows, h, length, want)).all()
    return got, counts


def check_intersect_count(card):
    a, b = on(card, *intersect_inputs(128))
    got, counts = launched_on(lambda: intersect_count(a, b))
    assert torch.equal(got, intersect_count_ref(a, b))
    return got, counts


def check_embedding_bag(card):
    table, ids, w = on(card, *bag_inputs(1000, 32, 33, 20))
    got, counts = launched_on(lambda: embedding_bag(table, ids, w, mode="mean"))
    want = embedding_bag_ref(table, ids, w, "mean")
    assert ((got - want).abs() <= 1e-5 + 1e-5 * want.abs()
            + sum_order_bound(table, ids, w, "mean", want)).all()
    return got, counts


def check_flash_decode(card):
    q, k, v, kv_len = on(card, *decode_inputs(3, 1000, 4, 2, 128))
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)  # the tensor-core route
    got, counts = launched_on(lambda: flash_decode(q, k, v, kv_len, softcap=50.0))
    torch.testing.assert_close(got, flash_decode_ref(q, k, v, kv_len, softcap=50.0),
                               rtol=2e-4, atol=2e-5)
    return got, counts


KERNEL_CHECKS = {"leaf_search": check_leaf_search, "leaf_scan_reduce": check_leaf_scan_reduce,
                 "leaf_spmm": check_leaf_spmm, "intersect_count": check_intersect_count,
                 "embedding_bag": check_embedding_bag, "flash_decode": check_flash_decode}


@pytest.mark.parametrize("card", [1, 2, 3])
@pytest.mark.parametrize("kernel", list(KERNEL_CHECKS))
def test_kernel_on_another_card(kernel, card):
    """With ``cuda:0`` current, the kernel runs on its tensors' card: the
    result there matches the plain version and the launch counts on that
    card alone."""
    assert torch.cuda.current_device() == 0
    out, counts = KERNEL_CHECKS[kernel](card)
    assert out.device == torch.device("cuda", card)
    assert counts == {k: int(k == card) for k in range(CARDS)}


def test_mixed_card_operands_raise():
    rows, _, h = on(1, *gather_inputs(16))
    table, ids, _ = bag_inputs(100, 16, 12, 5)
    q, k, v, kv_len = on(2, *decode_inputs(2, 256, 2, 4, 64))
    cases = [lambda: leaf_spmm(rows, h.to("cuda:2")),
             lambda: leaf_scan_reduce(rows, torch.zeros(300, device="cuda:0")),
             lambda: leaf_search(rows[:, :8], torch.zeros(rows.shape[0], dtype=torch.int32,
                                                          device="cuda:3")),
             lambda: intersect_count(rows, rows.to("cuda:0")),
             lambda: embedding_bag(torch.from_numpy(table).cuda(1),
                                   torch.from_numpy(ids).cuda(2)),
             lambda: flash_decode(q.to("cuda:0"), k, v, kv_len)]
    before = runtime.card_launches()
    for fn in cases:
        with pytest.raises(ValueError, match="cuda:"):
            fn()
    assert runtime.card_launches() == before


# ---------------------------------------------------------------------------
# the shard plane
N, PART = 96, 8


def five(view, w, h):
    return {"pagerank": A.pagerank_view(view), "bfs": A.bfs_view(view, 0),
            "sssp": A.sssp_view(view, w, 0), "wcc": A.wcc_view(view),
            "spmm": spmm_view(view, h)}


@pytest.mark.parametrize("symmetric", [True, False])
def test_plane_across_cards_matches_one_card(symmetric):
    """Pull-PageRank when ``symmetric``, push otherwise; in deterministic
    mode every collective of the four-card plane is bitwise the four
    shards' on ``cuda:0``; ``leaf_spmm`` launches on every card."""
    store = RapidStore.from_edges(N, rand_edges(N, 2000, seed=0), undirected=symmetric,
                                  partition_size=PART, B=16, high_threshold=8, device="cuda")
    assert store.device == torch.device("cuda", 0)
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.normal(size=(N, 16)).astype(np.float32)).cuda()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with store.read_view() as v:
            w = torch.from_numpy((rng.random(v.n_edges) + 0.1).astype(np.float32)).cuda()
            single = five(v, w, h)
        got = {}
        for name, devices in (("cards", [f"cuda:{k}" for k in range(CARDS)]),
                              ("one", ["cuda:0"] * CARDS)):
            plane = store.attach_shard_plane(devices=devices, symmetric=symmetric)
            with store.read_view() as v:
                got[name], counts = launched_on(lambda: five(v, w, h))
            if name == "cards":
                assert [d.index for d in plane.devices] == list(range(CARDS))
                assert all(counts[k] > 0 for k in range(CARDS)), counts
            store.detach_shard_plane()
    finally:
        torch.use_deterministic_algorithms(was)
    for key in single:
        assert torch.equal(got["cards"][key], got["one"][key]), key
        assert got["cards"][key].device == torch.device("cuda", 0)
    for key in ("bfs", "sssp", "wcc") + (("pagerank",) if symmetric else ()):
        assert torch.equal(got["cards"][key], single[key]), key


# ---------------------------------------------------------------------------
# the model side of the mesh
def test_placed_lookup_across_cards():
    """The table placed over (model=4) on four cards: bitwise the lookup on
    one card, one ``embedding_bag`` launch on each card, and nothing but
    the ids (one copy for each other card) crosses between cards."""
    table, ids, _ = C.lookup_inputs()
    table, ids = torch.from_numpy(table).cuda(), torch.from_numpy(ids).cuda()
    mesh = make_mesh((CARDS,), ("model",), device="cuda")
    assert [d.index for d in mesh.flat_devices] == list(range(CARDS))
    placed = place_table(table, mesh)
    assert [p.device.index for p in placed.parts] == list(range(CARDS))
    with CommCounter() as c:
        got, counts = launched_on(lambda: make_sharded_lookup(mesh, "model")(placed, ids))
    assert counts == {k: 1 for k in range(CARDS)}
    assert c.stats()["bytes_by_op"].get("shard-copy", 0) == (CARDS - 1) * ids.nbytes
    want = make_sharded_lookup(one_card(mesh), "model")(table, ids)
    assert torch.equal(got, want) and torch.equal(got, table[ids.long()])


def granite_decode(cfg, mesh, placed: bool, steps: int, s: int):
    """``steps`` f32 decode steps of ``cfg`` over (data=2, model=2): the
    logits of each and the bytes ``shard`` copied between cards."""
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    step = make_decode_step(cfg, torch.float32,
                            attn_fn=make_sp_attn_fn(mesh, ("model",), "data"),
                            moe_fn=TM.make_weight_stationary_moe_ffn(cfg, mesh, "data", "model"))
    if placed:
        params = TM.place_experts(params, mesh, TM.weight_stationary_specs("data", "model"))
        cache = init_sp_cache(cfg, 4, s, mesh, ("model",), "data", dtype=torch.float32)
    else:
        cache = T.init_cache(cfg, 4, s, dtype=torch.float32, device="cuda")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (4, 1),
                                                             dtype=np.int32)).cuda()
    logits = []
    with CommCounter() as c:
        for pos in range(steps):
            lg, nxt, _ = step(params, cache, tok, pos)
            logits.append(lg)
            tok = nxt[:, None]
    return logits, c.stats()["bytes_by_op"].get("shard-copy", 0)


def test_sharded_decode_across_cards():
    """Granite's SMOKE config: the placed four-card route within
    ``MESH_LOGITS_TOL`` of the per-call route on one card, step by step;
    the four-card route's copies between cards are the same for a cache of
    16 or 64 positions and for experts twice as wide (only activations
    move), and below the per-call route's on four cards."""
    cfg = registry.get_smoke_config("granite-moe-3b-a800m")
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda")
    got, placed_bytes = granite_decode(cfg, mesh, True, 10, 16)
    want, _ = granite_decode(cfg, one_card(mesh), False, 10, 16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=MESH_LOGITS_TOL, atol=MESH_LOGITS_TOL)
    _, longer = granite_decode(cfg, mesh, True, 10, 64)
    wide = replace(cfg, moe=replace(cfg.moe, d_ff=2 * cfg.moe.d_ff))
    _, wider = granite_decode(wide, mesh, True, 10, 16)
    _, per_call = granite_decode(cfg, mesh, False, 10, 16)
    assert 0 < placed_bytes == longer == wider < per_call


def test_gnn_step_across_cards():
    """gin's SMOKE step with the gather and scatter over (data=4): four
    cards against four shards on ``cuda:0``, deterministic mode, loss and
    first moments within f32 rounding (the same sums in the same order)."""
    cfg = registry.get_smoke_config(C.GNN_ARCH)
    b = {k: torch.from_numpy(v).cuda() for k, v in C.gnn_batch().items()}
    params = G.init_gnn(cfg, torch.Generator(device="cuda").manual_seed(0), C.GNN_D_FEAT,
                        device="cuda")
    mesh = make_mesh((CARDS,), ("data",), device="cuda")
    runs = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for m in (mesh, one_card(mesh)):
            step = make_gnn_train_step(cfg, C.N_NODES, lr=C.GNN_LR,
                                       gather_fn=G.make_shardmap_gather(m, "data", "data"),
                                       scatter_fn=G.make_shardmap_scatter(m, "data", "data",
                                                                          C.N_NODES))
            _, opt, met = step(params, adamw.init(params, moment_dtype=torch.float32),
                               b["feats"], b["src"], b["dst"], b["emask"], b["labels"],
                               b["lmask"])
            runs.append([met["loss"]] + tree_leaves(opt.mu))
    finally:
        torch.use_deterministic_algorithms(was)
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
