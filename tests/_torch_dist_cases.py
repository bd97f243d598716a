"""The cases of the model-side mesh tests, as numpy arrays from fixed seeds.

Imported by the reference's subprocess (eight forced host devices, JAX)
and by ``test_torch_dist_models.py`` (the port on CPU shards), so both
packages see the same inputs.  Numpy only: no JAX, no torch.
"""

import numpy as np

# name -> (mesh shape, mesh axes)
MESHES = {"m24": ((2, 4), ("data", "model")), "m8": ((8,), ("model",)),
          "pod4": ((4,), ("pod",)), "d8": ((8,), ("data",)), "d2": ((2,), ("data",))}

# name -> (mesh, table axis, batch axes)
LOOKUPS = {"m24": ("m24", "model", None), "m24_batch": ("m24", "model", "data"),
           "m8": ("m8", "model", None)}

# name -> (mesh, seq axes, batch axes, pos, window, softcap)
SP_ATTN = {"global": ("m24", ("model",), "data", 37, 64, None),
           "window": ("m24", ("data", "model"), None, 37, 9, 30.0),
           "m8_window": ("m8", ("model",), None, 50, 20, None)}

# name -> (mesh, node axes, edge axes)
GATHER = {"both": ("m24", ("data", "model"), ("data", "model")),
          "rest": ("m24", "model", ("data", "model")),
          "m8": ("m8", "model", "model")}

N_NODES, N_EDGES, D = 32, 64, 6
GNN_D_FEAT = 8


def lookup_inputs():
    """table [64, 8] f32, ids [6, 5] int32, output cotangent [6, 5, 8]."""
    table = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    ids = np.random.default_rng(1).integers(0, 64, size=(6, 5)).astype(np.int32)
    cot = np.random.default_rng(2).normal(size=(6, 5, 8)).astype(np.float32)
    return table, ids, cot


def attn_inputs():
    """q [4, 1, 4, 8], k and v caches [4, 64, 2, 8]."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(4, 1, 4, 8)).astype(np.float32)
    kc = rng.normal(size=(4, 64, 2, 8)).astype(np.float32)
    vc = rng.normal(size=(4, 64, 2, 8)).astype(np.float32)
    return q, kc, vc


def moe_inputs():
    """A capacity MoE layer of d_model 16, 4 experts, top 2, d_ff 32 (the
    weights fan-in scaled) and x [64, 16]."""
    rng = np.random.default_rng(5)
    lw = {"router": rng.normal(size=(16, 4)) / 4.0,
          "we_gate": rng.normal(size=(4, 16, 32)) / 4.0,
          "we_up": rng.normal(size=(4, 16, 32)) / 4.0,
          "we_down": rng.normal(size=(4, 32, 16)) / np.sqrt(32.0)}
    lw = {k: v.astype(np.float32) for k, v in lw.items()}
    return lw, rng.normal(size=(64, 16)).astype(np.float32)


def gather_inputs():
    """h [32, 6], edge ids [64], messages [64, 6], and cotangents of the
    gather's [64, 6] and the scatter's [32, 6] outputs."""
    rng = np.random.default_rng(7)
    h = rng.normal(size=(N_NODES, D)).astype(np.float32)
    idx = rng.integers(0, N_NODES, size=N_EDGES).astype(np.int32)
    msgs = rng.normal(size=(N_EDGES, D)).astype(np.float32)
    g_edges = rng.normal(size=(N_EDGES, D)).astype(np.float32)
    g_nodes = rng.normal(size=(N_NODES, D)).astype(np.float32)
    return h, idx, msgs, g_edges, g_nodes


def gnn_batch():
    """A padded node batch: 32 nodes of 8 features, 64 edges of which the
    last 8 are padding (src = dst = 0, masked), labels of 2 classes, the
    first 8 nodes labelled."""
    rng = np.random.default_rng(11)
    src = rng.integers(0, N_NODES, size=N_EDGES).astype(np.int32)
    dst = rng.integers(0, N_NODES, size=N_EDGES).astype(np.int32)
    emask = np.arange(N_EDGES) < N_EDGES - 8
    src[~emask] = 0
    dst[~emask] = 0
    feats = rng.normal(size=(N_NODES, GNN_D_FEAT)).astype(np.float32)
    labels = rng.integers(0, 2, size=N_NODES).astype(np.int32)
    lmask = (np.arange(N_NODES) < 8).astype(np.float32)
    return dict(feats=feats, src=src, dst=dst, emask=emask, labels=labels, lmask=lmask)


def grad_rows():
    """Per-shard gradients for the compressed reduce: [8, 64] f32."""
    return np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32)


def elastic_tree():
    return {"w": np.arange(32, dtype=np.float32).reshape(8, 4),
            "b": np.arange(6, dtype=np.float32)}


def bf16_sum_bound(partials: np.ndarray) -> np.ndarray:
    """Elementwise bound on the gap between two bf16 sums of the same
    per-shard f32 partials [n, ...] taken in different orders or with
    different accumulators: each side rounds at most n times (each partial
    to bf16, each add), each rounding at most 2^-8 of the sum of
    magnitudes, so the two lie within n x 2^-7 x sum |p| of each other:
    about one bf16 ulp per shard summand."""
    n = partials.shape[0]
    return n * 2.0 ** -7 * np.abs(partials.astype(np.float64)).sum(axis=0) + 1e-30


# the MoE layer's config: LMConfig and MoEConfig keyword arguments
MOE_LM = dict(name="m", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_head=8,
              d_ff=32, vocab=32)
MOE = dict(n_experts=4, top_k=2, d_ff=32, impl="capacity")
GNN_ARCH, GNN_LR = "gin-tu", 1e-3  # at its SMOKE config (gin-smoke)
