#!/usr/bin/env python3
"""Drive repro_torch's snapshot read path, its write side and its model
paths once on one CUDA card.

    python3 chip_smoke.py                 # the deployment below, one card

Deployment: the paper's own settings, |P|=64 and B=512 (configs/rapidstore,
paper section 6.5), ``high_threshold`` at its default, on a directed
Graph500 R-MAT graph (a=0.57, b=0.19, c=0.19) of scale 22 and edge factor
16: 4,194,304 vertices and about 67M edges, made from ``--seed``.  Triangle
counting runs on an undirected simple store of scale 18, durability on a
directed tiered store of scale 18.

Phases, each printing one JSON line (a failing phase raises, and the
script exits non-zero without the last line):

0. card      nvidia-smi name and power limit, torch and CUDA versions;
             fails unless the capability is (9, 0)
1. build     nvcc builds every csrc/*.cu for sm_90a
2. kernels   each CUDA kernel against its plain version at the main path's
             shapes, with its time, the plain version's, a library call's
             and the least time the card needs for the same bytes;
             leaf_search searches the candidate tiles in place (index and
             live length), beside torch.searchsorted on a gathered copy and
             the gather's own time; leaf_scan_reduce reads each tile's
             live length, beside the same kernel over the full width B,
             the library call on masked weights and on the live ids alone,
             and three cuts of its work (lengths 0, live ids 0, short and
             long tiles apart);
             leaf_spmm reads each tile's live length,
             on the 16,384-tile prefix and over all tiles (beside the same
             kernel over the full width, and the library call over all
             tiles, with ``gathered_bound_ms``: every live id's H row from
             HBM); intersect_count names the pairs' tiles in place, beside
             the kernel on gathered copies and the gather's own time
3. main      store + pinned view R0, the view-level entry points on R0,
             20 write transactions, spliced view R1, the entry points on
             R1, a warm repeat with zero uploads; checks against point
             reads and the port's own CPU route; edge_search_view on the
             warm R1 step by step
4. isolation the pinned R0 answers bitwise as before the writes
5. readers   two reader threads repeat queries on their own pinned views
             while the main thread commits
5s. shard_plane  on the main store: PageRank (10 iterations), BFS, SSSP,
             WCC and SpMM (d = 128) on a pinned view through the
             single-device route; a 4-shard plane (modulo, directed) over
             the visible cards (all four on one card when there is one):
             its cold sharded COO and tile builds, each shard's live
             edges, tiles, caps, uploads and bytes; the five queries
             through it on the same snapshot (BFS, SSSP, WCC bitwise,
             PageRank within 1e-5 and rtol 1e-3, atol 1e-9 — a plane that
             drops its lightest shard's partials must fail that — SpMM
             1e-4; warm medians of 3 beside the single route's;
             ``leaf_spmm`` once per shard, and each shard's launch at the
             plane's shapes held against the plain version, every tile,
             1e-4); 20
             transactions on shard 1's subgraphs (the other shards upload
             nothing and keep their bundles by identity); a migration of
             the 4 heaviest subgraphs to the least-loaded shard with a
             reader pinned before the flip (its bundles untouched,
             BFS/SSSP/WCC bitwise) and a view after it; the modulo and
             degree-balanced loads; device bytes before the attach, at the
             peak and after the detach.  After phase 6 its store takes a
             ``symmetric=True`` plane: pull PageRank against the single
             route as above
5a. write_side  on the main store: a write pipeline (4 shards, batches up
             to 1024), 4 writer threads each submitting 50 transactions with
             ``apply_async`` while two reader threads repeat edge search and
             scan-reduce on their pinned views; a compactor fold while one
             reader stays pinned (its answers must not change); 20 more
             pipelined writes; the entry points on a fresh view R2 (checks
             and the CPU route as in phase 3, uploads bounded by the
             snapshots without device tiles), then a warm repeat with zero
             uploads; commits/s, group sizes, fold seconds and report, R2's
             cold view with the assembler counters, ``memory_breakdown()``
5g. gnn_train  on the main store (no write pipeline attached): gin-tu at
             its published config trains for 20 steps at ``GNN_SHAPES``'
             minibatch_lg (1,024 seeds, fanouts 15, 10, d_feat 602), as
             ``examples/train_gnn_dynamic.py`` does: a writer thread
             streams edge updates through ``insert_edges``/
             ``delete_edges`` while each step samples from a pinned view
             (20 sampled edges of step 0 checked against ``view.scan``),
             gathers the [4,194,304, 602] f32 features held on the card
             and takes a train step; the loss finite and falling (the
             last 5 steps' mean below the first 5's).  After the loop:
             one step each of gcn-cora, gatedgcn and pna at their
             published configs on step 0's batch; step 0's loss and every
             gradient leaf of all four against the CPU route, which runs
             on a host thread beside the checkpoint of (params, AdamW
             state), restored bitwise, and ``check_invariants`` (float64:
             loss rtol 1e-4, each leaf within ``GNN_F64_GRAD_TOL`` of its
             largest magnitude, reversed edges and the card's f32 outside
             it; gin-tu in f32 too: each leaf within 2e-3, or ten times
             the CPU route's own f32 error where larger, reversed edges
             outside it); the loop's own step-0 loss against the CPU's;
             AdamW on the card against the CPU on the same gradients
             (1e-6); the split of a step (sampling, gather, step),
             steps/s over the timed steps (all but the profiled one),
             commits, one profiled step's device busy time, peak bytes
5b. durability  a directed R-MAT store of scale 18 with the paper's skew
             tiers (64, 512): WAL with fsync and the compactor's checkpoint
             under one temporary directory, 200 pipelined writes, a fold
             with a checkpoint, 20 more writes; then ``RapidStore.recover``
             on the card (R) and on the CPU (C).  R's edge set equals the
             live view's; R's and C's leaf streams are bitwise equal; edge
             search, BFS, SSSP, WCC and triangles on R equal the live
             view's on the card bitwise, SpMM and PageRank within
             tolerance; the other entry points on R on the card equal C's
             CPU route (integers bitwise, scan-reduce and PageRank 1e-5,
             SpMM 1e-4), and R's triangle count equals a host count of the
             same sum by another algorithm (the CPU route's plain
             intersect of every tile pair's [Ba, Bb] ids is too slow at
             this scale)
6. triangles triangle_count_view on the card, cold then warm, ==
             triangle_count_fast on host; then, uncounted, the warm call's
             split: host enumeration of the tile pairs, index uploads, the
             kernel's summed device time, the rest
7. model kernels  flash_decode and embedding_bag against their plain
             versions at the model paths' shapes, timed as in phase 2;
             flash_decode's tensor-core route at the decode_32k path, at
             seeded lengths, with softcap 50 and at dh 144 (Gemma-2-27B's
             grouping), and the CUDA-core route (f32 K/V) at seeded
             lengths
8. lm_serve  Qwen2.5-14B at full width: (a) ``repro_torch.launch.serve``'s
             ``main`` with its defaults (f32, batch 4, prompt 32 fed token
             by token, 32 decode tokens, max_seq 128), then one step of the
             kernel route against a plain route at rtol=atol=3e-4;
             (b) decode_32k in bf16: a cache of 32,768 positions filled to
             position 32,759 from the seed, then one checked step: each of
             its 48 flash_decode launches against the plain version on the
             same inputs at rtol=2e-4, atol=2e-5, and its logits against
             the plain route's within 10% of their largest magnitude (48
             bf16 layers amplify single rounding flips); two controls of
             that limit on the same step: one bf16 ulp on one element of
             layer 0's attention output must stay inside it, heads grouped
             h % KV (a planted fault) must fall outside; then 8 greedy
             tokens, timed, with 48 flash_decode launches per step, and one
             more under the profiler for the device's idle share
9. recsys_serve  BST at its published config, the 4,194,304 x 32 item
             table on the card: forward at serve_p99 (512) and serve_bulk
             (262,144), user_tower + retrieval_scores at retrieval_cand
             (1,000,000 candidates), each against the plain route
10. the ``kernels`` line, then the ``ok`` line.

The launch counters are set to 0 just before each of phases 3-6, 5s, 5a,
5g, 5b, 8 and 9 and read just after it (5g launches no hand kernel: its
segment ops are torch ops); every kernel a phase calls must have
launched in it.  The ``kernels`` line's ``launches`` is the count on each
kernel's own path (phase 3 for the graph kernels, 8 for flash_decode, 9 for
embedding_bag), and ``launches_by_path`` holds every phase's.  The
comparisons of phases 2 and 7 do not count.  The scale cuts:
decode_32k's global batch is 4, not 128, so that its cache and weights
fit on one card; the durability store is of scale 18, not 22, because
recovery rebuilds the store with ``from_edges`` (246.7 s at scale 22 on
the host), twice here; its SpMM width is 16 and its intersect pairs
1,024, because its CPU route materializes [tiles, B, d] and
[pairs, Ba, Bb].

The GNN phase's cut: the graph is the scale-22 R-MAT store, not
minibatch_lg's Reddit graph (232,965 x 114.6M); 20 steps, not the
example's 300.

``bound_ms`` counts the bytes the function needs on this run's data, not
the whole tiles: a tile's live ids are a sorted prefix followed by
SENTINEL padding (checked), so a read of a live prefix, given its
length, moves the 32-byte sectors that hold it and that length, the
binary searches over the tiles' live prefixes read
each distinct 32-byte sector their probes touch once (queries share
tiles), a gather reads each distinct x or H row it touches once, and
the intersections read each distinct tile's live prefix once.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
CUDA_CORE_OPS_PER_S = 67e12  # f32 outside the tensor cores, NVIDIA data sheet
SCALE = 22  # R-MAT scale of the main store (below 21 the writes cannot splice)
TC_SCALE = 18  # R-MAT scale of the undirected triangle-count store
D_FEATURES = 128  # SpMM width: a common GNN hidden width
N_WRITES, N_INS, N_DELS = 20, 256, 64
PLANE_SHARDS, PLANE_MOVES = 4, 4  # shard plane: 4 shards (on one card there); moves
WS_WRITERS, WS_TXNS, WS_MORE = 4, 50, 20  # write_side: 4 writers x 50 txns, 20 after the fold
DUR_SCALE = 18  # durability: recovery rebuilds with from_edges (246.7 s at 22)
DUR_TIERS = (64, 512)  # the paper's skew tiers (section 6.2)
DUR_WRITES, DUR_MORE = 200, 20  # pipelined writes before and after the checkpoint
DUR_PAIRS = 1024  # intersect pairs: the CPU route holds [pairs, 512, 512] compares
DUR_D = 16  # SpMM width: the CPU route materializes [tiles, B, d]
JOIN_S = 900  # every thread's join limit
N_QUERIES = 4096  # present and as many absent edge-search pairs
N_PAIRS = 8192  # intersect tile pairs (one sum_intersect batch)
SPMM_PLAIN_ROWS = 16384  # tiles per plain-SpMM call: it materializes [N, B, d]
SECTOR = 32  # bytes: a DRAM sector
SHORT_TILE = 32  # live ids: the scan's short tiles (one int4 a lane of its 8)
LM_ARCH = "qwen2.5-14b"
MODEL_SMOKE = False  # True takes the archs' SMOKE configs (CPU rehearsal)
DECODE_SEQ = 32768  # decode_32k's cache length
DECODE_BATCH = 4  # decode_32k's global batch is 128: cut to fit one card
DECODE_STEPS = 8  # greedy tokens after the cache is filled to DECODE_SEQ - 8
SERVE_BATCHES = (512, 262144)  # serve_p99, serve_bulk
N_CANDIDATES = 1_000_000  # retrieval_cand
GNN_ARCH, GNN_OTHER = "gin-tu", ("gcn-cora", "gatedgcn", "pna")
GNN_SEEDS, GNN_FANOUTS, GNN_D_FEAT = 1024, (15, 10), 602  # GNN_SHAPES' minibatch_lg
GNN_STEPS, GNN_LR = 20, 3e-3  # the example's lr; 20 steps, not its 300
GNN_LOSS_RTOL, GNN_ADAMW_TOL = 1e-4, 1e-6
# float64 gradient leaves, card against CPU, of their largest magnitude, by
# model kind.  GIN and GatedGCN compute every term in float64 (the H100 and
# its host agree to 2.7e-15 at most).  GCN's rsqrt and PNA's log1p of the
# degrees stay f32, as in the reference, and the card's f32 libm differs
# from the host's by an ulp or two there (3.5e-8 and 1.9e-8 measured); the
# card's f32 gradients sit 5.1e-7 (GCN) and more (the rest) from float64,
# which each run checks these limits reject
GNN_F64_GRAD_TOL = {"gin": 1e-9, "gatedgcn": 1e-9, "gcn": 1.5e-7, "pna": 1.5e-7}
# f32 gradient leaves, of their largest magnitude: layer 0's w0 sums
# 169,984 rows with cancellation, so both routes' f32 sit up to ~5e-4 from
# float64 (``card_f32_vs_f64`` and ``cpu_f32_vs_f64`` in the phase's line)
GNN_F32_GRAD_TOL = 2e-3

KERNELS = {
    "leaf_search": ("src/repro_torch/csrc/leaf_search.cu",
                    "src/repro/kernels/leaf_search/kernel.py:40"),
    "leaf_scan_reduce": ("src/repro_torch/csrc/leaf_scan_reduce.cu",
                         "src/repro/kernels/spmm/kernel.py:47"),
    "leaf_spmm": ("src/repro_torch/csrc/leaf_spmm.cu",
                  "src/repro/kernels/spmm/kernel.py:102"),
    "intersect_count": ("src/repro_torch/csrc/intersect_count.cu",
                        "src/repro/kernels/intersect/kernel.py:55"),
    "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/kernel.py:48"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode/kernel.py:95"),
}
# the path whose launches the ``kernels`` line reports for each kernel
KERNEL_PATH = {"leaf_search": "main", "leaf_scan_reduce": "main", "leaf_spmm": "main",
               "intersect_count": "main", "embedding_bag": "recsys_serve",
               "flash_decode": "lm_serve"}


START = time.monotonic()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``elapsed_s`` is the script's wall time so far (the
    whole run has a time limit, so each phase's share is on record)."""
    print(json.dumps({"phase": phase, **fields, "elapsed_s": time.monotonic() - START},
                     default=float), flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def wall(fn, device):
    """(result, seconds) of ``fn()`` with the device drained at both ends."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def device_seconds(fn, device):
    """(result, seconds) of ``fn()`` on the device: CUDA events around it
    on the card (the host clock on the CPU), the device drained first."""
    import torch

    sync(device)
    if device.type != "cuda":
        return wall(fn, device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def time_ms(fn, device, reps: int, graph: bool = False) -> float:
    """Mean device time of one ``fn()`` over ``reps`` warm calls (CUDA
    events on the card, the host clock on the CPU).  With ``graph`` the
    ``reps`` calls are captured once in a CUDA graph and the replay is
    timed, so a call that is shorter than its own Python launch path is
    timed on the device, not at the host's launch rate."""
    import torch

    fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    if graph:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # warm-up before capture, as torch asks
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        sync(device)
        call, per_call, calls = g.replay, reps, 5
    else:
        call, per_call, calls = fn, 1, reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * per_call)


def bound(nbytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the CUDA-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def live_lengths(rows):
    """Live ids per tile; raises unless every tile's live ids form a sorted
    prefix followed by SENTINEL padding (what the bounds below assume)."""
    from repro_torch.core.leaf_pool import SENTINEL

    mask = rows != SENTINEL
    if rows.shape[1] > 1 and bool(((rows[:, 1:] < rows[:, :-1]) |
                                   (mask[:, 1:] & ~mask[:, :-1])).any()):
        raise AssertionError("a tile is not a sorted live prefix + SENTINEL padding")
    return mask.sum(dim=1)


def live_bytes(lengths) -> int:
    """Bytes a read of each row's first ``lengths`` ids must move: the
    32-byte sectors that hold them (rows start on a sector boundary, as
    tiles of B = 512 do), none for an empty row."""
    import torch

    sectors = torch.div(lengths.long() * 4 + SECTOR - 1, SECTOR, rounding_mode="floor")
    return int(sectors.sum()) * SECTOR


def search_sectors(width: int) -> int:
    """32-byte sectors one binary search over a sorted row of ``width``
    int32 reads: one per probe until the interval fits in one sector."""
    return 1 + math.ceil(math.log2(max(1, math.ceil(width / (SECTOR // 4)))))


def search_sector_ids(rows, targets, index, length, want_pos):
    """(distinct sector ids, probes): the kernel's binary search replayed
    over each query's live prefix, every probe's 32-byte sector of ``rows``
    kept once; raises unless it lands on ``want_pos``."""
    import torch

    B = rows.shape[1]
    lo = torch.zeros_like(targets)
    hi = length[index].clamp(0, B)
    base = index * B
    ids, probes = [], 0
    while True:
        active = lo < hi
        if not bool(active.any()):
            break
        mid = (lo + hi) >> 1
        at = base[active] + mid[active]
        probes += int(at.numel())
        ids.append(at // (SECTOR // 4))
        below = torch.zeros_like(active)
        below[active] = rows.reshape(-1)[at] < targets[active]
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    if not torch.equal(lo, want_pos.to(lo.dtype)):
        raise AssertionError("the replayed search disagrees with leaf_search_ref")
    return torch.unique(torch.cat(ids)) if ids else base[:0], probes


def max_abs_err(got, want) -> float:
    import torch

    if got.numel() == 0:
        return 0.0
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())


# ---------------------------------------------------------------------------
# Phase 0 / 1: card and build
# ---------------------------------------------------------------------------
def phase_card(device) -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from repro_torch.kernels.runtime import is_hopper

    cap = torch.cuda.get_device_capability(device)
    emit("card", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(cap), name=torch.cuda.get_device_name(device))
    if not is_hopper():
        raise RuntimeError(f"need a Hopper card (capability 9.0), got {cap}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import runtime

    t0 = time.perf_counter()
    libs = runtime.build_all()
    emit("build", seconds=time.perf_counter() - t0, libraries=sorted(libs))


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
def build_store(scale: int, seed: int, device, undirected: bool = False, leaf_tiers=None):
    from repro_torch.configs import CONFIG
    from repro_torch.core import RapidStore
    from repro_torch.graph import rmat_edges

    t0 = time.perf_counter()
    edges = rmat_edges(scale, 16 << scale, seed=seed)
    t1 = time.perf_counter()
    store = RapidStore.from_edges(
        1 << scale, edges, undirected=undirected,
        partition_size=CONFIG.partition_size, B=CONFIG.leaf_width, device=device,
        leaf_tiers=leaf_tiers,
    )
    return store, {"generate_s": t1 - t0, "build_s": time.perf_counter() - t1,
                   "n_vertices": 1 << scale, "edges_generated": int(len(edges))}


def make_operands(view, seed: int, device, with_h: bool = True, n_pairs: int = N_PAIRS,
                  d: int = D_FEATURES):
    """Query operands for one view, made from ``seed`` (numpy on the host,
    torch on the device for the large float inputs)."""
    import numpy as np
    import torch

    from repro_torch.core import view_assembler

    rng = np.random.default_rng(seed)
    n = view.n_vertices
    src, dst = view.to_coo()
    pick = rng.choice(len(src), N_QUERIES, replace=False)
    present = np.stack([src[pick], dst[pick].astype(np.int64)], 1)
    cand = np.stack([np.tile(present[:, 0], 2), rng.integers(0, n, 2 * N_QUERIES)], 1)
    absent = np.array([(u, v) for u, v in cand if not view.search(int(u), int(v))],
                      np.int64).reshape(-1, 2)[:N_QUERIES]
    if len(absent) < N_QUERIES:
        raise RuntimeError(f"only {len(absent)} absent query pairs found")
    queries = np.concatenate([present, absent])
    # intersect pairs: the first leaf of each endpoint of sampled edges
    bsrc, order = view_assembler.block_src_index(view)
    s_sorted = bsrc[order]
    e = rng.choice(len(src), 2 * n_pairs, replace=False)
    u, v = src[e].astype(np.int64), dst[e].astype(np.int64)
    lo_u, lo_v = np.searchsorted(s_sorted, u), np.searchsorted(s_sorted, v)
    has_v = (lo_v < len(s_sorted)) & (s_sorted[np.minimum(lo_v, len(s_sorted) - 1)] == v)
    ia, ib = order[lo_u[has_v]][:n_pairs], order[lo_v[has_v]][:n_pairs]
    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "queries": queries,
        "n_present": len(present),
        "ia": ia,
        "ib": ib,
        "x": torch.randn(n, generator=g, device=device),
        "w": torch.rand(len(src), generator=g, device=device) + 0.1,
        "H": torch.randn((n, d), generator=g, device=device) if with_h else None,
    }


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def phase_kernels(view, ops, device) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core import view_assembler
    from repro_torch.core.leaf_pool import SENTINEL
    from repro_torch.kernels.intersect import intersect_count
    from repro_torch.kernels.intersect.ref import intersect_count_ref
    from repro_torch.kernels.leaf_search import leaf_search
    from repro_torch.kernels.leaf_search.ref import leaf_search_ref
    from repro_torch.kernels.spmm import leaf_scan_reduce, leaf_spmm
    from repro_torch.kernels.spmm.ref import leaf_scan_reduce_ref, leaf_spmm_ref

    rows = view.to_leaf_blocks_device().rows
    N, B = rows.shape
    lengths = live_lengths(rows)
    out = {}

    def record(name, shape, err, ms, plain_ms, library_ms, nbytes, nops, **extra):
        b_ms, b_by = bound(nbytes, nops)
        out[name] = dict(name=name, shape=list(shape), max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                         bound_by=b_by, bound_bytes=nbytes, **extra)
        emit("kernel", **out[name])

    # -- leaf_search at edge_search_view's shape: the queries' candidate
    # tiles, named by index into the resident tiles and searched over their
    # live prefix in place (no gathered copy)
    from repro_torch.kernels.leaf_search import ops as search_ops

    offsets, order = view_assembler.block_src_offsets(view)
    us, vs = ops["queries"][:, 0], ops["queries"][:, 1]
    qidx, flat = search_ops.flatten_candidates(
        order, *search_ops.candidate_ranges(offsets, us))
    index = torch.from_numpy(flat.astype(np.int32)).to(device)
    length = view.to_leaf_blocks_device().length
    tgt = torch.from_numpy(vs[qidx].astype(np.int32)).to(device)
    if not torch.equal(length, lengths.to(torch.int32)):
        raise AssertionError("the tiles' length column disagrees with their live prefix")
    f, p = leaf_search(rows, tgt, index, length)
    fr, pr = leaf_search_ref(rows, tgt, index, length)
    if not (torch.equal(f, fr) and torch.equal(p, pr)):
        raise AssertionError("leaf_search disagrees with its plain version")
    err = max(max_abs_err(p, pr), max_abs_err(f, fr))
    Q = tgt.shape[0]
    li = index.long()
    srows = rows[li]  # the gathered copy the first port searched
    tgt2 = tgt[:, None].contiguous()
    gather_ms = time_ms(lambda: rows[li], device, 20, graph=True)
    searchsorted_ms = time_ms(lambda: torch.searchsorted(srows, tgt2), device, 50, graph=True)
    # the bytes the search needs: each distinct sector its probes touch, once
    # (pairs share tiles), plus target, index, pos and found per pair and the
    # length of each distinct tile
    sector_ids, probes = search_sector_ids(rows, tgt, li, length, pr)
    sectors = int(sector_ids.numel())
    n_tiles = int(torch.unique(li).numel())
    seven_bound, _ = bound(Q * (search_sectors(B) * SECTOR + 4 * 4 + 1), 0)
    record("leaf_search", (Q, B), err,
           time_ms(lambda: leaf_search(rows, tgt, index, length), device, 50, graph=True),
           # the plain version checks the index range on the host, so no graph
           time_ms(lambda: leaf_search_ref(rows, tgt, index, length), device, 10),
           searchsorted_ms, sectors * SECTOR + Q * (4 * 3 + 1) + n_tiles * 4, probes,
           gather_ms=gather_ms, library_with_gather_ms=gather_ms + searchsorted_ms,
           distinct_sectors=sectors, probes=probes, distinct_tiles=n_tiles,
           bound_7_sectors_ms=seven_bound,
           mean_live=float(lengths[li].double().mean()), n_tiles=N)
    del srows, tgt, tgt2, f, p, fr, pr, index, li, sector_ids

    # -- leaf_scan_reduce over the whole view (leaf_scan_reduce_view's shape):
    # each tile read over its live prefix (the tiles' length column), timed
    # as a graph replay beside the same kernel over the full width B
    # (no_length_ms), both held against the plain version on every tile;
    # the library call on masked weights over all B slots (library_ms) and
    # on the compacted live ids alone (library_live_ms, ids and offsets
    # built outside the timed call).  Three cuts of the kernel's work show
    # where its time goes: every length 0 (the length loads and y alone),
    # every live id replaced by 0 (the same id traffic, every gather on one
    # line of x), and the tiles of at most SHORT_TILE live ids and the rest,
    # each gathered into tiles of their own.
    from repro_torch.kernels.spmm import route as spmm_route

    x = ops["x"]
    live = int(lengths.sum())
    rows_bytes = live_bytes(lengths)
    touched = int(torch.unique(rows[rows != SENTINEL]).numel())
    err = 0.0
    for ln in (None, length):  # yr, with length, stays for the library's check
        yr = leaf_scan_reduce_ref(rows, x, ln)
        y = leaf_scan_reduce(rows, x, ln)
        torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
        err = max(err, max_abs_err(y, yr))
    zero_len = torch.zeros_like(length)
    cuts = {"length_0_ms": time_ms(lambda: leaf_scan_reduce(rows, x, zero_len), device, 20,
                                   graph=True)}
    zero_ids = torch.where(rows != SENTINEL, 0, rows)
    cuts["ids_0_ms"] = time_ms(lambda: leaf_scan_reduce(zero_ids, x, length), device, 20,
                               graph=True)
    del zero_len, zero_ids
    short = lengths <= SHORT_TILE
    for name, sel in (("short", short), ("long", ~short)):
        part_rows, part_len = rows[sel].contiguous(), length[sel].contiguous()
        cuts[f"{name}_ms"] = time_ms(lambda: leaf_scan_reduce(part_rows, x, part_len), device,
                                     20, graph=True)
        cuts[f"{name}_tiles"], cuts[f"{name}_live"] = int(sel.sum()), int(lengths[sel].sum())
        del part_rows, part_len
    mask = rows != SENTINEL
    idx = torch.where(mask, rows, 0).long()
    psw = mask.to(torch.float32)
    live_ids = rows[mask].long()  # tile by tile: each live prefix in order
    del mask
    starts = torch.cumsum(lengths, 0) - lengths
    x2 = x[:, None].contiguous()
    # the library call sums each bag in its own order: held within the drift
    # of two f32 summation orders, 2 m u sum|x| (u = 2^-24), plus 1e-5
    drift = (1e-5 + 1e-5 * yr.abs() + 2 * lengths * 2.0 ** -24
             * leaf_scan_reduce_ref(rows, x.abs(), length))
    if not bool(((F.embedding_bag(live_ids, x2, starts, mode="sum")[:, 0] - yr).abs()
                 <= drift).all()):
        raise AssertionError("F.embedding_bag over the live ids is not the scan's function")
    del y, yr, drift
    record("leaf_scan_reduce", (N, B), err,
           time_ms(lambda: leaf_scan_reduce(rows, x, length), device, 20, graph=True),
           time_ms(lambda: leaf_scan_reduce_ref(rows, x, length), device, 2),
           time_ms(lambda: F.embedding_bag(idx, x2, mode="sum", per_sample_weights=psw),
                   device, 5),
           rows_bytes + touched * 4 + N * 4 + N * 4, live,
           kernel_route=spmm_route(B, rows.data_ptr()),
           no_length_ms=time_ms(lambda: leaf_scan_reduce(rows, x), device, 10, graph=True),
           library_live_ms=time_ms(lambda: F.embedding_bag(live_ids, x2, starts, mode="sum"),
                                   device, 20),
           # every live id's 32-byte sector of x from HBM (no L2 reuse)
           gathered_bound_ms=live * SECTOR / HBM_BYTES_PER_S * 1e3,
           live_entries=live, tile_bytes=N * B * 4, live_prefix_bytes=rows_bytes,
           distinct_x=touched, short_max_live=SHORT_TILE, **cuts)
    del live_ids, starts

    # -- leaf_spmm over each tile's live prefix (the tiles' length column):
    # timed against the plain version and the library call on a prefix of
    # tiles (the plain version materializes [N, B, d]); the all-tile launch
    # of the main path is timed (main_ms), beside the same kernel over the
    # full width B (main_no_length_ms), and held against the plain version
    # chunk by chunk, every tile included.
    H = ops["H"]
    d = H.shape[1]
    n_p = min(N, SPMM_PLAIN_ROWS)
    prow, plen = rows[:n_p], length[:n_p]
    plive = int(lengths[:n_p].sum())
    ptouched = int(torch.unique(prow[prow != SENTINEL]).numel())
    pidx, ppsw = idx[:n_p], psw[:n_p]
    main_ms = time_ms(lambda: leaf_spmm(rows, H, length), device, 5)
    main_no_length_ms = time_ms(lambda: leaf_spmm(rows, H), device, 3)
    ym = leaf_spmm(rows, H, length)
    err, main_library_ms, n_chunks = 0.0, 0.0, 0
    for c0 in range(0, N, SPMM_PLAIN_ROWS):
        c1 = min(N, c0 + SPMM_PLAIN_ROWS)
        ymr = leaf_spmm_ref(rows[c0:c1], H, length[c0:c1])
        torch.testing.assert_close(ym[c0:c1], ymr, rtol=1e-4, atol=1e-4)
        err = max(err, max_abs_err(ym[c0:c1], ymr))
        del ymr
        # the library call over all tiles: the same chunks, summed
        cidx, cpsw = idx[c0:c1], psw[c0:c1]
        main_library_ms += time_ms(lambda: F.embedding_bag(cidx, H, mode="sum",
                                                           per_sample_weights=cpsw), device, 2)
        n_chunks += 1
    del ym
    main_bound, _ = bound(rows_bytes + touched * d * 4 + N * 4 + N * d * 4, live * d)
    record("leaf_spmm", (n_p, B, d), err,
           time_ms(lambda: leaf_spmm(prow, H, plen), device, 20),
           time_ms(lambda: leaf_spmm_ref(prow, H, plen), device, 2),
           time_ms(lambda: F.embedding_bag(pidx, H, mode="sum", per_sample_weights=ppsw),
                   device, 5),
           live_bytes(lengths[:n_p]) + ptouched * d * 4 + n_p * 4 + n_p * d * 4,
           plive * d, kernel_route=spmm_route(d, H.data_ptr()),
           checked_tiles=N, gathered_bytes=plive * d * 4, distinct_h_rows=ptouched,
           main_shape=[N, B, d], main_ms=main_ms, main_no_length_ms=main_no_length_ms,
           main_bound_ms=main_bound, gathered_bound_ms=live * d * 4 / HBM_BYTES_PER_S * 1e3,
           main_distinct_h_rows=touched, main_gathered_bytes=live * d * 4,
           main_library_ms=main_library_ms, main_library_chunks=n_chunks)
    del idx, psw, pidx, ppsw, prow

    # -- intersect_count at sum_intersect_tiles_view's batch shape: the pairs'
    # tiles named by index into the resident tiles and read over their live
    # prefix in place (no gathered copy); beside it the same kernel on
    # gathered full-width copies (the first port's form) and the gather's
    # own time
    ia = torch.from_numpy(ops["ia"].astype(np.int32)).to(device)
    ib = torch.from_numpy(ops["ib"].astype(np.int32)).to(device)
    Qi = ia.shape[0]
    c = intersect_count(rows, rows, ia, ib, length, length)
    cr = intersect_count_ref(rows, rows, ia, ib, length, length)
    if not torch.equal(c, cr):
        raise AssertionError("intersect_count disagrees with its plain version")
    lia, lib = ia.long(), ib.long()
    a, b = rows[lia], rows[lib]  # the gathered copies the first port read
    if not torch.equal(intersect_count(a, b), c):
        raise AssertionError("intersect_count on gathered copies disagrees")
    gather_ms = time_ms(lambda: (rows[lia], rows[lib]), device, 20, graph=True)
    gathered_ms = time_ms(lambda: intersect_count(a, b), device, 50, graph=True)
    del a, b
    la, lb = lengths[lia], lengths[lib]
    tiles = torch.unique(torch.cat([lia, lib]))
    # each distinct tile's live-prefix sectors and length once, the two
    # indices and the count per pair; per pair: each pair's two prefixes
    per_pair, _ = bound(live_bytes(la) + live_bytes(lb) + Qi * 4 * 5, 0)
    # a merge of the two sorted live prefixes: one compare per element
    record("intersect_count", (Qi, B), max_abs_err(c, cr),
           time_ms(lambda: intersect_count(rows, rows, ia, ib, length, length), device, 50,
                   graph=True),
           # the plain version checks the index range on the host, so no graph
           time_ms(lambda: intersect_count_ref(rows, rows, ia, ib, length, length), device, 3),
           None,
           live_bytes(lengths[tiles]) + int(tiles.numel()) * 4 + Qi * 4 * 3,
           int((la + lb).sum()),
           bound_per_pair_ms=per_pair, distinct_tiles=int(tiles.numel()),
           gathered_ms=gathered_ms, gather_ms=gather_ms,
           gathered_with_gather_ms=gathered_ms + gather_ms,
           mean_live_a=float(la.double().mean()), mean_live_b=float(lb.double().mean()),
           total_count=int(c.sum()))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------
ENTRY_POINTS = (
    "edge_search_view", "intersect_tiles_view", "sum_intersect_tiles_view",
    "leaf_scan_reduce_view", "leaf_spmm_view", "spmm_view", "pagerank_view",
    "bfs_view", "sssp_view", "wcc_view",
)


def run_entry_points(view, ops, device, names=ENTRY_POINTS) -> tuple:
    """The view-level entry points ``names`` on ``view``: (results,
    seconds each)."""
    from repro_torch.core import analytics as A
    from repro_torch.kernels.intersect import intersect_tiles_view, sum_intersect_tiles_view
    from repro_torch.kernels.leaf_search import edge_search_view
    from repro_torch.kernels.spmm import leaf_scan_reduce_view, leaf_spmm_view, spmm_view

    q = ops["queries"]
    calls = {
        "edge_search_view": lambda: edge_search_view(view, q[:, 0], q[:, 1]),
        "intersect_tiles_view": lambda: intersect_tiles_view(view, ops["ia"], ops["ib"]),
        "sum_intersect_tiles_view": lambda: sum_intersect_tiles_view(
            view, ops["ia"], ops["ib"]),
        "leaf_scan_reduce_view": lambda: leaf_scan_reduce_view(view, ops["x"]),
        "leaf_spmm_view": lambda: leaf_spmm_view(view, ops["H"]),
        "spmm_view": lambda: spmm_view(view, ops["H"]),
        "pagerank_view": lambda: A.pagerank_view(view),
        "bfs_view": lambda: A.bfs_view(view, 0),
        "sssp_view": lambda: A.sssp_view(view, ops["w"], 0),
        "wcc_view": lambda: A.wcc_view(view),
    }
    res, secs = {}, {}
    for name in names:
        res[name], secs[name] = wall(calls[name], device)
    secs["bfs_iterations"] = A.bfs_coo.iterations
    secs["sssp_iterations"] = A.sssp_coo.iterations
    secs["wcc_iterations"] = A.wcc_coo.iterations
    return res, secs


def edge_search_breakdown(view, ops, device, reps: int = 5) -> dict:
    """edge_search_view on a warm view, step by step (host clock, device
    drained after each step; the median of ``reps``), and the whole call;
    the steps' answer must equal the call's bitwise."""
    import numpy as np

    from repro_torch.core import view_assembler
    from repro_torch.kernels.leaf_search import edge_search_view
    from repro_torch.kernels.leaf_search import ops as search_ops

    us, vs = ops["queries"][:, 0], ops["queries"][:, 1]
    steps = {k: [] for k in ("block_src_offsets", "candidate_ranges", "flatten",
                             "search_tiles", "copy_back", "steps_total", "edge_search_view")}
    for _ in range(reps):
        (offsets, order), t0 = wall(lambda: view_assembler.block_src_offsets(view), device)
        (lo, hi), t1 = wall(lambda: search_ops.candidate_ranges(offsets, us), device)
        (qidx, flat), t2 = wall(lambda: search_ops.flatten_candidates(order, lo, hi), device)
        hits, t3 = wall(lambda: search_ops.search_tiles(view, vs, qidx, flat, len(us)), device)
        got, t4 = wall(lambda: hits.cpu().numpy(), device)
        want, t5 = wall(lambda: edge_search_view(view, us, vs), device)
        if not np.array_equal(got, want):
            raise AssertionError("edge_search_view's steps disagree with the call")
        for k_, t in zip(steps, (t0, t1, t2, t3, t4, t0 + t1 + t2 + t3 + t4, t5)):
            steps[k_].append(t * 1e3)
    return {k_: float(np.median(v)) for k_, v in steps.items()} | {
        "pairs": int(len(flat)), "queries": int(len(us)), "reps": reps}


def check_results(view, ops, res) -> dict:
    """Shapes, finiteness, and the cross-checks that hold on any view."""
    import numpy as np
    import torch

    n = view.n_vertices
    n_blocks = view.to_leaf_blocks_device().n_blocks
    q = ops["queries"]
    want = np.array([view.search(int(u), int(v)) for u, v in q])
    if not np.array_equal(res["edge_search_view"], want):
        raise AssertionError("edge_search_view disagrees with view.search")
    if not res["edge_search_view"][: ops["n_present"]].all():
        raise AssertionError("a present edge was not found")
    if int(res["intersect_tiles_view"].sum()) != res["sum_intersect_tiles_view"]:
        raise AssertionError("sum_intersect_tiles_view != intersect_tiles_view sum")
    d = ops["H"].shape[1]
    shapes = {
        "leaf_scan_reduce_view": (n_blocks,), "leaf_spmm_view": (n_blocks, d),
        "spmm_view": (n, d), "pagerank_view": (n,), "bfs_view": (n,),
        "sssp_view": (n,), "wcc_view": (n,),
    }
    for name, shape in shapes.items():
        t = res[name]
        if tuple(t.shape) != shape:
            raise AssertionError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.is_floating_point() and name != "sssp_view" and not torch.isfinite(t).all():
            raise AssertionError(f"{name}: non-finite values")
    pr = res["pagerank_view"]
    return {"edge_search_hits": int(res["edge_search_view"].sum()),
            "pagerank_sum": float(pr.double().sum()),
            "bfs_reached": int((res["bfs_view"] >= 0).sum()),
            "sssp_reached": int(torch.isfinite(res["sssp_view"]).sum()),
            "wcc_components": int(torch.unique(res["wcc_view"]).numel())}


def check_cpu_route(view, ops, res) -> dict:
    """BFS, SSSP and WCC bitwise, PageRank within tolerance, against the
    port's own functions on CPU copies of the same view's COO."""
    import torch

    from repro_torch.core import analytics as A

    src, dst = (t.cpu() for t in view.to_coo_device())
    n = view.n_vertices
    t0 = time.perf_counter()
    want = {
        "bfs_view": A.bfs_coo(src, dst, n, 0),
        "sssp_view": A.sssp_coo(src, dst, ops["w"].cpu(), n, 0),
        "wcc_view": A.wcc_coo(src, dst, n),
    }
    for name, w in want.items():
        if not torch.equal(res[name].cpu(), w):
            raise AssertionError(f"{name} differs from the CPU route")
    pr_cpu = A.pagerank_coo(src, dst, n)
    pr = res["pagerank_view"].cpu()
    # f32 sums in another order (atomics on the card): relative tolerance
    torch.testing.assert_close(pr, pr_cpu, rtol=1e-3, atol=1e-9)
    rel = float(((pr.double() - pr_cpu.double()).abs() / pr_cpu.double().abs()).max())
    return {"cpu_route_s": time.perf_counter() - t0, "pagerank_max_rel_err": rel}


def random_writes(view, rng, n_txn: int):
    """``n_txn`` (ins, dels) batches: uniform random inserts and deletes of
    existing edges of ``view``."""
    import numpy as np

    src, dst = view.to_coo()
    n = view.n_vertices
    batches = []
    pick = rng.choice(len(src), n_txn * N_DELS, replace=False)
    for t in range(n_txn):
        ins = rng.integers(0, n, size=(N_INS, 2))
        ins = ins[ins[:, 0] != ins[:, 1]]
        sel = pick[t * N_DELS:(t + 1) * N_DELS]
        dels = np.stack([src[sel], dst[sel].astype(np.int64)], 1)
        batches.append((ins, dels))
    return batches


def snapshot_results(res) -> dict:
    return {k: (v.clone() if hasattr(v, "clone") else v.copy())
            for k, v in res.items()
            if k in ("edge_search_view", "leaf_scan_reduce_view", "leaf_spmm_view")}


def pin_view(store, build_info, seed, device) -> tuple:
    """Pin R0, time its cold device views, and make its operands."""
    from repro_torch.core import device_cache

    r0 = store.begin_read()
    _, cold_blocks = wall(r0.view.to_leaf_blocks_device, device)
    _, cold_coo = wall(r0.view.to_coo_device, device)
    uploads_cold = device_cache.stats.snapshot()
    ops0 = make_operands(r0.view, seed, device)
    info = dict(build_info, cold_blocks_s=cold_blocks, cold_coo_s=cold_coo,
                n_subgraphs=store.n_subgraphs,
                n_leaves=r0.view.to_leaf_blocks_device().n_blocks,
                n_edges=int(r0.view.to_coo_device()[0].shape[0]),
                cold_uploads=uploads_cold[2], cold_bytes_uploaded=uploads_cold[3])
    return r0, ops0, info


def phase_main(store, r0, ops0, info, seed, device) -> dict:
    """Phase 3; returns R0's first answers for the isolation check."""
    import numpy as np

    from repro_torch.core import device_cache, view_assembler

    res0, secs0 = run_entry_points(r0.view, ops0, device)
    chk0 = check_results(r0.view, ops0, res0)
    chk0.update(check_cpu_route(r0.view, ops0, res0))
    first = snapshot_results(res0)
    del res0
    # a retired predecessor at R0's timestamp: R1 splices against it
    rp = store.begin_read()
    rp.view.to_leaf_blocks_device()
    rp.view.to_coo_device()
    store.end_read(rp)
    del rp
    rng = np.random.default_rng(seed + 1)
    batches = random_writes(r0.view, rng, N_WRITES)
    t0 = time.perf_counter()
    for ins, dels in batches:
        store.apply(ins, dels)
    write_s = time.perf_counter() - t0
    r1 = store.begin_read()
    splices0 = view_assembler.stats.splices
    _, splice_blocks = wall(r1.view.to_leaf_blocks_device, device)
    _, splice_coo = wall(r1.view.to_coo_device, device)
    splices = view_assembler.stats.splices - splices0
    if splices <= 0:
        raise AssertionError("R1 did not take the splice path")
    ops1 = make_operands(r1.view, seed + 2, device)
    res1, secs1 = run_entry_points(r1.view, ops1, device)
    chk1 = check_results(r1.view, ops1, res1)
    del res1
    up0 = device_cache.stats.uploads
    _, secs_warm = run_entry_points(r1.view, ops1, device)
    warm_uploads = device_cache.stats.uploads - up0
    if warm_uploads:
        raise AssertionError(f"warm repeat uploaded {warm_uploads} arrays")
    breakdown = edge_search_breakdown(r1.view, ops1, device)
    emit("edge_search_breakdown", view="R1 warm", ms=breakdown)
    store.end_read(r1)
    emit("main", **info, write_txns=N_WRITES, write_s=write_s,
         splice_blocks_s=splice_blocks, splice_coo_s=splice_coo,
         splices=splices, r0_query_s=secs0, r0_checks=chk0,
         r1_query_s=secs1, r1_checks=chk1, warm_query_s=secs_warm,
         warm_uploads=warm_uploads)
    return first


def phase_isolation(r0, ops0, first, device) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.leaf_search import edge_search_view
    from repro_torch.kernels.spmm import leaf_scan_reduce_view, leaf_spmm_view

    res, secs = {}, {}

    q = ops0["queries"]
    res["edge_search_view"], secs["edge_search_view"] = wall(
        lambda: edge_search_view(r0.view, q[:, 0], q[:, 1]), device)
    res["leaf_scan_reduce_view"], secs["leaf_scan_reduce_view"] = wall(
        lambda: leaf_scan_reduce_view(r0.view, ops0["x"]), device)
    res["leaf_spmm_view"], secs["leaf_spmm_view"] = wall(
        lambda: leaf_spmm_view(r0.view, ops0["H"]), device)
    for k, v in first.items():
        same = np.array_equal(res[k], v) if isinstance(v, np.ndarray) else torch.equal(res[k], v)
        if not same:
            raise AssertionError(f"pinned R0 answers {k} differently after writes")
    emit("isolation", bitwise_equal=sorted(first), seconds=secs)


def phase_readers(store, seed, device, repeats: int = 4, commits: int = 10) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.leaf_search import edge_search_view
    from repro_torch.kernels.spmm import leaf_scan_reduce_view

    errors, stats = [], {}
    go = threading.Event()

    def reader(k):
        try:
            h = store.begin_read()
            try:
                ops = make_operands(h.view, seed + 10 + k, device, with_h=False)
                q = ops["queries"]
                go.set()
                base = (edge_search_view(h.view, q[:, 0], q[:, 1]),
                        leaf_scan_reduce_view(h.view, ops["x"]).clone())
                for _ in range(repeats):
                    e = edge_search_view(h.view, q[:, 0], q[:, 1])
                    s = leaf_scan_reduce_view(h.view, ops["x"])
                    if not (np.array_equal(e, base[0]) and torch.equal(s, base[1])):
                        raise AssertionError(f"reader {k}: answers changed")
                stats[k] = {"ts": h.ts, "repeats": repeats}
            finally:
                store.end_read(h)
        except BaseException as exc:  # re-raised on the main thread
            errors.append(exc)
            go.set()

    threads = [threading.Thread(target=reader, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    go.wait(timeout=600)
    rng = np.random.default_rng(seed + 3)
    with store.read_view() as v:
        batches = random_writes(v, rng, commits)
    t0 = time.perf_counter()
    for ins, dels in batches:
        store.apply(ins, dels)
    commit_s = time.perf_counter() - t0
    for t in threads:
        t.join(timeout=900)
        if t.is_alive():
            raise AssertionError("a reader thread did not finish")
    if errors:
        raise errors[0]
    emit("readers", readers=stats, commits=commits, commit_s=commit_s)


# ---------------------------------------------------------------------------
# Phase 5s: the shard plane
# ---------------------------------------------------------------------------
PLANE_QUERIES = ("pagerank_view", "bfs_view", "sssp_view", "wcc_view", "spmm_view")
PLANE_TOLERANCE = {"pagerank_view": 1e-5, "spmm_view": 1e-4}  # atomics on the card
# PageRank values average 1/n (2.4e-7 at scale 22), far below 1e-5: also
# held at the CPU route's relative limit (phase 3), scaled to the values
PR_RTOL, PR_ATOL = 1e-3, 1e-9


@contextmanager
def single_route():
    """The ``*_view`` entry points on the single-device route while inside
    (``REPRO_DISABLE_SHARD_PLANE``, the plane's own switch)."""
    import os

    os.environ["REPRO_DISABLE_SHARD_PLANE"] = "1"
    try:
        yield
    finally:
        del os.environ["REPRO_DISABLE_SHARD_PLANE"]


def plane_queries(view, w, h, device, reps: int = 1) -> tuple:
    """PageRank (10 iterations), BFS(0), SSSP(w, 0), WCC and SpMM on
    ``view`` through its store's current route: (answers, median warm
    seconds of ``reps`` calls after the first, or the first call's seconds
    when ``reps`` is 1)."""
    import numpy as np

    from repro_torch.core import analytics as A
    from repro_torch.kernels.spmm import spmm_view

    calls = {"pagerank_view": lambda: A.pagerank_view(view),
             "bfs_view": lambda: A.bfs_view(view, 0),
             "sssp_view": lambda: A.sssp_view(view, w, 0),
             "wcc_view": lambda: A.wcc_view(view),
             "spmm_view": lambda: spmm_view(view, h)}
    res, secs = {}, {}
    for name, fn in calls.items():
        res[name], t = wall(fn, device)
        if reps > 1:
            t = float(np.median([wall(fn, device)[1] for _ in range(reps)]))
        secs[name] = t
    return res, secs


def hold_pagerank(got, want, what: str) -> dict:
    """PageRank within 1e-5 and within rtol ``PR_RTOL``, atol ``PR_ATOL``:
    the largest absolute and relative differences."""
    import torch

    for tol in ({"rtol": 1e-5, "atol": 1e-5}, {"rtol": PR_RTOL, "atol": PR_ATOL}):
        torch.testing.assert_close(got, want, **tol,
                                   msg=lambda m: f"{what}: pagerank_view: {m}")
    diff = (got.double() - want.double()).abs()
    return {"max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / want.double().abs()).max())}


def hold_plane(want: dict, got: dict, what: str) -> dict:
    """BFS, SSSP and WCC bitwise, PageRank as ``hold_pagerank`` and SpMM
    within 1e-4 (rtol = atol); returns the largest absolute difference of
    the two float answers (and PageRank's largest relative one)."""
    import torch

    errs = {}
    for name in PLANE_QUERIES:
        w, g = want[name], got[name]
        if name == "pagerank_view":
            pr = hold_pagerank(g, w, what)
            errs[name], errs["pagerank_rel"] = pr["max_abs_err"], pr["max_rel_err"]
            continue
        tol = PLANE_TOLERANCE.get(name)
        if tol is None:
            if not torch.equal(w, g):
                raise AssertionError(f"{what}: {name} differs bitwise")
            continue
        torch.testing.assert_close(g, w, rtol=tol, atol=tol,
                                   msg=lambda m, n=name: f"{what}: {n}: {m}")
        errs[name] = float((g.double() - w.double()).abs().max()) if w.numel() else 0.0
    return errs


def dropped_partial_rejected(plane, view, want, what: str) -> int:
    """The PageRank check against a plane whose merges drop the lightest
    shard's partials (its degrees and rank contributions): raises unless
    ``hold_pagerank`` rejects the answer; returns the shard dropped."""
    import numpy as np

    from repro_torch.core import analytics as A
    from repro_torch.core import distributed

    loads = [s.n_live for s in plane.sharded_coo(view).shards]
    k = int(np.argmin(loads))
    merge = distributed.merge
    distributed.merge = lambda parts, op: merge([p for i, p in enumerate(parts) if i != k], op)
    try:
        bad = A.pagerank_view(view)
    finally:
        distributed.merge = merge
    try:
        hold_pagerank(bad, want, what)
    except AssertionError:
        return k
    raise AssertionError(f"{what}: the PageRank check passes a plane that lost shard {k}")


def hold_shard_spmm(plane, view, h) -> list:
    """``leaf_spmm`` on each shard's live tiles (the plane's own shapes and
    length columns) against its plain version, every tile, in
    ``SPMM_PLAIN_ROWS`` chunks at 1e-4 as in phase 2; per shard, the tiles
    and the largest absolute difference.  These comparison launches are
    taken off the launch count again."""
    import torch

    from repro_torch.kernels.spmm import leaf_spmm
    from repro_torch.kernels.spmm.ref import leaf_spmm_ref

    launches = leaf_spmm.launches
    out = []
    for k, shard in enumerate(plane.sharded_blocks(view).shards):
        _, rows, length = shard.live()
        hk = h.to(shard.device)
        y = leaf_spmm(rows, hk, length)
        err = 0.0
        for c0 in range(0, shard.n_live, SPMM_PLAIN_ROWS):
            c1 = min(shard.n_live, c0 + SPMM_PLAIN_ROWS)
            yr = leaf_spmm_ref(rows[c0:c1], hk, length[c0:c1])
            torch.testing.assert_close(y[c0:c1], yr, rtol=1e-4, atol=1e-4,
                                       msg=lambda m, k=k: f"leaf_spmm on shard {k}: {m}")
            err = max(err, max_abs_err(y[c0:c1], yr))
            del yr
        del y
        out.append({"shard": k, "tiles": shard.n_live, "width": int(rows.shape[1]),
                    "max_abs_err": err})
    leaf_spmm.launches = launches
    return out


def shard_layout(plane, view) -> list:
    """Per shard: device, live edges, live tiles, the shared caps, uploads
    and bytes uploaded so far."""
    coo, blocks = plane.sharded_coo(view), plane.sharded_blocks(view)
    return [{"device": str(plane.devices[k]), "live_edges": coo.shards[k].n_live,
             "live_tiles": blocks.shards[k].n_live, "coo_cap": coo.cap,
             "tile_cap": blocks.cap, "uploads": plane.stats.uploads[k],
             "bytes_uploaded": plane.stats.bytes_uploaded[k]}
            for k in range(plane.n_shards)]


def shard_writes(view, placement, shard: int, rng, n_txn: int):
    """``n_txn`` (ins, dels) batches whose sources all lie in subgraphs
    placed on ``shard``: random inserts and deletes of existing edges."""
    import numpy as np

    src, dst = view.to_coo()
    n, p = view.n_vertices, view.p
    sids = np.nonzero(np.asarray(placement) == shard)[0]
    mine = np.nonzero(np.isin(src // p, sids))[0]
    pick = rng.choice(mine, n_txn * N_DELS, replace=False)
    batches = []
    for t in range(n_txn):
        u = rng.choice(sids, N_INS) * p + rng.integers(0, p, N_INS)
        ins = np.stack([u, rng.integers(0, n, N_INS)], 1)
        ins = ins[(ins[:, 0] != ins[:, 1]) & (ins[:, 0] < n)]
        sel = pick[t * N_DELS:(t + 1) * N_DELS]
        batches.append((ins, np.stack([src[sel], dst[sel].astype(np.int64)], 1)))
    return batches


def phase_shard_plane(store, seed, device) -> int:
    """Phase 5s on the main store: the five collectives through a
    ``PLANE_SHARDS``-shard plane (modulo, directed) against the
    single-device route on the same view, a write on one shard, a
    migration under a pinned reader, the placements' loads, and the
    device bytes before, at the peak and after the detach.  Returns the
    allocator's peak before the phase (the phase resets it)."""
    import numpy as np
    import torch

    from repro_torch.core.shard_plane import degree_balanced_placement, modulo_placement
    from repro_torch.kernels.spmm import leaf_spmm

    cuda = device.type == "cuda"
    prior_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    mem_before = torch.cuda.memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    g = torch.Generator(device=device).manual_seed(seed + 30)
    n = store.n_vertices
    h = torch.randn((n, D_FEATURES), generator=g, device=device)

    # 1. the single-device route on a pinned view, before the attach
    r1 = store.begin_read()
    w = torch.rand(r1.view.n_edges, generator=g, device=device) + 0.1
    single, single_s = plane_queries(r1.view, w, h, device, reps=3)

    # 2. the plane, and the same timestamp through it
    plane = store.attach_shard_plane(n_devices=PLANE_SHARDS, symmetric=False)
    r2 = store.begin_read()
    if r2.ts != r1.ts or r2.view._plane is not plane:
        raise AssertionError("the view after the attach is not the same snapshot")
    _, coo_s = wall(lambda: plane.sharded_coo(r2.view), device)
    _, tiles_s = wall(lambda: plane.sharded_blocks(r2.view), device)
    layout = shard_layout(plane, r2.view)
    emit("shard_plane_attach", shards=PLANE_SHARDS, policy="modulo", symmetric=False,
         cold_coo_s=coo_s, cold_tiles_s=tiles_s, layout=layout)

    # 3. the same five queries through the plane on the same view
    n0 = leaf_spmm.launches
    sharded, sharded_s = plane_queries(r2.view, w, h, device, reps=3)
    spmm_launches = (leaf_spmm.launches - n0) / (1 + 3)  # the first call + 3 timed
    if "leaf_spmm" in PATH_KERNELS["shard_plane"] and spmm_launches < PLANE_SHARDS:
        raise AssertionError(f"leaf_spmm launched {spmm_launches} times per sharded SpMM")
    errs = hold_plane(single, sharded, "plane vs single route")
    dropped = dropped_partial_rejected(plane, r2.view, single["pagerank_view"],
                                       "a plane without a shard's partials")
    spmm_shards = hold_shard_spmm(plane, r2.view, h)
    # 4. 20 transactions on shard 1's subgraphs: the other shards upload
    # nothing and keep their bundles (R2 retires last, so it is the splice
    # source of the next view)
    placement = plane.placement_for(store.n_subgraphs)
    batches = shard_writes(r2.view, placement, 1, np.random.default_rng(seed + 31), N_WRITES)
    store.end_read(r1)
    pred_coo = r2.view.assembly.sharded.coo
    store.end_read(r2)
    del single, sharded, r1, r2  # ended views' bundles are garbage
    for ins, dels in batches:
        store.apply(ins, dels)
    u0, b0 = list(plane.stats.uploads), list(plane.stats.bytes_uploaded)
    r3 = store.begin_read()
    w3 = torch.rand(r3.view.n_edges, generator=g, device=device) + 0.1
    got3, write_s = plane_queries(r3.view, w3, h, device)
    up = [a - b for a, b in zip(plane.stats.uploads, u0)]
    succ = r3.view.assembly.sharded.coo
    if any(up[k] for k in range(PLANE_SHARDS) if k != 1) or up[1] <= 0:
        raise AssertionError(f"a write on shard 1 uploaded {up} segments per shard")
    reused = [k for k in range(PLANE_SHARDS) if succ.shards[k] is pred_coo.shards[k]]
    if reused != [k for k in range(PLANE_SHARDS) if k != 1]:
        raise AssertionError(f"clean COO shards reused by identity: {reused}")
    with single_route():
        want3, _ = plane_queries(r3.view, w3, h, device)
    errs3 = hold_plane(want3, got3, "after the shard-1 write")
    store.end_read(r3)
    del got3, want3, pred_coo, succ, r3
    emit("shard_plane_write", txns=N_WRITES, shard=1, uploads_delta=up,
         bytes_delta=[a - b for a, b in zip(plane.stats.bytes_uploaded, b0)],
         clean_shards_reused=reused, splices=plane.stats.splices,
         query_s=write_s, max_abs_err=errs3)

    # 5. a migration of the 4 heaviest subgraphs onto the least-loaded
    # shard while a reader stays pinned before the flip
    rb = store.attach_rebalancer()
    sig = rb.shard_signals()
    dst = min(sig, key=lambda k: sig[k]["load"])
    heads = np.array([c.head.n_edges for c in store.chains])
    cur = plane.placement_for(store.n_subgraphs)
    heavy = [int(s) for s in np.argsort(-heads, kind="stable") if int(cur[s]) != dst]
    moves = {sid: dst for sid in heavy[:PLANE_MOVES]}
    r4 = store.begin_read()
    w4 = torch.rand(r4.view.n_edges, generator=g, device=device) + 0.1
    pinned, _ = plane_queries(r4.view, w4, h, device)
    bundles = (r4.view.assembly.sharded.coo, r4.view.assembly.sharded.blocks)
    staged0 = store.stats.get("reshard_bytes_staged", 0)
    epoch, move_s = wall(lambda: rb.execute(rb.plan_moves(moves)), device)
    if epoch is None:
        raise AssertionError("the migration aborted")
    again, _ = plane_queries(r4.view, w4, h, device)
    if (r4.view.assembly.sharded.coo, r4.view.assembly.sharded.blocks) != bundles:
        raise AssertionError("the pinned view's bundles changed under the migration")
    pinned_errs = hold_plane(pinned, again, "pinned reader across the migration")
    pinned_bitwise = [k for k in PLANE_QUERIES if torch.equal(pinned[k], again[k])]
    store.end_read(r4)
    del pinned, again, bundles, r4
    r5 = store.begin_read()
    now = plane.placement_at(r5.ts, store.n_subgraphs)
    if r5.ts < epoch or any(int(now[s]) != d for s, d in moves.items()):
        raise AssertionError("the view after the flip does not resolve the new placement")
    got5, after_s = plane_queries(r5.view, w4, h, device)
    with single_route():
        want5, _ = plane_queries(r5.view, w4, h, device)
    errs5 = hold_plane(want5, got5, "after the migration")
    store.end_read(r5)
    del got5, want5, r5
    store.detach_rebalancer()
    emit("shard_plane_migration", moves={str(k): v for k, v in moves.items()},
         epoch=epoch, send_to_free_s=move_s,
         bytes_staged=store.stats["reshard_bytes_staged"] - staged0,
         pinned_bitwise=pinned_bitwise, pinned_max_abs_err=pinned_errs,
         after_query_s=after_s, max_abs_err=errs5,
         migration_rebuilds=plane.stats.migration_rebuilds,
         loads_after=[plane.shard_load(k) for k in range(PLANE_SHARDS)])

    # 6. the placements' loads at the current heads
    loads = {}
    for name, policy in (("modulo", modulo_placement),
                         ("degree_balanced", degree_balanced_placement)):
        ld = np.bincount(policy(heads, PLANE_SHARDS), weights=heads, minlength=PLANE_SHARDS)
        loads[name] = {"loads": [int(x) for x in ld], "max_over_min": float(ld.max() / ld.min())}

    # 8. detach
    stats = {k: v for k, v in vars(plane.stats).items()}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    store.detach_shard_plane()
    del plane, h, w, w3, w4
    free_device(device)
    mem_after = torch.cuda.memory_allocated(device) if cuda else 0
    emit("shard_plane", shards=PLANE_SHARDS, single_route_s=single_s,
         plane_s=sharded_s, max_abs_err=errs, leaf_spmm_per_sharded_spmm=spmm_launches,
         leaf_spmm_vs_plain=spmm_shards, pagerank_check_rejects_dropped_shard=dropped,
         placement_loads=loads, stats=stats,
         device_bytes={"before_attach": mem_before, "peak": peak, "after_detach": mem_after})
    return prior_peak


def phase_shard_symmetric(store, device) -> None:
    """Phase 6's undirected store under a ``symmetric=True`` plane: pull
    PageRank against the single-device route on the same view."""
    import numpy as np
    import torch

    from repro_torch.core import analytics as A

    def warm(fn):
        """(first answer, median seconds of 3 warm calls)."""
        out = fn()
        return out, float(np.median([wall(fn, device)[1] for _ in range(3)]))

    with store.read_view() as v:
        want, single_s = warm(lambda: A.pagerank_view(v))
    plane = store.attach_shard_plane(n_devices=PLANE_SHARDS, symmetric=True)
    with store.read_view() as v:
        _, cold_s = wall(lambda: plane.sharded_coo(v), device)
        got, plane_s = warm(lambda: A.pagerank_view(v))
        err = hold_pagerank(got, want, "symmetric plane vs single route")
        dropped = dropped_partial_rejected(plane, v, want, "a symmetric plane without a shard")
    store.detach_shard_plane()
    emit("shard_plane_symmetric", shards=PLANE_SHARDS, cold_coo_s=cold_s,
         pagerank_single_s=single_s, pagerank_plane_s=plane_s,
         pagerank_max_abs_err=err["max_abs_err"], pagerank_max_rel_err=err["max_rel_err"],
         pagerank_check_rejects_dropped_shard=dropped, bitwise=bool(torch.equal(got, want)))


def phase_write_side(store, seed, device) -> None:
    """Phase 5a on the main store: pipelined writers with two pinned
    readers, a fold while one reader stays pinned, more writes, and the
    entry points on a fresh view R2."""
    import numpy as np
    import torch

    from repro_torch.core import device_cache, view_assembler
    from repro_torch.kernels.leaf_search import edge_search_view
    from repro_torch.kernels.spmm import leaf_scan_reduce_view

    errors, readers = [], {}
    ready = [threading.Event(), threading.Event()]
    stop = [threading.Event(), threading.Event()]

    def reader(k):
        """Repeat two queries on a pinned view until told to stop, then
        once more; every answer must equal the first bit for bit."""
        try:
            h = store.begin_read()
            try:
                ops = make_operands(h.view, seed + 20 + k, device, with_h=False)
                q = ops["queries"]

                def ask():
                    out = (edge_search_view(h.view, q[:, 0], q[:, 1]),
                           leaf_scan_reduce_view(h.view, ops["x"]))
                    sync(device)
                    return out

                base = ask()
                ready[k].set()
                repeats = 0
                while True:
                    last = stop[k].is_set()
                    e, s = ask()
                    if not (np.array_equal(e, base[0]) and torch.equal(s, base[1])):
                        raise AssertionError(f"reader {k}: answers changed")
                    repeats += 1
                    if last:
                        break
                readers[k] = {"ts": h.ts, "repeats": repeats}
            finally:
                store.end_read(h)
        except BaseException as exc:  # re-raised on the main thread
            errors.append(exc)
            ready[k].set()

    def join(threads):
        for t in threads:
            t.join(timeout=JOIN_S)
            if t.is_alive():
                raise AssertionError(f"{t.name} did not finish")
        if errors:
            raise errors[0]

    def writer(k):
        try:
            for t in [store.apply_async(i, d) for i, d in first[k::WS_WRITERS]]:
                t.wait()
        except BaseException as exc:
            errors.append(exc)

    rthreads = [threading.Thread(target=reader, args=(k,), name=f"reader {k}", daemon=True)
                for k in range(2)]
    wthreads = [threading.Thread(target=writer, args=(k,), name=f"writer {k}", daemon=True)
                for k in range(WS_WRITERS)]
    try:
        for t in rthreads:
            t.start()
        for e in ready:
            if not e.wait(timeout=JOIN_S):
                raise AssertionError("a reader did not start")
        if errors:
            raise errors[0]
        wp = store.attach_write_pipeline()  # 4 shards, batches up to 1024
        rng = np.random.default_rng(seed + 4)
        with store.read_view() as v:
            batches = random_writes(v, rng, WS_WRITERS * WS_TXNS + WS_MORE)
        first, more = batches[:WS_WRITERS * WS_TXNS], batches[WS_WRITERS * WS_TXNS:]
        t0 = time.perf_counter()
        for t in wthreads:
            t.start()
        join(wthreads)
        store.flush()
        commit_s = time.perf_counter() - t0
        pipe = {f: getattr(wp.stats, f) for f in (
            "writes", "batches", "fences", "noop_batches", "publish_runs", "max_batch",
            "max_publish_run")}
        stop[0].set()
        join(rthreads[:1])
        comp = store.attach_compactor()
        live0 = store.pool.n_live_rows()
        report, fold_s = wall(comp.compact_once, device)  # reader 1 stays pinned
        stop[1].set()
        join(rthreads[1:])
    finally:  # a failed phase leaves no reader looping
        for e in stop:
            e.set()

    t0 = time.perf_counter()
    for t in [store.apply_async(i, d) for i, d in more]:
        t.wait()
    store.flush()
    more_s = time.perf_counter() - t0

    fields = ("splices", "full_concats", "base_splices", "reuses", "snapshot_touches",
              "fallback_no_pred", "fallback_lineage", "fallback_dirty_frac")
    va0 = {f: getattr(view_assembler.stats, f) for f in fields}
    up0 = device_cache.stats.snapshot()
    r2 = store.begin_read()
    cold_tiles = sum(s._dev_blocks_cache is None for s in r2.view.snaps)
    cold_coo = sum(s._dev_coo_cache is None for s in r2.view.snaps)
    _, blocks_s = wall(r2.view.to_leaf_blocks_device, device)
    _, coo_s = wall(r2.view.to_coo_device, device)
    up1 = device_cache.stats.snapshot()
    uploads = up1[2] - up0[2]
    # O(dirty): a snapshot uploads its 3 stream arrays and 2 COO arrays once
    if uploads > 3 * cold_tiles + 2 * cold_coo:
        raise AssertionError(f"R2 uploaded {uploads} arrays for {cold_tiles} snapshots "
                             f"without tiles and {cold_coo} without COO")
    assembler = {f: getattr(view_assembler.stats, f) - va0[f] for f in fields}
    ops2 = make_operands(r2.view, seed + 25, device)
    res2, secs2 = run_entry_points(r2.view, ops2, device)
    chk2 = check_results(r2.view, ops2, res2)
    chk2.update(check_cpu_route(r2.view, ops2, res2))
    del res2
    up = device_cache.stats.uploads
    _, secs_warm = run_entry_points(r2.view, ops2, device)
    warm_uploads = device_cache.stats.uploads - up
    if warm_uploads:
        raise AssertionError(f"R2's warm repeat uploaded {warm_uploads} arrays")
    store.end_read(r2)

    mem = store.memory_breakdown()
    if mem["pipeline"] != wp.queued_bytes() or mem["pipeline"]:
        raise AssertionError(f"flushed pipeline still holds {mem['pipeline']} bytes")
    if sum(mem.values()) != store.memory_bytes():
        raise AssertionError("memory_breakdown does not add up to memory_bytes")
    base = store._base_assembly
    store.detach_write_pipeline()
    store.detach_compactor()
    emit("write_side", writers=WS_WRITERS, txns=len(first), txns_after_fold=len(more),
         commit_s=commit_s, commits_per_s=len(first) / commit_s, pipeline=pipe,
         mean_group=pipe["writes"] / max(1, pipe["batches"]), readers=readers,
         fold_s=fold_s, report={k: v for k, v in vars(report).items() if k != "repacked"},
         repacked=len(report.repacked), live_rows_before_fold=live0,
         tier_migrations=store.stats.get("tier_migrations", 0),
         more_s=more_s, r2_cold_blocks_s=blocks_s, r2_cold_coo_s=coo_s,
         r2_uploads=uploads, r2_bytes_uploaded=up1[3] - up0[3],
         r2_snapshots_without_tiles=cold_tiles, r2_snapshots_without_coo=cold_coo,
         r2_assembler=assembler, r2_query_s=secs2, r2_checks=chk2,
         warm_query_s=secs_warm, warm_uploads=warm_uploads, memory_breakdown=mem,
         base_bundle_bytes={"host": base.host_bytes(), "device": base.device_bytes()})


# ---------------------------------------------------------------------------
# Phase 5g: GNN training on the live store
# ---------------------------------------------------------------------------
def gnn_config(arch: str):
    from repro_torch.configs import registry

    return (registry.get_smoke_config if MODEL_SMOKE else registry.get_config)(arch)


def gnn_flops(cfg, n_nodes: int, n_edges: int, d_feat: int) -> float:
    """A train step's FLOPs by the reference's formula
    (``repro/roofline/model.py:112``): per layer E*d messages and N*d^2
    transforms, the first layer's N*d_feat*d, x3 for the backward."""
    d = cfg.d_hidden
    per_layer = 2.0 * n_edges * d + 2.0 * n_nodes * d * d
    return 3.0 * (2.0 * n_nodes * d_feat * d + cfg.n_layers * per_layer)


def leaf_errors(got, want) -> list:
    """Per leaf (``tree_leaves`` order): largest |got - want| over the
    leaf's largest |want|, in float64 on the host."""
    from repro_torch.optim.tree import tree_leaves

    out = []
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.detach().cpu().double(), w.detach().cpu().double()
        out.append(float((g - w).abs().max() / max(float(w.abs().max()), 1e-30)))
    return out


def gnn_grads(cfg, params, batch, n_nodes: int, dev, dtype, reverse: bool = False):
    """((loss, grads), seconds) of the GNN loss at ``params`` on ``batch``,
    both copied to ``dev`` in ``dtype``; ``reverse`` swaps ``src`` and
    ``dst``, the planted fault."""
    from repro_torch.optim.tree import tree_map
    from repro_torch.train.step import gnn_value_and_grad

    p = tree_map(lambda t: t.to(dev, dtype), params)
    b = {k: t.to(dev, dtype) if t.is_floating_point() else t.to(dev) for k, t in batch.items()}
    src, dst = (b["dst"], b["src"]) if reverse else (b["src"], b["dst"])
    return wall(lambda: gnn_value_and_grad(
        cfg, p, b["feats"], src, dst, b["emask"], b["labels"], b["lmask"], n_nodes), dev)


def gnn_card_routes(cfg, params, batch, n_nodes: int, device, f32_fault: bool) -> dict:
    """The card's (loss, grads) at ``params`` on ``batch`` in float64 and
    f32, and with the edges reversed in float64 (and f32 with
    ``f32_fault``), keyed by route, with their seconds."""
    import torch

    out, secs = {}, {}
    for name, dtype, reverse in (("f64", torch.float64, False), ("f64_reversed", torch.float64, True),
                                 ("f32", torch.float32, False), ("f32_reversed", torch.float32, True)):
        if name != "f32_reversed" or f32_fault:
            out[name], secs[name] = gnn_grads(cfg, params, batch, n_nodes, device, dtype, reverse)
    return dict(routes=out, seconds=secs)


def gnn_cpu_routes(cfg, params, batch, n_nodes: int, f32: bool) -> dict:
    """The port's CPU route on host copies: float64, and f32 with ``f32``."""
    import torch

    cpu = torch.device("cpu")
    out, secs = {}, {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32))[:2 if f32 else 1]:
        out[name], secs[name] = gnn_grads(cfg, params, batch, n_nodes, cpu, dtype)
    return dict(routes=out, seconds=secs)


def hold_gnn(cfg, what: str, got, want, limits, controls: dict) -> dict:
    """``got`` (loss, grads) against ``want``: the loss within
    ``GNN_LOSS_RTOL``, every gradient leaf within its limit of its largest
    magnitude.  Each of ``controls`` (name -> (loss, grads)) must put some
    leaf outside its limit.  Returns the figures."""
    from repro_torch.optim.tree import tree_leaves

    loss_err = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    if not math.isfinite(float(got[0])) or loss_err > GNN_LOSS_RTOL:
        raise AssertionError(f"{cfg.name} {what}: card loss {float(got[0])} "
                             f"vs CPU {float(want[0])}")
    errs = leaf_errors(got[1], want[1])
    if not len(errs) == len(limits) == len(tree_leaves(want[1])):
        raise AssertionError(f"{cfg.name} {what}: gradient trees differ in their leaves")
    over = [(i, e, lim) for i, (e, lim) in enumerate(zip(errs, limits)) if not e <= lim]
    if over:
        raise AssertionError(f"{cfg.name} {what}: gradient leaves outside their limits: {over}")
    out = dict(loss_rel_err=loss_err, max_leaf_err=max(errs), max_leaf_limit=max(limits))
    for name, bad in controls.items():
        bad_errs = leaf_errors(bad[1], want[1])
        if all(e <= lim for e, lim in zip(bad_errs, limits)):
            raise AssertionError(f"{cfg.name} {what}: the control {name} passes the check")
        out[f"{name}_max_leaf_err"] = max(bad_errs)
    return out


def hold_gnn_step(cfg, card: dict, cpu: dict) -> dict:
    """Step 0's card routes against the CPU's.  Float64: each leaf within
    ``GNN_F64_GRAD_TOL[kind]``; reversed edges and the card's f32 are the
    controls.  f32, where the CPU route ran it: each leaf within
    ``GNN_F32_GRAD_TOL`` or ten times the CPU route's own f32 error
    (against its float64) where that is larger, as f32 GNNs can be
    ill-conditioned; reversed edges the control."""
    from repro_torch.optim.tree import tree_leaves

    c, h = card["routes"], cpu["routes"]
    n_leaves = len(tree_leaves(h["f64"][1]))
    out = dict(loss=float(c["f32"][0]), leaves=n_leaves,
               f64=hold_gnn(cfg, "f64", c["f64"], h["f64"], [GNN_F64_GRAD_TOL[cfg.kind]] * n_leaves,
                            {"reversed_edges": c["f64_reversed"], "card_f32": c["f32"]}),
               card_f32_vs_f64_max_leaf_err=max(leaf_errors(c["f32"][1], c["f64"][1])),
               card_s=card["seconds"], cpu_s=cpu["seconds"])
    if "f32" in h:
        cpu_errs = leaf_errors(h["f32"][1], h["f64"][1])
        limits = [max(GNN_F32_GRAD_TOL, 10 * e) for e in cpu_errs]
        out["f32"] = hold_gnn(cfg, "f32", c["f32"], h["f32"], limits,
                              {"reversed_edges": c["f32_reversed"]})
        out["f32"].update(cpu_f32_vs_f64_max_leaf_err=max(cpu_errs),
                          leaf_limits_above_tol=sum(lim > GNN_F32_GRAD_TOL for lim in limits))
    return out


def hold_adamw(params, opt, grads, device) -> float:
    """AdamW on the card and on the CPU from the same parameters, state and
    gradients: every new parameter and moment within ``GNN_ADAMW_TOL``.
    Returns the largest difference."""
    import torch

    from repro_torch.optim import adamw
    from repro_torch.optim.tree import tree_leaves, tree_map

    cpu = lambda t: t.detach().cpu()
    on_card = adamw.update(tree_map(lambda g: g.to(device), grads), opt, params,
                           GNN_LR, weight_decay=0.0)
    on_cpu = adamw.update(grads, adamw.AdamWState(cpu(opt.step), tree_map(cpu, opt.mu),
                                                  tree_map(cpu, opt.nu)),
                          tree_map(cpu, params), GNN_LR, weight_decay=0.0)
    worst = 0.0
    for tree_card, tree_cpu in zip((on_card[0], on_card[1].mu, on_card[1].nu),
                                   (on_cpu[0], on_cpu[1].mu, on_cpu[1].nu)):
        for a, b in zip(tree_leaves(tree_card), tree_leaves(tree_cpu)):
            worst = max(worst, max_abs_err(a.cpu(), b))
    if worst > GNN_ADAMW_TOL or int(on_card[1].step) != int(on_cpu[1].step):
        raise AssertionError(f"AdamW on the card and the CPU differ by {worst}")
    return worst


def check_sampled_edges(view, sub, rng, k: int = 20) -> int:
    """``k`` sampled edges, each a real edge of ``view``: the message
    v -> u of a block edge (src, dst) runs along the stored edge u -> v."""
    import numpy as np

    src, dst = sub.merged_edges()
    for e in rng.choice(len(src), size=min(k, len(src)), replace=False):
        u, v = int(sub.nodes[dst[e]]), int(sub.nodes[src[e]])
        if v not in set(view.scan(u).tolist()):
            raise AssertionError(f"sampled edge {u} -> {v} is not in the pinned view")
    return min(k, len(src))


def in_background(fn, name: str):
    """Start ``fn()`` on a thread; returns a ``join()`` that gives
    ``(result, seconds)`` or raises what ``fn`` raised."""
    box = {}

    def body():
        t0 = time.perf_counter()
        try:
            box["out"] = fn()
        except BaseException as exc:  # re-raised by join()
            box["exc"] = exc
        box["s"] = time.perf_counter() - t0

    t = threading.Thread(target=body, name=name, daemon=True)
    t.start()

    def join():
        t.join(timeout=JOIN_S)
        if t.is_alive():
            raise AssertionError(f"{name} did not finish in {JOIN_S} s")
        if "exc" in box:
            raise box["exc"]
        return box["out"], box["s"]

    return join


def phase_gnn_train(store, seed, device) -> int:
    """Phase 5g on the main store: gin-tu trains for ``GNN_STEPS`` steps on
    minibatches sampled from pinned views while a writer thread commits,
    with the features on the card.  Then step 0 and one step each of the
    other three GNNs on step 0's batch against the CPU route, which runs on
    a host thread while the card side checks the checkpoint and the store.
    Returns the allocator's peak before the phase (the phase resets it)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data.pipeline import GraphUpdateStream
    from repro_torch.graph.sampler import NeighborSampler, pad_subgraph
    from repro_torch.models import gnn as G
    from repro_torch.optim import adamw
    from repro_torch.optim.tree import tree_leaves, tree_map
    from repro_torch.train.step import make_gnn_train_step

    if store.write_pipeline is not None:
        raise AssertionError("a write pipeline is still attached")
    cell = next(c for c in GNN_SHAPES if c.name == "minibatch_lg").params
    n_seeds, fanouts, d_feat = GNN_SEEDS, GNN_FANOUTS, GNN_D_FEAT
    max_n = n_seeds * (1 + fanouts[0] + fanouts[0] * fanouts[1])
    max_e = n_seeds * (fanouts[0] + fanouts[0] * fanouts[1])
    n = store.n_vertices
    prior_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(seed + 30)

    def tables():  # features on the card; labels a linear threshold of them
        feat = torch.randn((n, d_feat), generator=gen, device=device)
        return feat, (feat @ torch.randn(d_feat, generator=gen, device=device) > 0).int()

    (feat_table, label_table), table_s = wall(tables, device)
    cfg = gnn_config(GNN_ARCH)
    params = G.init_gnn(cfg, gen, d_feat, device=device)
    opt = adamw.init(params)
    params0, opt0 = params, opt  # the update makes new tensors: these stay step 0's
    step_fn = make_gnn_train_step(cfg, n_nodes=max_n, lr=GNN_LR)
    rng = np.random.default_rng(seed + 31)

    stop, write_errors, writes = threading.Event(), [], [0]

    def writer():
        stream = GraphUpdateStream(n, batch=128, seed=42)
        try:
            while not stop.is_set():
                u = stream[writes[0]]
                store.insert_edges(u["insert"])
                store.delete_edges(u["delete"])
                writes[0] += 1
                time.sleep(0.002)
        except Exception as exc:  # re-raised on the main thread
            write_errors.append(exc)

    # the timed steps: every step but the profiled one, without step 0's
    # sampled-edge check (the CPU route runs after the loop)
    profiled, check_s, profiled_iter_s = GNN_STEPS // 2, 0.0, 0.0
    commits0 = store.stats["commits"]
    w = threading.Thread(target=writer, name="gnn writer", daemon=True)
    losses, parts, sizes, checks = [], {"sample": [], "gather": [], "step": []}, [], {}
    t_loop = time.perf_counter()
    w.start()
    try:
        for it in range(GNN_STEPS):
            t0 = time.perf_counter()
            with store.read_view() as view:
                sampler = NeighborSampler(view.scan, fanouts=list(fanouts), seed=seed * 1000 + it)
                sub = sampler.sample(rng.choice(n, n_seeds, replace=False).astype(np.int64))
                nodes, src, dst, nmask, emask = pad_subgraph(sub, max_n, max_e)
                if it == 0:
                    tc = time.perf_counter()
                    checks["sampled_edges_checked"] = check_sampled_edges(view, sub, rng)
                    check_s = time.perf_counter() - tc
            sample_s = time.perf_counter() - t0 - (check_s if it == 0 else 0.0)
            sizes.append((sub.n_nodes, len(sub.merged_edges()[0])))

            def gather():
                idx = torch.from_numpy(nodes).to(device)
                return {"feats": feat_table[idx] * torch.from_numpy(nmask).to(device)[:, None],
                        "labels": label_table[idx], "src": torch.from_numpy(src).to(device),
                        "dst": torch.from_numpy(dst).to(device),
                        "emask": torch.from_numpy(emask).to(device),
                        "lmask": (torch.arange(max_n, device=device) < sub.n_seeds).float()}

            batch, gather_s = wall(gather, device)
            if it == 0:
                first = batch
            run = lambda: step_fn(params, opt, batch["feats"], batch["src"], batch["dst"],
                                  batch["emask"], batch["labels"], batch["lmask"])
            if it == profiled:
                out = []
                busy_ms, prof_ms = profiled_step(lambda: out.append(run()), device)
                params, opt, metrics = out[0]
                profiled_iter_s = time.perf_counter() - t0  # the profiler's set-up included
            else:
                (params, opt, metrics), step_s = wall(run, device)
                for part, secs in zip(parts, (sample_s, gather_s, step_s)):
                    parts[part].append(secs)
            losses.append(float(metrics["loss"]))
    finally:
        stop.set()
        w.join(timeout=JOIN_S)
    loop_s = time.perf_counter() - t_loop
    if w.is_alive():
        raise AssertionError("the GNN writer did not stop")
    if write_errors:
        raise write_errors[0]
    commits = store.stats["commits"] - commits0
    timed_s = sum(sum(v) for v in parts.values())
    _, quiet_s = wall(run, device)  # the last step again, no writer holding the GIL
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite GNN loss: {losses}")
    k = min(5, GNN_STEPS // 2)
    if not np.mean(losses[-k:]) < np.mean(losses[:k]):
        raise AssertionError(f"gin-tu did not learn: {losses}")

    # step 0 of gin-tu and one step each of the other three on step 0's
    # batch: the card side now, the CPU route on host copies in the background
    models = {GNN_ARCH: (cfg, params0)}
    others = {}
    for arch in GNN_OTHER:
        ocfg = gnn_config(arch)
        oparams = G.init_gnn(ocfg, gen, d_feat, device=device)
        models[arch] = (ocfg, oparams)
        ostep = make_gnn_train_step(ocfg, n_nodes=max_n, lr=GNN_LR)
        (_, _, om), ostep_s = wall(lambda: ostep(
            oparams, adamw.init(oparams), first["feats"], first["src"], first["dst"],
            first["emask"], first["labels"], first["lmask"]), device)
        if not math.isfinite(float(om["loss"])):
            raise AssertionError(f"{arch}: non-finite loss")
        others[arch] = dict(step_s=ostep_s, flops=gnn_flops(ocfg, max_n, max_e, d_feat))
    card = {arch: gnn_card_routes(c, p, first, max_n, device, f32_fault=arch == GNN_ARCH)
            for arch, (c, p) in models.items()}
    def host(t):
        return t.detach().cpu()

    first_cpu = {k: host(t) for k, t in first.items()}
    cpu_params = {arch: (c, tree_map(host, p)) for arch, (c, p) in models.items()}
    join_cpu = in_background(lambda: {
        arch: gnn_cpu_routes(c, p, first_cpu, max_n, f32=arch == GNN_ARCH)
        for arch, (c, p) in cpu_params.items()}, "gnn CPU route")
    t_beside = time.perf_counter()

    with tempfile.TemporaryDirectory() as tmp:
        saver = ckpt.AsyncCheckpointer(tmp)
        _, save_s = wall(lambda: (saver.save(GNN_STEPS - 1, (params, opt)), saver.wait()),
                         device)
        (p_back, o_back), meta = ckpt.restore(tmp, (params, opt))
    same = [torch.equal(a, b) for a, b in zip(
        tree_leaves(p_back) + tree_leaves(o_back.mu) + tree_leaves(o_back.nu) + [o_back.step],
        tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu) + [opt.step])]
    if not all(same) or meta["step"] != GNN_STEPS - 1:
        raise AssertionError("the (params, AdamWState) checkpoint did not restore bitwise")
    _, invariants_s = wall(store.check_invariants, device)
    beside_s = time.perf_counter() - t_beside
    cpu, cpu_route_s = join_cpu()

    checks[GNN_ARCH] = hold_gnn_step(cfg, card[GNN_ARCH], cpu[GNN_ARCH])
    cpu_loss0 = float(cpu[GNN_ARCH]["routes"]["f32"][0])
    checks["loop_step0_loss_rel_err"] = abs(losses[0] - cpu_loss0) / abs(cpu_loss0)
    if not checks["loop_step0_loss_rel_err"] <= GNN_LOSS_RTOL:
        raise AssertionError(f"the loop's step 0 loss {losses[0]} vs CPU {cpu_loss0}")
    checks["adamw_max_abs_err"] = hold_adamw(params0, opt0, cpu[GNN_ARCH]["routes"]["f32"][1],
                                             device)
    for arch in GNN_OTHER:
        others[arch].update(hold_gnn_step(models[arch][0], card[arch], cpu[arch]))

    med = {p: float(np.median(v)) for p, v in parts.items()}
    flops = gnn_flops(cfg, max_n, max_e, d_feat)
    nodes_e = np.array(sizes)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    del feat_table, label_table, first, batch, models, card
    free_device(device)
    emit("gnn_train", arch=GNN_ARCH, cell="minibatch_lg", graph_vertices=n,
         published_graph=[cell["n_nodes"], cell["n_edges"]], seeds=n_seeds,
         fanouts=fanouts, d_feat=d_feat, max_nodes=max_n, max_edges=max_e, steps=GNN_STEPS,
         lr=GNN_LR, losses=losses, table_s=table_s, median_s=med,
         step_without_writer_s=quiet_s, timed_steps=len(parts["step"]), timed_s=timed_s,
         steps_per_s=len(parts["step"]) / timed_s,
         seeds_per_s=len(parts["step"]) * n_seeds / timed_s, loop_s=loop_s,
         profiled_iter_s=profiled_iter_s, sampled_edges_check_s=check_s,
         sampled_nodes=[int(nodes_e[:, 0].min()), float(nodes_e[:, 0].mean()),
                        int(nodes_e[:, 0].max())],
         sampled_edges=[int(nodes_e[:, 1].min()), float(nodes_e[:, 1].mean()),
                        int(nodes_e[:, 1].max())],
         commits=commits, commits_per_s=commits / loop_s, writer_batches=writes[0],
         profiled_step_ms=prof_ms, device_busy_ms=busy_ms,
         device_idle_share=None if busy_ms is None else 1 - busy_ms / prof_ms,
         step_flops=flops, step_tflops_per_s=flops / med["step"] / 1e12,
         f32_peak_share=flops / med["step"] / CUDA_CORE_OPS_PER_S,
         f32_peak_share_without_writer=flops / quiet_s / CUDA_CORE_OPS_PER_S,
         checks=checks, checkpoint_save_s=save_s, check_invariants_s=invariants_s,
         cpu_route_s=cpu_route_s, beside_cpu_route_s=beside_s,
         other_models=others, peak_allocated_bytes=peak)
    return prior_peak


def phase_durability(seed, device) -> None:
    """Phase 5b: WAL, checkpoint and recovery of a tiered store on the
    card; the recovered view held against the live one and, entry point
    by entry point, against the same layout on the CPU route."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import RapidStore
    from repro_torch.core.analytics import triangle_count_view
    from repro_torch.core.wal import WriteAheadLog

    cpu = torch.device("cpu")
    store, info = build_store(DUR_SCALE, seed, device, leaf_tiers=DUR_TIERS)
    rng = np.random.default_rng(seed + 30)
    with store.read_view() as v:
        batches = random_writes(v, rng, DUR_WRITES + DUR_MORE)
    ckpt_s = []
    checkpoint = store.checkpoint

    def timed_checkpoint(directory):
        t0 = time.perf_counter()
        ts = checkpoint(directory)
        ckpt_s.append(time.perf_counter() - t0)
        return ts

    store.checkpoint = timed_checkpoint  # the compactor's checkpoint cycle calls it
    with tempfile.TemporaryDirectory(prefix="chip_smoke_durability_") as root:
        wal_path = os.path.join(root, "wal.log")
        store.attach_wal(wal_path)  # fsync on every commit
        comp = store.attach_compactor(checkpoint_dir=os.path.join(root, "checkpoints"))
        store.attach_write_pipeline()
        t0 = time.perf_counter()
        for t in [store.apply_async(i, d) for i, d in batches[:DUR_WRITES]]:
            t.wait()
        write_s = time.perf_counter() - t0
        report, fold_s = wall(lambda: comp.compact_once(checkpoint=True), device)
        t0 = time.perf_counter()
        for t in [store.apply_async(i, d) for i, d in batches[DUR_WRITES:]]:
            t.wait()
        store.flush()
        more_s = time.perf_counter() - t0
        wal_bytes = store.wal.size_bytes()
        store.detach_write_pipeline()
        store.detach_compactor()
        store.detach_wal()
        _, records, clean = WriteAheadLog.replay(wal_path)
        live = store.begin_read()
        rec, rec_s = wall(lambda: RapidStore.recover(root, attach=False, device=device),
                          device)
        twin, twin_s = wall(lambda: RapidStore.recover(root, attach=False, device="cpu"),
                            device)
    if rec.device.type != device.type or not clean:
        raise AssertionError("recovery left the device or found a torn log")
    rh, th = rec.begin_read(), twin.begin_read()
    L, R, C = live.view, rh.view, th.view
    _, blocks_s = wall(R.to_leaf_blocks_device, device)
    _, coo_s = wall(R.to_coo_device, device)
    tiers = sorted(R.to_leaf_blocks_device().groups)
    if tiers != list(DUR_TIERS):
        raise AssertionError(f"the recovered store's device tiles hold tiers {tiers}")
    for a, b in zip(L.to_coo(), R.to_coo()):
        if not np.array_equal(a, b):
            raise AssertionError("the recovered edge set differs from the live one")
    for a, b in zip(stream_arrays(R), stream_arrays(C)):
        if not np.array_equal(a, b):
            raise AssertionError("two recoveries differ in their leaf streams")

    # answers that do not depend on the layout: the live view on the card
    # (the tile-indexed ones are not: L's tile indices do not name R's tiles)
    layout_free = ("edge_search_view", "spmm_view", "pagerank_view", "bfs_view",
                   "sssp_view", "wcc_view")
    ops = make_operands(L, seed + 31, device, n_pairs=DUR_PAIRS, d=DUR_D)
    res_l, _ = run_entry_points(L, ops, device, layout_free)
    res_r, _ = run_entry_points(R, ops, device, layout_free)
    tri_l, tri_l_s = wall(lambda: triangle_count_view(L), device)
    tri_r, tri_r_s = wall(lambda: triangle_count_view(R), device)
    if tri_l != tri_r:
        raise AssertionError(f"triangle_count_view: recovered {tri_r} != live {tri_l}")
    live_err = hold(res_l, res_r, layout_free)
    del res_l, res_r

    # every entry point on R on the card against the same layout on the CPU
    ops = make_operands(R, seed + 32, device, n_pairs=DUR_PAIRS, d=DUR_D)
    res_r, secs_r = run_entry_points(R, ops, device)
    chk = check_results(R, ops, res_r)
    ops_c = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in ops.items()}
    res_c, secs_c = run_entry_points(C, ops_c, cpu)
    cpu_err = hold(res_c, res_r, ENTRY_POINTS)
    # the triangle count's plain route intersects every tile pair's
    # [Ba, Bb] ids on the host, too slow here: a host count of the same sum
    tri_host, tri_host_s = wall(lambda: full_neighbour_triangles(C.to_csr()), device)
    if tri_host != tri_r:
        raise AssertionError(f"triangle_count_view {tri_r} != host count {tri_host}")
    for h, s in ((live, store), (rh, rec), (th, twin)):
        s.end_read(h)
    emit("durability", scale=DUR_SCALE, leaf_tiers=list(DUR_TIERS), **info,
         writes=DUR_WRITES, writes_after_checkpoint=DUR_MORE, write_s=write_s,
         more_s=more_s, fold_and_checkpoint_s=fold_s, checkpoint_s=ckpt_s,
         report={k: v for k, v in vars(report).items() if k != "repacked"},
         repacked=len(report.repacked), wal_bytes=wal_bytes, wal_records=len(records),
         wal_replayed=rec.stats["wal_replayed"],
         tier_migrations=store.stats.get("tier_migrations", 0),
         tier_migrations_held=store.stats.get("tier_migrations_held", 0),
         recover_s=rec_s, recover_cpu_s=twin_s, r_cold_blocks_s=blocks_s, r_cold_coo_s=coo_s,
         tiers=tiers, triangles=tri_r,
         triangle_s={"live": tri_l_s, "recovered": tri_r_s, "host": tri_host_s},
         r_checks=chk, live_vs_recovered=live_err, card_vs_cpu=cpu_err,
         r_query_s=secs_r, cpu_query_s=secs_c)


def full_neighbour_triangles(csr, chunk: int = 1 << 22) -> int:
    """``triangle_count_view``'s function on the host, by another
    algorithm: the sum over edges (u, v), u < v, of |N(u) & N(v)| over the
    full out-neighbour lists, divided by 3.  Each edge's shorter list is
    probed in the sorted edge keys u * n + w (``torch.searchsorted`` on
    the CPU), ``chunk`` probes at a time."""
    import numpy as np
    import torch

    off = np.asarray(csr.offsets, np.int64)
    idx = np.asarray(csr.indices, np.int64)
    n = len(off) - 1
    deg = np.diff(off)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    keys = torch.from_numpy(src * n + idx)  # sorted: rows in order, each sorted
    fwd = idx > src
    a, b = src[fwd], idx[fwd]
    swap = deg[b] < deg[a]
    a, b = np.where(swap, b, a), np.where(swap, a, b)
    da = deg[a]
    ends = np.cumsum(da)
    total, lo = 0, 0
    while lo < len(a):
        start = int(ends[lo - 1]) if lo else 0
        hi = max(lo + 1, int(np.searchsorted(ends, start + chunk, "right")))
        ca, cb, cd = a[lo:hi], b[lo:hi], da[lo:hi]
        rank = np.arange(int(cd.sum()), dtype=np.int64) - np.repeat(np.cumsum(cd) - cd, cd)
        q = torch.from_numpy(np.repeat(cb, cd) * n + idx[np.repeat(off[ca], cd) + rank])
        pos = torch.searchsorted(keys, q).clamp_(max=len(keys) - 1)
        total += int((keys[pos] == q).sum())
        lo = hi
    return total // 3


def stream_arrays(view):
    s = view.to_leaf_stream()
    return (s.data, s.leaf_offsets, s.leaf_lens, s.leaf_keys, s.leaf_tiers)


# integers bitwise; float sums within the North star's tolerances (rtol = atol)
TOLERANCE = {"leaf_scan_reduce_view": 1e-5, "pagerank_view": 1e-5,
             "leaf_spmm_view": 1e-4, "spmm_view": 1e-4}


def hold(want: dict, got: dict, names) -> dict:
    """``got`` against ``want`` per entry point: bitwise for integers and
    SSSP, within ``TOLERANCE`` for float sums; returns the largest
    absolute difference of each float entry point."""
    import numpy as np
    import torch

    errs = {}
    for name in names:
        w, g = want[name], got[name]
        if isinstance(w, torch.Tensor):
            w, g = w.cpu(), g.cpu()
        else:
            w, g = torch.as_tensor(np.asarray(w)), torch.as_tensor(np.asarray(g))
        tol = TOLERANCE.get(name)
        if tol is None:
            if not torch.equal(w, g):
                raise AssertionError(f"{name} differs bitwise")
            continue
        torch.testing.assert_close(g, w, rtol=tol, atol=tol, msg=lambda m, n=name: f"{n}: {m}")
        errs[name] = float((g.double() - w.double()).abs().max()) if w.numel() else 0.0
    return errs


def phase_triangles(scale: int, seed: int, device):
    """Phase 6's counted part: triangle_count_view on a cold view, then on
    the warm view; returns the store and what was measured."""
    from repro_torch.core.analytics import triangle_count_fast, triangle_count_view
    from repro_torch.kernels.intersect import intersect_count

    store, info = build_store(scale, seed, device, undirected=True)
    with store.read_view() as view:
        n0 = intersect_count.launches
        tc, dev_s = wall(lambda: triangle_count_view(view), device)
        launches = intersect_count.launches - n0
        tc_warm, warm_s = wall(lambda: triangle_count_view(view), device)
        t0 = time.perf_counter()
        want = triangle_count_fast(view.to_csr())
        host_s = time.perf_counter() - t0
        n_leaves = view.to_leaf_blocks_device().n_blocks
    if tc != want or tc_warm != want:
        raise AssertionError(f"triangle_count_view {tc}, {tc_warm} != "
                             f"triangle_count_fast {want}")
    return store, dict(scale=scale, **info, n_leaves=n_leaves, triangles=tc,
                       device_s=dev_s, device_warm_s=warm_s, host_fast_s=host_s,
                       launches_per_call=launches)


def triangle_split(store, info: dict, device) -> None:
    """Phase 6's split, after the counted calls: triangle_count_view's steps
    on the warm view, each timed on its own (host clock, device drained):
    the host enumeration of the tile pairs, the uploads of their indices in
    the call's batches, and the kernel's summed device time (CUDA events
    around the loop of launches on the uploaded indices, no host work
    between them), each step through the same functions
    ``sum_intersect_tiles_view`` runs (``ops._pair_index``,
    ``ops._count_pairs``, batches of ``ops.SUM_BATCH``).  ``rest`` is what
    the warm call took beyond the three, ``cold_extra`` what the first call
    took beyond the warm one (the view's tile upload and host CSR).  Prints
    the ``triangles`` line."""
    import torch

    from repro_torch.core.analytics import triangle_tile_pairs
    from repro_torch.kernels.intersect import ops as intersect_ops

    batch = intersect_ops.SUM_BATCH
    with store.read_view() as view:
        (ia, ib), enum_s = wall(lambda: triangle_tile_pairs(view), device)
        dev = view.to_leaf_blocks_device()
        if getattr(dev, "groups", None) is not None:
            raise AssertionError("the triangle store is tiered: the split assumes one tier")
        idx, upload_s = wall(lambda: [intersect_ops._pair_index(ia[lo:lo + batch],
                                                                ib[lo:lo + batch], device)
                                      for lo in range(0, len(ia), batch)], device)
        intersect_ops._count_pairs(dev, idx[0])  # warm
        counts, kernel_s = device_seconds(
            lambda: [intersect_ops._count_pairs(dev, i) for i in idx], device)
        total = int(sum(c.sum(dtype=torch.int64) for c in counts))
        if total != 3 * info["triangles"]:
            raise AssertionError(f"the split's pair count, {total}, "
                                 f"!= 3 x {info['triangles']}")
    pairs = len(ia)
    warm = info["device_warm_s"]
    emit("triangles", **info, pairs=pairs, pairs_per_launch=batch,
         launches_split=len(idx),
         split_s={"host_enumeration": enum_s, "index_uploads": upload_s,
                  "kernel_device": kernel_s,
                  "rest": warm - enum_s - upload_s - kernel_s,
                  "cold_extra": info["device_s"] - warm},
         kernel_ms_per_launch=kernel_s * 1e3 / len(idx))


# ---------------------------------------------------------------------------
# Phases 7-9: the model paths
# ---------------------------------------------------------------------------
def model_configs():
    from repro_torch.configs import registry

    get = registry.get_smoke_config if MODEL_SMOKE else registry.get_config
    return get(LM_ARCH), get("bst")


def free_device(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def plain_lookup(table, ids):
    """The BST lookup through embedding_bag's plain version (bags of one)."""
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    return embedding_bag_ref(table, ids.reshape(-1, 1)).reshape(*ids.shape, table.shape[1])


def phase_model_kernels(seed: int, device) -> dict:
    """flash_decode and embedding_bag against their plain versions at the
    model paths' shapes (phase 7)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    lm, rec = model_configs()
    out = {}
    g = torch.Generator(device=device).manual_seed(seed + 20)
    rng = np.random.default_rng(seed + 20)

    def record(name, shape, err, ms, plain_ms, library_ms, nbytes, nops, **extra):
        b_ms, b_by = bound(nbytes, nops)
        rec_ = dict(name=name, shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                    **extra)
        emit("kernel", **rec_)
        return rec_

    # -- flash_decode: q [B, KV, G, dh] f32 against the cache.  Each case is
    # checked against the plain version and timed beside SDPA (GQA, a length
    # mask) on the same inputs; the kernels line takes the decode_32k path.
    from repro_torch.kernels.flash_decode import ops as decode_ops

    def sdpa_fn(q, k, v, kv_len):
        """SDPA over [B, H, 1, dh] x [B, KV, S, dh] in K/V's type."""
        b_, s_, kv_, dh_ = k.shape
        qh = q.reshape(b_, -1, 1, dh_).to(k.dtype)
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        mask = (torch.arange(s_, device=device)[None, :] < kv_len[:, None])[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(qh, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)

    def decode_case(q, k, v, kv_len, softcap=None, plain_reps=5):
        got = flash_decode(q, k, v, kv_len, softcap=softcap)
        want = flash_decode_ref(q, k, v, kv_len, softcap=softcap)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
        b_, s_, kv_, dh_ = k.shape
        live = int(kv_len.clamp(0, s_).sum())
        esz = k.element_size()
        res = dict(shape=[b_, s_, kv_, q.shape[2], dh_], dtype=str(k.dtype).split(".")[-1],
                   route=decode_ops.route(k.dtype, dh_), softcap=softcap,
                   kv_len=kv_len.tolist(), live_positions=live,
                   max_abs_err=max_abs_err(got, want),
                   ms=time_ms(lambda: flash_decode(q, k, v, kv_len, softcap=softcap),
                              device, 50, graph=True),
                   plain_ms=time_ms(lambda: flash_decode_ref(q, k, v, kv_len, softcap=softcap),
                                    device, plain_reps),
                   library_ms=None if softcap else time_ms(sdpa_fn(q, k, v, kv_len), device,
                                                           20))
        b_ms, b_by = bound(live * kv_ * dh_ * esz * 2 + q.numel() * 4 * 2 + b_ * 4,
                           live * kv_ * q.shape[2] * dh_ * 4)
        res.update(bound_ms=b_ms, bound_by=b_by)
        emit("flash_decode_case", **res)
        return res

    kv, dh = lm.n_kv_heads, lm.d_head
    grp = lm.n_heads // kv
    b, s = DECODE_BATCH, DECODE_SEQ
    q = torch.randn((b, kv, grp, dh), generator=g, device=device)
    k = torch.randn((b, s, kv, dh), generator=g, device=device, dtype=torch.bfloat16)
    v = torch.randn((b, s, kv, dh), generator=g, device=device, dtype=torch.bfloat16)
    kv_len = torch.from_numpy(rng.integers(1, s + 1, b).astype(np.int32)).to(device)
    cases = {}
    # the decode_32k path's own launches: every row live up to the last step
    path_len = torch.full((b,), s - DECODE_STEPS + 1, dtype=torch.int32, device=device)
    cases["path"] = decode_case(q, k, v, path_len)
    cases["seeded"] = decode_case(q, k, v, kv_len)
    # softcap 50 (Gemma-2's) on the same grouping, small
    slen = torch.tensor([1000, 377], dtype=torch.int32, device=device)
    cases["softcap"] = decode_case(q[:2], k[:2, :1000].contiguous(), v[:2, :1000].contiguous(),
                                   slen, softcap=50.0)
    # the CUDA-core route: the same seeded inputs with f32 K/V
    kf, vf = k.float(), v.float()
    del k, v
    free_device(device)
    cases["f32_seeded"] = decode_case(q, kf, vf, kv_len)
    del kf, vf
    free_device(device)
    # dh 144, small: Gemma-2-27B's grouping (32 heads over 16 KV heads) and cap
    q2 = torch.randn((2, 16, 2, 144), generator=g, device=device)
    k2 = torch.randn((2, 4096, 16, 144), generator=g, device=device, dtype=torch.bfloat16)
    v2 = torch.randn((2, 4096, 16, 144), generator=g, device=device, dtype=torch.bfloat16)
    len2 = torch.tensor([4096, 2900], dtype=torch.int32, device=device)
    cases["dh144"] = decode_case(q2, k2, v2, len2)
    cases["dh144_softcap"] = decode_case(q2, k2, v2, len2, softcap=50.0)
    del q2, k2, v2
    p_ = cases["path"]
    out["flash_decode"] = dict(
        name="flash_decode", max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        ms=p_["ms"], plain_ms=p_["plain_ms"], library_ms=p_["library_ms"],
        bound_ms=p_["bound_ms"], bound_by=p_["bound_by"], shape=p_["shape"],
        chunk_rows=decode_ops.MMA_CHUNK_ROWS, cases=cases)
    emit("kernel", **{k_: v_ for k_, v_ in out["flash_decode"].items() if k_ != "cases"})
    del q
    free_device(device)

    # -- embedding_bag at BST's three lookups, plus a weighted, padded case
    n_items, d = rec.n_items, rec.embed_dim
    table = (torch.randn((n_items, d), generator=g, device=device) * 0.02).contiguous()
    bulk = SERVE_BATCHES[-1]
    cases = {
        "forward": (rng.integers(0, n_items, (bulk * (rec.seq_len + 1), 1)), None, "sum"),
        "user_tower": (rng.integers(0, n_items, (1, rec.seq_len)), None, "mean"),
        "retrieval": (rng.integers(0, n_items, (N_CANDIDATES, 1)), None, "sum"),
        "weighted_padded": (rng.integers(0, n_items, (SERVE_BATCHES[0], rec.seq_len)),
                            rng.random((SERVE_BATCHES[0], rec.seq_len)).astype(np.float32),
                            "mean"),
    }
    pad = rng.random(cases["weighted_padded"][0].shape) < 0.3
    cases["weighted_padded"][0][pad] = -1
    shapes = {}
    for name, (ids_np, w_np, mode) in cases.items():
        ids = torch.from_numpy(ids_np.astype(np.int32)).to(device)
        w = None if w_np is None else torch.from_numpy(w_np).to(device)
        got = embedding_bag(table, ids, w, mode)
        want = embedding_bag_ref(table, ids, w, mode)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        n, kk = ids.shape
        ids_l = torch.where(ids >= 0, ids, 0).long()
        if w is None:
            lib = lambda: F.embedding_bag(ids_l, table, mode=mode)  # noqa: E731
        else:  # F.embedding_bag takes per-sample weights in sum mode only
            lib = None
        distinct = int(torch.unique(ids[ids >= 0]).numel())
        shapes[name] = dict(
            shape=[n, kk, d], mode=mode, weighted=w is not None, max_abs_err=max_abs_err(got, want),
            ms=time_ms(lambda: embedding_bag(table, ids, w, mode), device, 20, graph=True),
            plain_ms=time_ms(lambda: embedding_bag_ref(table, ids, w, mode), device, 5),
            library_ms=time_ms(lib, device, 20) if lib else None,
            bound=bound(distinct * d * 4 + ids.numel() * 4 * (1 if w is None else 2)
                        + n * d * 4, ids.numel() * d * 2),
            distinct_rows=distinct)
        emit("embedding_bag_shape", name=name, **shapes[name])
        del ids, w, ids_l, got, want
    r = shapes["retrieval"]
    out["embedding_bag"] = dict(
        name="embedding_bag", shape=r["shape"], max_abs_err=max(x["max_abs_err"]
                                                               for x in shapes.values()),
        ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
        bound_ms=r["bound"][0], bound_by=r["bound"][1], shapes=shapes)
    del table
    free_device(device)
    return out


def check_logits(got, want, rtol: float, atol: float, what: str) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; the max abs error."""
    import torch

    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} or non-finite logits")
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")
    return max_abs_err(got, want)


def profiled_step(fn, device) -> tuple:
    """``fn()`` once under the profiler: (the union of the device's activity
    intervals in ms, or None where the trace holds no device event, and the
    step's wall time in ms, device drained)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        _, sec = wall(fn, device)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None, sec * 1e3
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    return (busy + hi - lo) / 1e3, sec * 1e3


def phase_lm_serve(seed: int, device) -> dict:
    """Phase 8: (a) the serve launcher's main at full width in f32, then one
    step of both routes; (b) decode_32k in bf16."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_decode import flash_decode, route
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import flash_attn_fn, make_decode_step, make_flash_attn_fn

    plain_attn = make_flash_attn_fn(flash_decode_ref)
    report = {}

    # (a) the launcher, as a user runs it
    argv = ["--arch", LM_ARCH, "--device", device.type, "--seed", str(seed)]
    t0 = time.perf_counter()
    res = serve_main(argv + (["--smoke"] if MODEL_SMOKE else []))
    main_s = time.perf_counter() - t0
    cfg, params, cache = res["cfg"], res["params"], res["cache"]
    toks = res["tokens"]
    if toks.shape != (4, 33) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"serve main: tokens {tuple(toks.shape)} out of shape or range")
    step_k = make_decode_step(cfg, torch.float32, attn_fn=flash_attn_fn)
    step_p = make_decode_step(cfg, torch.float32, attn_fn=plain_attn)
    last, pos = toks[:, -1:], res["pos"]
    lp, tp, _ = step_p(params, cache, last, pos)  # each route writes pos itself
    lk, tk, _ = step_k(params, cache, last, pos)
    sync(device)
    report["main"] = dict(config=cfg.name, seconds=main_s, tok_per_s=res["tok_per_s"],
                          decode_s=res["seconds"], tokens=list(toks.shape),
                          check_pos=pos, tokens_equal=bool(torch.equal(tk, tp)),
                          max_abs_err=check_logits(lk, lp, 3e-4, 3e-4, "serve main f32"),
                          logit_absmax=float(lp.abs().max()))
    emit("lm_serve_main", **report["main"])
    del res, params, cache, lk, lp
    free_device(device)

    # (b) decode_32k in bf16: weights and cache in the compute type
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    lm, _ = model_configs()
    gen = torch.Generator(device=device).manual_seed(seed + 30)
    t0 = time.perf_counter()
    params = T.init_params(lm, gen, dtype=torch.bfloat16, device=device)
    cache = T.init_cache(lm, DECODE_BATCH, DECODE_SEQ, dtype=torch.bfloat16, device=device)
    first = DECODE_SEQ - DECODE_STEPS  # positions [0, first) filled from the seed
    for name in ("k", "v"):
        for i in range(lm.n_layers):
            cache[name][i, :, :first].normal_(generator=gen)
    sync(device)
    setup_s = time.perf_counter() - t0
    launch_errs = []

    def checked_attn(q, k_cache, v_cache, pos, window, cap):
        """The kernel route, each launch held against its plain version on
        the same inputs (f32 accumulation on both sides)."""
        got = flash_attn_fn(q, k_cache, v_cache, pos, window, cap)
        want = plain_attn(q, k_cache, v_cache, pos, window, cap)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
        launch_errs.append(max_abs_err(got, want))
        return got

    step_k = make_decode_step(lm, torch.bfloat16, attn_fn=flash_attn_fn)
    tok = torch.from_numpy(np.random.default_rng(seed + 30).integers(
        0, lm.vocab, (DECODE_BATCH, 1), dtype=np.int32)).to(device)
    # one checked step at the first position, both routes from the same cache
    # (each writes that position itself); the timed steps then redo it
    lp, tp, _ = make_decode_step(lm, torch.bfloat16, attn_fn=plain_attn)(
        params, cache, tok, first)
    lc, tc, _ = make_decode_step(lm, torch.bfloat16, attn_fn=checked_attn)(
        params, cache, tok, first)
    limit = 0.1 * float(lp.abs().max())
    err = check_logits(lc, lp, 0.0, limit, "decode_32k bf16")
    # two controls of that limit, same step: the plain route with one bf16
    # ulp added to one element of layer 0's attention output (rounding
    # noise) must stay inside it, and the kernel route with query head h
    # grouped under KV head h % KV instead of h // G (a planted fault) must
    # fall outside it
    def nudged_attn(q, k_cache, v_cache, pos, window, cap):
        out = plain_attn(q, k_cache, v_cache, pos, window, cap).to(torch.bfloat16)
        if not nudged:
            out.view(torch.int16).view(-1)[0] += 1
            nudged.append(True)
        return out

    def regrouped_attn(q, k_cache, v_cache, pos, window, cap):
        b, _, h, dh = q.shape
        kv = k_cache.shape[2]
        qr = q.reshape(b, 1, h // kv, kv, dh).transpose(2, 3).reshape(b, 1, h, dh)
        out = flash_attn_fn(qr, k_cache, v_cache, pos, window, cap)
        return out.reshape(b, 1, kv, h // kv, dh).transpose(2, 3).reshape(b, 1, h, dh)

    nudged = []
    ln, _, _ = make_decode_step(lm, torch.bfloat16, attn_fn=nudged_attn)(
        params, cache, tok, first)
    lf, _, _ = make_decode_step(lm, torch.bfloat16, attn_fn=regrouped_attn)(
        params, cache, tok, first)
    noise_err, fault_err = max_abs_err(ln, lp), max_abs_err(lf, lp)
    del ln, lf
    if not noise_err <= limit < fault_err:
        raise AssertionError(f"decode_32k: the logits limit {limit} does not separate "
                             f"one-ulp noise ({noise_err}) from a planted fault ({fault_err})")
    step_s, per_step = [], []
    for i in range(DECODE_STEPS):
        n0 = flash_decode.launches
        (lk, tk, _), sec = wall(lambda: step_k(params, cache, tok, first + i), device)
        step_s.append(sec)
        per_step.append(flash_decode.launches - n0)
        tok = tk[:, None]
    if "flash_decode" in PATH_KERNELS["lm_serve"] and any(n != lm.n_layers for n in per_step):
        raise AssertionError(f"decode_32k: flash_decode launches per step {per_step}, "
                             f"want {lm.n_layers}")
    # the last position once more, under the profiler: the device's busy
    # time, against that step's wall time and the unprofiled steps' median
    busy_ms, prof_ms = profiled_step(
        lambda: step_k(params, cache, tok, DECODE_SEQ - 1), device)
    median_ms = float(np.median(step_s)) * 1e3
    report["decode_32k"] = dict(
        config=lm.name, batch=DECODE_BATCH, cache_len=DECODE_SEQ, first_pos=first,
        steps=DECODE_STEPS, setup_s=setup_s, step_s=step_s,
        tok_per_s=DECODE_BATCH * DECODE_STEPS / sum(step_s),
        launches_per_step=per_step, route=route(torch.bfloat16, lm.d_head),
        max_abs_err=err, tokens_equal=bool(torch.equal(tc, tp)),
        one_ulp_control_max_abs_err=noise_err, regrouped_fault_max_abs_err=fault_err,
        logit_absmax=float(lp.abs().max()), checked_launches=len(launch_errs),
        launch_max_abs_err=max(launch_errs), logits_limit=limit,
        profiled_step_ms=prof_ms, device_busy_ms=busy_ms, median_step_ms=median_ms,
        idle_share_profiled=None if busy_ms is None else 1.0 - busy_ms / prof_ms,
        idle_share_median=None if busy_ms is None else 1.0 - busy_ms / median_ms,
        param_bytes=sum(t.numel() * t.element_size() for t in
                        [params["embed"], params["final_norm"], *params["layers"].values()]),
        cache_bytes=2 * cache["k"].numel() * cache["k"].element_size(),
        peak_allocated_bytes=(torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None))
    emit("lm_serve_decode_32k", **report["decode_32k"])
    del params, cache
    free_device(device)
    return report


def phase_recsys_serve(seed: int, device) -> dict:
    """Phase 9: BST serving at its published shapes, the table on the card."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models import bst as B

    _, cfg = model_configs()
    gen = torch.Generator(device=device).manual_seed(seed + 40)
    rng = np.random.default_rng(seed + 40)
    params = B.init_params(cfg, gen, device=device)
    report = {"table_bytes": params["item_emb"].numel() * 4}

    def ids(shape):
        return torch.from_numpy(rng.integers(0, cfg.n_items, shape).astype(np.int32)).to(device)

    for name, batch in zip(("serve_p99", "serve_bulk"), SERVE_BATCHES):
        hist, target = ids((batch, cfg.seq_len)), ids((batch,))
        feats = torch.randn((batch, cfg.n_other_feats), generator=gen, device=device)
        got = B.forward(cfg, params, hist, target, feats)
        want = B.forward(cfg, params, hist, target, feats, lookup_fn=plain_lookup)
        err = check_logits(got, want, 1e-5, 1e-5, f"bst forward {name}")
        ms = time_ms(lambda: B.forward(cfg, params, hist, target, feats), device, 10)
        report[name] = dict(batch=batch, ms=ms, rows_per_s=batch / ms * 1e3, max_abs_err=err)
        emit("recsys_serve", cell=name, **report[name])
        del hist, target, feats, got, want

    hist = ids((1, cfg.seq_len))
    feats = torch.randn((1, cfg.n_other_feats), generator=gen, device=device)
    cand = ids((N_CANDIDATES,))

    def retrieve(lookup_fn=None):
        u = B.user_tower(cfg, params, hist, feats)
        return u, B.retrieval_scores(cfg, params, u, cand, lookup_fn=lookup_fn)

    user, scores = retrieve()
    # the tower's plain version is the same mean bag (f32) cast to bf16: at
    # most one bf16 rounding step apart
    user_want = embedding_bag_ref(params["item_emb"], hist, mode="mean").to(user.dtype)
    torch.testing.assert_close(user.float(), user_want.float(), rtol=2.0 ** -8, atol=1e-7)
    _, scores_want = retrieve(plain_lookup)
    err = check_logits(scores, scores_want, 1e-5, 1e-5, "bst retrieval_scores")
    ms = time_ms(retrieve, device, 10)
    report["retrieval_cand"] = dict(candidates=N_CANDIDATES, ms=ms,
                                    rows_per_s=N_CANDIDATES / ms * 1e3, max_abs_err=err,
                                    user_max_abs_err=max_abs_err(user, user_want))
    emit("recsys_serve", cell="retrieval_cand", **report["retrieval_cand"])
    del params, hist, cand, scores, scores_want
    free_device(device)
    return report


def run_models(seed: int, device, launches: dict) -> dict:
    """Phases 7-9; returns the model kernels' records."""
    import torch

    free_device(device)
    if device.type == "cuda":
        emit("model_start", allocated_bytes=torch.cuda.memory_allocated(device))
        torch.cuda.reset_peak_memory_stats(device)
    kernels = phase_model_kernels(seed, device)
    counted("lm_serve", launches, phase_lm_serve, seed, device)
    counted("recsys_serve", launches, phase_recsys_serve, seed, device)
    if device.type == "cuda":
        emit("memory", phases="7-9",
             peak_allocated_bytes=torch.cuda.max_memory_allocated(device))
    return kernels


# ---------------------------------------------------------------------------
def counters():
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.intersect import intersect_count
    from repro_torch.kernels.leaf_search import leaf_search
    from repro_torch.kernels.spmm import leaf_scan_reduce, leaf_spmm

    return {"leaf_search": leaf_search, "leaf_scan_reduce": leaf_scan_reduce,
            "leaf_spmm": leaf_spmm, "intersect_count": intersect_count,
            "embedding_bag": embedding_bag, "flash_decode": flash_decode}


# the kernels each counted phase calls: each must launch in its phase
PATH_KERNELS = {
    "main": ("leaf_search", "leaf_scan_reduce", "leaf_spmm", "intersect_count"),
    "isolation": ("leaf_search", "leaf_scan_reduce", "leaf_spmm"),
    "readers": ("leaf_search", "leaf_scan_reduce"),
    "shard_plane": ("leaf_spmm",),
    "write_side": ("leaf_search", "leaf_scan_reduce"),
    "gnn_train": (),  # segment ops are torch ops: no hand kernel on this path
    "durability": ("leaf_search", "leaf_scan_reduce", "leaf_spmm", "intersect_count"),
    "triangles": ("intersect_count",),
    "lm_serve": ("flash_decode",),
    "recsys_serve": ("embedding_bag",),
}


def counted(path: str, launches: dict, fn, *args):
    """``fn(*args)`` with every launch counter set to 0 just before and read
    just after into ``launches[path]``; raises if a kernel of the path
    never launched."""
    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    result = fn(*args)
    launches[path] = {name: w.launches for name, w in wrappers.items()}
    missing = [n for n in PATH_KERNELS[path] if launches[path][n] <= 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")
    return result


def run(seed: int, device) -> dict:
    """Phases 1-9 on ``device``; returns the per-kernel records."""
    import torch

    if device.type == "cuda":
        phase_build()
    store, build_info = build_store(SCALE, seed, device)
    r0, ops0, info = pin_view(store, build_info, seed, device)
    kernels = phase_kernels(r0.view, ops0, device)
    launches = {}
    first = counted("main", launches, phase_main, store, r0, ops0, info, seed, device)
    counted("isolation", launches, phase_isolation, r0, ops0, first, device)
    store.end_read(r0)
    counted("readers", launches, phase_readers, store, seed, device)
    prior_peak = counted("shard_plane", launches, phase_shard_plane, store, seed, device)
    counted("write_side", launches, phase_write_side, store, seed, device)
    prior_peak = max(prior_peak, counted("gnn_train", launches, phase_gnn_train, store,
                                         seed, device))
    del store, r0, ops0, first
    counted("durability", launches, phase_durability, seed, device)
    tc_store, tc_info = counted("triangles", launches, phase_triangles, TC_SCALE, seed, device)
    triangle_split(tc_store, tc_info, device)
    phase_shard_symmetric(tc_store, device)
    del tc_store
    if device.type == "cuda":
        emit("memory", phases="1-6", peak_allocated_bytes=max(
            prior_peak, torch.cuda.max_memory_allocated(device)))
    kernels.update(run_models(seed, device, launches))
    for name, rec in kernels.items():
        source, replaces = KERNELS[name]
        rec.update(route="cuda", source=source, replaces=replaces,
                   launches=launches[KERNEL_PATH[name]][name],
                   launches_by_path={p: c[name] for p, c in launches.items()})
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the data and operands")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import repro_torch next to this script: {exc}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = phase_card(device)
    emit("config", scale=SCALE, tc_scale=TC_SCALE, seed=args.seed,
         partition_size=64, B=512, edge_factor=16, spmm_d=D_FEATURES, lm=LM_ARCH,
         decode_batch=DECODE_BATCH, decode_seq=DECODE_SEQ, serve_batches=SERVE_BATCHES,
         n_candidates=N_CANDIDATES, gnn=GNN_ARCH, gnn_seeds=GNN_SEEDS,
         gnn_fanouts=GNN_FANOUTS, gnn_d_feat=GNN_D_FEAT, gnn_steps=GNN_STEPS)
    kernels = run(args.seed, device)
    order = list(KERNELS)
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path"]
    print(json.dumps({"kernels": [{k: kernels[n][k] for k in keys} for n in order]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
