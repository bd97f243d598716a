#!/usr/bin/env python3
"""Drive repro_torch's snapshot read path once on one CUDA card.

    python3 chip_smoke.py                 # the deployment below, one card

Deployment: the paper's own settings, |P|=64 and B=512 (configs/rapidstore,
paper section 6.5), ``high_threshold`` at its default, on a directed
Graph500 R-MAT graph (a=0.57, b=0.19, c=0.19) of scale 22 and edge factor
16: 4,194,304 vertices and about 67M edges, made from ``--seed``.  Triangle
counting runs on an undirected simple store of scale 18.

Phases, each printing one JSON line (a failing phase raises, and the
script exits non-zero without the last line):

0. card      nvidia-smi name and power limit, torch and CUDA versions;
             fails unless the capability is (9, 0)
1. build     nvcc builds every csrc/*.cu for sm_90a
2. kernels   each CUDA kernel against its plain version at the main path's
             shapes, with its time, the plain version's, a library call's
             and the least time the card needs for the same bytes
3. main      store + pinned view R0, the view-level entry points on R0,
             20 write transactions, spliced view R1, the entry points on
             R1, a warm repeat with zero uploads; checks against point
             reads and the port's own CPU route
4. isolation the pinned R0 answers bitwise as before the writes
5. readers   two reader threads repeat queries on their own pinned views
             while the main thread commits
6. triangles triangle_count_view on the card == triangle_count_fast on host
7. the ``kernels`` line, then the ``ok`` line.

The launch counters are set to 0 just before each of phases 3-6 and read
just after it; every kernel a phase calls must have launched in it.  The
``kernels`` line's ``launches`` is phase 3's (the main path), and
``launches_by_path`` holds all four phases'.  The comparisons of phase 2
do not count.

``bound_ms`` counts the bytes the function needs on this run's data, not
the whole tiles: a tile's live ids are a sorted prefix followed by
SENTINEL padding (checked), so a scan reads the 128-byte lines up to the
first SENTINEL, a binary search reads one 32-byte sector per probe until
its interval fits in one sector, and a gather reads each distinct x or H
row it touches once.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
CUDA_CORE_OPS_PER_S = 67e12  # f32 outside the tensor cores, NVIDIA data sheet
SCALE = 22  # R-MAT scale of the main store (below 21 the writes cannot splice)
TC_SCALE = 18  # R-MAT scale of the undirected triangle-count store
D_FEATURES = 128  # SpMM width: a common GNN hidden width
N_WRITES, N_INS, N_DELS = 20, 256, 64
N_QUERIES = 4096  # present and as many absent edge-search pairs
N_PAIRS = 8192  # intersect tile pairs (one sum_intersect batch)
SPMM_PLAIN_ROWS = 16384  # tiles per plain-SpMM call: it materializes [N, B, d]
LINE, SECTOR = 128, 32  # bytes: an L2 cache line and a DRAM sector

KERNELS = {
    "leaf_search": ("src/repro_torch/csrc/leaf_search.cu",
                    "src/repro/kernels/leaf_search/kernel.py:40"),
    "leaf_scan_reduce": ("src/repro_torch/csrc/leaf_scan_reduce.cu",
                         "src/repro/kernels/spmm/kernel.py:47"),
    "leaf_spmm": ("src/repro_torch/csrc/leaf_spmm.cu",
                  "src/repro/kernels/spmm/kernel.py:102"),
    "intersect_count": ("src/repro_torch/csrc/intersect_count.cu",
                        "src/repro/kernels/intersect/kernel.py:55"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


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


def prefix_bytes(lengths, width: int) -> int:
    """Bytes a scan of each row must read: the 128-byte lines up to and
    including the first SENTINEL (the whole row when it is full)."""
    import torch

    lines = torch.div(lengths + 1 + LINE // 4 - 1, LINE // 4, rounding_mode="floor")
    return int(torch.clamp(lines * LINE, max=width * 4).sum())


def search_sectors(width: int) -> int:
    """32-byte sectors one binary search over a sorted row of ``width``
    int32 reads: one per probe until the interval fits in one sector."""
    return 1 + math.ceil(math.log2(max(1, math.ceil(width / (SECTOR // 4)))))


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
def build_store(scale: int, seed: int, device, undirected: bool = False):
    from repro_torch.configs import CONFIG
    from repro_torch.core import RapidStore
    from repro_torch.graph import rmat_edges

    t0 = time.perf_counter()
    edges = rmat_edges(scale, 16 << scale, seed=seed)
    t1 = time.perf_counter()
    store = RapidStore.from_edges(
        1 << scale, edges, undirected=undirected,
        partition_size=CONFIG.partition_size, B=CONFIG.leaf_width, device=device,
    )
    return store, {"generate_s": t1 - t0, "build_s": time.perf_counter() - t1,
                   "n_vertices": 1 << scale, "edges_generated": int(len(edges))}


def make_operands(view, seed: int, device, with_h: bool = True):
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
    e = rng.choice(len(src), 2 * N_PAIRS, replace=False)
    u, v = src[e].astype(np.int64), dst[e].astype(np.int64)
    lo_u, lo_v = np.searchsorted(s_sorted, u), np.searchsorted(s_sorted, v)
    has_v = (lo_v < len(s_sorted)) & (s_sorted[np.minimum(lo_v, len(s_sorted) - 1)] == v)
    ia, ib = order[lo_u[has_v]][:N_PAIRS], order[lo_v[has_v]][:N_PAIRS]
    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "queries": queries,
        "n_present": len(present),
        "ia": ia,
        "ib": ib,
        "x": torch.randn(n, generator=g, device=device),
        "w": torch.rand(len(src), generator=g, device=device) + 0.1,
        "H": (torch.randn((n, D_FEATURES), generator=g, device=device)
              if with_h else None),
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

    # -- leaf_search at edge_search_view's shape: candidate tiles of the queries
    bsrc, order = view_assembler.block_src_index(view)
    s_sorted = bsrc[order]
    us, vs = ops["queries"][:, 0], ops["queries"][:, 1]
    lo, hi = np.searchsorted(s_sorted, us, "left"), np.searchsorted(s_sorted, us, "right")
    qidx = np.repeat(np.arange(len(us)), hi - lo)
    flat = np.concatenate([order[a:b] for a, b in zip(lo, hi) if b > a])
    srows = rows[torch.from_numpy(flat).to(device)]
    tgt = torch.from_numpy(vs[qidx].astype(np.int32)).to(device)
    f, p = leaf_search(srows, tgt)
    fr, pr = leaf_search_ref(srows, tgt)
    if not (torch.equal(f, fr) and torch.equal(p, pr)):
        raise AssertionError("leaf_search disagrees with its plain version")
    Q = srows.shape[0]
    tgt2 = tgt[:, None].contiguous()
    probes = search_sectors(B)
    record("leaf_search", (Q, B), max(max_abs_err(p, pr), max_abs_err(f, fr)),
           time_ms(lambda: leaf_search(srows, tgt), device, 50, graph=True),
           time_ms(lambda: leaf_search_ref(srows, tgt), device, 10, graph=True),
           time_ms(lambda: torch.searchsorted(srows, tgt2), device, 50, graph=True),
           Q * (probes * SECTOR + 4 + 4 + 1), Q * math.ceil(math.log2(B + 1)),
           sectors_per_query=probes)
    del srows, tgt, tgt2, f, p, fr, pr

    # -- leaf_scan_reduce over the whole view (leaf_scan_reduce_view's shape)
    x = ops["x"]
    live = int(lengths.sum())
    rows_bytes = prefix_bytes(lengths, B)
    touched = int(torch.unique(rows[rows != SENTINEL]).numel())
    y = leaf_scan_reduce(rows, x)
    yr = leaf_scan_reduce_ref(rows, x)
    torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
    err = max_abs_err(y, yr)
    del y, yr
    mask = rows != SENTINEL
    idx = torch.where(mask, rows, 0).long()
    psw = mask.to(torch.float32)
    del mask
    x2 = x[:, None].contiguous()
    record("leaf_scan_reduce", (N, B), err,
           time_ms(lambda: leaf_scan_reduce(rows, x), device, 20),
           time_ms(lambda: leaf_scan_reduce_ref(rows, x), device, 2),
           time_ms(lambda: F.embedding_bag(idx, x2, mode="sum", per_sample_weights=psw),
                   device, 5),
           rows_bytes + touched * 4 + N * 4, live, live_entries=live,
           tile_bytes=N * B * 4, live_prefix_bytes=rows_bytes, distinct_x=touched)

    # -- leaf_spmm: timed against the plain version and the library call on
    # a prefix of tiles (the plain version materializes [N, B, d]); the
    # all-tile launch of the main path is timed (main_ms) and held against
    # the plain version chunk by chunk, every tile included.
    H = ops["H"]
    d = H.shape[1]
    n_p = min(N, SPMM_PLAIN_ROWS)
    prow = rows[:n_p]
    plive = int(lengths[:n_p].sum())
    ptouched = int(torch.unique(prow[prow != SENTINEL]).numel())
    pidx, ppsw = idx[:n_p], psw[:n_p]
    main_ms = time_ms(lambda: leaf_spmm(rows, H), device, 3)
    ym = leaf_spmm(rows, H)
    err = 0.0
    for c0 in range(0, N, SPMM_PLAIN_ROWS):
        c1 = min(N, c0 + SPMM_PLAIN_ROWS)
        ymr = leaf_spmm_ref(rows[c0:c1], H)
        torch.testing.assert_close(ym[c0:c1], ymr, rtol=1e-4, atol=1e-4)
        err = max(err, max_abs_err(ym[c0:c1], ymr))
        del ymr
    del ym
    main_bound, _ = bound(rows_bytes + touched * d * 4 + N * d * 4, live * d)
    record("leaf_spmm", (n_p, B, d), err,
           time_ms(lambda: leaf_spmm(prow, H), device, 20),
           time_ms(lambda: leaf_spmm_ref(prow, H), device, 2),
           time_ms(lambda: F.embedding_bag(pidx, H, mode="sum", per_sample_weights=ppsw),
                   device, 5),
           prefix_bytes(lengths[:n_p], B) + ptouched * d * 4 + n_p * d * 4, plive * d,
           checked_tiles=N, gathered_bytes=plive * d * 4, distinct_h_rows=ptouched,
           main_shape=[N, B, d], main_ms=main_ms, main_bound_ms=main_bound,
           main_distinct_h_rows=touched, main_gathered_bytes=live * d * 4)
    del idx, psw, pidx, ppsw, prow

    # -- intersect_count at sum_intersect_tiles_view's batch shape
    ia = torch.from_numpy(ops["ia"]).to(device)
    ib = torch.from_numpy(ops["ib"]).to(device)
    a, b = rows[ia], rows[ib]
    c = intersect_count(a, b)
    cr = intersect_count_ref(a, b)
    if not torch.equal(c, cr):
        raise AssertionError("intersect_count disagrees with its plain version")
    la, lb = lengths[ia], lengths[ib]
    Qi = a.shape[0]
    # a merge of the two sorted live prefixes: one compare per element
    record("intersect_count", (Qi, B), max_abs_err(c, cr),
           time_ms(lambda: intersect_count(a, b), device, 50, graph=True),
           time_ms(lambda: intersect_count_ref(a, b), device, 3, graph=True),
           None,
           prefix_bytes(la, B) + prefix_bytes(lb, B) + Qi * 4, int((la + lb).sum()),
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


def run_entry_points(view, ops, device) -> tuple:
    """The view-level entry points on ``view``: (results, seconds each)."""
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
    for name in ENTRY_POINTS:
        res[name], secs[name] = wall(calls[name], device)
    secs["bfs_iterations"] = A.bfs_coo.iterations
    secs["sssp_iterations"] = A.sssp_coo.iterations
    secs["wcc_iterations"] = A.wcc_coo.iterations
    return res, secs


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
    shapes = {
        "leaf_scan_reduce_view": (n_blocks,), "leaf_spmm_view": (n_blocks, D_FEATURES),
        "spmm_view": (n, D_FEATURES), "pagerank_view": (n,), "bfs_view": (n,),
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
        "wcc_view": A.wcc_coo(torch.cat([src, dst]), torch.cat([dst, src]), n),
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


def phase_triangles(scale: int, seed: int, device) -> None:
    from repro_torch.core.analytics import triangle_count_fast, triangle_count_view

    store, info = build_store(scale, seed, device, undirected=True)
    with store.read_view() as view:
        tc, dev_s = wall(lambda: triangle_count_view(view), device)
        t0 = time.perf_counter()
        want = triangle_count_fast(view.to_csr())
        host_s = time.perf_counter() - t0
        n_leaves = view.to_leaf_blocks_device().n_blocks
    if tc != want:
        raise AssertionError(f"triangle_count_view {tc} != triangle_count_fast {want}")
    emit("triangles", scale=scale, **info, n_leaves=n_leaves, triangles=tc,
         device_s=dev_s, host_fast_s=host_s)


# ---------------------------------------------------------------------------
def counters():
    from repro_torch.kernels.intersect import intersect_count
    from repro_torch.kernels.leaf_search import leaf_search
    from repro_torch.kernels.spmm import leaf_scan_reduce, leaf_spmm

    return {"leaf_search": leaf_search, "leaf_scan_reduce": leaf_scan_reduce,
            "leaf_spmm": leaf_spmm, "intersect_count": intersect_count}


# the kernels each counted phase calls: each must launch in its phase
PATH_KERNELS = {
    "main": ("leaf_search", "leaf_scan_reduce", "leaf_spmm", "intersect_count"),
    "isolation": ("leaf_search", "leaf_scan_reduce", "leaf_spmm"),
    "readers": ("leaf_search", "leaf_scan_reduce"),
    "triangles": ("intersect_count",),
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
    """Phases 1-6 on ``device``; returns the per-kernel records."""
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
    del store, r0, ops0, first
    counted("triangles", launches, phase_triangles, TC_SCALE, seed, device)
    for name, rec in kernels.items():
        source, replaces = KERNELS[name]
        rec.update(route="cuda", source=source, replaces=replaces,
                   launches=launches["main"][name],
                   launches_by_path={p: c[name] for p, c in launches.items()})
    if device.type == "cuda":
        emit("memory", peak_allocated_bytes=torch.cuda.max_memory_allocated(device))
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
         partition_size=64, B=512, edge_factor=16, spmm_d=D_FEATURES)
    kernels = run(args.seed, device)
    order = ["leaf_search", "leaf_scan_reduce", "leaf_spmm", "intersect_count"]
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
