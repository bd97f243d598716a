"""Time the edge relax of BFS, SSSP and WCC on the card, each mode alone,
beside the torch chain it replaced, on the benchmark's kind of graph: an
undirected Graph500 R-MAT graph (A 0.57, B 0.19, C 0.19, edge factor 16,
both directions stored, each pair once, grouped by source).

    PYTHONPATH=src python3 scripts/time_edge_relax.py [--scale 22] [--seed 1]

Each loop runs once on the card (``core.analytics``' single-shard route)
with every iteration's vertex vector recorded.  Then, for every recorded
vector, CUDA events time ``edge_relax`` (the wrapper: output fill and one
launch) and the chain that ran before it (a gather, the cast, an
identity-filled ``n + 1`` output and ``scatter_reduce_``, with the int64
keys made once, as the loops made them once a query), the median of
``--reps`` runs each, and check that both agree.  One JSON line a mode:
iterations, both times in total and per iteration, and two bounds at
3.35 TB/s: ``ids_bound_ms`` (8 B an edge of int32 ids, 12 with SSSP's
weights) and ``needed_bound_ms`` (the bytes these inputs need: src, the dst
(and w) of each group of four edges with a source in the frontier or at a
finite distance, x read and the output filled and written once).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12


def card() -> dict:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": q.stdout.strip()}


def undirected_rmat(scale: int, seed: int, device):
    from repro_torch.graph.generators import rmat_edges_torch

    e = torch.from_numpy(rmat_edges_torch(scale, 16 << scale, seed, device)).to(device)
    key = torch.cat([(e[:, 0] << 32) | e[:, 1], (e[:, 1] << 32) | e[:, 0]])
    key = torch.unique(key)  # sorted: grouped by source, each pair once
    src = (key >> 32).to(torch.int32)
    dst = (key & 0xFFFFFFFF).to(torch.int32)
    return src, dst, 1 << scale


def record(src, dst, w, n, root):
    """Each loop's per-iteration vertex vectors, from one run on the card."""
    from repro_torch.core import analytics as A
    from repro_torch.core import distributed

    seen = {"flag": [], "min_plus": [], "min_both": []}
    relax = distributed.edge_relax

    def recording(mode, x, *args):
        seen[mode].append(x.clone())
        return relax(mode, x, *args)

    distributed.edge_relax = recording
    try:
        A.bfs_coo(src, dst, n, root)
        A.sssp_coo(src, dst, w, n, root)
        A.wcc_coo(src, dst, n)
    finally:
        distributed.edge_relax = relax
    return seen


def chain(mode, x, g_src, k_dst, g_dst, k_src, w):
    """The torch chain the loops ran before the kernel, keys made already."""
    from repro_torch.kernels.relax.ref import I32_MAX, I32_MIN, segment_reduce

    n = x.shape[0]
    if mode == "flag":
        return segment_reduce(x[g_src].to(torch.int32), k_dst, n, "amax", I32_MIN)
    if mode == "min_plus":
        return segment_reduce(x[g_src] + w, k_dst, n, "amin", float("inf"))
    return torch.minimum(segment_reduce(x[g_src], k_dst, n, "amin", I32_MAX),
                         segment_reduce(x[g_dst], k_src, n, "amin", I32_MAX))


def time_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def needed_bytes(mode, x, src, n) -> int:
    """Bytes these inputs need: every src id, the dst (and w) of each group
    of four edges with an active source (all of them for WCC), x read and
    the output filled and written once."""
    m = src.shape[0]
    if mode == "min_both":
        edge = 8 * m
    else:
        act = x[src.long()] if mode == "flag" else torch.isfinite(x[src.long()])
        pad = torch.zeros((-m) % 4, dtype=torch.bool, device=act.device)
        quads = int(torch.cat([act, pad]).view(-1, 4).any(1).sum())
        edge = 4 * m + quads * 16 * (2 if mode == "min_plus" else 1)
    return edge + x.numel() * x.element_size() + 2 * 4 * n


def main() -> None:
    from repro_torch.kernels.relax import edge_relax

    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_edge_relax: torch sees no CUDA device")
    dev = torch.device("cuda", 0)
    src, dst, n = undirected_rmat(args.scale, args.seed, dev)
    m = src.shape[0]
    g = torch.Generator(device=dev).manual_seed(args.seed)
    w = (torch.randint(0, 1 << 23, (m,), generator=g, device=dev).float() * 2.0**-23 + 0.5)
    root = int(src[torch.randint(0, m, (1,), generator=g, device=dev)])
    seen = record(src, dst, w, n, root)
    keys = {}

    def make_keys():
        keys.update(g_src=src.long(), k_dst=dst.long(), g_dst=dst.long(), k_src=src.long())

    keys_ms = time_ms(make_keys, 1)
    info = dict(card(), scale=args.scale, n=n, m=m, root=root, keys_once_ms=keys_ms)
    print(json.dumps(info), flush=True)
    for mode, xs in seen.items():
        kernel, torch_chain, needed, agree = [], [], [], True
        for x in xs:
            got = edge_relax(mode, x, src, dst, None, w)
            want = chain(mode, x, **keys, w=w)
            if mode == "flag":
                agree &= bool(torch.equal(got > 0, want > 0))
            else:
                agree &= bool(torch.equal(got, torch.minimum(x, want)))
            kernel.append(time_ms(lambda: edge_relax(mode, x, src, dst, None, w), args.reps))
            torch_chain.append(time_ms(lambda: chain(mode, x, **keys, w=w), args.reps))
            needed.append(needed_bytes(mode, x, src, n))
        ids = (12 if mode == "min_plus" else 8) * m
        line = dict(mode=mode, iterations=len(xs), agree=agree,
                    kernel_ms=sum(kernel), chain_ms=sum(torch_chain),
                    kernel_ms_per_iter=kernel, chain_ms_per_iter=torch_chain,
                    ids_bound_ms=ids / HBM_BYTES_PER_S * 1e3,
                    needed_bound_ms=sum(needed) / HBM_BYTES_PER_S * 1e3,
                    needed_bound_ms_per_iter=[b / HBM_BYTES_PER_S * 1e3 for b in needed])
        print(json.dumps(line), flush=True)
        if not agree:
            raise SystemExit(f"time_edge_relax: kernel and chain disagree in {mode}")


if __name__ == "__main__":
    main()
