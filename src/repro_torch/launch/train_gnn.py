"""Train a GNN on a LIVE dynamic graph: ``python -m repro_torch.launch.train_gnn``.

The paper's read-intensive workload as a training system: a writer thread
streams edge updates into the RapidStore while the trainer samples
neighbor-fanout minibatches from lock-free snapshots and takes train steps,
with asynchronous checkpoints every 100 steps and ``--resume``.  The
graph is an R-MAT graph of scale 12 (80,000 edges), 16 features a vertex
from a fixed seed, labels a linear threshold of them; 64 seeds a step,
fanouts (8, 4).  ``--arch`` picks the GNN (its published config, or
``--smoke`` for the small one); ``--device`` defaults to the card and
raises without one.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import threading
import time

import numpy as np
import torch

from ..checkpoint import manager as ckpt
from ..configs import registry
from ..core import RapidStore
from ..data.pipeline import GraphUpdateStream
from ..graph.generators import rmat_edges
from ..graph.sampler import NeighborSampler, pad_subgraph
from ..models import gnn as G
from ..optim import adamw
from ..train.step import make_gnn_train_step

N_VERTICES, N_EDGES, D_FEAT = 4096, 80_000, 16
MAX_N, MAX_E = 2048, 4096
N_SEEDS, FANOUTS = 64, (8, 4)


def main(argv=None) -> dict:
    """Run the loop; returns the losses, the final parameters and optimizer
    state, and the store's commit count, for callers that check them."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gin-tu",
                    choices=[a for a in registry.arch_ids() if registry.FAMILY[a] == "gnn"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_gnn_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the host")
    N = N_VERTICES
    store = RapidStore.from_edges(N, rmat_edges(12, N_EDGES, seed=0), partition_size=64,
                                  B=512, tracer_k=8, device=device)
    cfg = registry.get_smoke_config(args.arch) if args.smoke else registry.get_config(args.arch)
    rng = np.random.default_rng(0)
    feat_np = rng.normal(size=(N, D_FEAT)).astype(np.float32)
    feat_table = torch.from_numpy(feat_np).to(device)
    label_table = torch.from_numpy(
        (feat_np @ rng.normal(size=D_FEAT) > 0).astype(np.int32)).to(device)

    params = G.init_gnn(cfg, torch.Generator(device=device).manual_seed(0), D_FEAT,
                        device=device)
    opt = adamw.init(params)
    start = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        (params, opt), meta = ckpt.restore(args.ckpt_dir, (params, opt))
        start = meta["step"] + 1
        print(f"resumed from step {meta['step']}")

    step_fn = make_gnn_train_step(cfg, n_nodes=MAX_N, lr=3e-3)
    saver = ckpt.AsyncCheckpointer(args.ckpt_dir)

    stop = threading.Event()
    write_errors = []

    def writer():
        stream = GraphUpdateStream(N, batch=128, seed=42)
        i = 0
        try:
            while not stop.is_set():
                u = stream[i]
                store.insert_edges(u["insert"])
                store.delete_edges(u["delete"])
                i += 1
                time.sleep(0.002)
        except Exception as exc:  # re-raised on the main thread
            write_errors.append(exc)

    w = threading.Thread(target=writer, daemon=True)
    w.start()

    t0 = time.time()
    losses = []
    try:
        for it in range(start, args.steps):
            with store.read_view() as view:  # lock-free snapshot
                sampler = NeighborSampler(view.scan, fanouts=list(FANOUTS), seed=it)
                seeds = np.random.default_rng(it).choice(N, N_SEEDS, replace=False)
                sub = sampler.sample(seeds.astype(np.int64))
                nodes, src, dst, nmask, emask = pad_subgraph(sub, MAX_N, MAX_E)
            nodes_t = torch.from_numpy(nodes).to(device)
            feats = feat_table[nodes_t] * torch.from_numpy(nmask).to(device)[:, None]
            labels = label_table[nodes_t]
            lmask = torch.zeros(MAX_N, dtype=torch.float32, device=device)
            lmask[: sub.n_seeds] = 1.0
            params, opt, metrics = step_fn(
                params, opt, feats, torch.from_numpy(src).to(device),
                torch.from_numpy(dst).to(device), torch.from_numpy(emask).to(device),
                labels, lmask)
            losses.append(float(metrics["loss"]))
            if it % 25 == 0:
                print(f"step {it:4d} loss {losses[-1]:.4f} "
                      f"(graph @ t={store.clock.read_timestamp()})", flush=True)
            if it and it % 100 == 0:
                saver.save(it, (params, opt))
    finally:
        stop.set()
        w.join(timeout=60)
        saver.save(args.steps - 1, (params, opt))
        saver.wait()
    if w.is_alive():
        raise RuntimeError("the writer thread did not stop")
    if write_errors:
        raise write_errors[0]
    dt = time.time() - t0
    k = max(len(losses) // 10, 1)
    print(f"done: {len(losses)} steps in {dt:.1f}s "
          f"({dt / max(len(losses), 1) * 1e3:.0f} ms/step); "
          f"loss {np.mean(losses[:k]):.4f} -> {np.mean(losses[-k:]):.4f} "
          f"on a graph that changed {store.stats['commits']} times ({device})")
    if losses and not np.mean(losses[-k:]) < np.mean(losses[:k]):
        raise RuntimeError("did not learn")
    store.check_invariants()
    print("OK")
    return {"losses": losses, "params": params, "opt": opt,
            "commits": store.stats["commits"], "start": start}


if __name__ == "__main__":
    main()
