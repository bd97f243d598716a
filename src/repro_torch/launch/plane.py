"""The shard plane over one process per card, on ``torch.distributed``.

    REPRO_MULTIHOST=1 torchrun --nproc_per_node=N -m repro_torch.launch.plane \\
        --scale 18 --shards 4 --backend nccl --out DIR

Every rank builds the same seeded R-MAT store (undirected; the paper's
|P| = 64 and B = 512), attaches a shard plane over
:func:`~repro_torch.launch.mesh.distributed_shard_mesh` (shard ``k`` on
rank ``k % world``, this rank's shards on card ``LOCAL_RANK % n_cards``),
runs PageRank in its pull and push forms, BFS, SSSP, WCC and SpMM on a
view (:func:`drive`), commits ``--txns`` transactions whose sources all
lie in subgraphs on shard 1, and runs them again on a fresh view; then
it migrates subgraphs between shards of different ranks
(:func:`cross_moves`, through the rebalancer's ``plan_moves`` and
``execute``, on every rank at the same point), commits ``--txns`` more
on the moved subgraphs and runs them a third time.  Each
rank prints one JSON line: the backend, the world size, the seconds of
each step and its ``leaf_spmm`` launches; with ``--out`` it saves its
answers (``DIR/rank<r>.pt``).  ``--init`` takes the group's address
(``tcp://host:port`` or ``file://path``) where torchrun's ``MASTER_ADDR``
and ``MASTER_PORT`` are not set.  The backend is ``nccl`` on the card by
default (one rank a card: NCCL refuses two ranks on one card) and
``gloo`` on the CPU; pass ``--backend gloo`` to put several ranks on one
card.  Without
``REPRO_MULTIHOST=1`` the same runs in one process over a one-process
plane.  :func:`spawn_ranks` starts such ranks as child processes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels.runtime import drain

N_INS, N_DELS = 256, 64  # a transaction's inserts and deletes
WRITE_SHARD = 1  # the shard whose subgraphs the transactions touch
STEPS = ("before", "after", "migrated")  # the views the collectives run on
# the answers equal bit for bit on every rank and in one process: min and
# max merges, and sums in which one shard holds each vertex's terms
BITWISE = ("pagerank_pull", "bfs", "sssp", "wcc", "spmm")


def rmat_store(scale: int, seed: int, device, undirected: bool = True, leaf_tiers=None):
    """``(store, info)``: a Graph500 R-MAT graph of ``scale`` and edge
    factor 16 drawn from ``seed`` on ``device`` (``rmat_edges_torch``), in
    a store at the paper's |P| and B on ``device``; ``info`` has the
    generation and build seconds."""
    from ..configs import CONFIG
    from ..core import RapidStore
    from ..graph import rmat_edges_torch

    t0 = time.perf_counter()
    edges = rmat_edges_torch(scale, 16 << scale, seed, device)
    t1 = time.perf_counter()
    store = RapidStore.from_edges(
        1 << scale, edges, undirected=undirected, partition_size=CONFIG.partition_size,
        B=CONFIG.leaf_width, device=device, leaf_tiers=leaf_tiers)
    return store, {"generate_s": t1 - t0, "build_s": time.perf_counter() - t1,
                   "n_vertices": 1 << scale, "edges_generated": int(len(edges))}


def shard_writes(view, placement, shard: int, rng, n_txn: int, n_ins: int = N_INS,
                 n_dels: int = N_DELS) -> list:
    """``n_txn`` (ins, dels) batches whose sources all lie in subgraphs
    placed on ``shard``: random inserts and deletes of existing edges."""
    sids = np.nonzero(np.asarray(placement) == shard)[0]
    return sid_writes(view, sids, rng, n_txn, n_ins, n_dels)


def sid_writes(view, sids, rng, n_txn: int, n_ins: int = N_INS, n_dels: int = N_DELS) -> list:
    """``n_txn`` (ins, dels) batches whose sources all lie in subgraphs
    ``sids``: random inserts and deletes of existing edges."""
    src, dst = view.to_coo()
    n, p = view.n_vertices, view.p
    sids = np.asarray(sids)
    mine = np.nonzero(np.isin(src // p, sids))[0]
    pick = rng.choice(mine, n_txn * n_dels, replace=False)
    batches = []
    for t in range(n_txn):
        u = rng.choice(sids, n_ins) * p + rng.integers(0, p, n_ins)
        ins = np.stack([u, rng.integers(0, n, n_ins)], 1)
        ins = ins[(ins[:, 0] != ins[:, 1]) & (ins[:, 0] < n)]
        sel = pick[t * n_dels:(t + 1) * n_dels]
        batches.append((ins, np.stack([src[sel], dst[sel].astype(np.int64)], 1)))
    return batches


def cross_moves(placement, n_shards: int) -> Dict[int, int]:
    """``{sid: shard}``: every other subgraph of shard ``WRITE_SHARD`` to
    the next shard, and the first subgraph of shard 0 to the last.  Shard
    ``k`` lies on rank ``k % world``, so over two or more ranks each move
    crosses ranks."""
    placement = np.asarray(placement)
    moves = {int(sid): (WRITE_SHARD + 1) % n_shards
             for sid in np.nonzero(placement == WRITE_SHARD)[0][::2]}
    moves[int(np.nonzero(placement == 0)[0][0])] = n_shards - 1
    return moves




def operands(view, seed: int, d: int, device) -> tuple:
    """SSSP's edge weights (host f32 in [0.5, 1.5), global COO order) and
    SpMM's [n, d] features (``torch.randn`` on ``device``), from ``seed``."""
    w = np.random.default_rng(seed).random(view.n_edges, dtype=np.float32) + 0.5
    gen = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn((view.n_vertices, d), generator=gen, device=device)
    return w, h


def queries(plane, view, w, h, device) -> tuple:
    """``(answers, seconds)`` of the plane's collectives on ``view``:
    PageRank (10 iterations) in its pull and push forms, BFS and SSSP from
    vertex 0, WCC and SpMM."""
    calls = {"pagerank_pull": lambda: plane.pagerank(view, pull=True),
             "pagerank_push": lambda: plane.pagerank(view, pull=False),
             "bfs": lambda: plane.bfs(view, 0),
             "sssp": lambda: plane.sssp(view, w, 0),
             "wcc": lambda: plane.wcc(view),
             "spmm": lambda: plane.spmm(view, h)}
    out, secs = {}, {}
    for name, fn in calls.items():
        drain(plane.devices)  # every card of the plane, not only ``device``
        t0 = time.perf_counter()
        out[name] = fn()
        drain(plane.devices)
        secs[name] = time.perf_counter() - t0
    return out, secs


def drive(store, mesh, seed: int, n_txn: int, d: int = 128) -> dict:
    """The plane's sequence on ``store`` over ``mesh`` (one process or
    many): attach a symmetric plane, the collectives on a view
    (``before``), ``n_txn`` transactions on shard ``WRITE_SHARD``, the
    collectives on a fresh view (``after``), the :func:`cross_moves`
    migration, ``n_txn`` transactions on the moved subgraphs, the
    collectives once more (``migrated``).  Returns the answers, the
    seconds of each step, the plane's per-shard uploads after each view
    and the transactions committed (``writes``).  Every rank computes the
    same placement, moves and writes and commits them in the same order
    (so its epochs take the same timestamps): every rank's answers are
    the same."""
    from ..kernels.spmm import leaf_spmm

    device = mesh.flat_devices[mesh.local_shards[0]]
    launches0 = leaf_spmm.launches
    t0 = time.perf_counter()
    plane = store.attach_shard_plane(symmetric=True, mesh=mesh)
    out: Dict[str, object] = {"attach_s": time.perf_counter() - t0, "writes": {}}

    def commit(step: str, batches: list) -> None:
        t0 = time.perf_counter()
        for ins, dels in batches:
            store.apply(ins, dels)
        out[f"commits_{step}_s"] = time.perf_counter() - t0
        out["writes"][step] = batches

    def run(step: str, view, op_seed: int) -> None:
        w, h = operands(view, op_seed, d, device)
        out[step], out[f"{step}_s"] = queries(plane, view, w, h, device)
        out[f"uploads_{step}"] = list(plane.stats.uploads)

    try:
        with store.read_view() as view:
            t0 = time.perf_counter()
            plane.sharded_coo(view)
            plane.sharded_blocks(view)
            drain(mesh.flat_devices)
            out["cold_tiles_s"] = time.perf_counter() - t0
            run("before", view, seed)
            placement = plane.placement_for(len(view.snaps))
            batches = shard_writes(view, placement, WRITE_SHARD,
                                   np.random.default_rng(seed + 1), n_txn)
        commit("after", batches)
        moves = cross_moves(placement, plane.n_shards)
        with store.read_view() as view:
            run("after", view, seed + 2)
            # drawn here, so that the last view before the migrated one is
            # this one, assembled under the old epoch: the migrated view
            # then rebuilds only the shards the moves and writes touch
            batches = sid_writes(view, sorted(moves), np.random.default_rng(seed + 3), n_txn)
        rb = store.attach_rebalancer()
        try:
            t0 = time.perf_counter()
            epoch = rb.execute(rb.plan_moves(moves, reason="cross_moves"))
            out["migrate_s"] = time.perf_counter() - t0
        finally:
            store.detach_rebalancer()
        if epoch is None:
            raise RuntimeError("the migration aborted")
        out["moves"] = moves
        out["moved_from"] = {sid: int(placement[sid]) for sid in moves}
        commit("migrated", batches)
        with store.read_view() as view:
            run("migrated", view, seed + 4)
            out["placement_migrated"] = plane.placement_for(len(view.snaps)).tolist()
        out["migration_rebuilds"] = plane.stats.migration_rebuilds
    finally:
        store.detach_shard_plane()
    out["leaf_spmm_launches"] = leaf_spmm.launches - launches0
    return out


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's dtype, shape and bytes: equal digests are
    bitwise-equal answers."""
    a = t.detach().cpu().contiguous()
    head = f"{a.dtype}{tuple(a.shape)}".encode()
    return hashlib.sha256(head + a.view(torch.uint8).numpy().tobytes()).hexdigest()


def summary(run: dict) -> dict:
    """What a rank saves: every answer's digest, the push-PageRank vectors
    (held within tolerance, not bitwise), seconds and counts."""
    keep = {k: v for k, v in run.items() if k not in STEPS + ("writes",)}
    for when in STEPS:
        keep[f"{when}_digest"] = {k: digest(v) for k, v in run[when].items()}
        keep[f"{when}_pagerank_push"] = run[when]["pagerank_push"].cpu()
    return keep


def spawn_ranks(cmd: Sequence[str], world: int, timeout: float,
                env: Optional[dict] = None) -> List[str]:
    """Run ``cmd`` as ``world`` ranks (``REPRO_MULTIHOST=1``, ``RANK``,
    ``LOCAL_RANK`` and ``WORLD_SIZE`` set; ``cmd`` names the group's
    address), all within ``timeout`` seconds; returns their standard
    outputs.  Raises if any rank exits non-zero or runs out of time, after
    killing every rank still running (the others would wait in a
    collective for the one that is gone)."""
    base = dict(os.environ if env is None else env)
    # output to files, not pipes: a rank that fills a pipe would block
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in range(world)]
    procs = [subprocess.Popen(list(cmd), stdout=out, stderr=err,
                              env=dict(base, REPRO_MULTIHOST="1", RANK=str(r),
                                       LOCAL_RANK=str(r), WORLD_SIZE=str(world)))
             for r, (out, err) in enumerate(logs)]

    def read(f) -> str:
        f.seek(0)
        return f.read()

    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                if p.poll():
                    raise RuntimeError(f"rank {r} of {world} exited {p.returncode}:\n"
                                       f"{read(logs[r][1])[-3000:]}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks not done in {timeout} s")
            time.sleep(0.05)
        for r, p in enumerate(procs):
            if p.returncode:
                raise RuntimeError(f"rank {r} of {world} exited {p.returncode}:\n"
                                   f"{read(logs[r][1])[-3000:]}")
        return [read(out) for out, _ in logs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()


def main(argv=None) -> int:
    from ..kernels.runtime import default_device
    from .mesh import distributed_shard_mesh, init_distributed, multihost_enabled

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=18, help="R-MAT scale of the store")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--txns", type=int, default=20, help="transactions on shard 1")
    ap.add_argument("--d", type=int, default=128, help="SpMM width")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, help="nccl (the card's default) or gloo")
    ap.add_argument("--init", default=None,
                    help="the group's address, tcp://host:port or file://path "
                         "(default: torchrun's MASTER_ADDR and MASTER_PORT)")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms: the card's sums "
                         "(index_add_) then add in a fixed order")
    ap.add_argument("--out", default=None, help="directory for rank<r>.pt")
    args = ap.parse_args(argv)

    device = torch.device(args.device) if args.device else default_device()
    backend = args.backend or ("gloo" if device.type == "cpu" else "nccl")
    if multihost_enabled():
        init_distributed(coordinator_address=args.init, backend=backend)
    mesh = distributed_shard_mesh(args.shards, device=device, backend=backend)
    rank = 0 if mesh.ranks is None else mesh.ranks.rank
    world = 1 if mesh.ranks is None else mesh.ranks.world
    here = mesh.flat_devices[mesh.local_shards[0]]
    if here.type == "cuda":
        torch.cuda.set_device(here)
    t0 = time.perf_counter()
    store, info = rmat_store(args.scale, args.seed, here)
    info["store_s"] = time.perf_counter() - t0
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    run = drive(store, mesh, args.seed, args.txns, args.d)
    line = {"rank": rank, "world": world, "backend": backend, "device": str(here),
            "shards": args.shards, "local_shards": mesh.local_shards, **info,
            **{k: v for k, v in run.items()
               if k not in STEPS + ("writes", "moves", "moved_from")}}
    print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        torch.save(summary(run), os.path.join(args.out, f"rank{rank}.pt"))
    if mesh.ranks is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
