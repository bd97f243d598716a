#!/usr/bin/env python3
"""Run the paths of ``chip_smoke.py`` that spread over the cards, on every
visible card, and nothing else of the script.

    python3 scripts/chip_multicard.py [--seed N] [--paths shard_plane,...]

The paths: phase 5s (the shard plane on the scale-22 store, shard k on
card k % n_cards, then its four shards on one card), the mesh GNN step on
that store, phase 6m (the plane in one process over the cards and on one
card, then over one nccl rank a card and over four gloo ranks, on the
undirected scale-18 store) and the mesh phase's BST, granite, int8
reduce and elastic parts.  Each path runs under ``chip_smoke.counted``:
with more than one card it prints a ``cards`` line (launches,
``max_memory_allocated`` and the bytes ``collectives.shard`` copied
between cards, per card) and fails unless its kernels launched on every
card.  The JSON lines are ``chip_smoke.py``'s; the last line is the
``ok`` line, after the cards' ``nvidia-smi`` name and power limit.  Exits
non-zero without a card.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# each path and its phase, in the order they run
PATHS = {"shard_plane": cs.phase_shard_plane, "mesh_gnn": cs.phase_mesh_gnn,
         "multiprocess": cs.phase_multiprocess, "mesh_bst": cs.phase_mesh_bst,
         "mesh_granite": cs.phase_mesh_granite, "mesh_reduce": cs.phase_mesh_reduce,
         "mesh_elastic": cs.phase_mesh_elastic}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the data and weights")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma-separated subset of " + ",".join(PATHS))
    args = ap.parse_args(argv)
    paths = args.paths.split(",")
    if not set(paths) <= set(PATHS):
        ap.error(f"--paths: each of {PATHS}")

    import torch

    if not torch.cuda.is_available():
        print("chip_multicard: torch sees no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs.phase_card(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    cs.emit("cards_seen", count=torch.cuda.device_count(), nvidia_smi=smi.splitlines())
    cs.phase_build()
    seed, launches = args.seed, {}
    if {"shard_plane", "mesh_gnn"} & set(paths):
        store, _ = cs.build_store(cs.SCALE, seed, device)
        for path in ("shard_plane", "mesh_gnn"):
            if path in paths:
                cs.counted(path, launches, PATHS[path], store, seed, device)
        del store
        cs.free_device(device)
    if "multiprocess" in paths:
        tc_store, _ = cs.build_store(cs.TC_SCALE, seed, device, undirected=True)
        cs.counted("multiprocess", launches, cs.phase_multiprocess, tc_store, seed, device)
        del tc_store
        cs.free_device(device)
    for path in ("mesh_bst", "mesh_granite", "mesh_reduce", "mesh_elastic"):
        if path in paths:
            cs.counted(path, launches, PATHS[path], seed, device)
    cs.emit("total", seconds=time.monotonic() - cs.START, launches=launches)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
