"""Where ``intersect_count``'s time goes, measured on the card.

Builds the undirected Graph500 R-MAT store of ``chip_smoke.py``'s phase 6
(scale 18, edge factor 16, |P|=64, B=512) and takes tile pairs the way its
phase 2 does: the first leaf of each endpoint of sampled edges, mostly hub
tiles.  At 1,024, 8,192 and 65,536 pairs it times the kernel in place with
every live length cut to 0 (the index and length loads alone), 1, 32 and
64 ids, and uncut; the uncut call is checked against the plain version
bit for bit on its first 2,048 pairs.  One JSON line per pair count; needs the card::

    PYTHONPATH=src python -m repro_torch.kernels.intersect.probe_lengths [--seed 0]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ...configs import CONFIG
from ...core import RapidStore, view_assembler
from ...graph import rmat_edges
from ..flash_decode.probe_chunks import replay_ms
from .ops import intersect_count
from .ref import intersect_count_ref

PAIRS = (1024, 8192, 65536)
CUTS = (0, 1, 32, 64)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_lengths needs a CUDA device")
    scale = 18
    store = RapidStore.from_edges(1 << scale, rmat_edges(scale, 16 << scale, seed=args.seed),
                                  undirected=True, partition_size=CONFIG.partition_size,
                                  B=CONFIG.leaf_width, device="cuda")
    with store.read_view() as view:
        blocks = view.to_leaf_blocks_device()
        rows, length = blocks.rows, blocks.length
        src, dst = view.to_coo()
        bsrc, order = view_assembler.block_src_index(view)
        s_sorted = bsrc[order]
        rng = np.random.default_rng(args.seed)
        e = rng.choice(len(src), max(PAIRS), replace=True)
        first = [order[np.searchsorted(s_sorted, x[e].astype(np.int64))] for x in (src, dst)]
        ia_all, ib_all = (torch.from_numpy(f.astype(np.int32)).cuda() for f in first)
        for q in PAIRS:
            ia, ib = ia_all[:q].contiguous(), ib_all[:q].contiguous()
            want = intersect_count_ref(rows, rows, ia[:2048], ib[:2048], length, length)
            line = {"pairs": q, "mean_live_a": float(length[ia.long()].double().mean()),
                    "mean_live_b": float(length[ib.long()].double().mean())}
            got = intersect_count(rows, rows, ia, ib, length, length)
            if not torch.equal(got[:2048], want):
                raise AssertionError("intersect_count disagrees with its plain version")
            line["uncut_ms"] = replay_ms(
                lambda: intersect_count(rows, rows, ia, ib, length, length))
            for cut in CUTS:
                lc = length.clamp(max=cut)
                line[f"cut_{cut}_ms"] = replay_ms(
                    lambda: intersect_count(rows, rows, ia, ib, lc, lc))
            line["card"] = torch.cuda.get_device_name(0)
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
