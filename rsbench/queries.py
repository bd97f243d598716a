"""The read queries a traffic mix names, as calls into the program.

Each kind runs one of ``repro_torch``'s view-level entry points on a
pinned snapshot view and returns its answer on the device.  A checked
query also hands the judge what the view held (fingerprints of its COO or
tiles) and the answer's rows that the reference recomputes; that capture
runs after the query's time is taken.

``CONTROL`` holds the same kinds computed by the plain reference in
bfloat16 (:mod:`rsbench.reference.graph`) on the view's COO: the
control that the comparison must refuse.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from . import gen
from .reference import graph as ref


@dataclass(frozen=True)
class Kind:
    name: str
    uses: str  # "coo" or "tiles": what of the view the query reads
    run: Callable  # (view, ctx, root) -> answer on the device


def _coo(view):
    return view.to_coo_device()


def _pagerank(view, ctx, root):
    from repro_torch.core import analytics

    return analytics.pagerank_view(view, iters=ctx["pagerank_iters"])


def _bfs(view, ctx, root):
    from repro_torch.core import analytics

    return analytics.bfs_view(view, root)


def _sssp(view, ctx, root):
    from repro_torch.core import analytics

    src, dst = _coo(view)
    return analytics.sssp_view(view, gen.edge_weight(src, dst, ctx["seed"]), root)


def _wcc(view, ctx, root):
    from repro_torch.core import analytics

    return analytics.wcc_view(view)


def _spmm(view, ctx, root):
    from repro_torch.kernels.spmm import spmm_view

    return spmm_view(view, ctx["H"])


def _scan(view, ctx, root):
    from repro_torch.kernels.spmm import leaf_scan_reduce_view

    return leaf_scan_reduce_view(view, ctx["x"])


KINDS: Dict[str, Kind] = {k.name: k for k in (
    Kind("pagerank_view", "coo", _pagerank),
    Kind("bfs_view", "coo", _bfs),
    Kind("sssp_view", "coo", _sssp),
    Kind("wcc_view", "coo", _wcc),
    Kind("spmm_view", "tiles", _spmm),
    Kind("leaf_scan_reduce_view", "tiles", _scan),
)}


# ---------------------------------------------------------------------------
# The control: the plain reference in bfloat16, in the program's place
# ---------------------------------------------------------------------------
_LOW = torch.bfloat16


def _c_pagerank(view, ctx, root):
    src, dst = _coo(view)
    return ref.pagerank(src, dst, view.n_vertices, ctx["pagerank_iters"], dtype=_LOW)


def _c_bfs(view, ctx, root):
    src, dst = _coo(view)
    return ref.bfs(src, dst, view.n_vertices, root)


def _c_sssp(view, ctx, root):
    src, dst = _coo(view)
    w = gen.edge_weight(src, dst, ctx["seed"])
    return ref.sssp(src, dst, w, view.n_vertices, root, dtype=_LOW)


def _c_wcc(view, ctx, root):
    src, dst = _coo(view)
    return ref.wcc(src, dst, view.n_vertices)


def _c_spmm(view, ctx, root):
    src, dst = _coo(view)
    return ref.neighbor_sum(src, dst, ctx["H"], view.n_vertices, dtype=_LOW)[0]


def _c_scan(view, ctx, root):
    src, dst = _coo(view)
    return ref.neighbor_sum(src, dst, ctx["x"], view.n_vertices, dtype=_LOW)[0]


CONTROL: Dict[str, Kind] = {k.name: k for k in (
    Kind("pagerank_view", "coo", _c_pagerank),
    Kind("bfs_view", "coo", _c_bfs),
    Kind("sssp_view", "coo", _c_sssp),
    Kind("wcc_view", "coo", _c_wcc),
    Kind("spmm_view", "coo", _c_spmm),
    Kind("leaf_scan_reduce_view", "coo", _c_scan),
)}


# ---------------------------------------------------------------------------
# What a checked query hands the judge
# ---------------------------------------------------------------------------
def tile_groups(blocks):
    """``[(src, rows, length)]``: one group for a single-width view, one a
    tier for a tiered one (``DeviceTieredBlocks``)."""
    groups = getattr(blocks, "groups", None)
    if groups is None:
        return [(blocks.src, blocks.rows, blocks.length)]
    return [groups[t] for t in sorted(groups)]


def tile_src(blocks) -> torch.Tensor:
    """Each tile's source vertex, in the global tile order that
    ``leaf_scan_reduce_view`` answers in."""
    groups = getattr(blocks, "groups", None)
    if groups is None:
        return blocks.src
    dev = next(iter(groups.values()))[0].device
    out = torch.empty(blocks.n_blocks, dtype=torch.int32, device=dev)
    for t in sorted(groups):
        out[torch.from_numpy(blocks.gidx[t]).to(out.device)] = groups[t][0]
    return out


TILE_CHUNK = 1 << 17  # tiles a step: [chunk, 512] int64 keys are 512 MiB


def tiles_fingerprint(blocks):
    """The fingerprint of the live edges the tiles hold: tile i's source
    with each of its first ``length[i]`` ids."""
    total = (0, 0)
    for src, rows, length in tile_groups(blocks):
        width = rows.shape[1]
        col = torch.arange(width, device=rows.device)
        for lo in range(0, rows.shape[0], TILE_CHUNK):
            r = rows[lo:lo + TILE_CHUNK]
            live = col[None, :] < length[lo:lo + TILE_CHUNK, None].long()
            keys = gen.edge_keys(src[lo:lo + TILE_CHUNK, None].expand_as(r)[live], r[live])
            total = gen.add_fingerprints(total, gen.fingerprint_keys(keys))
    return gen.normalize(total)


def coo_fingerprint(view):
    src, dst = _coo(view)
    return gen.normalize(gen.fingerprint_keys(gen.edge_keys(src, dst)))


def capture(kind: Kind, view, answer, ctx, control: bool = False) -> dict:
    """What the judge needs of one checked query, taken while its view is
    pinned: the fingerprint of what the query read, and the answer (for
    SpMM its sampled rows; for the scan each tile's source beside it)."""
    out = {}
    if kind.uses == "coo":
        out["coo_fp"] = coo_fingerprint(view)
    else:
        blocks = view.to_leaf_blocks_device()
        out["tiles_fp"] = tiles_fingerprint(blocks)
    if kind.name == "spmm_view":
        answer = answer[ctx["spmm_rows"]].clone()
    elif kind.name == "leaf_scan_reduce_view":
        out["tile_src"] = (torch.arange(view.n_vertices, dtype=torch.int32, device=answer.device)
                           if control else tile_src(view.to_leaf_blocks_device()).clone())
    out["answer"] = answer
    return out
