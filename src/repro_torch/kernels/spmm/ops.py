"""SpMM / scan-reduce over the leaf-block snapshot view: the CUDA kernels
(``csrc/leaf_scan_reduce.cu``, ``csrc/leaf_spmm.cu``) on the card, the
plain versions on the CPU."""

from __future__ import annotations

import torch

from ..runtime import check, count_launch, cuda_input, kernel_fn, on_cpu, stream_ptr
from .ref import leaf_scan_reduce_ref, leaf_spmm_ref


def route(width: int, address: int) -> str:
    """The route of a leaf kernel that reads rows of ``width`` 4-byte
    elements starting at byte ``address``, a pure function of the two:
    ``"vec4"`` (16-byte loads, four elements a lane) when width % 4 == 0
    and the data is 16-byte aligned, ``"scalar"`` (one element a lane)
    otherwise.  ``leaf_spmm`` asks it with H's d and start, and
    ``leaf_scan_reduce`` with the tile width B and the start of ``rows``."""
    return "vec4" if width % 4 == 0 and address % 16 == 0 else "scalar"


def leaf_scan_reduce(rows, x, length=None) -> torch.Tensor:
    """y[i] = sum over live j of x[rows[i, j]] — the PR scan primitive.

    rows: [N, B] int32 tiles; x: [nx] f32; length: [N] int32, each tile's
    live ids (None: all B).  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel, which reads only each tile's live prefix
    and gathers ``x`` itself (the [N, B] gathered values never reach
    device memory), on the route that :func:`route` names for B and rows.
    """
    rows = torch.as_tensor(rows, dtype=torch.int32)
    x = torch.as_tensor(x, dtype=torch.float32, device=rows.device)
    if length is not None:
        length = torch.as_tensor(length, dtype=torch.int32, device=rows.device)
    if on_cpu(rows, "leaf_scan_reduce"):
        return leaf_scan_reduce_ref(rows, x, length)
    rows = cuda_input(rows, torch.int32, 2, "leaf_scan_reduce rows")
    x = cuda_input(x, torch.float32, 1, "leaf_scan_reduce x")
    n, b = rows.shape
    if length is not None:
        length = cuda_input(length, torch.int32, 1, "leaf_scan_reduce length")
        if length.shape[0] != n:
            raise ValueError("leaf_scan_reduce: length and rows disagree on N")
    out = torch.empty(n, dtype=torch.float32, device=rows.device)
    if n:
        vec4 = route(b, rows.data_ptr()) == "vec4"
        fn = kernel_fn("leaf_scan_reduce", "leaf_scan_reduce_launch", "pppplilip")
        check(fn(rows.data_ptr(), x.data_ptr(),
                 None if length is None else length.data_ptr(), out.data_ptr(),
                 n, b, x.shape[0], int(vec4), stream_ptr(rows)),
              "leaf_scan_reduce")
        count_launch(leaf_scan_reduce)
    return out


leaf_scan_reduce.launches = 0


def leaf_spmm(rows, h, length=None) -> torch.Tensor:
    """Y[i] = sum over live j of H[rows[i, j]] — the GNN message primitive.

    rows: [N, B] int32 tiles; h: [nv, d] f32; length: [N] int32, each
    tile's live ids (None: all B).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel, which reads only each tile's live
    prefix and gathers rows of H directly (no one-hot, no padding of H),
    on the route that :func:`route` names.
    """
    rows = torch.as_tensor(rows, dtype=torch.int32)
    h = torch.as_tensor(h, dtype=torch.float32, device=rows.device)
    if length is not None:
        length = torch.as_tensor(length, dtype=torch.int32, device=rows.device)
    if on_cpu(rows, "leaf_spmm"):
        return leaf_spmm_ref(rows, h, length)
    rows = cuda_input(rows, torch.int32, 2, "leaf_spmm rows")
    h = cuda_input(h, torch.float32, 2, "leaf_spmm H")
    n, b = rows.shape
    nv, d = h.shape
    if length is not None:
        length = cuda_input(length, torch.int32, 1, "leaf_spmm length")
        if length.shape[0] != n:
            raise ValueError("leaf_spmm: length and rows disagree on N")
    out = torch.empty((n, d), dtype=torch.float32, device=rows.device)
    if n and d:
        vec4 = route(d, h.data_ptr()) == "vec4"
        fn = kernel_fn("leaf_spmm", "leaf_spmm_launch", "ppppliilip")
        check(fn(rows.data_ptr(), h.data_ptr(),
                 None if length is None else length.data_ptr(), out.data_ptr(),
                 n, b, d, nv, int(vec4), stream_ptr(rows)), "leaf_spmm")
        count_launch(leaf_spmm)
    return out


leaf_spmm.launches = 0


def _tier_groups(blocks):
    """``[(gidx_or_None, (src, rows, length))]`` per tier — one entry with
    ``gidx=None`` for unified (single-tier) block views."""
    groups = getattr(blocks, "groups", None)
    if groups is None:
        return [(None, (blocks.src, blocks.rows, blocks.length))]
    return [(blocks.gidx[t], groups[t]) for t in blocks.tiers]


def _scatter_rows(out: torch.Tensor, gidx, y: torch.Tensor) -> None:
    out[torch.from_numpy(gidx).to(out.device)] = y


def leaf_scan_reduce_view(view, x) -> torch.Tensor:
    """Per-tile scan-reduce over a view's device-resident leaf blocks, each
    tile read over its live prefix (the blocks' ``length`` column).

    ``y[i] = sum_j x[rows[i, j]]`` for tile i of
    ``view.to_leaf_blocks_device()``; warm repeats on an unchanged view read
    the pinned device tiles and transfer nothing host->device (pass ``x`` as
    a tensor on ``view.device`` to keep the whole call transfer-free).  On a
    tiered pool the kernel runs once per tier group (fixed ``[n_t, B_t]``
    shapes) and each group's outputs are scattered back to global tile order.
    """
    blocks = view.to_leaf_blocks_device()
    x = torch.as_tensor(x, dtype=torch.float32, device=view.device)
    parts = _tier_groups(blocks)
    if len(parts) == 1 and parts[0][0] is None:
        return leaf_scan_reduce(blocks.rows, x, blocks.length)
    out = torch.zeros(blocks.n_blocks, dtype=torch.float32, device=view.device)
    for gidx, (_s, rows, length) in parts:
        _scatter_rows(out, gidx, leaf_scan_reduce(rows, x, length))
    return out


def leaf_spmm_view(view, h) -> torch.Tensor:
    """Per-tile SpMM (GNN messages) over device-resident leaf blocks, each
    tile read over its live prefix (the blocks' ``length`` column).

    Tiered pools run the kernel once per tier group and scatter the
    per-group outputs back into global tile order.
    """
    blocks = view.to_leaf_blocks_device()
    h = torch.as_tensor(h, dtype=torch.float32, device=view.device)
    parts = _tier_groups(blocks)
    if len(parts) == 1 and parts[0][0] is None:
        return leaf_spmm(blocks.rows, h, blocks.length)
    out = torch.zeros((blocks.n_blocks, h.shape[1]), dtype=torch.float32,
                      device=view.device)
    for gidx, (_s, rows, length) in parts:
        _scatter_rows(out, gidx, leaf_spmm(rows, h, length))
    return out


def spmm_view(view, h) -> torch.Tensor:
    """Per-vertex aggregated SpMM: ``Y[u] = sum_{v in N(u)} H[v]``.

    Runs the tile kernel then sums tile outputs by their source vertex with
    ``index_add_`` — all on the view's device.  On a tiered pool each tier
    group runs its own fixed-shape kernel and the per-tier partials add up:
    every vertex's leaves share one tier, so the other tiers add exact zeros.
    On CUDA ``index_add_`` adds with atomics, so the f32 order (and the last
    bits) can change from run to run.

    Under an attached shard plane the same kernel runs per shard over its
    pinned tiles and the tile outputs add by source into one output, each
    vertex's tiles in this order (every source vertex lives on one shard);
    see :mod:`repro_torch.core.shard_plane`.
    """
    from ...core.shard_plane import active_plane

    plane = active_plane(view)
    if plane is not None:
        return plane.spmm(view, h)
    blocks = view.to_leaf_blocks_device()
    h = torch.as_tensor(h, dtype=torch.float32, device=view.device)
    out = torch.zeros((view.n_vertices, h.shape[1]), dtype=torch.float32,
                      device=view.device)
    for _gidx, (src, rows, length) in _tier_groups(blocks):
        out.index_add_(0, src, leaf_spmm(rows, h, length))
    return out


__all__ = [
    "leaf_scan_reduce",
    "leaf_scan_reduce_view",
    "leaf_spmm",
    "leaf_spmm_view",
    "leaf_scan_reduce_ref",
    "leaf_spmm_ref",
    "route",
    "spmm_view",
]
