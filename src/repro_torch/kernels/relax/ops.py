"""The edge relax of BFS, SSSP and WCC: the CUDA kernel
(``csrc/edge_relax.cu``) on the card, the plain version on the CPU."""

from __future__ import annotations

import torch

from ..runtime import (check, check_operands, count_launch, cuda_input, kernel_fn,
                       launch_on, on_cpu, stream_ptr)
from .ref import MODES, edge_relax_ref

_X_DTYPE = {"flag": torch.bool, "min_plus": torch.float32, "min_both": torch.int32}


def edge_relax(mode: str, x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               valid=None, w=None) -> torch.Tensor:
    """One relax of the vertex vector ``x`` ([n]) over one shard's edges
    ``src[e] -> dst[e]`` ([m] ids; ``valid`` [m] bool marks the live slots,
    None: all), for the loops of :mod:`repro_torch.core.distributed`.

    A CPU tensor takes the plain version, :func:`.ref.edge_relax_ref`,
    which returns each vertex's reduction over its edges (the reduction's
    identity where it has none).  A CUDA tensor launches the kernel, one
    pass over the edges that reads the int32 ids in place and never
    dereferences a pad slot or an id outside ``[0, n)``; it returns what
    the loops need of that reduction, bit for bit the same after their
    next step:

    - ``"flag"`` (``x`` the bool frontier): int32, 1 where some live
      in-edge leaves the frontier, else 0, so ``> 0`` exactly where the
      plain version's is;
    - ``"min_plus"`` (``x`` the f32 distances, ``w`` [m] f32 weights): the
      min of ``x`` and the plain version's, which is what the loop's
      ``torch.minimum(dist, cand)`` makes of either;
    - ``"min_both"`` (``x`` the int32 labels): the min of ``x`` and the
      plain version's, likewise.
    """
    if mode not in MODES:
        raise ValueError(f"edge_relax: mode {mode!r}, not one of {MODES}")
    check_operands("edge_relax", src, x, dst, valid, w)
    if on_cpu(src, "edge_relax"):
        return edge_relax_ref(mode, x, src, dst, valid, w)
    src = cuda_input(src, torch.int32, 1, "edge_relax src")
    dst = cuda_input(dst, torch.int32, 1, "edge_relax dst")
    x = cuda_input(x, _X_DTYPE[mode], 1, "edge_relax x")
    m, n = src.shape[0], x.shape[0]
    if dst.shape[0] != m:
        raise ValueError("edge_relax: src and dst disagree on the edge count")
    if valid is not None:
        valid = cuda_input(valid, torch.bool, 1, "edge_relax valid")
        if valid.shape[0] != m:
            raise ValueError("edge_relax: valid and src disagree on the edge count")
    if mode == "min_plus":
        if w is None:
            raise ValueError("edge_relax: min_plus needs the weights w")
        w = cuda_input(w, torch.float32, 1, "edge_relax w")
        if w.shape[0] != m:
            raise ValueError("edge_relax: w and src disagree on the edge count")
    out = torch.zeros(n, dtype=torch.int32, device=x.device) if mode == "flag" else x.clone()
    if m and n:
        fn = kernel_fn("edge_relax", "edge_relax_launch", "ipppppplip")
        with launch_on(src.device):
            check(fn(MODES.index(mode), src.data_ptr(), dst.data_ptr(),
                     None if valid is None else valid.data_ptr(), x.data_ptr(),
                     w.data_ptr() if mode == "min_plus" else None, out.data_ptr(),
                     m, n, stream_ptr(src)), "edge_relax")
        count_launch(edge_relax, src.device)
    return out


edge_relax.launches = 0

__all__ = ["edge_relax", "edge_relax_ref"]
