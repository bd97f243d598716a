"""The arithmetic every metric is read with: the H100's peaks, the bytes
the three leaf kernels need, and the statistics of a run.

The byte counts are a frozen copy of ``chip_smoke.py``'s phase 2: each
input byte read once, each output byte written once, for what the data
needs (a tile's live prefix in 32-byte sectors, each distinct row of x
or H once, each distinct sector a search's probes touch once), so a
kernel that reads more or a cache that hides reads both stay honest
against the same bound.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_CUDA_CORE_FLOPS = 67e12
SECTOR = 32  # bytes: one DRAM sector


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds one H100 takes to move ``nbytes`` through HBM and
    do ``ops`` f32 operations on the CUDA cores, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_CUDA_CORE_FLOPS)


def live_sector_bytes(lengths: Iterable[int]) -> int:
    """Bytes of the 32-byte sectors that hold each row's first
    ``lengths[i]`` int32 ids (rows start on a sector boundary, as rows of
    any width that is a multiple of 8 ids do); none for an empty row."""
    per = SECTOR // 4
    if hasattr(lengths, "long"):  # a tensor: summed where it lives
        return int(((lengths.long() + per - 1) // per).sum()) * SECTOR
    return sum((int(n) + per - 1) // per for n in lengths) * SECTOR


def scan_bytes(n_tiles: int, sector_bytes: int, distinct_ids: int) -> int:
    """``leaf_scan_reduce`` over one group of tiles: the live sectors, each
    distinct x read once, ``length`` and ``y`` (4 bytes a tile each)."""
    return sector_bytes + distinct_ids * 4 + n_tiles * 4 + n_tiles * 4


def spmm_bytes(n_tiles: int, sector_bytes: int, distinct_ids: int, d: int) -> int:
    """``leaf_spmm`` over one group of tiles: the live sectors, each
    distinct row of H once, ``length`` and the ``[n_tiles, d]`` f32
    output."""
    return sector_bytes + distinct_ids * d * 4 + n_tiles * 4 + n_tiles * d * 4


def kernel_bound_s(kernel: str, group: dict, d: int) -> float:
    """The bound of one launch of ``kernel`` over a group of tiles
    described by ``group`` (``n_tiles``, ``live``, ``sector_bytes``,
    ``distinct``)."""
    if kernel == "leaf_scan_reduce":
        return bound_s(scan_bytes(group["n_tiles"], group["sector_bytes"], group["distinct"]),
                       group["live"])
    if kernel == "leaf_spmm":
        return bound_s(spmm_bytes(group["n_tiles"], group["sector_bytes"], group["distinct"], d),
                       group["live"] * d)
    raise KeyError(kernel)


def search_sector_ids(rows, targets, index, length):
    """(distinct sector ids, probes): ``leaf_search``'s binary search over
    each query's live prefix (tile ``index[i]``, ``length`` ids) replayed,
    every probe's 32-byte sector of ``rows`` kept once."""
    import torch

    width = rows.shape[1]
    flat = rows.reshape(-1)
    index = index.long()
    lo = torch.zeros_like(index)
    hi = length[index].long().clamp(0, width)
    base = index * width
    targets = targets.long()
    ids, probes = [], 0
    while True:
        active = lo < hi
        if not bool(active.any()):
            break
        mid = (lo + hi) >> 1
        at = base[active] + mid[active]
        probes += int(at.numel())
        ids.append(torch.unique(at // (SECTOR // 4)))
        below = torch.zeros_like(active)
        below[active] = flat[at].long() < targets[active]
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return (torch.unique(torch.cat(ids)) if ids else base[:0]), probes


def search_bytes(n_sectors: int, n_pairs: int, n_tiles: int) -> int:
    """One ``leaf_search`` launch: the distinct sectors its probes touch;
    per pair the target, the tile index, pos (4 bytes each) and found (1);
    each distinct tile's length."""
    return n_sectors * SECTOR + n_pairs * (4 * 3 + 1) + n_tiles * 4


def launch_share_pct(bounds: Sequence[float], durations_s: Sequence[float]) -> Optional[float]:
    """A kernel's share of its roofline, in %: the summed least time of its
    launches over their summed device time.  None where no launch was
    traced or the trace holds another number of launches than the
    queries made (a launch missed or one not accounted for)."""
    if not durations_s or len(bounds) != len(durations_s):
        return None
    return 100.0 * sum(bounds) / sum(durations_s)


def roofline_pct(kernel: str, groups: Sequence[dict], d: int,
                 durations_s: Sequence[float]) -> Optional[float]:
    """A kernel's share of its roofline over a traced window, in %: the
    bound of every launch over their device time.  Each call launches
    once per group of tiles, so the launches are whole calls; None where
    the trace holds none, or a part of a call."""
    if not durations_s or not groups or len(durations_s) % len(groups):
        return None
    calls = len(durations_s) // len(groups)
    need = calls * sum(kernel_bound_s(kernel, g, d) for g in groups)
    return 100.0 * need / sum(durations_s)


# ---------------------------------------------------------------------------
# The statistics of a run
# ---------------------------------------------------------------------------
def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile by nearest rank: the smallest value with at
    least ``q`` % of the values at or below it (``inf`` counts as the
    largest; a failed query is ``inf``)."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(completed: int, window_s: float) -> float:
    """Work completed in the window over all of the window's seconds."""
    return completed / window_s


def visibility(txns: List[Dict], reads: List[Dict], t_end: float) -> Optional[float]:
    """The mean commit-to-answer delay in seconds over the transactions
    due in the window: from when each was due to the completion of the
    first read whose pinned snapshot contains it (``read["ts"] >=
    txn["ts"]``), or to the window's end where none completed by then
    (a transaction never acknowledged counts so too).  None without
    transactions."""
    if not txns:
        return None
    done = sorted((r["t_done"], r["ts"]) for r in reads
                  if r.get("t_done") is not None and r["t_done"] <= t_end)
    delays = []
    for t in txns:
        seen = t_end
        if t.get("ts"):
            for t_done, ts in done:
                if ts >= t["ts"] and t_done >= t["due"]:
                    seen = t_done
                    break
        delays.append(max(0.0, seen - t["due"]))
    return sum(delays) / len(delays)
