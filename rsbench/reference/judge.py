"""The comparison that decides ``correct``.

The judge takes what the run kept: the base edge keys, every
acknowledged transaction with its commit timestamp, the operands, and
for each checked query (a sample drawn from the seed over the whole
window, each query whose view was assembled anew, and each client's last
query) its pinned timestamp, the fingerprint of what it read and
its answer.  It replays the edge set at each such timestamp
(:func:`graph.replay`), recomputes the answer with the plain reference
and reduces every comparison to a few numbers, each held to its limit in
``limits.json``.

Numbers (a number is the worst over the checked queries of its kind):

- ``views_wrong``: checked views (and the final view after the window)
  whose COO or tiles hold another edge set than the replay at their
  timestamp: the store, the transactions and the view assembly;
- ``bfs_wrong``, ``wcc_wrong``, ``sssp_wrong``: entries that differ
  (BFS levels, WCC labels and SSSP's float32 distances are exact);
- ``pagerank_err``: the largest |p - p_ref| / p_ref over the vertices;
- ``spmm_err``: the largest |Y - Y_ref| / sum |H| over a seeded sample
  of rows and every column, the magnitudes summed over the same
  neighbours (f32 sums drift with their magnitudes, not their values);
- ``scan_err``: the same for the scan, its tiles' outputs added up by
  each tile's source vertex;
- ``kinds_unchecked``: kinds of the mix with no checked answer;
- ``answers_lost``: read queries and writes that failed.

A query kind defined by its own file (``rsbench/kinds/<name>.py``) adds
its ``NUMBERS``, each with its limit, where the mix names it: its
``hold`` gives them for one checked answer, and they add up over the
checks (wrong answers in all).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import torch

from .. import gen
from . import graph

LIMITS = Path(__file__).resolve().parent / "limits.json"


def limits(files: Optional[Dict[str, object]] = None) -> Dict[str, float]:
    """Each number's limit: ``limits.json``'s, and those of the kind files
    ``files`` (kind name -> module)."""
    out = {k: float(v) for k, v in json.loads(LIMITS.read_text())["limits"].items()}
    for name, mod in (files or {}).items():
        for number, limit in mod.NUMBERS.items():
            if number in out:
                raise KeyError(f"kind {name!r} names the number {number!r} a second time")
            out[number] = float(limit)
    return out


def _worst(a: float, b: float) -> float:
    """The larger of two readings, NaN counting as the largest."""
    return b if (b != b or b > a) else a


def _scaled_err(got: torch.Tensor, want: torch.Tensor, mag: torch.Tensor) -> float:
    """The largest |got - want| / mag; a gap where mag is 0 reads inf."""
    if got.shape != want.shape:
        raise ValueError(f"answer of shape {tuple(got.shape)}, want {tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    gap = (got.to(torch.float64) - want.to(torch.float64)).abs()
    tiny = torch.finfo(torch.float64).tiny
    err = (gap / mag.to(torch.float64).clamp(min=tiny)).nan_to_num(nan=float("inf"))
    return float(err.max())


def _wrong(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        raise ValueError(f"answer of shape {tuple(got.shape)}, want {tuple(want.shape)}")
    return int((got.to(want.dtype) != want).sum())


def judge(base_keys: torch.Tensor, txns: List[tuple], checks: List[dict], ctx: dict,
          kinds: List[str], lost: int, final: Optional[dict] = None,
          files: Optional[Dict[str, object]] = None) -> Dict[str, float]:
    """The numbers of one run.  ``txns`` are ``(commit_ts, inserts,
    deletes)``; each check has ``kind``, ``ts`` and what
    :func:`rsbench.queries.capture` or a kind file's ``capture`` took
    (``final`` is the view pinned after the window, with its
    fingerprints); ``files`` maps the mix's kind files to their modules."""
    n = ctx["n"]
    files = files or {}
    numbers = {"views_wrong": 0, "bfs_wrong": 0, "wcc_wrong": 0, "sssp_wrong": 0,
               "pagerank_err": 0.0, "spmm_err": 0.0, "scan_err": 0.0,
               "kinds_unchecked": len(set(kinds) - {c["kind"] for c in checks}),
               "answers_lost": lost}
    for mod in files.values():
        numbers.update({k: 0 for k in mod.NUMBERS})
    views = list(checks) + ([final] if final is not None else [])
    for ts in sorted({v["ts"] for v in views}):
        keys = graph.replay(base_keys, txns, ts)
        want_fp = gen.normalize(gen.fingerprint_keys(keys))
        src, dst = graph.split_keys(keys)
        del keys
        for v in views:
            if v["ts"] != ts:
                continue
            for key in ("coo_fp", "tiles_fp"):
                if key in v and tuple(v[key]) != want_fp:
                    numbers["views_wrong"] += 1
            if v.get("answer") is not None:
                try:
                    mod = files.get(v["kind"])
                    if mod is None:
                        _hold(numbers, v, src, dst, n, ctx)
                    else:
                        for k, value in mod.hold(v, src, dst, n, ctx).items():
                            numbers[k] += value
                except (ValueError, RuntimeError, IndexError):
                    numbers["answers_lost"] += 1  # an answer of the wrong form
        del src, dst
    return numbers


def _hold(numbers: dict, check: dict, src, dst, n: int, ctx: dict) -> None:
    kind, got = check["kind"], check["answer"]
    if kind == "bfs_view":
        numbers["bfs_wrong"] += _wrong(got, graph.bfs(src, dst, n, check["root"]))
    elif kind == "wcc_view":
        numbers["wcc_wrong"] += _wrong(got, graph.wcc(src, dst, n))
    elif kind == "sssp_view":
        w = gen.edge_weight(src, dst, ctx["seed"])
        numbers["sssp_wrong"] += _wrong(got, graph.sssp(src, dst, w, n, check["root"]))
    elif kind == "pagerank_view":
        want = graph.pagerank(src, dst, n, ctx["pagerank_iters"])
        numbers["pagerank_err"] = _worst(numbers["pagerank_err"], _scaled_err(got, want, want))
    elif kind == "spmm_view":
        want, mag = graph.neighbor_sum(src, dst, ctx["H"], n, rows=ctx["spmm_rows"])
        numbers["spmm_err"] = _worst(numbers["spmm_err"], _scaled_err(got, want, mag))
    elif kind == "leaf_scan_reduce_view":
        want, mag = graph.neighbor_sum(src, dst, ctx["x"], n)
        per_vertex = torch.zeros(n, dtype=torch.float64, device=got.device)
        per_vertex.index_add_(0, check["tile_src"].long(), got.to(torch.float64))
        numbers["scan_err"] = _worst(numbers["scan_err"], _scaled_err(per_vertex, want, mag))
    else:
        raise KeyError(kind)


def verdict(numbers: Dict[str, float], limit: Optional[Dict[str, float]] = None) -> bool:
    """True when every number is at or below its limit (a number that is
    not a number, as from a NaN answer, fails)."""
    limit = limit if limit is not None else limits()
    return all(float(numbers[k]) <= limit[k] for k in numbers)
