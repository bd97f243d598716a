"""Whole runs of the harness on the CPU at a tiny scale, past its look for
a card: a sound run is correct, and the control and each fault that a
cell can have are refused.

The control is the plain reference in bfloat16 put in the program's
place.  The faults are planted in the program underneath the timed path:
a commit that leaves the store unchanged, a splice that hands back the
predecessor's state unchanged, half of a batch of tiles or edges left out
with the rest scaled up to stand for it, and an answer altered where it
is produced.  (The cells run on one chip: there is no exchange between
chips to leave out.)
"""

import copy
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from rsbench import harness, spec  # noqa: E402
from rsbench.reference import judge  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 2026
# the writer's mix on both layouts, and the read-only mixes that no cell of
# BENCHMARK.json runs yet: these pairs are made here from their files
WRITER_CELLS = [("g500-s22", "analytics-w"), ("g500-s22-tiered", "analytics-w")]
OTHER_CELLS = [("g500-s22", "analytics-ro"), ("g500-s22-tiered", "tiles-ro")]
BENCH_CELLS = [(w["config"], w["traffic"]) for w in spec.load_benchmark()["workloads"]]


def tiny(config: str, traffic: str) -> spec.Cell:
    cell = spec.Cell(name=f"{config}.{traffic}", chips=1,
                     config=copy.deepcopy(spec.load_json(spec.config_path(config))),
                     traffic=copy.deepcopy(spec.load_json(spec.traffic_path(traffic))),
                     end_to_end=[], per_layer=[])
    cell.config["scale"] = 9
    cell.traffic["check"]["spmm_rows"] = 32
    # the search kind's batches, cut to what a 1 s window on the CPU holds
    if "edge_search_view" in cell.traffic:
        cell.traffic["edge_search_view"]["sets"] = {"general": 128, "low": 128, "high": 128}
    if cell.traffic.get("writer"):
        cell.traffic["writer"]["rate_per_s"] = 4.0
    return cell


def run(config: str, traffic: str, seconds: float = 1.0) -> dict:
    return harness.run(tiny(config, traffic), SEED, seconds, False, CPU, time.perf_counter())


@pytest.mark.parametrize("config,traffic", BENCH_CELLS + OTHER_CELLS + WRITER_CELLS)
def test_a_sound_run_is_correct(config, traffic):
    res = run(config, traffic)
    assert res["correct"], res["numbers"]
    assert res["failed"] == 0 and res["attempted"] > 0
    e2e = res["e2e"]
    want = {"read_p95_ms", "reads_per_s", "setup_s"}
    if (config, traffic) in WRITER_CELLS:
        want.add("visibility_ms")
    assert set(e2e) == want
    assert all(v > 0 for v in e2e.values())
    assert res["setup"]["checks"] >= len(tiny(config, traffic).traffic["kinds"])


@pytest.mark.parametrize("config,traffic", WRITER_CELLS)
def test_every_read_that_assembled_its_view_is_checked(config, traffic):
    res = run(config, traffic)
    w = res["window"]
    checked = {(c["client"], c["i"]) for c in w.checks}
    assembled = [(r["client"], r["i"]) for r in w.reads if r["assembled"]]
    assert assembled and set(assembled) <= checked


@pytest.mark.parametrize("config,traffic", WRITER_CELLS)
def test_the_control_is_refused(config, traffic):
    cell = tiny(config, traffic)
    state = harness.setup(cell, SEED, CPU, False, seconds=1.0, control=True)
    w = harness.window(state, 1.0, False, control=True)
    numbers = harness.check(state, w, None)
    assert not judge.verdict(numbers), numbers
    lim = judge.limits()
    assert numbers["pagerank_err"] > lim["pagerank_err"]
    assert numbers["spmm_err"] > lim["spmm_err"]
    assert numbers["scan_err"] > lim["scan_err"]


def _half(fn):
    """``fn`` over every other tile, doubled: half the batch left out and
    the rest standing in for it."""
    def half(rows, x, length=None):
        y = fn(rows, x, length)
        y[1::2] = 0
        y[::2] *= 2
        return y
    return half


def _half_edges(fn):
    def half(src, dst, n, *args, **kw):
        return fn(src[::2], dst[::2], n, *args, **kw)
    return half


def _altered(fn, change):
    def altered(*args, **kw):
        out = fn(*args, **kw).clone()
        i = int(out.numel() // 2)
        out[i] = change(out[i])
        return out
    return altered


def _stale_plan(fn):
    """Every view with a predecessor takes it whole, as if nothing had
    been committed between the two."""
    def plan(view):
        pred = view._pred() if view._pred is not None else None
        if pred is not None and pred.S == len(view.snaps):
            return pred, []
        return fn(view)
    return plan


def _faults():
    from repro_torch.core import analytics, txn, view_assembler
    from repro_torch.kernels.spmm import ops as spmm_ops

    return {
        "commit_leaves_the_store_unchanged": (txn, "prepare", lambda f: lambda *a, **k: {},
                                              "answers_lost"),
        "splice_hands_back_the_predecessor": (view_assembler, "_plan", _stale_plan,
                                              "views_wrong"),
        "half_the_spmm_tiles_left_out": (spmm_ops, "leaf_spmm", _half, "spmm_err"),
        "half_the_scan_tiles_left_out": (spmm_ops, "leaf_scan_reduce", _half, "scan_err"),
        "half_the_pagerank_edges_left_out": (analytics, "pagerank_coo", _half_edges,
                                             "pagerank_err"),
        "a_bfs_level_altered": (analytics, "bfs_view",
                                lambda f: _altered(f, lambda v: v + 1), "bfs_wrong"),
        "a_wcc_label_altered": (analytics, "wcc_view",
                                lambda f: _altered(f, lambda v: v + 1), "wcc_wrong"),
        "an_sssp_distance_altered": (analytics, "sssp_view",
                                     lambda f: _altered(f, lambda v: v * (1 + 2**-20)),
                                     "sssp_wrong"),
        "a_pagerank_value_altered": (analytics, "pagerank_view",
                                     lambda f: _altered(f, lambda v: v * 2),
                                     "pagerank_err"),
    }


FAULTS = ["commit_leaves_the_store_unchanged", "splice_hands_back_the_predecessor",
          "half_the_spmm_tiles_left_out", "half_the_scan_tiles_left_out",
          "half_the_pagerank_edges_left_out", "a_bfs_level_altered", "a_wcc_label_altered",
          "an_sssp_distance_altered", "a_pagerank_value_altered"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_the_timed_path_is_refused(fault, monkeypatch):
    module, attr, wrap, number = _faults()[fault]
    monkeypatch.setattr(module, attr, wrap(getattr(module, attr)))
    res = run(*WRITER_CELLS[0])
    assert not res["correct"], res["numbers"]
    assert res["numbers"][number] > res["limits"][number], res["numbers"]
