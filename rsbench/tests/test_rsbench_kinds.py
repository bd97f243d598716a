"""Query kinds defined by their own files (``rsbench/kinds/``): a new kind
runs through the harness with no other file edited, the search kind is
judged by its plain reference, the control and the faults a search cell
can have are refused, and the mix that was there before the kind files
came reads as it did.

The faults are planted in the program underneath the timed path: a search
answer flipped where it is produced, half of a batch's searches left
out, an answer of the wrong shape, and tiles of another timestamp.  (The cell has no writer
whose step could leave the store unchanged, and runs on one chip: there
is no exchange between chips to leave out.)
"""

import copy
import hashlib
import json
import random
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from rsbench import harness, spec, yardstick  # noqa: E402
from rsbench.reference import judge, search  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 2026


def tiny_search(scale: int = 9, writer: bool = False) -> spec.Cell:
    """``g500-s22.search-ro`` at a tiny scale and batch."""
    cell = spec.Cell(name="g500-s22.search-ro", chips=1,
                     config=copy.deepcopy(spec.load_json(spec.config_path("g500-s22"))),
                     traffic=copy.deepcopy(spec.load_json(spec.traffic_path("search-ro"))),
                     end_to_end=[], per_layer=[])
    cell.config["scale"] = scale
    cell.traffic["edge_search_view"]["sets"] = {"general": 128, "low": 128, "high": 128}
    if writer:
        cell.traffic["writer"] = dict(
            spec.load_json(spec.traffic_path("analytics-w"))["writer"], rate_per_s=4.0)
    return cell


def run(cell: spec.Cell, seconds: float = 1.0) -> dict:
    return harness.run(cell, SEED, seconds, False, CPU, time.perf_counter())


# ---------------------------------------------------------------------------
# A kind as a file
# ---------------------------------------------------------------------------
DEGREE_KIND = '''"""Out-degree of the plan's vertex, read from the view's COO."""
import torch

from rsbench.reference import search

USES = "coo"
NUMBERS = {"degree_wrong": 0}


def draw(ctx, arg):
    return int(arg)


def run(view, ctx, ops):
    src, _dst = view.to_coo_device()
    return (src == ops).sum()


control = run


def capture(view, answer, ctx, ops):
    return {"answer": answer.clone(), "vertex": ops}


def hold(check, src, dst, n, ctx):
    keys = search.sorted_keys(src, dst)
    v = torch.tensor([check["vertex"]])
    lo = torch.searchsorted(keys, v << 32)
    hi = torch.searchsorted(keys, (v + 1) << 32)
    return {"degree_wrong": abs(int(check["answer"]) - int(hi - lo))}
'''


def _root_with(tmp_path: Path, kind_files: dict) -> Path:
    shutil.copytree(ROOT / "rsbench", tmp_path / "rsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, text in kind_files.items():
        (tmp_path / "rsbench/kinds" / f"{name}.py").write_text(text)
    mix = json.loads((ROOT / "rsbench/traffic/coo-ro.json").read_text())
    mix.update(name="degree-ro", kinds={name: 1 for name in kind_files} | {"bfs_view": 1})
    (tmp_path / "rsbench/traffic/degree-ro.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "g500-s22.degree-ro", "config": "g500-s22",
                               "traffic": "degree-ro", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_a_kind_added_as_a_file_runs_with_no_other_edit(tmp_path):
    root = _root_with(tmp_path, {"degree_view": DEGREE_KIND})
    cell = spec.cell("g500-s22.degree-ro", root=root)
    cell.config["scale"] = 9
    res = run(cell)
    assert res["correct"], res["numbers"]
    assert res["numbers"]["degree_wrong"] == 0 and res["limits"]["degree_wrong"] == 0
    assert res["numbers"]["kinds_unchecked"] == 0
    assert {c["kind"] for c in res["window"].checks} == {"degree_view", "bfs_view"}
    # the kind file's number joins only the runs whose mix names it
    assert "degree_wrong" not in harness.run(tiny_search(), SEED, 0.5, False, CPU,
                                             time.perf_counter())["numbers"]


def test_a_kind_both_built_in_and_a_file_is_refused(tmp_path):
    root = _root_with(tmp_path, {"bfs_view": DEGREE_KIND})
    with pytest.raises(KeyError, match="both built in and a file"):
        harness.file_kinds(spec.cell("g500-s22.degree-ro", root=root))


def test_an_unknown_kind_is_refused(tmp_path):
    root = _root_with(tmp_path, {})
    cell = spec.cell("g500-s22.degree-ro", root=root)
    cell.traffic["kinds"]["no_such_view"] = 1
    with pytest.raises(KeyError, match="unknown query kinds"):
        harness.file_kinds(cell)


# ---------------------------------------------------------------------------
# The search cell
# ---------------------------------------------------------------------------
def test_a_tiny_search_run_is_correct():
    res = run(tiny_search())
    assert res["correct"], res["numbers"]
    assert res["numbers"]["search_wrong"] == 0
    assert res["failed"] == 0 and set(res["e2e"]) == {"read_p95_ms", "reads_per_s", "setup_s"}
    checks = res["window"].checks
    assert {c["kind"] for c in checks} == {"edge_search_view"}
    assert all("tiles_fp" in c for c in checks)
    for c in checks:
        assert c["answer"].dtype == torch.bool and c["answer"].numel() == 384
    # present and absent pairs alike among the answers checked
    assert 0 < sum(int(c["answer"].sum()) for c in checks) < 384 * len(checks)


def test_batches_are_drawn_from_the_seed_and_the_plan():
    cell = tiny_search()
    state = harness.setup(cell, SEED, CPU, False, seconds=0.5)
    es = harness.file_kinds(cell)["edge_search_view"]
    a, b, c = (es.draw(state.ctx, r) for r in (17, 17, 18))
    assert np.array_equal(a["us"], b["us"]) and np.array_equal(a["vs"], b["vs"])
    assert not np.array_equal(a["us"], c["us"])
    n = state.ctx["n"]
    assert a["us"].shape == a["vs"].shape == (384,)
    assert 0 <= a["us"].min() and a["us"].max() < n and 0 <= a["vs"].min() and a["vs"].max() < n
    # the sets in order: all vertices, the tenth of lowest degree, of highest
    deg = torch.bincount(state.base_keys >> 32, minlength=n).numpy()
    tail = n // 10
    low, high = a["us"][128:256], a["us"][256:]
    assert deg[low].max() <= np.sort(deg)[tail - 1]
    assert deg[high].min() >= np.sort(deg)[n - tail]
    assert len(np.unique(a["us"][:128])) > 100  # uniform over all 512


def test_the_control_is_refused():
    cell = tiny_search(scale=12)
    state = harness.setup(cell, SEED, CPU, False, seconds=1.0, control=True)
    w = harness.window(state, 1.0, False, control=True)
    numbers = harness.check(state, w, None)
    lim = judge.limits(harness.file_kinds(cell))
    assert not judge.verdict(numbers, lim), numbers
    assert numbers["search_wrong"] > lim["search_wrong"]


def _flip_one(fn):
    def flipped(*args, **kw):
        out = fn(*args, **kw).clone()
        out[out.numel() // 2] = ~out[out.numel() // 2]
        return out
    return flipped


def _half_the_pairs(fn):
    """The searches of every other (query, tile) pair left out."""
    def half(view, vs, qidx, flat, n_queries):
        return fn(view, vs, qidx[::2], flat[::2], n_queries)
    return half


def _short(fn):
    def short(*args, **kw):
        return fn(*args, **kw)[:-1]
    return short


def _stale_plan(fn):
    """Every view with a predecessor takes its tiles whole, as if nothing
    had been committed between the two."""
    def plan(view):
        pred = view._pred() if view._pred is not None else None
        if pred is not None and pred.S == len(view.snaps):
            return pred, []
        return fn(view)
    return plan


def _faults():
    from repro_torch.core import view_assembler
    from repro_torch.kernels.leaf_search import ops as search_ops

    return {
        "a_search_answer_flipped": (search_ops, "search_tiles", _flip_one, "search_wrong"),
        "half_the_searched_pairs_left_out": (search_ops, "search_tiles", _half_the_pairs,
                                             "search_wrong"),
        "a_search_answer_of_the_wrong_shape": (search_ops, "search_tiles", _short,
                                               "answers_lost"),
        "tiles_of_another_timestamp": (view_assembler, "_plan", _stale_plan, "views_wrong"),
    }


FAULTS = ["a_search_answer_flipped", "half_the_searched_pairs_left_out",
          "a_search_answer_of_the_wrong_shape", "tiles_of_another_timestamp"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_the_search_path_is_refused(fault, monkeypatch):
    module, attr, wrap, number = _faults()[fault]
    monkeypatch.setattr(module, attr, wrap(getattr(module, attr)))
    # stale tiles show only once a commit lands between two pins
    res = run(tiny_search(writer=fault == "tiles_of_another_timestamp"))
    assert not res["correct"], res["numbers"]
    assert res["numbers"][number] > res["limits"][number], res["numbers"]


# ---------------------------------------------------------------------------
# The reference and the byte counts
# ---------------------------------------------------------------------------
def test_the_reference_agrees_with_python_sets():
    rng = random.Random(5)
    n = 300
    edges = {(rng.randrange(n), rng.randrange(n)) for _ in range(4000)}
    edges = {(u, v) for u, v in edges if u != v}
    edges |= {(v, u) for u, v in edges}
    pairs = list(edges)[:500] + [(rng.randrange(n), rng.randrange(n)) for _ in range(500)]
    src = torch.tensor([u for u, _ in edges])
    dst = torch.tensor([v for _, v in edges])
    keys = search.sorted_keys(src, dst)
    us = torch.tensor([u for u, _ in pairs])
    vs = torch.tensor([v for _, v in pairs])
    assert search.contains(keys, us, vs).tolist() == [p in edges for p in pairs]
    # the control compares ids in bfloat16: above 256 they collide
    low = search.sorted_keys(src, dst, low=True)
    assert search.contains(low, us, vs, low=True).tolist() != [p in edges for p in pairs]


def test_search_bytes_by_hand():
    sent = 2**31 - 1
    rows = torch.tensor([[1, 3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27, 29, 31],
                         [2, 4, sent, sent, sent, sent, sent, sent, sent, sent, sent, sent,
                          sent, sent, sent, sent]], dtype=torch.int32)
    length = torch.tensor([16, 2], dtype=torch.int32)
    # 9 in tile 0: probes at 8, 4, 2, 3 (ids 17, 9, 5, 7): sectors 1, 0
    # 2 in tile 1: probes at 1, 0 (ids 4, 2): sector 2 (row 1 starts at id 16)
    # 9 in tile 0 again: the same sectors
    sectors, probes = yardstick.search_sector_ids(rows, torch.tensor([9, 2, 9]),
                                                  torch.tensor([0, 1, 0]), length)
    assert sectors.tolist() == [0, 1, 2] and probes == 4 + 2 + 4
    assert yardstick.search_bytes(3, 3, 2) == 3 * 32 + 3 * 13 + 2 * 4
    assert yardstick.launch_share_pct([1e-6, 3e-6], [4e-6, 4e-6]) == pytest.approx(50.0)
    assert yardstick.launch_share_pct([1e-6], [4e-6, 4e-6]) is None  # a launch unaccounted
    assert yardstick.launch_share_pct([], []) is None


def test_bounds_count_what_the_kinds_sent():
    cell = tiny_search()
    state = harness.setup(cell, SEED, CPU, False, seconds=0.5)
    kinds = harness.file_kinds(cell)
    h = state.store.begin_read()
    try:
        view = h.view
        blocks = view.to_leaf_blocks_device()
        ops = kinds["edge_search_view"].draw(state.ctx, 3)
        (b,) = kinds["edge_search_view"].bounds(view, state.ctx, ops)["leaf_search_kernel"]
        from repro_torch.core import view_assembler
        from repro_torch.kernels.leaf_search import ops as search_ops

        offsets, order = view_assembler.block_src_offsets(view)
        qidx, flat = search_ops.flatten_candidates(
            order, *search_ops.candidate_ranges(offsets, ops["us"]))
        sectors, probes = yardstick.search_sector_ids(
            blocks.rows, torch.from_numpy(ops["vs"][qidx]), torch.from_numpy(flat),
            blocks.length)
        want = yardstick.search_bytes(int(sectors.numel()), len(flat), len(np.unique(flat)))
        assert b == yardstick.bound_s(want, probes)
    finally:
        state.store.end_read(h)


# ---------------------------------------------------------------------------
# The mix that was there before kind files reads as it did
# ---------------------------------------------------------------------------
def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()[:16]


def test_coo_ro_plans_checks_and_keys_are_those_of_the_parent():
    """Digests recorded on the commit before kind files: the same plans,
    checked positions and sampled rows, and the same result keys."""
    cell = spec.cell("g500-s22.coo-ro")
    cell.config["scale"] = 9
    cell.traffic["check"]["spmm_rows"] = 32
    state = harness.setup(cell, SEED, CPU, False, seconds=1.0)
    assert _digest(state.plans) == "f5537323da2c446a"
    assert _digest(state.check_pos) == "8853aa66d5c87703"
    assert _digest(state.ctx["spmm_rows"].tolist()) == "93ea64dd10491d8b"
    res = run(cell)
    assert sorted(res) == ["attempted", "correct", "e2e", "failed", "limits", "numbers",
                           "peak", "setup", "window"]
    numbers = ["answers_lost", "bfs_wrong", "kinds_unchecked", "pagerank_err", "scan_err",
               "spmm_err", "sssp_wrong", "views_wrong", "wcc_wrong"]
    assert sorted(res["numbers"]) == numbers and sorted(res["limits"]) == numbers
    assert sorted(res["e2e"]) == ["read_p95_ms", "reads_per_s", "setup_s"]
    assert sorted(res["setup"]) == ["build_s", "check_s", "checks", "cold_views_s",
                                    "generate_s", "operands_s", "setup_s"]
