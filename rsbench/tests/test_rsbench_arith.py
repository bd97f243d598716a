"""The harness's own arithmetic, worked by hand, and the lookup of a
cell's files by name."""

import json
import math
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from rsbench import gen, spec, traceread, yardstick  # noqa: E402

SENT = 2**31 - 1


def test_live_sectors_by_hand():
    # 0 ids: no sector; 1-8 ids: one 32-byte sector; 9: two; 17: three
    assert yardstick.live_sector_bytes([0, 1, 8, 9, 17]) == (0 + 1 + 1 + 2 + 3) * 32
    assert yardstick.live_sector_bytes(torch.tensor([0, 1, 8, 9, 17])) == 7 * 32


def test_kernel_bounds_on_tiny_tiles_by_hand():
    rows = torch.tensor([[3, 5, 9, SENT], [5, SENT, SENT, SENT], [1, 2, 3, 4]], dtype=torch.int32)
    length = torch.tensor([3, 1, 4], dtype=torch.int32)
    from rsbench.harness import tile_stats

    class Blocks:  # a single-width view's blocks
        src = torch.tensor([0, 1, 2], dtype=torch.int32)

    Blocks.rows, Blocks.length = rows, length
    (g,) = tile_stats(Blocks)
    # three rows of 16 bytes, each live prefix within one sector; ids 1,2,3,4,5,9
    assert g == {"n_tiles": 3, "width": 4, "live": 8, "sector_bytes": 96, "distinct": 6}
    scan = 96 + 6 * 4 + 3 * 4 + 3 * 4
    assert yardstick.scan_bytes(3, 96, 6) == scan
    d = 8
    spmm = 96 + 6 * d * 4 + 3 * 4 + 3 * d * 4
    assert yardstick.spmm_bytes(3, 96, 6, d) == spmm
    assert yardstick.kernel_bound_s("leaf_spmm", g, d) == spmm / 3.35e12
    # two launches of 1 us each: the share is the bound of both over 2 us
    pct = yardstick.roofline_pct("leaf_scan_reduce", [g], 0, [1e-6, 1e-6])
    assert pct == pytest.approx(100 * 2 * (scan / 3.35e12) / 2e-6)
    # a tiered call launches once a group: an odd count is no whole call
    assert yardstick.roofline_pct("leaf_spmm", [g, g], d, [1e-6] * 3) is None
    assert yardstick.roofline_pct("leaf_spmm", [g], d, []) is None


def test_p95_counts_failures_as_missing_every_limit():
    ok = [0.010] * 95
    assert yardstick.percentile(ok + [0.5] * 5, 95) == 0.010
    assert yardstick.percentile(ok + [math.inf] * 6, 95) == math.inf
    assert yardstick.percentile(list(range(1, 21)), 95) == 19


def test_rate_is_all_work_over_all_the_window():
    assert yardstick.rate(300, 30.0) == 10.0


def test_visibility_with_a_commit_no_query_saw():
    t_end = 10.0
    txns = [{"due": 1.0, "ts": 5}, {"due": 2.0, "ts": 6}, {"due": 3.0, "ts": 0}]
    reads = [{"t_done": 1.4, "ts": 4}, {"t_done": 1.7, "ts": 5}, {"t_done": 2.5, "ts": 5},
             {"t_done": 11.0, "ts": 6}]  # ts 6 is first seen after the window
    # 0.7 s; 8.0 s (to the window's end); a write that failed: 7.0 s
    assert yardstick.visibility(txns, reads, t_end) == pytest.approx((0.7 + 8.0 + 7.0) / 3)
    assert yardstick.visibility([], reads, t_end) is None


def test_rmat_edge_count_and_determinism():
    cfg = {"scale": 8, "generator": {"a": 0.57, "b": 0.19, "c": 0.19, "edge_factor": 16,
                                     "directed": True}}
    e1, k1 = gen.base_graph(cfg, 2**31 + 11, torch.device("cpu"))
    e2, k2 = gen.base_graph(cfg, 2**31 + 11, torch.device("cpu"))
    e3, _ = gen.base_graph(cfg, 2**31 + 12, torch.device("cpu"))
    assert e1.shape == (16 << 8, 2) and torch.equal(e1, e2) and not torch.equal(e1, e3)
    assert bool((e1[:, 0] != e1[:, 1]).all()) and int(e1.max()) < 256
    assert torch.equal(k1, torch.unique(gen.edge_keys(e1[:, 0], e1[:, 1])))


def test_an_undirected_graph_holds_each_edge_both_ways():
    cfg = {"scale": 8, "generator": {"a": 0.57, "b": 0.19, "c": 0.19, "edge_factor": 16,
                                     "directed": False}}
    e, keys = gen.base_graph(cfg, 2**31 + 11, torch.device("cpu"))
    assert e.shape == (2 * (16 << 8), 2)
    flipped = torch.sort(gen.edge_keys(keys & gen.MASK32, keys >> 32)).values
    assert torch.equal(keys, flipped)
    drawn, _ = gen.base_graph(dict(cfg, generator=dict(cfg["generator"], directed=True)),
                              2**31 + 11, torch.device("cpu"))
    assert torch.equal(e[:16 << 8], drawn)


def test_sssp_weights_are_seeded_exact_and_agree_across_libraries():
    g = torch.Generator().manual_seed(0)
    src = torch.randint(0, 1 << 22, (4096,), generator=g)
    dst = torch.randint(0, 1 << 22, (4096,), generator=g)
    w = gen.edge_weight(src, dst, 5)
    assert w.dtype == torch.float32 and torch.equal(w, gen.edge_weight(src, dst, 5))
    assert not torch.equal(w, gen.edge_weight(src, dst, 6))
    assert float(w.min()) >= 0.5 and float(w.max()) < 1.5
    k = (w.double() - 0.5) * 2**23
    assert torch.equal(k, k.round())  # 0.5 + k 2^-23 exactly
    np.testing.assert_array_equal(gen.edge_weight(src.numpy(), dst.numpy(), 5), w.numpy())
    keys = gen.edge_keys(src, dst)
    assert gen.fingerprint_keys(keys) == gen.fingerprint_keys(keys.numpy())
    assert gen.fingerprint_keys(keys) == gen.fingerprint_keys(keys.flip(0))
    assert gen.fingerprint_keys(keys) != gen.fingerprint_keys(keys[1:])


def test_transactions_delete_live_edges_and_never_their_own_inserts():
    cfg = {"scale": 9, "generator": {"a": 0.57, "b": 0.19, "c": 0.19, "edge_factor": 16,
                                     "directed": True}}
    _e, keys = gen.base_graph(cfg, 3, torch.device("cpu"))
    txns = gen.transactions(cfg, {"inserts": 32, "deletes": 8}, keys, 5, 3)
    base = set(keys.tolist())
    dels = [tuple(d) for _ins, dd in txns for d in dd.tolist()]
    assert len(dels) == len(set(dels)) == 40
    assert all(((u << 32) | v) in base for u, v in dels)
    for ins, dd in txns:
        assert len(ins) == 32 and len({tuple(e) for e in ins.tolist()}) == 32
        assert not {tuple(e) for e in ins.tolist()} & {tuple(e) for e in dd.tolist()}


def test_undirected_transactions_write_each_edge_both_ways():
    cfg = {"scale": 9, "generator": {"a": 0.57, "b": 0.19, "c": 0.19, "edge_factor": 16,
                                     "directed": False}}
    _e, keys = gen.base_graph(cfg, 3, torch.device("cpu"))
    txns = gen.transactions(cfg, {"inserts": 32, "deletes": 8}, keys, 5, 3)
    base = set(keys.tolist())
    dels = [tuple(d) for _ins, dd in txns for d in dd.tolist()]
    assert len(dels) == len(set(dels)) == 80
    assert all(((u << 32) | v) in base for u, v in dels)
    for ins, dd in txns:
        for arr in (ins, dd):
            pairs = {tuple(e) for e in arr.tolist()}
            assert pairs == {(v, u) for u, v in pairs}
        assert len(ins) == 64 and len({tuple(e) for e in ins.tolist()}) == 64
        assert not {tuple(e) for e in ins.tolist()} & {tuple(e) for e in dd.tolist()}


def test_client_plans_run_every_kind_in_equal_shares():
    keys = torch.tensor([(1 << 32) | 2, (3 << 32) | 1], dtype=torch.int64)
    traffic = {"clients": 2, "kinds": {"a": 1, "b": 1, "c": 2}}
    plans = gen.client_plans(traffic, keys, 9, 40)
    for plan in plans:
        for i in range(0, 40, 4):
            assert sorted(k for k, _ in plan[i:i + 4]) == ["a", "b", "c", "c"]
        assert {r for _, r in plan} <= {1, 3}
    pos = gen.check_positions(plans[0], 8, np.random.default_rng(0))
    first = {k: min(i for i, (kk, _) in enumerate(plans[0]) if kk == k) for k in "abc"}
    assert set(first.values()) <= set(pos) and len(pos) <= 40
    assert {plans[0][p][0] for p in pos} == {"a", "b", "c"}


def test_checked_positions_span_the_whole_plan():
    plan = [("abcd"[i % 4], 0) for i in range(4000)]
    pos = gen.check_positions(plan, 8, np.random.default_rng(5))
    assert pos == gen.check_positions(plan, 8, np.random.default_rng(5))
    assert {0, 1, 2, 3} <= set(pos) and 400 < len(pos) < 600
    for q in range(4):  # every quarter of the plan holds its share of the sample
        assert 100 < sum(1 for p in pos if q * 1000 <= p < (q + 1) * 1000) < 150


def test_idle_gaps_and_busy_time():
    ev = [("k1", 10, 20), ("k2", 15, 30), ("k3", 50, 60)]
    assert traceread.busy_ns(ev, 0, 100) == 30
    host = [("bfs_view", 30, 55), ("commit", 0, 5)]
    gaps = traceread.idle_gaps(ev, 0, 100, host, k=2)
    assert gaps == [["host: nothing open @0.000s", 40e-9], ["host: bfs_view @0.000s", 20e-9]]
    assert traceread.top_ops(ev, 1) == [["k2", 15e-9]]


def test_every_benchmark_entry_resolves_to_its_files():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench=bench)
        assert cell.config["name"] == w["config"] and cell.traffic["name"] == w["traffic"]
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and spec.config_path(c["name"]) == ROOT / c["file"]
    for m in bench["per_layer"]:
        reader = spec.metric_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])


def test_new_files_are_found_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "rsbench", tmp_path / "rsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "rsbench/configs/g500-s22.json").read_text())
    cfg.update(name="g500-s20", scale=20)
    (tmp_path / "rsbench/configs/g500-s20.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "rsbench/traffic/analytics-ro.json").read_text())
    mix.update(name="bfs-only", kinds={"bfs_view": 1})
    (tmp_path / "rsbench/traffic/bfs-only.json").write_text(json.dumps(mix))
    (tmp_path / "rsbench/metrics/reads.count.py").write_text(
        'UNIT = "1"\nLAYER = "device"\nMOVES = "reads_per_s"\n\n\n'
        'def read(trace):\n    return float(len(trace.device_events))\n')
    bench["configs"].append({"name": "g500-s20", "file": "rsbench/configs/g500-s20.json"})
    bench["workloads"].append({"name": "g500-s20.bfs-only", "config": "g500-s20",
                               "traffic": "bfs-only", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "reads.count", "unit": "1", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "reads_per_s", "workloads": ["g500-s20.bfs-only"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("g500-s20.bfs-only", root=tmp_path)
    assert cell.config["scale"] == 20 and list(cell.traffic["kinds"]) == ["bfs_view"]
    assert [m["name"] for m in cell.per_layer][-1] == "reads.count"
    readers = spec.readers(cell.per_layer, root=tmp_path)
    tr = traceread.Trace(window_s=1.0, busy_s=0.5, device_events=[("k", 0, 1)] * 3, spans=[],
                         counters={})
    assert readers["reads.count"].read(tr) == 3.0
    assert "device.idle_pct" not in readers  # its entry lists the cells it reads in
    assert spec.metric_reader("device.idle_pct", root=tmp_path).read(tr) == 50.0
    with pytest.raises(KeyError):
        spec.cell("g500-s20.nothing", root=tmp_path)
