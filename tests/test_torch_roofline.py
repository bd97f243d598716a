"""The port's roofline (``repro_torch.roofline``) against the reference's.

- The report's three terms and ``mfu_bound`` at the H100's peaks, in the
  style of ``tests/test_roofline.py``, on both compute paths.
- The four model-FLOP formulas equal to the reference's on every config of
  both registries (full and smoke), at every shape cell of the config's
  family.
- The ring model equal to ``collective_stats``' on the five instructions
  of ``tests/test_roofline.py``'s HLO, with their shapes given to the
  port's function, and the collectives' counter on a CPU host mesh.
- ``cost.count_step``'s FLOPs and bytes of a two-matmul step equal to a
  count by hand, and the kernels it names.
"""

import math

import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.roofline import model as RM
from repro.roofline.hlo import collective_stats

from repro_torch.configs import registry
from repro_torch.kernels import runtime
from repro_torch.launch.collectives import P, all_gather, pmax, psum, psum_scatter, shard
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.roofline import comm, cost
from repro_torch.roofline import model as TM

HLO = """
HloModule jit_step
%x1 = f32[16,128]{1,0} all-reduce(f32[16,128]{1,0} %a), replica_groups=[16,16]<=[256], to_apply=%add
%x2 = bf16[4,256]{1,0} all-gather(bf16[4,16]{1,0} %b), replica_groups={{0,1,2,3}}, dimensions={1}
%x3 = f32[8,8]{1,0} reduce-scatter(f32[64,8]{1,0} %c), replica_groups=[32,8]<=[256], dimensions={0}
%x4 = f32[2,2]{1,0} collective-permute(f32[2,2]{1,0} %d), source_target_pairs={{0,1}}
%x5 = (f32[4,4]{0,1}, f32[4,4]{0,1}) all-to-all(f32[4,4]{0,1} %e, f32[4,4]{0,1} %f), replica_groups=[128,2]<=[256]
%done = f32[4]{0} all-reduce-done(f32[4]{0} %x9)
"""
# the same five as (op, operand bytes, result bytes, group size)
CALLS = [("all-reduce", 16 * 128 * 4, 16 * 128 * 4, 16),
         ("all-gather", 4 * 16 * 2, 4 * 256 * 2, 4),
         ("reduce-scatter", 64 * 8 * 4, 8 * 8 * 4, 8),
         ("collective-permute", 2 * 2 * 4, 2 * 2 * 4, 256),
         ("all-to-all", 2 * 4 * 4 * 4, 2 * 4 * 4 * 4, 2)]


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------
def test_h100_peaks():
    assert TM.HBM_BW == 3.35e12
    assert TM.CUDA_CORE_F32_FLOPS == 67e12
    assert TM.TENSOR_CORE_BF16_FLOPS == 989e12
    assert TM.NVLINK_BW == 450e9


@pytest.mark.parametrize("dtype,path,peak", [("bfloat16", "tensor_core", 989e12),
                                             ("float16", "tensor_core", 989e12),
                                             ("float32", "cuda_core", 67e12)])
def test_roofline_report_terms(dtype, path, peak):
    r = TM.RooflineReport(
        arch="x", shape="y", mesh="4", n_devices=4,
        hlo_flops_per_dev=peak,  # exactly 1 second of compute
        hlo_bytes_per_dev=3.35e12,  # exactly 1 second of HBM
        coll_bytes_per_dev=225e9,  # 0.5 s of one NVLink direction
        model_flops_total=peak * 4 * 0.5, dtype=dtype,
    )
    assert r.path == path and r.peak_flops == peak
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 1.0) < 1e-9
    assert abs(r.collective_s - 0.5) < 1e-9
    assert r.bound in ("compute", "memory")
    assert abs(r.step_time_s - 1.0) < 1e-9
    assert abs(r.mfu_bound - 0.5) < 1e-9
    assert abs(r.useful_flops_ratio - 0.5) < 1e-9
    d = r.to_dict()
    assert d["bound"] == r.bound and d["compute_path"] == path and d["peak_flops"] == peak
    for key in RM.RooflineReport(arch="x", shape="y", mesh="m", n_devices=1,
                                 hlo_flops_per_dev=1.0, hlo_bytes_per_dev=1.0,
                                 coll_bytes_per_dev=1.0).to_dict():
        assert key in d  # every key of the reference's report


def test_report_compute_path_and_link_rate_override():
    """An f32 step forced onto the tensor cores, and a slower link."""
    r = TM.RooflineReport(arch="x", shape="y", mesh="1", n_devices=1,
                          hlo_flops_per_dev=989e12, hlo_bytes_per_dev=0.0,
                          coll_bytes_per_dev=1e9, dtype="float32",
                          compute_path="tensor_core", link_bw=1e9)
    assert r.compute_s == 1.0 and r.collective_s == 1.0
    assert r.mfu_bound is None and r.useful_flops_ratio is None
    assert TM.RooflineReport(arch="x", shape="y", mesh="1", n_devices=1,
                             hlo_flops_per_dev=0.0, hlo_bytes_per_dev=1.0,
                             coll_bytes_per_dev=0.0, model_flops_total=1.0,
                             ).useful_flops_ratio is None


def test_bound_s():
    assert TM.bound_s(3.35e12, 0.0) == (1.0, "bytes")
    assert TM.bound_s(0.0, 67e12) == (1.0, "operations")
    assert TM.bound_s(3.35e12, 67e12) == (1.0, "bytes")


# ---------------------------------------------------------------------------
# Model FLOPs: equal to the reference's on every config
# ---------------------------------------------------------------------------
def flop_calls(fam, cell):
    """(port function, reference function, positional args, keyword args)
    for one shape cell of a config family."""
    p = cell.params
    if fam == "lm":
        b, s = p["global_batch"], p["seq_len"]
        if cell.kind == "decode":
            return [(TM.lm_decode_model_flops, RM.lm_decode_model_flops, (b, s), {})]
        return [(TM.lm_model_flops, RM.lm_model_flops, (b, s), {"train": cell.kind == "train"})]
    if fam == "gnn":
        args = (p["n_nodes"], p["n_edges"], p["d_feat"])
        return [(TM.gnn_model_flops, RM.gnn_model_flops, args, {"train": t})
                for t in (True, False)]
    return [(TM.bst_model_flops, RM.bst_model_flops, (p["batch"],), {"train": t})
            for t in (True, False)]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", RR.arch_ids())
def test_model_flops_match_reference(arch, smoke):
    assert registry.arch_ids() == RR.arch_ids()
    get, rget = ((registry.get_smoke_config, RR.get_smoke_config) if smoke
                 else (registry.get_config, RR.get_config))
    cfg, rcfg = get(arch), rget(arch)
    cells = RR.shapes_for(arch)
    assert [c.name for c in registry.shapes_for(arch)] == [c.name for c in cells]
    n = 0
    for cell in cells:
        for fn, rfn, args, kw in flop_calls(RR.FAMILY[arch], cell):
            got, want = fn(cfg, *args, **kw), rfn(rcfg, *args, **kw)
            assert got == want and math.isfinite(got) and got > 0, (cell.name, fn.__name__)
            n += 1
    assert n > 0


# ---------------------------------------------------------------------------
# Collective bytes: the ring model and the counter
# ---------------------------------------------------------------------------
def test_ring_model_matches_collective_stats():
    want = collective_stats(HLO, 256)
    for op, operand, result, s in CALLS:
        assert comm.ring_bytes(op, operand, result, s) == pytest.approx(
            want["bytes_by_op"][op], rel=1e-12), op
    with comm.CommCounter() as c:
        for call in CALLS:
            comm.record(*call)
    got = c.stats()
    assert got["counts"] == want["counts"]
    assert got["raw_operand_bytes"] == want["raw_operand_bytes"]
    assert got["per_device_bytes"] == pytest.approx(want["per_device_bytes"], rel=1e-12)
    for op, b in want["bytes_by_op"].items():
        assert got["bytes_by_op"][op] == pytest.approx(b, rel=1e-12)


def test_ring_model_edges():
    assert comm.ring_bytes("all-reduce", 100, 100, 1) == 0.0
    with pytest.raises(ValueError):
        comm.ring_bytes("broadcast", 1, 1, 2)
    with comm.CommCounter() as c:
        comm.record("all-reduce", 100, 100, 1)  # a group of one moves nothing
    assert c.stats()["counts"] == {}
    comm.record("all-reduce", 100, 100, 4)  # no counter active: nothing
    assert c.stats()["per_device_bytes"] == 0.0


def test_counter_on_host_mesh_collectives():
    """psum, pmax, psum_scatter and all_gather on a (data=2, model=2) CPU
    mesh: one record a call, per device, over the axis' group."""
    mesh = make_host_mesh((2, 2), ("data", "model"))
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    xs = shard(x, mesh, P(("data", "model"), None))  # [2, 6] f32 a shard: 48 B
    part = 2 * 6 * 4
    with comm.CommCounter() as c:
        psum(xs, mesh, "model")
        pmax(xs, mesh, ("data", "model"))
        psum_scatter(xs, mesh, "data", scatter_dimension=0, tiled=True)
        all_gather(xs, mesh, ("data", "model"), axis=0, tiled=True)
    st = c.stats()
    assert st["counts"] == {"all-reduce": 2, "reduce-scatter": 1, "all-gather": 1}
    want = {"all-reduce": 2 * (1 / 2) * part + 2 * (3 / 4) * part,
            "reduce-scatter": (1 / 2) * part,
            "all-gather": (3 / 4) * 4 * part}
    assert st["bytes_by_op"] == pytest.approx(want)
    assert st["per_device_bytes"] == pytest.approx(sum(want.values()))
    assert st["raw_operand_bytes"] == 4 * part
    with comm.CommCounter() as quiet:
        pass
    psum(xs, mesh, "model")  # outside any counter: not recorded
    assert quiet.stats()["counts"] == {} and c.stats() == st


# ---------------------------------------------------------------------------
# Step cost
# ---------------------------------------------------------------------------
def test_count_step_two_matmuls_by_hand():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, generator=g)
    w1 = torch.randn(8, 16, generator=g)
    w2 = torch.randn(16, 2, generator=g)

    def step():
        return (x @ w1) @ w2

    out, c = cost.count_step(step)
    assert torch.equal(out, (x @ w1) @ w2)
    assert c.flops == 2 * 4 * 8 * 16 + 2 * 4 * 16 * 2
    # each mm reads its operands and writes its result once, f32
    assert c.bytes == 4 * ((4 * 8 + 8 * 16 + 4 * 16) + (4 * 16 + 16 * 2 + 4 * 2))
    assert c.ops == 2 and c.kernel_launches == {}
    r = c.report("two-mm", "4x8", "float32", model_flops_total=c.flops)
    assert r.useful_flops_ratio == 1.0 and r.path == "cuda_core"
    assert r.compute_s == c.flops / TM.CUDA_CORE_F32_FLOPS
    assert r.memory_s == c.bytes / TM.HBM_BW


def test_count_step_views_move_nothing_and_out_counts_once():
    a = torch.ones(8, 4)
    buf = torch.empty(4, 8)

    def step():
        v = a.t()  # a view
        torch.add(v, 1.0, out=buf)
        return buf

    _, c = cost.count_step(step)
    assert c.flops == 0
    assert c.bytes == 4 * (32 + 32)  # add reads v once and writes buf once
    assert c.ops == 1


def test_count_step_names_the_kernels_that_launched():
    """Hand-written kernels launch below the dispatcher: the cost names
    them, without counting their work."""
    w = runtime.launch_counters()["leaf_spmm"]
    before = w.launches

    def step():
        runtime.count_launch(w, torch.device("cuda", 0))  # what a launch on the card records
        return torch.zeros(3) + 1

    try:
        _, c = cost.count_step(step)
    finally:
        w.launches = before
    assert c.kernel_launches == {"leaf_spmm": 1}
    assert set(runtime.launch_counters()) == {"leaf_search", "leaf_scan_reduce", "leaf_spmm",
                                              "intersect_count", "embedding_bag",
                                              "flash_decode", "edge_relax"}


def test_count_step_through_autograd():
    """Forward and backward of a linear layer whose input needs no
    gradient: two matmuls' FLOPs (the forward and w's gradient)."""
    x = torch.randn(5, 7)
    w = torch.randn(7, 3, requires_grad=True)

    def step():
        loss = (x @ w).sum()
        loss.backward()
        return w.grad

    _, c = cost.count_step(step)
    assert c.flops == 2 * (2 * 5 * 7 * 3)
    assert np.isfinite(c.bytes) and c.bytes > 0
