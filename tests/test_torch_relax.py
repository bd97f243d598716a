"""The edge relax of BFS, SSSP and WCC (``repro_torch.kernels.relax``).

CPU: the plain version, ``edge_relax_ref``, equals the per-shard
expression the loops of ``core.distributed`` ran before the kernel
(:func:`old_relax`, a copy of it), bit for bit, in each mode: on edges
without pads, on edges with SENTINEL pads and a ``valid`` mask, and
through ``make_bfs`` / ``make_sssp`` / ``make_wcc`` over four padded
shards, where the loops' results and iterations equal those of the loops
with the old expression patched in.  The CPU route launches nothing.
``kernel_lib`` builds the one source it is asked for (a stand-in
``nvcc`` through ``NVCC`` and a stand-in loader), and ``build_all`` the
rest.

Card (``cuda`` marker, skipped where torch sees no CUDA device): the
kernel route against the plain version, bit for bit, on an R-MAT graph of
scale 16 (grouped by source, and shuffled), on a star whose hub has 10^5
neighbours, and on four padded shards on one card; each mode alone on
random vertex vectors, including operands at an odd offset (the scalar
route); and ``edge_relax.launches`` equal to the loops' iterations.  This
file imports no JAX.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.core.analytics as A
from repro_torch.core import distributed
from repro_torch.core.distributed import make_bfs, make_sssp, make_wcc, shard_edges
from repro_torch.graph.generators import rmat_edges
from repro_torch.kernels import runtime
from repro_torch.kernels.relax import edge_relax
from repro_torch.kernels.relax.ref import edge_relax_ref

SENT = 2**31 - 1
MODES = ("flag", "min_plus", "min_both")
CASES = ("no_pads", "sentinel_pads", "four_shards")


def old_relax(mode, x, src, dst, valid=None, w=None):
    """The per-shard expression of ``core.distributed``'s loops before the
    relax kernel, as they ran it (keys and indices made once a query
    there, once a call here)."""
    n = x.shape[0]

    def key(ids):
        return ids.long() if valid is None else torch.where(valid, ids.long(), n)

    def gather(ids):
        return ids.long() if valid is None else torch.where(valid, ids.long(), 0)

    def live(v, fill):
        return v if valid is None else torch.where(valid, v, fill)

    def reduce(vals, k, op, identity):
        out = torch.full((n + 1,), identity, dtype=vals.dtype, device=vals.device)
        return out.scatter_reduce_(0, k, vals, op, include_self=False)[:n]

    if mode == "flag":
        return reduce(live(x[gather(src)], False).to(torch.int32), key(dst), "amax", -(2**31))
    if mode == "min_plus":
        inf = float("inf")
        return reduce(live(x[gather(src)] + w, inf), key(dst), "amin", inf)
    fwd = reduce(live(x[gather(src)], SENT), key(dst), "amin", SENT)
    bwd = reduce(live(x[gather(dst)], SENT), key(src), "amin", SENT)
    return torch.minimum(fwd, bwd)


def bits(t: torch.Tensor) -> np.ndarray:
    a = t.cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.float32 else a


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and np.array_equal(bits(a), bits(b))


def graph(n=300, m=2400, seed=0):
    """Random directed edges grouped by source, int32, and f32 weights."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, (m, 2))
    e = e[e[:, 0] != e[:, 1]]
    e = e[np.lexsort((e[:, 1], e[:, 0]))]
    w = (rng.random(len(e)) + 0.1).astype(np.float32)
    return (torch.from_numpy(e[:, 0].astype(np.int32)),
            torch.from_numpy(e[:, 1].astype(np.int32)), torch.from_numpy(w), n)


def vertex_vector(mode, n, seed=1):
    """A vector of each mode's kind: a frontier, distances with some
    unreached (inf), labels."""
    rng = np.random.default_rng(seed)
    if mode == "flag":
        return torch.from_numpy(rng.random(n) < 0.2)
    if mode == "min_plus":
        d = (rng.random(n) * 4).astype(np.float32)
        d[rng.random(n) < 0.3] = np.inf
        return torch.from_numpy(d)
    return torch.from_numpy(rng.permutation(n).astype(np.int32))


def with_sentinel_pads(src, dst, w, n_pad=7, seed=2):
    """The edges with ``n_pad`` SENTINEL slots spread among them and the
    ``valid`` mask that marks the live ones."""
    rng = np.random.default_rng(seed)
    m = src.shape[0]
    live = np.ones(m + n_pad, bool)
    live[rng.choice(m + n_pad, n_pad, replace=False)] = False
    valid = torch.from_numpy(live)
    out = []
    for a, pad in ((src, SENT), (dst, SENT), (w, np.float32(0.0))):
        full = torch.full((m + n_pad,), pad, dtype=a.dtype)
        full[valid] = a
        out.append(full)
    return (*out, valid)


def sharded(src, dst, w, n_shards=4):
    """``shard_edges``' padded shards (self-loops on vertex 0, the last
    shard's pads marked in ``valid``) as lists of tensors, and each
    shard's weights."""
    s, d, v = shard_edges(src.numpy(), dst.numpy(), n_shards)
    wp = np.concatenate([w.numpy(), np.zeros(s.size - len(w), np.float32)])
    t = lambda a: [torch.from_numpy(np.ascontiguousarray(r)) for r in a]  # noqa: E731
    return t(s), t(d), t(v), t(wp.reshape(s.shape))


def run_loop(mode, srcs, dsts, valids, ws, n, root=0):
    """One of the three loops over shards: (result, iterations)."""
    if mode == "flag":
        fn = make_bfs(n)
        out = fn(srcs, dsts, valids, root)
    elif mode == "min_plus":
        fn = make_sssp(n)
        out = fn(srcs, dsts, valids, ws, root)
    else:
        fn = make_wcc(n)
        out = fn(srcs, dsts, valids)
    return out, fn.iterations


# ---------------------------------------------------------------------------
# CPU: the plain version is the expression it replaced
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_plain_version_equals_the_replaced_expression(mode, case, monkeypatch):
    src, dst, w, n = graph()
    x = vertex_vector(mode, n)
    if case == "no_pads":
        assert same(edge_relax_ref(mode, x, src, dst, None, w),
                    old_relax(mode, x, src, dst, None, w))
        assert same(edge_relax(mode, x, src, dst, None, w),
                    old_relax(mode, x, src, dst, None, w))
    elif case == "sentinel_pads":
        ps, pd, pw, valid = with_sentinel_pads(src, dst, w)
        got = edge_relax(mode, x, ps, pd, valid, pw)
        assert same(got, old_relax(mode, x, ps, pd, valid, pw))
        assert same(got, old_relax(mode, x, src, dst, None, w))  # the pads add nothing
    else:
        srcs, dsts, valids, ws = sharded(src, dst, w)
        assert (~valids[-1]).sum() > 0
        got, it = run_loop(mode, srcs, dsts, valids, ws, n)
        single, it1 = run_loop(mode, [src], [dst], [None], [w], n)
        monkeypatch.setattr(distributed, "edge_relax", old_relax)
        want, it0 = run_loop(mode, srcs, dsts, valids, ws, n)
        assert same(got, want) and same(got, single)
        assert it == it0 == it1 > 1


def test_unknown_mode_and_device_raise():
    src, dst, w, n = graph(n=20, m=60)
    with pytest.raises(ValueError, match="mode"):
        edge_relax("amax", torch.zeros(n, dtype=torch.bool), src, dst)
    with pytest.raises(ValueError, match="mode"):
        edge_relax_ref("amax", torch.zeros(n, dtype=torch.bool), src, dst)
    meta = src.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        edge_relax("flag", torch.zeros(n, dtype=torch.bool, device="meta"), meta, meta)


def test_cpu_route_launches_nothing():
    src, dst, w, n = graph(n=60, m=400)
    before = edge_relax.launches
    A.bfs_coo(src, dst, n, 0)
    A.sssp_coo(src, dst, w, n, 0)
    A.wcc_coo(src, dst, n)
    assert edge_relax.launches == before


# ---------------------------------------------------------------------------
# CPU: the build compiles the one source a kernel asks for
# ---------------------------------------------------------------------------
def test_kernel_lib_builds_one_source_and_build_all_the_rest(tmp_path, monkeypatch):
    """``kernel_lib("edge_relax")`` on a fresh checkout runs ``nvcc`` on
    ``csrc/edge_relax.cu`` alone; ``build_all`` then compiles every other
    source once and loads all; a process that finds the library on disk
    loads it without ``nvcc``."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        f"open({str(log)!r}, 'a').write(args[-1].rsplit('/', 1)[-1] + '\\n')\n"
        "open(args[args.index('-o') + 1], 'w').write('stand-in library')\n"
    )
    nvcc.chmod(0o755)
    monkeypatch.setenv("NVCC", str(nvcc))
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(runtime, "_LIBS", {})
    monkeypatch.setattr(runtime.ctypes, "CDLL", lambda path: SimpleNamespace(path=Path(path)))

    def compiled():
        return log.read_text().split() if log.exists() else []

    lib = runtime.kernel_lib("edge_relax")
    assert compiled() == ["edge_relax.cu"]
    assert lib.path.name.startswith("libedge_relax_") and lib.path.exists()
    assert runtime.kernel_lib("edge_relax") is lib
    assert compiled() == ["edge_relax.cu"]

    sources = sorted(p.name for p in runtime.CSRC.glob("*.cu"))
    libs = runtime.build_all()
    assert sorted(compiled()) == sources
    assert set(libs) == {s[:-3] for s in sources} and libs["edge_relax"] is lib
    runtime.build_all()
    assert len(compiled()) == len(sources)

    monkeypatch.setattr(runtime, "_LIBS", {})  # a new process, the libraries on disk
    assert runtime.kernel_lib("leaf_spmm").path == libs["leaf_spmm"].path
    assert len(compiled()) == len(sources)
    with pytest.raises(RuntimeError, match="no kernel source"):
        runtime.kernel_lib("no_such_kernel")


# ---------------------------------------------------------------------------
# Card: the kernel route against the plain version
# ---------------------------------------------------------------------------
def rmat_coo(scale, seed, shuffle=False):
    """An undirected R-MAT graph (both directions, each pair once) grouped
    by source as the store's COO is, or shuffled."""
    e = rmat_edges(scale, 8 << scale, seed)
    e = np.unique(np.concatenate([e, e[:, ::-1]]), axis=0)
    if shuffle:
        e = e[np.random.default_rng(seed).permutation(len(e))]
    return e[:, 0].astype(np.int32), e[:, 1].astype(np.int32), 1 << scale


def star_coo(degree=100_000, hub=50_000):
    """A hub joined to every other vertex both ways, and a path through
    the leaves: the hub takes every edge's atomic in the first
    iterations."""
    n = degree + 1
    leaves = np.delete(np.arange(n), hub)
    path = np.stack([leaves[:-1], leaves[1:]], 1)
    e = np.concatenate([np.stack([np.full(degree, hub), leaves], 1), path])
    e = np.unique(np.concatenate([e, e[:, ::-1]]), axis=0)
    return e[:, 0].astype(np.int32), e[:, 1].astype(np.int32), n


def weights(m, seed=3):
    return (np.random.default_rng(seed).random(m) + 0.05).astype(np.float32)


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a tensor 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.shape[0] + 1, dtype=t.dtype, device=t.device)
    out = buf[1:]
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
class TestEdgeRelaxOnCard:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("layout", ["aligned", "misaligned", "sentinel_pads"])
    def test_each_mode_matches_plain_version(self, mode, layout):
        s, d, n = rmat_coo(12, seed=5)
        src, dst, w = torch.from_numpy(s), torch.from_numpy(d), torch.from_numpy(weights(len(s)))
        valid = None
        if layout == "sentinel_pads":
            src, dst, w, valid = with_sentinel_pads(src, dst, w, n_pad=1001)
        x = vertex_vector(mode, n, seed=9)
        want = edge_relax_ref(mode, x, src, dst, valid, w)
        cuda = [None if t is None else t.cuda() for t in (x, src, dst, valid, w)]
        if layout == "misaligned":
            cuda = [cuda[0]] + [None if t is None else misaligned(t) for t in cuda[1:]]
        got = edge_relax(mode, *cuda)
        torch.cuda.synchronize()
        if mode == "flag":
            assert torch.equal(got.cpu() > 0, want > 0)
        else:
            assert same(got, torch.minimum(x, want))

    @pytest.mark.parametrize("graph_case", ["rmat16", "rmat16_shuffled", "star"])
    def test_loops_match_plain_version(self, graph_case):
        if graph_case == "star":
            s, d, n = star_coo()
        else:
            s, d, n = rmat_coo(16, seed=7, shuffle=graph_case.endswith("shuffled"))
        w = weights(len(s))
        root = int(s[0])
        cpu = [torch.from_numpy(a) for a in (s, d, w)]
        card = [t.cuda() for t in cpu]
        for mode in MODES:
            want, it_want = run_loop(mode, [cpu[0]], [cpu[1]], [None], [cpu[2]], n, root)
            n0 = edge_relax.launches
            got, it = run_loop(mode, [card[0]], [card[1]], [None], [card[2]], n, root)
            torch.cuda.synchronize()
            assert same(got, want), mode
            assert it == it_want and edge_relax.launches - n0 == it, mode

    @pytest.mark.parametrize("pads", ["self_loops", "sentinel"])
    def test_four_padded_shards_on_one_card(self, pads):
        s, d, n = rmat_coo(14, seed=11)
        w = weights(len(s))
        src, dst, wt = (torch.from_numpy(a) for a in (s, d, w))
        srcs, dsts, valids, ws = sharded(src, dst, wt)
        if pads == "sentinel":
            for a, v in zip(srcs + dsts, valids + valids):
                a[~v] = SENT
        root = int(s[0])
        card = [[t.cuda() for t in group] for group in (srcs, dsts, valids, ws)]
        for mode in MODES:
            want, it_want = run_loop(mode, [src], [dst], [None], [wt], n, root)
            n0 = edge_relax.launches
            got, it = run_loop(mode, *card, n, root)
            torch.cuda.synchronize()
            assert same(got, want), mode
            assert it == it_want and edge_relax.launches - n0 == 4 * it, mode
