"""The port's kernel wrappers against the JAX reference kernels.

The same numpy-seeded inputs go through ``repro``'s function — its Pallas
kernel in interpret mode on the CPU, as ``tests/test_kernels.py`` runs it
— and the port's function on CPU tensors, which takes the plain PyTorch
version.  Graph kernels (B in {16, 128, 512}, a ragged Q, some
all-SENTINEL rows): leaf search and intersect must match bitwise,
scan-reduce within rtol=atol=1e-5 and SpMM within 1e-4 (the sums run in
another order).  The resident-tile forms (an ``index`` into the tiles, a
live ``length`` per tile, some cut short) are held against the reference
kernel on the gathered tiles with the dead columns set to SENTINEL:
intersect bitwise, with repeated ids too, scan-reduce within 1e-5, and
SpMM within 1e-5 at d in {6, 32, 128, 160}.  Model kernels: embedding_bag
within rtol=atol=1e-5 on ``test_kernels.py``'s grid (sum/mean, weighted
and not, 30% -1 padding); flash_decode and its partial form within
rtol=2e-4, atol=2e-5 in f32 and
2e-2 in bf16, on ``test_kernels.py``'s cases plus Qwen2.5-14B's grouping
(G=5, dh=128); its plain version within 1e-5 at Gemma-2-27B's (G=2,
dh=144, softcap 50) and Qwen3-32B's (G=8, dh=80) f32 heads.

``TestKernelsOnCard`` holds each CUDA kernel against its plain version on
the card and skips where torch sees no CUDA device.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_decode import (
    flash_decode,
    flash_decode_partial,
    merge_partials,
)
from repro_torch.kernels.flash_decode.ref import flash_decode_partial_ref, flash_decode_ref
from repro_torch.kernels.intersect import intersect_count, intersect_count_hybrid
from repro_torch.kernels.intersect.ref import intersect_count_ref
from repro_torch.kernels.leaf_search import leaf_search
from repro_torch.kernels.leaf_search.ref import leaf_search_ref
from repro_torch.kernels.spmm import leaf_scan_reduce, leaf_spmm, route as spmm_route
from repro_torch.kernels.spmm.ref import leaf_scan_reduce_ref, leaf_spmm_ref

SRC = Path(__file__).resolve().parents[1] / "src"
SENT = np.iinfo(np.int32).max
WIDTHS = [16, 128, 512]
Q = 37  # ragged: no block size of either package divides it


def sorted_rows(rng, q, b, universe):
    """Sorted unique SENTINEL-padded rows; rows 0 and 5 are all-SENTINEL."""
    x = np.full((q, b), SENT, np.int32)
    for i in range(q):
        n = 0 if i in (0, 5) else int(rng.integers(1, b + 1))
        x[i, :n] = np.sort(rng.choice(universe, size=n, replace=False))
    return x


def search_inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    rows = sorted_rows(rng, Q, b, 5000)
    targets = rng.integers(0, 5000, Q).astype(np.int32)
    for i in range(0, Q, 2):  # force hits
        live = rows[i][rows[i] != SENT]
        if len(live):
            targets[i] = live[rng.integers(0, len(live))]
    return rows, targets


def tile_search_inputs(b, n=11, seed=5):
    """Resident tiles with ragged live lengths (tiles 0 and 5 empty), their
    lengths, Q queries naming tiles with repeats, and targets below, on,
    between and above each tile's live ids."""
    rng = np.random.default_rng(seed)
    tiles = sorted_rows(rng, n, b, 5000)
    length = (tiles != SENT).sum(axis=1).astype(np.int32)
    index = rng.integers(0, n, Q).astype(np.int32)
    index[:2] = 0  # the length-0 tile
    targets = np.empty(Q, np.int32)
    for i, r in enumerate(index):
        live = tiles[r, : length[r]]
        if not len(live):
            targets[i] = rng.integers(0, 5000)
            continue
        kind = i % 4
        if kind == 0:
            targets[i] = live[0] - 1  # below
        elif kind == 1:
            targets[i] = live[rng.integers(0, len(live))]  # on an id
        elif kind == 2:
            targets[i] = rng.integers(live[0], live[-1] + 1)  # inside, hit or miss
        else:
            targets[i] = live[-1] + 1 + rng.integers(0, 3)  # above
    return tiles, targets, index, length


def gather_inputs(b, nv=300, d=12, seed=1):
    rng = np.random.default_rng(seed)
    rows = np.full((Q, b), SENT, np.int32)
    for i in range(Q):
        n = 0 if i in (0, 5) else int(rng.integers(1, b + 1))
        rows[i, :n] = rng.integers(0, nv, n)
    x = rng.normal(size=nv).astype(np.float32)
    h = rng.normal(size=(nv, d)).astype(np.float32)
    return rows, x, h


def intersect_inputs(b, seed=2):
    rng = np.random.default_rng(seed)
    universe = max(2 * b, 64)  # dense enough that rows overlap
    return sorted_rows(rng, Q, b, universe), sorted_rows(rng, Q, b, universe)


SPMM_WIDTHS = [6, 32, 128, 160]  # scalar route, one 128-byte row, a warp, two slices


def spmm_length_inputs(b, d, seed=7):
    """gather_inputs' tiles (a live prefix, then SENTINEL) with their live
    lengths, some cut short (tiles 2, 9, ...) and tile 3's set to 0."""
    rows, _, h = gather_inputs(b, d=d, seed=seed)
    length = (rows != SENT).sum(axis=1).astype(np.int32)
    length[2::7] //= 2
    length[3] = 0
    return rows, h, length


def scan_length_inputs(b, seed=7):
    """spmm_length_inputs' tiles and lengths with x, the one column of H."""
    rows, h, length = spmm_length_inputs(b, 1, seed=seed)
    return rows, np.ascontiguousarray(h[:, 0]), length


def live_masked(rows, length):
    """The rows with columns at or past ``length`` set to SENTINEL: the
    gathered full-width input the reference kernels take."""
    return np.where(np.arange(rows.shape[1])[None, :] < length[:, None], rows, SENT)


def intersect_tile_inputs(b, n_a=11, n_b=13, seed=8, repeats=False):
    """Two sets of resident tiles of width b (sorted live prefix, SENTINEL
    padding; with ``repeats`` ids may repeat), their live lengths with some
    cut short, and Q pairs naming tiles with repeats (pair 0 an empty tile)."""
    rng = np.random.default_rng(seed)
    universe = max(2 * b, 64)
    if repeats:
        ta, tb = (np.full((n, b), SENT, np.int32) for n in (n_a, n_b))
        for t in (ta, tb):
            for i in range(1, len(t)):
                k = int(rng.integers(1, b + 1))
                t[i, :k] = np.sort(rng.integers(0, universe // 4, k))
    else:
        ta, tb = sorted_rows(rng, n_a, b, universe), sorted_rows(rng, n_b, b, universe)
    la = (ta != SENT).sum(axis=1).astype(np.int32)
    lb = (tb != SENT).sum(axis=1).astype(np.int32)
    la[1::4] = (la[1::4] * 3) // 4
    lb[2::5] //= 2
    ia = rng.integers(0, n_a, Q).astype(np.int32)
    ib = rng.integers(0, n_b, Q).astype(np.int32)
    ia[0] = 0  # the empty tile
    return ta, tb, ia, ib, la, lb


def spmm_order_bound(rows, h, length, want):
    """How far two f32 summation orders of the same tile sums may drift
    apart: 2 m u Σ_j |H[id_j]| over each tile's m live ids (u = 2^-24),
    plus rtol=atol=1e-5."""
    live = (rows != SENT) & (torch.arange(rows.shape[1], device=rows.device)[None, :]
                             < length[:, None])
    mag = torch.where(live[..., None], h[torch.where(live, rows, 0).long()].abs(), 0.0)
    return 1e-5 + 1e-5 * want.abs() + 2 * length[:, None] * 2.0 ** -24 * mag.sum(1)


EMBEDDING_BAG_CASES = [(100, 16, 12, 5, "sum"), (1000, 32, 33, 20, "mean"),
                       (64, 8, 4, 3, "sum")]
# (B, S, KV, G, dh, softcap): tests/test_kernels.py's cases, then Qwen2.5-14B's
# grouping (40 query heads over 8 KV heads: G=5, dh=128) at a small S,
# Gemma-2-27B's (32 over 16: G=2, dh=144, softcap 50) and a full group of 8
FLASH_DECODE_CASES = [(2, 256, 2, 4, 64, None), (3, 1000, 4, 2, 128, 50.0),
                      (1, 64, 1, 8, 32, None), (2, 300, 2, 5, 128, None),
                      (2, 300, 2, 2, 144, 50.0), (1, 200, 1, 8, 128, None)]


def bag_inputs(v, d, n, k, seed=3):
    """Table, ids with 30% -1 padding, and normal weights."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, size=(n, k)).astype(np.int32)
    ids[rng.random(size=(n, k)) < 0.3] = -1
    return table, ids, rng.normal(size=(n, k)).astype(np.float32)


def decode_inputs(b, s, kv, g, dh, seed=4, q_norm=None):
    """q [B, KV, G, dh], k, v [B, S, KV, dh] and kv_len in [1, S]; each
    query head scaled to norm ``q_norm`` where given."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kv, g, dh)).astype(np.float32)
    if q_norm is not None:
        q = (q * (q_norm / np.linalg.norm(q, axis=-1, keepdims=True))).astype(np.float32)
    k = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    return q, k, v, rng.integers(1, s + 1, b).astype(np.int32)


def sum_order_bound(table, ids, w, mode, want):
    """How far two f32 summation orders of the same bags may drift apart:
    2 K u Σ_k |w_k table[id_k]| (u = 2^-24) for the weighted sum, divided
    by the mean's divisor, plus |want| times the divisor's own drift
    2 K u Σ|w| / |Σ w| in mean mode.  Normal weights that nearly cancel make
    a mean ill-conditioned, so rtol alone cannot hold it."""
    k, u = ids.shape[1], 2.0 ** -24
    mask = ids >= 0
    wl = torch.where(mask, torch.ones_like(mask, dtype=torch.float32) if w is None else w, 0.0)
    rows = table[torch.where(mask, ids, 0).long()]
    bound = 2 * k * u * (rows.abs() * wl.abs()[..., None]).sum(1)
    if mode == "mean":
        den = wl.sum(1).clamp(min=1e-9)[:, None]
        bound = bound / den + want.abs() * 2 * k * u * wl.abs().sum(1)[:, None] / den
    return bound


@pytest.fixture(scope="module")
def ref():
    """The reference kernels, imported here so that the card-only class
    below collects where JAX is not installed."""
    from types import SimpleNamespace

    from repro.kernels.embedding_bag import embedding_bag
    from repro.kernels.flash_decode import flash_decode
    from repro.kernels.flash_decode.ops import flash_decode_partial, merge_partials
    from repro.kernels.intersect import intersect_count, intersect_count_hybrid
    from repro.kernels.leaf_search import leaf_search
    from repro.kernels.spmm import leaf_scan_reduce, leaf_spmm

    return SimpleNamespace(
        leaf_search=leaf_search, scan=leaf_scan_reduce, spmm=leaf_spmm,
        intersect=intersect_count, hybrid=intersect_count_hybrid,
        embedding_bag=embedding_bag, flash_decode=flash_decode,
        flash_decode_partial=flash_decode_partial, merge_partials=merge_partials,
    )


@pytest.mark.parametrize("b", WIDTHS)
def test_leaf_search_matches_reference(ref, b):
    rows, targets = search_inputs(b)
    f_want, p_want = ref.leaf_search(rows, targets)
    f_got, p_got = leaf_search(torch.from_numpy(rows), torch.from_numpy(targets))
    assert f_got.dtype == torch.bool and p_got.dtype == torch.int32
    assert np.array_equal(f_got.numpy(), np.asarray(f_want))
    assert np.array_equal(p_got.numpy(), np.asarray(p_want))


@pytest.mark.parametrize("b", WIDTHS)
def test_leaf_search_index_length_matches_reference(ref, b):
    """Resident tiles named by index, searched over their live prefix,
    against the reference kernel on the gathered full rows."""
    tiles, targets, index, length = tile_search_inputs(b)
    f_want, p_want = ref.leaf_search(tiles[index], targets)
    args = [torch.from_numpy(a) for a in (tiles, targets, index, length)]
    for f_got, p_got in (leaf_search_ref(*args), leaf_search(*args)):
        assert f_got.dtype == torch.bool and p_got.dtype == torch.int32
        assert np.array_equal(f_got.numpy(), np.asarray(f_want))
        assert np.array_equal(p_got.numpy(), np.asarray(p_want))
    assert np.asarray(f_want).any() and not np.asarray(f_want).all()


@pytest.mark.parametrize("bad", [11, -1])
def test_leaf_search_index_out_of_range_raises(bad):
    """On the CPU an index outside [0, n) raises, as the kernel traps."""
    tiles, targets, index, length = (torch.from_numpy(a) for a in tile_search_inputs(16))
    index[3] = bad
    with pytest.raises(IndexError, match="outside"):
        leaf_search(tiles, targets, index, length)


@pytest.mark.parametrize("b", WIDTHS)
def test_leaf_scan_reduce_matches_reference(ref, b):
    rows, x, _ = gather_inputs(b)
    want = np.asarray(ref.scan(rows, x))
    got = leaf_scan_reduce(torch.from_numpy(rows), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b", WIDTHS)
def test_leaf_scan_reduce_length_matches_reference(ref, b):
    """Tiles read over their live length (some cut short, one 0) against
    the reference kernel on the same tiles with the dead columns set to
    SENTINEL; without ``length`` the full-width form agrees with the live
    lengths."""
    rows, x, length = scan_length_inputs(b)
    want = np.asarray(ref.scan(live_masked(rows, length), x))
    args = [torch.from_numpy(a) for a in (rows, x, length)]
    for got in (leaf_scan_reduce_ref(*args), leaf_scan_reduce(*args)):
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert want[3] == 0  # the length-0 tile
    live = torch.from_numpy((rows != SENT).sum(axis=1).astype(np.int32))
    assert torch.equal(leaf_scan_reduce(*args[:2]), leaf_scan_reduce(*args[:2], live))


@pytest.mark.parametrize("b", WIDTHS)
def test_leaf_spmm_matches_reference(ref, b):
    rows, _, h = gather_inputs(b)
    want = np.asarray(ref.spmm(rows, h))
    got = leaf_spmm(torch.from_numpy(rows), torch.from_numpy(h))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b", WIDTHS)
def test_intersect_count_matches_reference(ref, b):
    a, bb = intersect_inputs(b)
    want = np.asarray(ref.intersect(a, bb))
    got = intersect_count(torch.from_numpy(a), torch.from_numpy(bb))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want.sum() > 0
    hybrid = intersect_count_hybrid(torch.from_numpy(a), torch.from_numpy(bb))
    assert np.array_equal(hybrid.numpy(), np.asarray(ref.hybrid(a, bb)))


@pytest.mark.parametrize("d", SPMM_WIDTHS)
@pytest.mark.parametrize("b", WIDTHS)
def test_leaf_spmm_length_matches_reference(ref, b, d):
    """Tiles read over their live length (some cut short, one 0) against
    the reference kernel on the same tiles with the dead columns set to
    SENTINEL."""
    rows, h, length = spmm_length_inputs(b, d)
    want = np.asarray(ref.spmm(live_masked(rows, length), h))
    args = [torch.from_numpy(x) for x in (rows, h, length)]
    for got in (leaf_spmm_ref(*args), leaf_spmm(*args)):
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not want[3].any()  # the length-0 tile


def test_leaf_spmm_route_is_a_function_of_width_and_alignment():
    """"vec4" for d % 4 == 0 on a 16-byte boundary, "scalar" otherwise (the
    card tests' d = 6 and an H that starts 4 bytes in); the scan asks the
    same function with its tile width B and where ``rows`` starts (the card
    tests' B = 18 and rows that start 4 bytes in)."""
    assert {spmm_route(d, 0) for d in (4, 32, 128, 160)} == {"vec4"}
    assert {spmm_route(d, 0) for d in (1, 6, 10)} == {"scalar"}
    assert spmm_route(128, 4) == "scalar" and spmm_route(128, 48) == "vec4"
    h = torch.zeros(33 * 8)
    assert spmm_route(8, h[8:].view(32, 8).data_ptr()) == spmm_route(8, h.data_ptr())
    assert spmm_route(8, h[1:257].view(32, 8).data_ptr()) == "scalar"
    rows = torch.zeros((3, 16), dtype=torch.int32)
    assert {spmm_route(b, rows.data_ptr()) for b in WIDTHS} == {"vec4"}
    assert spmm_route(16, rows[1:].data_ptr()) == "vec4"  # 64 bytes in
    assert spmm_route(18, 0) == "scalar"
    assert spmm_route(12, rows.view(-1)[1:37].view(3, 12).data_ptr()) == "scalar"


@pytest.mark.parametrize("repeats", [False, True], ids=["unique", "repeats"])
@pytest.mark.parametrize("b", WIDTHS)
def test_intersect_count_index_length_matches_reference(ref, b, repeats):
    """Pairs of resident tiles named by index, each read over its live
    length, bitwise against the reference kernel on the gathered tiles with
    the dead columns set to SENTINEL; with repeated ids too (all-pairs
    counts)."""
    ta, tb, ia, ib, la, lb = intersect_tile_inputs(b, repeats=repeats)
    want = np.asarray(ref.intersect(live_masked(ta[ia], la[ia]), live_masked(tb[ib], lb[ib])))
    args = [torch.from_numpy(x) for x in (ta, tb, ia, ib, la, lb)]
    for got in (intersect_count_ref(*args), intersect_count(*args)):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    assert want.sum() > 0 and want[0] == 0
    # index None: tile i of a against tile i of b
    want = np.asarray(ref.intersect(live_masked(ta, la), live_masked(tb[:11], lb[:11])))
    got = intersect_count(args[0], args[1][:11], None, None, args[4], args[5][:11])
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("side", ["a", "b"])
@pytest.mark.parametrize("bad", [13, -1])
def test_intersect_count_index_out_of_range_raises(bad, side):
    """On the CPU an index outside [0, n) raises, as the kernel traps."""
    ta, tb, ia, ib, la, lb = (torch.from_numpy(x) for x in intersect_tile_inputs(16))
    (ia if side == "a" else ib)[3] = bad
    with pytest.raises(IndexError, match=f"index_{side} outside"):
        intersect_count(ta, tb, ia, ib, la, lb)


def test_intersect_count_checks_pairs():
    ta, tb, ia, ib, la, lb = (torch.from_numpy(x) for x in intersect_tile_inputs(16))
    with pytest.raises(ValueError, match="disagree on Q"):
        intersect_count(ta, tb, ia, ib[:-1], la, lb)
    with pytest.raises(ValueError, match="disagree on Q"):
        intersect_count(ta, tb[:-1])


def test_cpu_index_length_forms_launch_nothing():
    rows, h, length = (torch.from_numpy(x) for x in spmm_length_inputs(16, 8))
    ta, tb, ia, ib, la, lb = (torch.from_numpy(x) for x in intersect_tile_inputs(16))
    before = (leaf_scan_reduce.launches, leaf_spmm.launches, intersect_count.launches)
    leaf_scan_reduce(rows, h[:, 0], length)
    leaf_spmm(rows, h, length)
    intersect_count(ta, tb, ia, ib, la, lb)
    assert (leaf_scan_reduce.launches, leaf_spmm.launches,
            intersect_count.launches) == before


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("case", EMBEDDING_BAG_CASES, ids=str)
def test_embedding_bag_matches_reference(ref, case, weighted):
    v, d, n, k, mode = case
    table, ids, w = bag_inputs(v, d, n, k)
    w = w if weighted else None
    want = np.asarray(ref.embedding_bag(table, ids, w, mode=mode))
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        None if w is None else torch.from_numpy(w), mode=mode)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", FLASH_DECODE_CASES, ids=str)
def test_flash_decode_matches_reference(ref, case):
    *shape, cap = case
    q, k, v, kv_len = decode_inputs(*shape)
    want = np.asarray(ref.flash_decode(q, k, v, kv_len, block_s=128, softcap=cap))
    got = flash_decode(*(torch.from_numpy(a) for a in (q, k, v, kv_len)), softcap=cap)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case", FLASH_DECODE_CASES, ids=str)
def test_flash_decode_partial_matches_reference(ref, case):
    *shape, cap = case
    q, k, v, kv_len = decode_inputs(*shape)
    want = ref.flash_decode_partial(q, k, v, kv_len, block_s=128, softcap=cap)
    got = flash_decode_partial(*(torch.from_numpy(a) for a in (q, k, v, kv_len)),
                               softcap=cap)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5)


def test_flash_decode_sequence_parallel_merge_matches_reference(ref):
    """Two sequence shards merged with the log-sum-exp rule; the second
    sequence has no live position in the second shard."""
    q, k, v, _ = decode_inputs(2, 512, 2, 4, 64)
    kv_len = np.array([500, 128], np.int32)
    half = 256
    shards = [(k[:, :half], v[:, :half], np.minimum(kv_len, half)),
              (k[:, half:], v[:, half:], np.maximum(kv_len - half, 0))]
    want_parts = [ref.flash_decode_partial(q, ks, vs, n, block_s=128) for ks, vs, n in shards]
    want = np.asarray(ref.merge_partials(*zip(*want_parts)))
    parts = [flash_decode_partial(torch.from_numpy(q), torch.from_numpy(ks),
                                  torch.from_numpy(vs), torch.from_numpy(n))
             for ks, vs, n in shards]
    got = merge_partials(*zip(*parts))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    whole = flash_decode(*(torch.from_numpy(a) for a in (q, k, v, kv_len)))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=2e-4, atol=2e-5)


def test_flash_decode_bf16_matches_reference(ref):
    import jax.numpy as jnp

    q, k, v, _ = decode_inputs(2, 256, 2, 5, 128)
    kv_len = np.array([256, 77], np.int32)
    want = np.asarray(ref.flash_decode(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                       kv_len, block_s=128))
    got = flash_decode(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                       torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_cpu_path_launches_nothing():
    rows, targets = search_inputs(16)
    before = (leaf_search.launches, leaf_scan_reduce.launches,
              leaf_spmm.launches, intersect_count.launches)
    leaf_search(torch.from_numpy(rows), torch.from_numpy(targets))
    leaf_scan_reduce(torch.from_numpy(rows), torch.zeros(5001))
    intersect_count(torch.from_numpy(rows), torch.from_numpy(rows))
    after = (leaf_search.launches, leaf_scan_reduce.launches,
             leaf_spmm.launches, intersect_count.launches)
    assert before == after


def simt_ring() -> tuple[int, int, int, int]:
    """csrc/flash_decode.cu's "simt" staging constants: kStages,
    kRingBytes, kMaxTile and kMinTile."""
    import re

    src = (SRC / "repro_torch" / "csrc" / "flash_decode.cu").read_text()
    ring = re.search(r"constexpr int kStages = (\d+);[^\n]*\nconstexpr int kRingBytes = (\d+);",
                     src)
    tiles = re.search(r"constexpr int kMaxTile = (\d+), kMinTile = (\d+);", src)
    return (*map(int, ring.groups()), *map(int, tiles.groups()))


def simt_tile(dh: int, dtype: torch.dtype) -> tuple[int, int]:
    """(L, T) of the "simt" kernel as ``simt::tile_rows`` picks them from
    :func:`simt_ring`: a row of L 16-byte words, T positions a warp tile,
    the largest power of two from kMaxTile down to kMinTile whose rings
    (WARPS x kStages K and V tiles of T rows of L | 1 words) fit
    kRingBytes."""
    from repro_torch.kernels.flash_decode.ops import WARPS

    stages, ring_bytes, max_tile, min_tile = simt_ring()
    words, tile = dh * dtype.itemsize // 16, max_tile
    while tile > min_tile and WARPS * stages * 2 * tile * (words | 1) * 16 > ring_bytes:
        tile //= 2
    return words, tile


def test_flash_decode_kernel_shapes():
    """bf16 rows with dh a multiple of 16 (up to 256) take the tensor-core
    route, whole block steps of 2048 rows per block; the CUDA-core route
    takes any row of L 16-byte words up to dh 256 (L <= 64), staged in warp
    tiles of T positions (the largest of 32, 16, 8, 4 whose rings fit the
    kernel's budget), 1024 rows per block, and refuses the rest."""
    from repro_torch.kernels.flash_decode.ops import WARPS, _chunk_rows, route

    # (L words of 16 bytes, T positions a warp tile)
    assert simt_tile(128, torch.bfloat16) == (16, 16)
    assert simt_tile(128, torch.float32) == (32, 8)
    assert simt_tile(16, torch.bfloat16) == (2, 32)
    assert simt_tile(24, torch.bfloat16) == (3, 32)
    assert simt_tile(144, torch.float32) == (36, 8)
    assert simt_tile(80, torch.float32) == (20, 16)
    assert simt_tile(256, torch.float32) == (64, 4)
    assert route(torch.bfloat16, 144) == "mma"
    for dh, dtype in ((272, torch.float32), (6, torch.float32), (12, torch.bfloat16)):
        with pytest.raises(ValueError, match="no kernel"):
            route(dtype, dh)
    for dh, dtype in ((128, torch.float32), (8, torch.bfloat16), (4, torch.float32),
                      (80, torch.float32), (144, torch.float32), (256, torch.float32),
                      (24, torch.bfloat16)):
        assert _chunk_rows(dh, dtype) == 1024 and 1024 % (WARPS * simt_tile(dh, dtype)[1]) == 0
    for dh in (16, 64, 128, 144, 256):
        assert _chunk_rows(dh, torch.bfloat16) == 2048


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_decode_simt_staging_fits_every_width(dtype):
    """At every width route "simt" takes, the kernel's tile T divides the
    chunk ops.py passes and the launch's shared memory at G 8 (q rows of an
    odd number of float4, p, then the rings or the warps' states, as
    ``simt::smem_bytes`` adds them) fits a block's 232,448 bytes."""
    from repro_torch.kernels.flash_decode.ops import CHUNK_ROWS, WARPS, _chunk_rows, route

    step = 4 if dtype == torch.float32 else 8
    widths = [dh for dh in range(step, 257, step) if route(dtype, dh) == "simt"]
    assert len(widths) == (64 if dtype == torch.float32 else 16)
    stages, ring_bytes, _, _ = simt_ring()
    g = 8
    for dh in widths:
        words, tile = simt_tile(dh, dtype)
        assert tile in (4, 8, 16, 32) and CHUNK_ROWS % (WARPS * tile) == 0
        assert _chunk_rows(dh, dtype) == CHUNK_ROWS
        rings = WARPS * stages * 2 * tile * (words | 1) * 16
        state = 4 * WARPS * g * (dh + 2)
        smem = 4 * g * 4 * ((dh // 4) | 1) + 4 * WARPS * g * (tile + 4) + max(rings, state)
        assert rings <= ring_bytes and smem <= 232448, (dh, tile, smem)


def test_flash_decode_route_is_a_function_of_dtype_and_dh():
    """The route: "mma" for bf16 K/V with 16 <= dh <= 256 a multiple of 16
    (every LM config's dh at full width: 64, 80, 128, 144), "simt" for f32
    rows of any multiple of 4 up to 256 (every LM config's dh too: the
    serve launcher's f32 cache) and the other bf16 multiples of 8; other
    types raise."""
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_decode import route

    assert {route(torch.bfloat16, dh) for dh in range(16, 257, 16)} == {"mma"}
    assert {route(torch.bfloat16, dh) for dh in range(8, 257, 16)} == {"simt"}
    assert {route(torch.float32, dh) for dh in range(4, 257, 4)} == {"simt"}
    for dh in (272, 512):
        with pytest.raises(ValueError, match="no kernel"):
            route(torch.bfloat16, dh)
    with pytest.raises(TypeError, match="f32 or bf16"):
        route(torch.float16, 128)
    lms = [a for a in registry.arch_ids() if registry.FAMILY[a] == "lm"]
    full = {registry.get_config(a).d_head for a in lms}
    assert full == {64, 80, 128, 144}
    assert {route(torch.bfloat16, dh) for dh in full} == {"mma"}
    assert {route(torch.float32, dh) for dh in full} == {"simt"}
    assert {registry.get_smoke_config(a).d_head for a in lms} == {8, 16}


# (dtype, dh, route or None where no kernel takes the row): Qwen3's and
# Gemma-2's f32 heads, the widest f32 row, bf16 rows of an odd number of
# 16-byte words; rows of no whole word and dh past 256 raise
ROUTE_CASES = [(torch.float32, 80, "simt"), (torch.float32, 144, "simt"),
               (torch.float32, 256, "simt"), (torch.bfloat16, 24, "simt"),
               (torch.bfloat16, 72, "simt"), (torch.bfloat16, 80, "mma"),
               (torch.bfloat16, 12, None), (torch.float32, 6, None),
               (torch.bfloat16, 272, None), (torch.float32, 272, None)]


@pytest.mark.parametrize("dtype,dh,want", ROUTE_CASES,
                         ids=[f"{str(d).split('.')[-1]}-{dh}" for d, dh, _ in ROUTE_CASES])
def test_flash_decode_route_case(dtype, dh, want):
    from repro_torch.kernels.flash_decode import route

    if want is None:
        with pytest.raises(ValueError, match="no kernel"):
            route(dtype, dh)
    else:
        assert route(dtype, dh) == want


# (B, S, KV, G, dh, softcap): the serve launcher's f32 heads at full width:
# Gemma-2-27B's (G 2, dh 144, softcap 50) and Qwen3-32B's (G 8, dh 80)
FULL_HEAD_CASES = [(2, 300, 2, 2, 144, 50.0), (2, 300, 1, 8, 80, None)]


@pytest.mark.parametrize("case", FULL_HEAD_CASES, ids=["gemma2", "qwen3"])
def test_flash_decode_ref_matches_reference_at_full_width_heads(ref, case):
    """The port's plain version (the oracle of the "simt" kernel on the
    card) against the reference's ``flash_decode`` on the CPU, within 1e-5."""
    *shape, cap = case
    q, k, v, kv_len = decode_inputs(*shape, seed=7)
    want = np.asarray(ref.flash_decode(q, k, v, kv_len, block_s=128, softcap=cap))
    got = flash_decode_ref(*(torch.from_numpy(a) for a in (q, k, v, kv_len)), softcap=cap)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_model_kernels_launch_nothing():
    table, ids, w = (torch.from_numpy(a) for a in bag_inputs(50, 8, 6, 4))
    q, k, v, kv_len = (torch.from_numpy(a) for a in decode_inputs(1, 64, 1, 8, 32))
    before = (embedding_bag.launches, flash_decode.launches)
    embedding_bag(table, ids, w, mode="mean")
    flash_decode(q, k, v, kv_len)
    flash_decode_partial(q, k, v, kv_len)
    assert (embedding_bag.launches, flash_decode.launches) == before


def test_launch_counter_is_exact_across_threads():
    import threading

    from repro_torch.kernels.runtime import card_launches, count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    before = card_launches()

    def bump(card):
        for _ in range(20000):
            count_launch(wrapper, torch.device("cuda", card))

    threads = [threading.Thread(target=bump, args=(k % 2 + 1,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrapper.launches == 80000
    after = card_launches()
    assert [after.get(k, 0) - before.get(k, 0) for k in (1, 2)] == [40000, 40000]


def test_launch_signatures_match_the_sources():
    """Every ``kernel_fn`` call's ctypes argtypes spell the C signature of
    its launch function in ``csrc/``: a missing letter would pass the
    stream as an int and crash the card run, not a CPU test."""
    import re

    letter = {"void*": "p", "long long": "l", "int": "i", "float": "f"}
    sigs = {}
    for src in (SRC / "repro_torch" / "csrc").glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            types = [re.sub(r"\bconst\b|\s*\w+$", "", q.strip()).replace(" *", "*").strip()
                     for q in params.split(",")]
            sigs[(src.stem, name)] = "".join(letter[t] for t in types)
    calls = []
    for ops in (SRC / "repro_torch" / "kernels").rglob("ops.py"):
        calls += re.findall(r'kernel_fn\("(\w+)", "(\w+)", "(\w+)"\)', ops.read_text())
    assert {(stem, symbol) for stem, symbol, _ in calls} == set(sigs)
    for stem, symbol, argtypes in calls:
        assert sigs[(stem, symbol)] == argtypes, (stem, symbol)


def test_other_devices_raise():
    rows = torch.zeros((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        leaf_search(rows, torch.zeros(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        embedding_bag(torch.zeros((8, 4), device="meta"), rows[:, :2])
    k = torch.zeros((1, 8, 1, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_decode(torch.zeros((1, 1, 2, 4), device="meta"), k, k, [8])
    with pytest.raises(ValueError, match="mode"):
        embedding_bag(torch.zeros((8, 4)), torch.zeros((2, 2), dtype=torch.int32), mode="max")


def test_operands_on_two_devices_raise():
    """Every wrapper checks its tensor operands before it moves any: a
    device beside the primary operand's (here the meta device beside CPU
    tiles) raises ValueError naming both, and nothing launches."""
    rows = torch.zeros((4, 16), dtype=torch.int32)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    h = torch.zeros((8, 4), device="meta")
    calls = [lambda: leaf_search(rows, meta), lambda: leaf_scan_reduce(rows, meta.float()),
             lambda: leaf_spmm(rows, h), lambda: intersect_count(rows, rows, meta, meta),
             lambda: embedding_bag(torch.zeros((8, 4)), meta[:, None]),
             lambda: flash_decode(torch.zeros((1, 1, 2, 4), device="meta"),
                                  torch.zeros((1, 8, 1, 4)), torch.zeros((1, 8, 1, 4)), [8])]
    for call in calls:
        with pytest.raises(ValueError, match=r"\['cpu', 'meta'\]"):
            call()


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
class TestKernelsOnCard:
    """Each CUDA kernel against its plain version on the same card inputs."""

    @pytest.mark.parametrize("b", WIDTHS)
    def test_leaf_search(self, b):
        rows, targets = (torch.from_numpy(a).cuda() for a in search_inputs(b))
        n0 = leaf_search.launches
        f, p = leaf_search(rows, targets)
        torch.cuda.synchronize()
        assert leaf_search.launches == n0 + 1
        fr, pr = leaf_search_ref(rows, targets)
        assert torch.equal(f, fr) and torch.equal(p, pr)

    @pytest.mark.parametrize("b", WIDTHS)
    def test_leaf_search_index_length(self, b):
        """The gather-fused, live-prefix kernel bitwise against the plain
        version."""
        tiles, targets, index, length = (torch.from_numpy(a).cuda()
                                         for a in tile_search_inputs(b))
        n0 = leaf_search.launches
        f, p = leaf_search(tiles, targets, index, length)
        torch.cuda.synchronize()
        assert leaf_search.launches == n0 + 1
        fr, pr = leaf_search_ref(tiles, targets, index, length)
        assert torch.equal(f, fr) and torch.equal(p, pr)
        f, p = leaf_search(tiles, targets[:11], None, length)  # tile i for query i
        fr, pr = leaf_search_ref(tiles, targets[:11], None, length)
        assert torch.equal(f, fr) and torch.equal(p, pr)

    @pytest.mark.parametrize("bad", [4, -1])
    def test_leaf_search_index_out_of_range_fails(self, bad):
        """An index outside [0, n) traps instead of reading past the tiles;
        the next synchronisation raises (in a child process: a trap leaves
        the CUDA context unusable)."""
        code = (
            "import torch\n"
            "from repro_torch.kernels.leaf_search import leaf_search\n"
            "rows = torch.zeros((4, 16), dtype=torch.int32, device='cuda')\n"
            "t = torch.zeros(3, dtype=torch.int32, device='cuda')\n"
            f"ix = torch.tensor([0, {bad}, 1], dtype=torch.int32, device='cuda')\n"
            "leaf_search(rows, t, ix)\n"
            "try:\n"
            "    torch.cuda.synchronize()\n"
            "except RuntimeError:\n"
            "    print('trapped', flush=True)\n"
        )
        env = dict(os.environ, PYTHONPATH=str(SRC))
        out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.stdout.strip() == "trapped", out.stderr[-2000:]

    @pytest.mark.parametrize("b", WIDTHS)
    def test_leaf_scan_reduce(self, b):
        rows, x, _ = (torch.from_numpy(a).cuda() for a in gather_inputs(b))
        got = leaf_scan_reduce(rows, x)
        torch.testing.assert_close(got, leaf_scan_reduce_ref(rows, x),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("b", WIDTHS + [18])
    def test_leaf_scan_reduce_length(self, b):
        """The live-prefix kernel on both routes (B = 18, and rows that
        start 4 bytes in, take the scalar one) against the plain version,
        within the drift of two f32 summation orders."""
        rows, x, length = (torch.from_numpy(a).cuda() for a in scan_length_inputs(b))
        shifted = torch.empty(rows.numel() + 1, dtype=torch.int32, device="cuda")[1:]
        shifted = shifted.view(rows.shape)
        shifted.copy_(rows)
        for rr in (rows, shifted):
            n0 = leaf_scan_reduce.launches
            got = leaf_scan_reduce(rr, x, length)
            torch.cuda.synchronize()
            assert leaf_scan_reduce.launches == n0 + 1
            want = leaf_scan_reduce_ref(rr, x, length)
            drift = spmm_order_bound(rr, x[:, None], length, want[:, None])[:, 0]
            assert ((got - want).abs() <= drift).all()
        assert spmm_route(b, rows.data_ptr()) == ("vec4" if b % 4 == 0 else "scalar")
        assert spmm_route(b, shifted.data_ptr()) == "scalar"
        assert got[3] == 0

    @pytest.mark.parametrize("b", WIDTHS + [18])
    def test_leaf_scan_reduce_without_length_is_full_width(self, b):
        """``length=None`` reads all B slots: the same sums as lengths of B,
        and, on tiles that are a live prefix then SENTINEL, as their live
        lengths."""
        rows, x, _ = (torch.from_numpy(a).cuda() for a in gather_inputs(b))
        full = torch.full((rows.shape[0],), b, dtype=torch.int32, device="cuda")
        live = (rows != SENT).sum(dim=1).to(torch.int32)
        got = leaf_scan_reduce(rows, x)
        assert torch.equal(got, leaf_scan_reduce(rows, x, full))
        assert torch.equal(got, leaf_scan_reduce(rows, x, live))

    @pytest.mark.parametrize("b", WIDTHS)
    def test_leaf_spmm(self, b):
        rows, _, h = (torch.from_numpy(a).cuda() for a in gather_inputs(b, d=160))
        got = leaf_spmm(rows, h)
        torch.testing.assert_close(got, leaf_spmm_ref(rows, h), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("b", WIDTHS)
    def test_intersect_count(self, b):
        a, bb = (torch.from_numpy(x).cuda() for x in intersect_inputs(b))
        assert torch.equal(intersect_count(a, bb), intersect_count_ref(a, bb))
        narrow = bb[:, : b // 2].contiguous()  # two widths, as tier pairs give
        assert torch.equal(intersect_count(a, narrow), intersect_count_ref(a, narrow))

    @pytest.mark.parametrize("d", SPMM_WIDTHS)
    @pytest.mark.parametrize("b", WIDTHS)
    def test_leaf_spmm_length(self, b, d):
        """The live-prefix kernel on both routes (d = 6, and an H that
        starts 4 bytes in, take the scalar one) against the plain version,
        within the drift of two f32 summation orders."""
        rows, h, length = (torch.from_numpy(x).cuda() for x in spmm_length_inputs(b, d))
        shifted = torch.empty(h.numel() + 1, device="cuda")[1:].view(h.shape)
        shifted.copy_(h)
        for hh in (h, shifted):
            n0 = leaf_spmm.launches
            got = leaf_spmm(rows, hh, length)
            torch.cuda.synchronize()
            assert leaf_spmm.launches == n0 + 1
            want = leaf_spmm_ref(rows, hh, length)
            assert ((got - want).abs() <= spmm_order_bound(rows, hh, length, want)).all()
        assert spmm_route(d, shifted.data_ptr()) == "scalar"
        assert not got[3].any()

    @pytest.mark.parametrize("repeats", [False, True], ids=["unique", "repeats"])
    @pytest.mark.parametrize("b", WIDTHS)
    def test_intersect_count_index_length(self, b, repeats):
        """The gather-fused, live-prefix kernel bitwise against the plain
        version, at equal and at unequal widths and with index None.  The
        ``unique`` case (b's live ids distinct, as in leaf tiles) takes the
        branch-free merge path; the ``repeats`` case, where b repeats ids,
        the walk over each run of equal ids."""
        ta, tb, ia, ib, la, lb = (torch.from_numpy(x).cuda()
                                  for x in intersect_tile_inputs(b, repeats=repeats))
        n0 = intersect_count.launches
        got = intersect_count(ta, tb, ia, ib, la, lb)
        torch.cuda.synchronize()
        assert intersect_count.launches == n0 + 1
        assert torch.equal(got, intersect_count_ref(ta, tb, ia, ib, la, lb))
        narrow = tb[:, : b // 2].contiguous()  # two widths, as tier pairs give
        lb2 = lb.clamp(max=b // 2)
        assert torch.equal(intersect_count(ta, narrow, ia, ib, la, lb2),
                           intersect_count_ref(ta, narrow, ia, ib, la, lb2))
        got = intersect_count(ta, tb[:11], None, None, la, lb[:11])
        assert torch.equal(got, intersect_count_ref(ta, tb[:11], None, None, la, lb[:11]))

    @pytest.mark.parametrize("widths", [(4096, 4096), (512, 12288), (29056, 29056)],
                             ids=str)
    def test_intersect_count_wide_tiles(self, widths):
        """Wide rows: fewer pairs share a block, down to one pair when
        Ba + Bb fills a block's shared memory (58,112 ids); one id more
        raises before any launch."""
        from repro_torch.kernels.intersect.ops import MAX_WIDTHS

        rng = np.random.default_rng(7)
        ba, bb = widths
        n = 4 if ba + bb > 20000 else 24  # the plain version compares all B^2 pairs
        la = torch.from_numpy(rng.integers(0, ba + 1, n).astype(np.int32)).cuda()
        lb = torch.from_numpy(rng.integers(0, bb + 1, n).astype(np.int32)).cuda()
        la[0], lb[0] = ba, bb
        ta, tb = (torch.sort(torch.randint(0, 2 * max(ba, bb), (n, w), device="cuda",
                                           dtype=torch.int32), dim=1).values
                  for w in (ba, bb))
        ia = torch.randperm(n, device="cuda").to(torch.int32)
        ib = torch.randperm(n, device="cuda").to(torch.int32)
        got = intersect_count(ta, tb, ia, ib, la, lb)
        assert torch.equal(got, intersect_count_ref(ta, tb, ia, ib, la, lb))
        assert got.sum() > 0
        n0 = intersect_count.launches
        too_wide = torch.zeros((2, MAX_WIDTHS + 1 - ba), dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="shared memory"):
            intersect_count(ta[:2], too_wide)
        assert intersect_count.launches == n0

    @pytest.mark.parametrize("bad", [4, -1])
    def test_intersect_count_index_out_of_range_fails(self, bad):
        """An index outside [0, n) traps instead of reading past the tiles;
        the next synchronisation raises (in a child process: a trap leaves
        the CUDA context unusable)."""
        code = (
            "import torch\n"
            "from repro_torch.kernels.intersect import intersect_count\n"
            "rows = torch.zeros((4, 16), dtype=torch.int32, device='cuda')\n"
            f"ib = torch.tensor([0, {bad}, 1], dtype=torch.int32, device='cuda')\n"
            "intersect_count(rows, rows, ib.flip(0).clamp(0, 3), ib)\n"
            "try:\n"
            "    torch.cuda.synchronize()\n"
            "except RuntimeError:\n"
            "    print('trapped', flush=True)\n"
        )
        env = dict(os.environ, PYTHONPATH=str(SRC))
        out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.stdout.strip() == "trapped", out.stderr[-2000:]

    @pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
    @pytest.mark.parametrize("case", EMBEDDING_BAG_CASES + [(4096, 32, 1000, 1, "sum")],
                             ids=str)
    def test_embedding_bag(self, case, weighted):
        v, d, n, k, mode = case
        table, ids, w = (torch.from_numpy(a).cuda() for a in bag_inputs(v, d, n, k))
        w = w if weighted else None
        n0 = embedding_bag.launches
        got = embedding_bag(table, ids, w, mode=mode)
        torch.cuda.synchronize()
        assert embedding_bag.launches == n0 + 1
        want = embedding_bag_ref(table, ids, w, mode)
        assert ((got - want).abs() <= 1e-5 + 1e-5 * want.abs()
                + sum_order_bound(table, ids, w, mode, want)).all()

    def test_embedding_bag_refuses_rows_it_reads_no_float4_of(self):
        ids = torch.zeros((3, 2), dtype=torch.int32, device="cuda")
        n0 = embedding_bag.launches
        with pytest.raises(ValueError, match="d=6"):
            embedding_bag(torch.zeros((40, 6), device="cuda"), ids)
        with pytest.raises(ValueError, match="aligned"):
            embedding_bag(torch.zeros(40 * 8 + 1, device="cuda")[1:].view(40, 8), ids)
        assert embedding_bag.launches == n0

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
    @pytest.mark.parametrize("case", FLASH_DECODE_CASES + [(4, 4100, 8, 5, 128, None),
                                                           (3, 333, 2, 1, 64, None)], ids=str)
    def test_flash_decode(self, case, dtype):
        """Both routes (bf16 with dh % 16 == 0 takes the tensor cores);
        a dh that neither route takes raises before any launch."""
        from repro_torch.kernels.flash_decode import route

        *shape, cap = case
        q, k, v, kv_len = (torch.from_numpy(a).cuda() for a in decode_inputs(*shape))
        k, v = k.to(dtype), v.to(dtype)
        n0 = flash_decode.launches
        try:
            route(dtype, shape[-1])
        except ValueError:
            with pytest.raises(ValueError, match="no kernel"):
                flash_decode(q, k, v, kv_len, softcap=cap)
            assert flash_decode.launches == n0
            return
        got = flash_decode(q, k, v, kv_len, softcap=cap)
        torch.cuda.synchronize()
        assert flash_decode.launches == n0 + 1
        torch.testing.assert_close(got, flash_decode_ref(q, k, v, kv_len, softcap=cap),
                                   rtol=2e-4, atol=2e-5)
        for g, w in zip(flash_decode_partial(q, k, v, kv_len, softcap=cap),
                        flash_decode_partial_ref(q, k, v, kv_len, softcap=cap)):
            torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-5)

    @pytest.mark.parametrize("case,dtype", [
        (FULL_HEAD_CASES[0], torch.float32), (FULL_HEAD_CASES[1], torch.float32),
        ((1, 5000, 2, 2, 256, None), torch.float32), ((2, 300, 2, 3, 12, None), torch.float32),
        ((2, 300, 2, 4, 24, None), torch.bfloat16), ((2, 300, 2, 2, 72, 50.0), torch.bfloat16),
    ], ids=["gemma2", "qwen3", "dh256", "f32-dh12", "bf16-dh24", "bf16-dh72"])
    def test_flash_decode_simt_full_width_heads(self, case, dtype):
        """The "simt" kernel against its plain version, one launch each: f32
        rows of 20, 36 and 64 words (dh 80, 144, 256; a warp reads one row),
        and rows of 3 (f32 dh 12, bf16 dh 24) and 9 words (bf16 dh 72),
        where a warp reads several rows at once in lane groups with idle
        lanes."""
        from repro_torch.kernels.flash_decode import route

        *shape, cap = case
        q, k, v, kv_len = (torch.from_numpy(a).cuda() for a in decode_inputs(*shape, seed=7))
        k, v = k.to(dtype), v.to(dtype)
        assert route(k.dtype, shape[-1]) == "simt"
        n0 = flash_decode.launches
        got = flash_decode(q, k, v, kv_len, softcap=cap)
        torch.cuda.synchronize()
        assert flash_decode.launches == n0 + 1
        torch.testing.assert_close(got, flash_decode_ref(q, k, v, kv_len, softcap=cap),
                                   rtol=2e-4, atol=2e-5)

    @staticmethod
    def check_simt(q, k, v, kv_len, cap=None):
        """Both forms of the "simt" kernel against their plain versions at
        rtol 2e-4, atol 2e-5, one launch each."""
        from repro_torch.kernels.flash_decode import route

        assert route(k.dtype, q.shape[-1]) == "simt"
        n0 = flash_decode.launches
        got = flash_decode(q, k, v, kv_len, softcap=cap)
        torch.cuda.synchronize()
        assert flash_decode.launches == n0 + 1
        torch.testing.assert_close(got, flash_decode_ref(q, k, v, kv_len, softcap=cap),
                                   rtol=2e-4, atol=2e-5)
        parts = flash_decode_partial(q, k, v, kv_len, softcap=cap)
        torch.cuda.synchronize()
        assert flash_decode.launches == n0 + 2
        for g, w in zip(parts, flash_decode_partial_ref(q, k, v, kv_len, softcap=cap)):
            torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-5)

    @pytest.mark.parametrize("at", ["1", "T-1", "T", "T+1", "chunk-1", "chunk+1"])
    @pytest.mark.parametrize("dtype,g,dh", [(torch.float32, 8, 80), (torch.float32, 2, 144),
                                            (torch.float32, 3, 256), (torch.bfloat16, 4, 72)],
                             ids=["f32-dh80", "f32-dh144", "f32-dh256", "bf16-dh72"])
    def test_flash_decode_simt_tile_edges(self, dtype, g, dh, at):
        """Live lengths at the edges of a warp tile (T positions, as
        ``simt_tile`` works out the kernel's choice) and of a block's chunk:
        the first sequence ends there, the second fills the cache."""
        from repro_torch.kernels.flash_decode.ops import _chunk_rows

        tile, chunk = simt_tile(dh, dtype)[1], _chunk_rows(dh, dtype)
        n = {"1": 1, "T-1": tile - 1, "T": tile, "T+1": tile + 1, "chunk-1": chunk - 1,
             "chunk+1": chunk + 1}[at]
        s = chunk + 2 * tile
        q, k, v, _ = (torch.from_numpy(a).cuda() for a in decode_inputs(2, s, 2, g, dh, seed=8))
        kv_len = torch.tensor([n, s], dtype=torch.int32, device="cuda")
        self.check_simt(q, k.to(dtype), v.to(dtype), kv_len)

    @pytest.mark.parametrize("g", range(1, 9))
    def test_flash_decode_simt_every_group(self, g):
        """Every grouping G of 1-8 query heads a KV head at Qwen3-32B's f32
        dh 80: head groups of a tile that hold fewer heads than others, and
        (head, word) pairs past G L in the last lanes."""
        q, k, v, kv_len = (torch.from_numpy(a).cuda()
                           for a in decode_inputs(3, 1100, 2, g, 80, seed=9))
        self.check_simt(q, k, v, kv_len)

    @pytest.mark.parametrize("cap", [None, 50.0], ids=str)
    @pytest.mark.parametrize("g,dh", [(8, 80), (2, 144), (3, 64)], ids=["dh80", "dh144", "dh64"])
    def test_flash_decode_simt_large_q(self, g, dh, cap):
        """f32 query heads of norm 30 (peaked scores: the running max moves
        late and exp underflows) on the CUDA-core route."""
        q, k, v, kv_len = (torch.from_numpy(a).cuda()
                           for a in decode_inputs(2, 700, 2, g, dh, seed=6, q_norm=30.0))
        self.check_simt(q, k, v, kv_len, cap)

    @pytest.mark.parametrize("g,dh", [(4, 24), (8, 24), (2, 72), (8, 72)])
    def test_flash_decode_simt_bf16_odd_widths_softcap(self, g, dh):
        """bf16 rows of 3 and 9 16-byte words (dh 24, 72) with softcap 50."""
        q, k, v, kv_len = (torch.from_numpy(a).cuda()
                           for a in decode_inputs(2, 900, 2, g, dh, seed=10))
        self.check_simt(q, k.to(torch.bfloat16), v.to(torch.bfloat16), kv_len, 50.0)

    @pytest.mark.parametrize("cap", [None, 50.0], ids=str)
    @pytest.mark.parametrize("dh", [64, 128, 144])
    def test_flash_decode_mma_large_q(self, dh, cap):
        """Query heads of norm 30 (peaked scores, large products): the
        tensor-core route's bf16 hi/lo split of q and p keeps f32 accuracy."""
        q, k, v, kv_len = (torch.from_numpy(a).cuda()
                           for a in decode_inputs(2, 700, 2, 5, dh, seed=6, q_norm=30.0))
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        got = flash_decode(q, k, v, kv_len, softcap=cap)
        torch.testing.assert_close(got, flash_decode_ref(q, k, v, kv_len, softcap=cap),
                                   rtol=2e-4, atol=2e-5)
