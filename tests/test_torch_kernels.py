"""The port's four kernel wrappers against the JAX reference kernels.

The same numpy-seeded inputs (B in {16, 128, 512}, a ragged Q, some
all-SENTINEL rows) go through ``repro``'s function — its Pallas kernel in
interpret mode on the CPU, as ``tests/test_kernels.py`` runs it — and the
port's function on CPU tensors, which takes the plain PyTorch version.
Leaf search and intersect must match bitwise; scan-reduce within
rtol=atol=1e-5 and SpMM within 1e-4 (the sums run in another order).

``TestKernelsOnCard`` holds each CUDA kernel against its plain version on
the card and skips where torch sees no CUDA device.
"""

import numpy as np
import pytest

import torch

from repro_torch.kernels.intersect import intersect_count, intersect_count_hybrid
from repro_torch.kernels.intersect.ref import intersect_count_ref
from repro_torch.kernels.leaf_search import leaf_search
from repro_torch.kernels.leaf_search.ref import leaf_search_ref
from repro_torch.kernels.spmm import leaf_scan_reduce, leaf_spmm
from repro_torch.kernels.spmm.ref import leaf_scan_reduce_ref, leaf_spmm_ref

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


@pytest.fixture(scope="module")
def ref():
    """The reference kernels, imported here so that the card-only class
    below collects where JAX is not installed."""
    from types import SimpleNamespace

    from repro.kernels.intersect import intersect_count, intersect_count_hybrid
    from repro.kernels.leaf_search import leaf_search
    from repro.kernels.spmm import leaf_scan_reduce, leaf_spmm

    return SimpleNamespace(
        leaf_search=leaf_search, scan=leaf_scan_reduce, spmm=leaf_spmm,
        intersect=intersect_count, hybrid=intersect_count_hybrid,
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
def test_leaf_scan_reduce_matches_reference(ref, b):
    rows, x, _ = gather_inputs(b)
    want = np.asarray(ref.scan(rows, x))
    got = leaf_scan_reduce(torch.from_numpy(rows), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


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


def test_launch_counter_is_exact_across_threads():
    import threading

    from repro_torch.kernels.runtime import count_launch

    def wrapper():
        pass

    wrapper.launches = 0

    def bump():
        for _ in range(20000):
            count_launch(wrapper)

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrapper.launches == 80000


def test_other_devices_raise():
    rows = torch.zeros((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        leaf_search(rows, torch.zeros(4, dtype=torch.int32, device="meta"))


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
    def test_leaf_scan_reduce(self, b):
        rows, x, _ = (torch.from_numpy(a).cuda() for a in gather_inputs(b))
        got = leaf_scan_reduce(rows, x)
        torch.testing.assert_close(got, leaf_scan_reduce_ref(rows, x),
                                   rtol=1e-5, atol=1e-5)

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
