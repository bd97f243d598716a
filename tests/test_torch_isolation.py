"""The port stands alone, refuses to run on the host by accident, and keeps
the device-cache contracts of the reference: zero uploads on a warm
repeat, O(dirty) uploads after a write, and a splice that never changes
an older pinned view's tensors."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _parity import rand_edges

from repro_torch.core import RapidStore, device_cache, view_assembler
from repro_torch.kernels.leaf_search import edge_search_view
from repro_torch.kernels.spmm import leaf_scan_reduce_view, leaf_spmm_view

SRC = Path(__file__).resolve().parents[1] / "src"
KW = dict(partition_size=16, B=16, high_threshold=8)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("imported", sum(1 for n in sys.modules if n.startswith("repro_torch")))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20


def test_store_without_device_raises_when_cuda_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RapidStore.from_edges(32, rand_edges(32, 100), **KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RapidStore(32, **KW)


def test_views_and_outputs_live_on_store_device():
    store = RapidStore.from_edges(96, rand_edges(96, 900, 1), device="cpu", **KW)
    assert store.device == torch.device("cpu")
    with store.read_view() as view:
        assert view.device == store.device
        blocks = view.to_leaf_blocks_device()
        src, dst = view.to_coo_device()
        assert blocks.rows.dtype == src.dtype == dst.dtype == torch.int32
        assert leaf_scan_reduce_view(view, torch.ones(96)).device == store.device


def test_warm_repeat_uploads_nothing_and_writes_upload_only_dirty():
    store = RapidStore.from_edges(96, rand_edges(96, 900, 1), device="cpu", **KW)
    x, h = torch.ones(96), torch.ones((96, 4))
    with store.read_view() as view:
        leaf_scan_reduce_view(view, x)
        view.to_coo_device()
    with store.read_view() as view:
        before = device_cache.stats.uploads
        leaf_scan_reduce_view(view, x)
        leaf_spmm_view(view, h)
        edge_search_view(view, [1, 2], [3, 4])
        view.to_coo_device()
        assert device_cache.stats.uploads == before
    store.insert_edges(np.array([[17, 3], [18, 4]]))  # subgraph 1 only
    with store.read_view() as view:
        before = device_cache.stats.uploads
        leaf_scan_reduce_view(view, x)
        view.to_coo_device()
        # one dirty snapshot: 3 stream arrays + 2 COO arrays
        assert device_cache.stats.uploads - before == 5


def test_splice_never_changes_older_pinned_view():
    store = RapidStore.from_edges(96, rand_edges(96, 900, 1), device="cpu", **KW)
    old = store.begin_read()
    rows_old = old.view.to_leaf_blocks_device().rows
    kept = rows_old.clone()
    store.end_read(old)  # retired: the next view splices from its bundle
    src, dst = old.view.to_coo_uncached()
    u, v = int(src[src >= 16][0]), int(dst[src >= 16][0])
    # swap one neighbour of u for another: same leaf count, so the splice
    # patches the predecessor's columns instead of re-concatenating
    new_v = next(w for w in range(96) if w != u and not old.view.search(u, w))
    store.apply(np.array([[u, new_v]]), np.array([[u, v]]))
    splices = view_assembler.stats.splices
    with store.read_view() as view:
        rows_new = view.to_leaf_blocks_device().rows
        assert view_assembler.stats.splices == splices + 1
        assert rows_new.shape == rows_old.shape
        assert np.array_equal(rows_new.numpy(), view.to_leaf_blocks_uncached().rows)
    assert torch.equal(rows_old, kept)
    assert not torch.equal(rows_new, kept)


def test_tiered_blocks_unified_twin_matches_oracle():
    store = RapidStore.from_edges(96, rand_edges(96, 900, 1), device="cpu",
                                  leaf_tiers=(8, 16), **KW)
    with store.read_view() as view:
        dev = view.to_leaf_blocks_device()
        want = view.to_leaf_blocks_uncached()
        assert sorted(dev.groups) == [8, 16]
        assert np.array_equal(dev.rows.numpy(), want.rows)
        assert np.array_equal(dev.src.numpy(), want.src)
        assert np.array_equal(dev.length.numpy(), want.length)
