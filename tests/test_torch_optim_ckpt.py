"""Checkpoints of optimizer state across both packages, CPU only.

The port's checkpoint manager writes the reference's file format: a tree
that holds a ``NamedTuple`` (AdamW's state) names its fields ``.<field>``
as JAX's ``GetAttrKey`` does, and comes back as the same ``NamedTuple``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as rckpt
from repro.optim import adamw as RA

from repro_torch.checkpoint import manager as tckpt
from repro_torch.models.params import adamw_state_from_numpy
from repro_torch.optim import adamw as TA
from repro_torch.optim.tree import tree_leaves, tree_map


def numpy_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"gnn": {"layer0": {"eps": np.float32(0.25),
                               "w0": rng.normal(size=(3, 4)).astype(np.float32)}},
            "head": {"w": rng.normal(size=(4, 2)).astype(np.float32),
                     "b": np.zeros(2, np.float32)}}


def reference_tree(seed=0):
    """(params, AdamWState) after two updates, bf16 moments."""
    params = jax.tree.map(jnp.asarray, numpy_params(seed))
    opt = RA.init(params)
    rng = np.random.default_rng(seed + 1)
    for _ in range(2):
        g = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), params)
        params, opt = RA.update(g, opt, params, 1e-2)
    return params, opt


def port_tree(ref):
    params = tree_map(lambda x: torch.tensor(np.asarray(x)), jax.tree.map(np.asarray, ref[0]))
    opt = adamw_state_from_numpy(jax.tree.map(np.asarray, ref[1]), params, device="cpu")
    return params, opt


def test_namedtuple_keys_match_reference():
    ref = reference_tree()
    want = list(rckpt._flatten(ref))
    assert "1/.step" in want and "1/.mu/head/w" in want
    assert list(tckpt._flatten(port_tree(ref))) == want


@pytest.mark.parametrize("tree", [
    {"b": np.ones(2), "a": [np.zeros(1), (np.arange(3), np.ones((2, 2)))]},
    [np.ones(3), {"z": np.zeros(2), "y": np.ones(1)}],
    (np.ones(1), (np.zeros(2),)),
], ids=["dict", "list", "tuple"])
def test_plain_container_keys_unchanged(tree):
    assert list(tckpt._flatten(tree)) == list(rckpt._flatten(tree))


def test_port_restores_namedtuple(tmp_path):
    tree = port_tree(reference_tree())
    tckpt.save(tmp_path, 4, tree)
    (params, opt), meta = tckpt.restore(tmp_path, tree)
    assert meta["step"] == 4 and isinstance(opt, TA.AdamWState)
    assert opt.step.dtype == torch.int32 and int(opt.step) == 2
    assert opt.mu["head"]["w"].dtype == torch.bfloat16
    for got, want in zip(tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu),
                         tree_leaves(tree[0]) + tree_leaves(tree[1].mu)
                         + tree_leaves(tree[1].nu)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("writer", ("port", "reference"))
def test_adamw_checkpoint_crosses_packages(tmp_path, writer):
    """(params, AdamWState) saved by one package restores in the other with
    every leaf equal (bf16 moments bitwise)."""
    ref = reference_tree()
    port = port_tree(ref)
    if writer == "port":
        tckpt.save(tmp_path, 7, port)
        (params, opt), _ = rckpt.restore(tmp_path, ref)
        assert isinstance(opt, RA.AdamWState)
        got = [np.asarray(x, np.float64) for x in jax.tree.leaves((params, opt))]
    else:
        rckpt.save(tmp_path, 7, ref)
        (params, opt), _ = tckpt.restore(tmp_path, port)
        assert isinstance(opt, TA.AdamWState) and opt.nu["head"]["b"].dtype == torch.bfloat16
        got = [x.double().numpy() for x in
               [*tree_leaves(params), opt.step, *tree_leaves(opt.mu), *tree_leaves(opt.nu)]]
    want = [np.asarray(x).astype(np.float64) for x in jax.tree.leaves(ref)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_async_checkpointer_saves_namedtuple(tmp_path):
    tree = port_tree(reference_tree())
    saver = tckpt.AsyncCheckpointer(tmp_path)
    saver.save(1, tree)
    saver.wait()
    (_, opt), _ = tckpt.restore(tmp_path, tree)
    assert isinstance(opt, TA.AdamWState) and torch.equal(opt.nu["head"]["w"], tree[1].nu["head"]["w"])
