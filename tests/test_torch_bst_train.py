"""BST training on the port against the JAX reference on the CPU.

The reference's parameters (norms and biases moved off their initial values
by seeded noise) are carried across with ``repro_torch.models.params``;
batches come from ``RecsysBatches`` with a seed.  ``embedding_lookup`` sends
the lookup through ``embedding_bag`` (its plain version on the CPU) with a
backward of its own: the looked-up rows' gradients added into a zero table
gradient, what autodiff of the reference's ``table[ids]`` gives.  In f32:

- the lookup's table gradient against the reference's within 1e-6, with
  repeated and absent ids;
- one ``make_bst_train_step`` step: the loss (rtol 1e-6) and every gradient
  leaf within 1e-5 of its largest magnitude, then every parameter within
  ``PARAM_STEP_TOL`` learning rates and every moment within 1e-5 after it;
- the kernel route against a plain ``table[ids]`` lookup in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as RR
from repro.models import bst as RB
from repro.optim import adamw as RA
from repro.train.step import make_bst_train_step as r_make_bst_train_step

from repro_torch.configs import registry
from repro_torch.data.pipeline import RecsysBatches
from repro_torch.models import bst as B
from repro_torch.models.params import bst_params_from_numpy
from repro_torch.optim import adamw
from repro_torch.optim.tree import tree_leaves
from repro_torch.train.step import bst_value_and_grad, make_bst_train_step

NOISED = ("norm1", "norm2", "ffn_b1", "ffn_b2", "b0", "b1", "b2", "b3")
TOL = 1e-5
PARAM_STEP_TOL = 1e-2  # parameters after a step, in learning rates (AdamW normalizes)
LR = 1e-2


def numpy_tree(tree):
    return {k: numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def noised(tree, rng):
    return {k: noised(v, rng) if isinstance(v, dict)
            else v + 0.1 * rng.normal(size=v.shape).astype(v.dtype)
            if k.endswith(NOISED) else v
            for k, v in tree.items()}


def leaf_errs(got, want):
    return [float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                  / max(float(np.abs(np.asarray(b, np.float64)).max()), 1e-30))
            for a, b in zip(got, want)]


def case(batch=32):
    """(reference cfg, port cfg, numpy params, a RecsysBatches batch)."""
    rcfg, cfg = RR.get_smoke_config("bst"), registry.get_smoke_config("bst")
    tree = noised(numpy_tree(RB.init_params(rcfg, jax.random.PRNGKey(5))),
                  np.random.default_rng(2))
    data = RecsysBatches(cfg.n_items, batch, cfg.seq_len, cfg.n_other_feats, seed=3)[0]
    return rcfg, cfg, tree, data


def torch_batch(data, dtype=torch.float32):
    return [torch.from_numpy(data[k]) if data[k].dtype.kind == "i"
            else torch.from_numpy(data[k]).to(dtype)
            for k in ("hist", "target", "other", "label")]


def test_lookup_gradient_matches_reference():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(0, 20, (6, 7)).astype(np.int32)  # repeats; rows 20-49 never looked up
    cot = rng.normal(size=(6, 7, 8)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(RB.embedding_lookup(t, ids) * cot))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    out = B.embedding_lookup(t, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.detach().numpy(), table[ids])
    (got,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert not got[20:].any()


def test_bst_grads_match_reference():
    rcfg, cfg, tree, data = case()
    r_loss, r_grads = jax.value_and_grad(lambda p: RB.bst_loss(RB.forward(
        rcfg, p, data["hist"], data["target"], data["other"], compute_dtype=jnp.float32),
        data["label"]))(jax.tree.map(jnp.asarray, tree))
    params = bst_params_from_numpy(cfg, tree, device="cpu")
    loss, grads = bst_value_and_grad(cfg, params, *torch_batch(data),
                                     compute_dtype=torch.float32)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-6)
    assert max(leaf_errs(tree_leaves(grads), jax.tree.leaves(r_grads))) <= TOL


def test_bst_train_step_matches_reference():
    """One step of each package from the same state (f32 moments, as the
    LM's step test explains), then a second step of the port with the
    default bf16 moments: the loss falls on a repeated batch."""
    rcfg, cfg, tree, data = case()
    r_params = jax.tree.map(jnp.asarray, tree)
    r_opt = RA.init(r_params, moment_dtype=jnp.float32)
    r_params, r_opt, r_m = jax.jit(r_make_bst_train_step(rcfg, lr=LR,
                                                         compute_dtype=jnp.float32))(
        r_params, r_opt, data["hist"], data["target"], data["other"], data["label"])
    params = bst_params_from_numpy(cfg, tree, device="cpu")
    opt = adamw.init(params, moment_dtype=torch.float32)
    step = make_bst_train_step(cfg, lr=LR, compute_dtype=torch.float32)
    new_params, new_opt, m = step(params, opt, *torch_batch(data))
    np.testing.assert_allclose(float(m["loss"]), float(r_m["loss"]), rtol=1e-6)
    assert int(new_opt.step) == 1 and int(opt.step) == 0  # functional: the old state stays
    moved = [np.abs(a.numpy() - np.asarray(b)).max()
             for a, b in zip(tree_leaves(new_params), jax.tree.leaves(r_params))]
    assert max(moved) <= PARAM_STEP_TOL * LR
    for mine, ref in ((new_opt.mu, r_opt.mu), (new_opt.nu, r_opt.nu)):
        assert max(leaf_errs(tree_leaves(mine), jax.tree.leaves(ref))) <= TOL

    params = bst_params_from_numpy(cfg, tree, device="cpu")
    opt = adamw.init(params)
    losses = []
    for _ in range(3):
        params, opt, m = step(params, opt, *torch_batch(data))
        losses.append(float(m["loss"]))
    assert opt.mu["item_emb"].dtype == torch.bfloat16 and losses[-1] < losses[0]


def test_kernel_route_matches_plain_lookup_in_float64():
    """The autograd lookup (the kernel's plain version here) and a plain
    ``table[ids]`` give the same loss and gradients: the table stays f32,
    the kernel's type, and every other leaf is float64."""
    _, cfg, tree, data = case(batch=16)
    params = bst_params_from_numpy(cfg, tree, device="cpu", dtype=torch.float64)
    params["item_emb"] = params["item_emb"].float()
    batch = torch_batch(data, torch.float64)
    plain = lambda t, ids: t[ids.long()]  # noqa: E731
    a = bst_value_and_grad(cfg, params, *batch, compute_dtype=torch.float64)
    b = bst_value_and_grad(cfg, params, *batch, lookup_fn=plain, compute_dtype=torch.float64)
    assert a[0].dtype == torch.float64 and a[1]["item_emb"].dtype == torch.float32
    np.testing.assert_allclose(float(a[0]), float(b[0]), rtol=1e-14)
    assert max(leaf_errs(tree_leaves(a[1]), tree_leaves(b[1]))) <= 1e-6
