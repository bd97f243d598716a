"""The port's LM full-sequence path against the JAX reference on the CPU.

Parameters come from ``repro``'s own ``init_params`` (norms and biases moved
off their initial values by seeded noise) and are carried across with
``repro_torch.models.params``; inputs are made with numpy from a seed.  In
f32 both packages compute the same function with the same roundings, so:

- ``flash_attention`` (the cases of ``tests/test_models_lm.py``: GQA, a
  softcap, a window below S): the output within rtol 2e-4 / atol 2e-5 and
  the three gradients within rtol 5e-4 / atol 5e-5 (that test's limits);
  in bf16 the output within 1e-4 and each gradient within one bf16 step
  (2^-8) of its largest magnitude, since a product's order can flip one
  rounding of ``p`` or ``ds``;
- the three MoE forms, forward and gradients, within 1e-5, and capacity's
  dropped assignments (a router that sends every token to one expert);
- ``forward`` and ``lm_loss`` (``FULL_FEATURE_CFG``, the granite and grok
  SMOKE configs): logits and loss within 1e-5, every gradient leaf within
  1e-5 of its largest magnitude (measured: 2.5e-6 at most);
- ``decode_step`` with MoE against the reference's (rtol = atol = 3e-4, the
  limit of the reference's decode-vs-forward test), decode against
  ``forward`` and prefill;
- one ``make_lm_train_step`` step: loss, gradients, then the parameters
  and moments after the step; ``update_`` and ``clip_by_global_norm_``
  bitwise equal to the functional ``update`` and ``clip_by_global_norm``;
- the training launcher with ``--smoke --device cpu``, a save and a
  ``--resume``; a granite-smoke ``(params, AdamWState)`` checkpoint across
  both packages both ways.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as rckpt
from repro.configs import registry as RR
from repro.configs.base import LMConfig as RLMConfig
from repro.configs.base import MoEConfig as RMoEConfig
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.models.flash_attention import flash_attention as r_flash
from repro.optim import adamw as RA
from repro.train.step import make_lm_train_step as r_make_lm_train_step

from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs import registry
from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.models.flash_attention import flash_attention
from repro_torch.models.params import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.optim import adamw
from repro_torch.optim.clip import clip_by_global_norm, clip_by_global_norm_
from repro_torch.optim.tree import tree_leaves, tree_map
from repro_torch.serve.decode import flash_attn_fn, make_prefill_step
from repro_torch.train.step import lm_value_and_grad, make_lm_train_step

FULL_FEATURE = dict(
    name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
    d_ff=64, vocab=128, qk_norm=True, qkv_bias=True, attn_softcap=50.0,
    final_softcap=30.0, local_window=6, layer_pattern="local_global",
    post_norms=True, zero_centered_norm=True, embed_scale=True, act="gelu_tanh",
)  # tests/test_models_lm.py's FULL_FEATURE_CFG
MOE_ARCHS = ["granite-moe-3b-a800m", "grok-1-314b"]
MODELS = ["full_feature"] + MOE_ARCHS
MOE_BASE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_head=8, d_ff=64, vocab=64)
NOISED = ("norm", "bq", "bk", "bv")
# parameters after a step, absolute, in units of the step's learning rate:
# AdamW normalizes each gradient element, so an element whose gradient is
# near eps moves with its gradient's last bits (measured: 0.0034 lr)
PARAM_STEP_TOL = 1e-2
TOL = 1e-5  # f32 logits, loss and gradient leaves (of their largest magnitude)


def numpy_tree(tree):
    return {k: numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def noised(tree, rng):
    return {k: noised(v, rng) if isinstance(v, dict)
            else v + 0.1 * rng.normal(size=v.shape).astype(v.dtype)
            if k.endswith(NOISED) else v
            for k, v in tree.items()}


def leaf_errs(got, want):
    """Per leaf: largest |got - want| over the leaf's largest |want|."""
    return [float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                  / max(float(np.abs(np.asarray(b, np.float64)).max()), 1e-30))
            for a, b in zip(got, want)]


def configs(name):
    """(reference config, port config) of a model name."""
    if name == "full_feature":
        return RLMConfig(**FULL_FEATURE), LMConfig(**FULL_FEATURE)
    return RR.get_smoke_config(name), registry.get_smoke_config(name)


@functools.lru_cache(maxsize=None)
def model(name):
    """(reference config, port config, numpy params, tokens [2, 17])."""
    rcfg, cfg = configs(name)
    tree = noised(numpy_tree(RT.init_params(rcfg, jax.random.PRNGKey(0))),
                  np.random.default_rng(9))
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (2, 17)).astype(np.int32)
    return rcfg, cfg, tree, toks


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FLASH_CASES = [
    (2, 32, 2, 3, 8, None, 32, 8),  # GQA
    (1, 64, 4, 2, 16, 50.0, 64, 16),  # softcap
    (2, 48, 1, 4, 8, None, 10, 16),  # window below S
]


def flash_inputs(case):
    B, S, KV, G, dh = case[:5]
    rng = np.random.default_rng(S)
    return (rng.normal(size=(B, S, KV, G, dh)).astype(np.float32),
            rng.normal(size=(B, S, KV, dh)).astype(np.float32),
            rng.normal(size=(B, S, KV, dh)).astype(np.float32))


def flash_both(case, dtype):
    """(reference out, grads), (port out, grads) of sum(sin(attention)) in ``dtype``."""
    _, _, _, _, _, cap, win, qc = case
    jx = [jnp.asarray(a, dtype) for a in flash_inputs(case)]
    r_out = r_flash(*jx, jnp.int32(win), cap, qc, qc)
    r_grads = jax.grad(lambda *a: jnp.sum(jnp.sin(r_flash(*a, jnp.int32(win), cap, qc, qc))),
                       argnums=(0, 1, 2))(*jx)
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))
          .requires_grad_() for a in jx]
    out = flash_attention(*tx, win, cap, qc, qc)
    grads = torch.autograd.grad(torch.sum(torch.sin(out)), tx)
    as_np = lambda t: t.detach().float().numpy()  # noqa: E731
    return ((np.asarray(r_out, np.float32), [np.asarray(g.astype(jnp.float32)) for g in r_grads]),
            (as_np(out), [as_np(g) for g in grads]))


@pytest.mark.parametrize("case", FLASH_CASES, ids=["gqa", "softcap", "window"])
def test_flash_attention_matches_reference(case):
    (r_out, r_grads), (out, grads) = flash_both(case, "float32")
    np.testing.assert_allclose(out, r_out, rtol=2e-4, atol=2e-5)
    for g, rg in zip(grads, r_grads):
        np.testing.assert_allclose(g, rg, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("case", FLASH_CASES, ids=["gqa", "softcap", "window"])
def test_flash_attention_bf16_rounds_as_reference(case):
    (r_out, r_grads), (out, grads) = flash_both(case, "bfloat16")
    assert out.dtype == np.float32
    assert max(leaf_errs([out], [r_out])) <= 1e-4
    assert max(leaf_errs(grads, r_grads)) <= 2.0 ** -8


def test_flash_attention_runs_its_own_backward():
    """The gradient comes from the recomputing backward (the graph holds one
    node, not the forward's tiles), and equals autograd through the plain
    chunked loop."""
    q, k, v = (torch.from_numpy(a).double().requires_grad_() for a in flash_inputs(FLASH_CASES[2]))
    out = flash_attention(q, k, v, 10, None, 16, 16)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert out.dtype == torch.float64
    b, s, kv, g, dh = q.shape
    plain = T.chunked_attention(q.reshape(b, s, kv * g, dh), k, v, window=10, cap=None,
                                q_chunk=16, kv_chunk=16).reshape(out.shape)
    cot = torch.from_numpy(np.random.default_rng(0).normal(size=out.shape))
    for a, b_ in zip(torch.autograd.grad((out * cot).sum(), (q, k, v)),
                     torch.autograd.grad((plain * cot).sum(), (q, k, v))):
        torch.testing.assert_close(a, b_, rtol=1e-12, atol=1e-12)


def test_flash_attention_refuses_uneven_chunks():
    q, k, v = (torch.from_numpy(a) for a in flash_inputs(FLASH_CASES[2]))
    with pytest.raises(ValueError, match="divide"):
        flash_attention(q, k, v, 48, None, 32, 32)


def test_chunked_attention_matches_reference():
    B, S, KV, G, dh, cap, win, qc = FLASH_CASES[1]
    q, k, v = flash_inputs(FLASH_CASES[1])
    q = q.reshape(B, S, KV * G, dh)
    fn = lambda q_, k_, v_: RT.chunked_attention(  # noqa: E731
        q_, k_, v_, window=jnp.int32(win), cap=cap, q_chunk=qc, kv_chunk=qc)
    want = fn(q, k, v)
    want_g = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a))), argnums=(0, 1, 2))(q, k, v)
    tx = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = T.chunked_attention(*tx, window=win, cap=cap, q_chunk=qc, kv_chunk=qc)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    for g, rg in zip(torch.autograd.grad(torch.sum(torch.sin(got)), tx), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=5e-4, atol=5e-5)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def moe_case(impl, skew: bool = False, n_tokens: int = 40):
    """(reference cfg, port cfg, numpy layer weights, x [T, D]); with
    ``skew`` the router sends every token to expert 0 first."""
    kw = dict(name=impl, **MOE_BASE)
    rcfg = RLMConfig(moe=RMoEConfig(4, 2, 48, impl=impl), **kw)
    cfg = LMConfig(moe=MoEConfig(4, 2, 48, impl=impl), **kw)
    tree = numpy_tree(RT.init_params(rcfg, jax.random.PRNGKey(4)))["layers"]
    lw = {k: tree[k][0] for k in ("router", "we_gate", "we_up", "we_down")}
    x = np.random.default_rng(3).normal(size=(n_tokens, 32)).astype(np.float32)
    if skew:
        x = np.abs(x)
        lw["router"] = lw["router"].copy()
        lw["router"][:, 0] = 5.0
    return rcfg, cfg, lw, x


def moe_both(rcfg, cfg, lw, x):
    """(reference out, grads), (port out, grads) of sum(sin(moe_ffn)) in x and weights."""
    names = sorted(lw)
    r_fn = lambda w, x_: jnp.sum(jnp.sin(RM.moe_ffn(rcfg, dict(zip(names, w)), x_)))  # noqa
    jw = [jnp.asarray(lw[n]) for n in names]
    r_out = RM.moe_ffn(rcfg, dict(zip(names, jw)), jnp.asarray(x))
    r_gw, r_gx = jax.grad(r_fn, argnums=(0, 1))(jw, jnp.asarray(x))
    tw = [torch.tensor(lw[n]).requires_grad_() for n in names]
    tx = torch.from_numpy(x).requires_grad_()
    out = TM.moe_ffn(cfg, dict(zip(names, tw)), tx)
    grads = torch.autograd.grad(torch.sum(torch.sin(out)), tw + [tx])
    return ((np.asarray(r_out), [np.asarray(g) for g in list(r_gw) + [r_gx]]),
            (out.detach().numpy(), [g.numpy() for g in grads]))


@pytest.mark.parametrize("impl", ["ragged", "capacity", "dense"])
def test_moe_matches_reference(impl):
    (r_out, r_grads), (out, grads) = moe_both(*moe_case(impl))
    np.testing.assert_allclose(out, r_out, rtol=TOL, atol=TOL)
    assert max(leaf_errs(grads, r_grads)) <= TOL


def test_moe_capacity_drops_as_reference():
    """Every token picks expert 0: its 300 assignments overflow the
    capacity (ceil(600 / 4) * 1.25 = 187.5 -> 187, rounded up to 256), so
    the last 44 in the stable order (tokens 256-299) lose expert 0, and
    only they differ from the ragged form's result."""
    rcfg, cfg, lw, x = moe_case("capacity", skew=True, n_tokens=300)
    assert TM.capacity(300, cfg) == 256
    (r_out, r_grads), (out, grads) = moe_both(rcfg, cfg, lw, x)
    np.testing.assert_allclose(out, r_out, rtol=TOL, atol=TOL)
    assert max(leaf_errs(grads, r_grads)) <= TOL
    ragged = TM.moe_ffn(with_impl(cfg, "ragged"),
                        {k: torch.tensor(v) for k, v in lw.items()}, torch.from_numpy(x))
    dropped = np.abs(ragged.numpy() - out).max(axis=1) > 1e-6
    assert dropped.sum() == 300 - 256 and dropped[256:].all()


def with_impl(cfg, impl):
    from dataclasses import replace

    return replace(cfg, moe=replace(cfg.moe, impl=impl))


def test_router_matches_reference():
    rcfg, cfg, lw, x = moe_case("ragged", n_tokens=64)
    r_p, r_i = RM.router_probs(rcfg, lw, jnp.asarray(x))
    t_lw = {k: torch.tensor(v) for k, v in lw.items()}
    p, i = TM.router_probs(cfg, t_lw, torch.from_numpy(x))
    assert np.array_equal(i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(p.numpy(), np.asarray(r_p), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("skew", [False, True])
def test_load_balance_loss_matches_reference(skew):
    rcfg, cfg, lw, x = moe_case("ragged", skew=skew, n_tokens=64)
    want = float(RM.load_balance_loss(rcfg, lw, jnp.asarray(x)))
    got = TM.load_balance_loss(cfg, {k: torch.tensor(v) for k, v in lw.items()},
                               torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    if skew:  # every token picks expert 0 first: far from the balanced 1
        assert float(got) > 1.5


@pytest.mark.parametrize("n_tokens, want", [(4, 128), (8192, 2048), (32768, 8192), (1024, 256)])
def test_capacity_is_the_reference_expression(n_tokens, want):
    cfg = registry.get_config("granite-moe-3b-a800m")  # 40 experts, top-8
    assert TM.capacity(n_tokens, cfg) == want


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_params_match_reference_layout_and_count(arch):
    from repro_torch.models.common import count_params

    rcfg, cfg = configs(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    want = numpy_tree(RT.init_params(rcfg, jax.random.PRNGKey(0)))
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else tuple(np.shape(v))  # noqa
                        for k, v in t.items()}
    assert shapes(numpy_tree(params)) == shapes(want)
    assert count_params(params) == cfg.n_params
    assert torch.equal(params["layers"]["attn_norm"], torch.ones(cfg.n_layers, cfg.d_model))


@pytest.mark.parametrize("name", MODELS)
def test_forward_and_loss_match_reference(name):
    rcfg, cfg, tree, toks = model(name)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    want = RT.forward(rcfg, jtree(tree), toks[:, :-1], compute_dtype=jnp.float32, attn_chunk=8)
    got = T.forward(cfg, params, torch.from_numpy(toks[:, :-1]), compute_dtype=torch.float32,
                    attn_chunk=8)
    assert got.shape == (2, 16, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(T.lm_loss(got, torch.from_numpy(toks[:, 1:]))),
                               float(RT.lm_loss(want, toks[:, 1:])), rtol=TOL)


@pytest.mark.parametrize("name", MODELS)
def test_loss_gradients_match_reference(name):
    rcfg, cfg, tree, toks = model(name)
    r_loss, r_grads = jax.value_and_grad(lambda p: RT.lm_loss(RT.forward(
        rcfg, p, toks[:, :-1], compute_dtype=jnp.float32, attn_chunk=8), toks[:, 1:]))(jtree(tree))
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    loss, grads = lm_value_and_grad(cfg, params, torch.from_numpy(toks[:, :-1]),
                                    torch.from_numpy(toks[:, 1:]),
                                    compute_dtype=torch.float32, attn_chunk=8)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=TOL)
    assert max(leaf_errs(tree_leaves(grads), jax.tree.leaves(r_grads))) <= TOL


@pytest.mark.parametrize("name", MODELS)
def test_bf16_forward_near_reference(name):
    """bf16 rounds at the same points in both; products sum in other orders,
    so single roundings flip: logits within 3% of their largest magnitude
    (measured: 1.5%)."""
    rcfg, cfg, tree, toks = model(name)
    x = toks[:, :-1]
    want = np.asarray(RT.forward(rcfg, jtree(tree), x, attn_chunk=8).astype(jnp.float32))
    got = T.forward(cfg, lm_params_from_numpy(cfg, tree, device="cpu"), torch.from_numpy(x),
                    attn_chunk=8)
    assert got.dtype == torch.bfloat16
    assert max(leaf_errs([got.float().numpy()], [want])) <= 3e-2


@pytest.mark.parametrize("name", MODELS)
def test_remat_and_chunks_change_nothing(name):
    """``remat`` recomputes the same values (gradients bitwise); chunk 4,
    8 and the whole sequence agree within f32 rounding."""
    _, cfg, tree, toks = model(name)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    x, y = torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])
    outs = [lm_value_and_grad(cfg, params, x, y, torch.float32, attn_chunk=c)
            for c in (8, 4, -1)]
    with torch.no_grad():
        no_remat = T.lm_loss(T.forward(cfg, params, x, torch.float32, remat=False,
                                       attn_chunk=8), y)
    assert float(no_remat) == float(outs[0][0])
    for loss, grads in outs[1:]:
        np.testing.assert_allclose(float(loss), float(outs[0][0]), rtol=1e-6)
        assert max(leaf_errs(tree_leaves(grads), tree_leaves(outs[0][1]))) <= 1e-5


@functools.lru_cache(maxsize=None)
def reference_decode(name):
    """The reference's decode logits [S, B, V] on ``model(name)``'s tokens."""
    rcfg, _, tree, toks = model(name)
    step = jax.jit(functools.partial(RT.decode_step, rcfg, compute_dtype=jnp.float32))
    cache = RT.init_cache(rcfg, 2, 16, dtype=jnp.float32)
    out = []
    for t in range(16):
        lg, cache = step(jtree(tree), toks[:, t:t + 1], cache, jnp.int32(t))
        out.append(np.asarray(lg))
    return np.stack(out)


def port_decode(name, attn_fn=None):
    _, cfg, tree, toks = model(name)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    cache = T.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    out = []
    for t in range(16):
        lg, cache = T.decode_step(cfg, params, torch.from_numpy(toks[:, t:t + 1]), cache, t,
                                  compute_dtype=torch.float32, attn_fn=attn_fn)
        out.append(lg.numpy())
    return params, np.stack(out)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_reference(arch):
    _, got = port_decode(arch)
    np.testing.assert_allclose(got, reference_decode(arch), rtol=3e-4, atol=3e-4)
    _, flash = port_decode(arch, flash_attn_fn)  # the flash-decode route's plain version
    np.testing.assert_allclose(flash, got, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("name", MODELS)
def test_decode_matches_forward_and_prefill(name):
    _, cfg, tree, toks = model(name)
    params, dec = port_decode(name)
    full = T.forward(cfg, params, torch.from_numpy(toks[:, :16]), compute_dtype=torch.float32,
                     attn_chunk=4)
    np.testing.assert_allclose(dec, full.numpy().transpose(1, 0, 2), rtol=3e-4, atol=3e-4)
    last = make_prefill_step(cfg, torch.float32, attn_chunk=4)(params,
                                                               torch.from_numpy(toks[:, :16]))
    # prefill unembeds the last position alone: forward's last row up to the
    # f32 summation order of a product of another shape
    torch.testing.assert_close(last, full[:, -1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(last.numpy(), dec[-1], rtol=3e-4, atol=3e-4)


# ---------------------------------------------------------------------------
# train step and optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MODELS)
def test_lm_train_step_matches_reference(name):
    """One step from the same parameters, state and batch: loss, gradient
    norm and LR within 1e-5, every moment within 1e-5 of its leaf's
    magnitude, every parameter within ``PARAM_STEP_TOL`` learning rates of
    the reference's.  The moments are f32 here: bf16 moments round at
    the same points in both packages, but a 1e-7 difference in a gradient
    can flip one rounding and move a parameter by lr * 2^-8; the bf16
    arithmetic is held bitwise against the functional update below."""
    rcfg, cfg, tree, toks = model(name)
    r_params = jtree(tree)
    r_opt = RA.init(r_params, moment_dtype=jnp.float32)
    r_params, r_opt, r_m = jax.jit(r_make_lm_train_step(
        rcfg, compute_dtype=jnp.float32, warmup=2, total=10, peak_lr=1e-2))(
        r_params, RA.AdamWState(jnp.int32(1), r_opt.mu, r_opt.nu), toks[:, :-1], toks[:, 1:])
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    opt = adamw.init(params, moment_dtype=torch.float32)
    opt = adamw.AdamWState(torch.tensor(1, dtype=torch.int32), opt.mu, opt.nu)
    step = make_lm_train_step(cfg, compute_dtype=torch.float32, warmup=2, total=10, peak_lr=1e-2)
    new_params, new_opt, m = step(params, opt, torch.from_numpy(toks[:, :-1]),
                                  torch.from_numpy(toks[:, 1:]))
    assert new_params is params and int(new_opt.step) == 2  # updated in place
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(r_m[key]), rtol=TOL)
    for mine, ref in ((new_opt.mu, r_opt.mu), (new_opt.nu, r_opt.nu)):
        assert max(leaf_errs(tree_leaves(mine), jax.tree.leaves(ref))) <= TOL
    moved = [np.abs(a.numpy() - np.asarray(b)).max()
             for a, b in zip(tree_leaves(new_params), jax.tree.leaves(r_params))]
    assert max(moved) <= PARAM_STEP_TOL * 1e-2  # the step's lr


def random_tree(rng, dtype):
    """Stacked 4-d and 2-d leaves (sliced and whole in the in-place update)."""
    shapes = {"layers": {"we": (3, 4, 5, 6), "norm": (3, 5)}, "embed": (7, 5), "b": (5,)}
    return {"layers": {k: torch.from_numpy(rng.normal(size=s)).to(dtype)
                       for k, s in shapes["layers"].items()},
            "embed": torch.from_numpy(rng.normal(size=shapes["embed"])).to(dtype),
            "b": torch.from_numpy(rng.normal(size=shapes["b"])).to(dtype)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_in_place_update_is_bitwise_functional(dtype):
    rng = np.random.default_rng(0)
    params, grads = random_tree(rng, dtype), random_tree(rng, dtype)
    opt = adamw.init(params)
    opt = adamw.AdamWState(opt.step + 3, tree_map(lambda t: t + 0.01, opt.mu),
                           tree_map(lambda t: t + 0.02, opt.nu))
    lr = torch.tensor(3e-3)
    clipped, norm = clip_by_global_norm(grads, 0.5)
    want_p, want_s = adamw.update(clipped, opt, params, lr)
    g2 = tree_map(torch.clone, grads)
    norm2 = clip_by_global_norm_(g2, 0.5)
    assert torch.equal(norm, norm2)
    for a, b in zip(tree_leaves(g2), tree_leaves(clipped)):
        assert torch.equal(a, b)
    p2 = tree_map(torch.clone, params)
    s2 = adamw.AdamWState(opt.step, tree_map(torch.clone, opt.mu), tree_map(torch.clone, opt.nu))
    new_s = adamw.update_(g2, s2, p2, lr)
    assert int(new_s.step) == int(want_s.step) and int(s2.step) == int(opt.step)
    for got, want in ((p2, want_p), (new_s.mu, want_s.mu), (new_s.nu, want_s.nu)):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# launcher and checkpoints
# ---------------------------------------------------------------------------
def test_train_main_smoke_with_resume(tmp_path, capsys):
    """6 steps with a checkpoint every 3, then ``--resume`` to 8: the second
    run starts at 6 from the saved state (its first loss equals the loss of
    the first run's final parameters on batch 6), and the file holds those
    parameters and moments bitwise."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import main

    argv = ["--arch", "granite-moe-3b-a800m", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-every", "3", "--ckpt-dir", str(tmp_path)]
    first = main(argv + ["--steps", "6"])
    assert first["start"] == 0 and len(first["losses"]) == 6
    assert all(np.isfinite(first["losses"]))
    saved, meta = tckpt.restore(first["ckpt_dir"], (first["params"], first["opt"]))
    assert meta["step"] == 5
    for a, b in zip(tree_leaves(saved[0]) + tree_leaves(saved[1].mu) + [saved[1].step],
                    tree_leaves(first["params"]) + tree_leaves(first["opt"].mu)
                    + [first["opt"].step]):
        assert torch.equal(a, b)
    cfg = first["cfg"]
    batch = SyntheticTokens(cfg.vocab, 2, 16)[6]
    with torch.no_grad():
        want = T.lm_loss(T.forward(cfg, first["params"], torch.from_numpy(batch["tokens"]),
                                   torch.float32), torch.from_numpy(batch["targets"]))
    second = main(argv + ["--steps", "8", "--resume"])
    assert second["start"] == 6 and len(second["losses"]) == 2
    assert second["losses"][0] == float(want)
    assert "resumed from step 5" in capsys.readouterr().out
    assert tckpt.latest_step(second["ckpt_dir"]) == 7


def test_train_main_refuses_non_lm():
    from repro_torch.launch.train import main

    with pytest.raises(SystemExit):
        main(["--arch", "bst", "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("writer", ("port", "reference"))
def test_lm_checkpoint_crosses_packages(tmp_path, writer):
    """granite-smoke's (params, AdamWState) after one reference step: saved
    by one package, restored by the other, every leaf equal (bf16 moments
    bitwise)."""
    rcfg, cfg, tree, toks = model("granite-moe-3b-a800m")
    r_params = jtree(tree)
    r_opt = RA.init(r_params)
    r_params, r_opt, _ = jax.jit(r_make_lm_train_step(rcfg, compute_dtype=jnp.float32,
                                                      warmup=0, total=10))(
        r_params, r_opt, toks[:, :-1], toks[:, 1:])
    ref = (r_params, r_opt)
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, r_params), device="cpu")
    port = (params, adamw_state_from_numpy(jax.tree.map(np.asarray, r_opt), params,
                                           device="cpu"))
    assert port[1].mu["layers"]["we_gate"].dtype == torch.bfloat16
    if writer == "port":
        tckpt.save(tmp_path, 3, port)
        (p, o), _ = rckpt.restore(tmp_path, ref)
        got = [np.asarray(x, np.float64) for x in jax.tree.leaves((p, o))]
    else:
        rckpt.save(tmp_path, 3, ref)
        (p, o), _ = tckpt.restore(tmp_path, port)
        got = [x.double().numpy() for x in
               [*tree_leaves(p), o.step, *tree_leaves(o.mu), *tree_leaves(o.nu)]]
    want = [np.asarray(x).astype(np.float64) for x in jax.tree.leaves(ref)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
