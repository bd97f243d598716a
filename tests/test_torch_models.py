"""The port's model layer against the JAX reference on the CPU.

Parameters come from ``repro``'s own ``init_params``, with the norms and
biases (ones and zeros there) moved off their initial values by seeded
numpy noise, and are carried across with ``repro_torch.models.params``;
inputs are made with numpy from a seed.  Both packages then compute on the same weights:

- LM decode (the SMOKE configs of Qwen2.5, Qwen3 and Gemma-2): logits of
  12 greedy steps (past Gemma-2's SMOKE window of 8) within rtol=atol=3e-4 in f32, as
  ``tests/test_models_lm.py::test_decode_matches_forward`` holds decode to
  forward; the port through its plain attention and, for the global-only
  configs, through the flash-decode route.
- BST (its SMOKE config): ``forward``, ``user_tower`` and
  ``retrieval_scores`` within rtol=atol=1e-5 in f32; in bf16 (the
  reference's default compute type) within rtol=atol=2e-2, since the two
  frameworks round the same products to bf16 at different points.
- the serving launcher with ``--smoke --device cpu``.
"""

import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.models import bst as B
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.models.params import bst_params_from_numpy, lm_params_from_numpy
from repro_torch.serve.decode import (flash_attn_fn, make_decode_step, make_flash_attn_fn,
                                      make_serve_attn_fn)

GLOBAL_ARCHS = ["qwen2.5-14b", "qwen3-32b"]
DENSE_ARCHS = GLOBAL_ARCHS + ["gemma2-27b"]
STEPS = 12
NOISED = ("norm", "norm1", "norm2", "bq", "bk", "bv", "ffn_b1", "ffn_b2", "b0", "b1", "b2")


def numpy_tree(tree):
    return {k: numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def noised(tree, rng):
    """``tree`` (numpy leaves) with every norm and bias leaf moved by 0.1 N(0, 1)."""
    return {k: noised(v, rng) if isinstance(v, dict)
            else v + 0.1 * rng.normal(size=v.shape).astype(v.dtype)
            if k.endswith(NOISED) else v
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def lm_reference(arch):
    """(cfg, numpy params, the reference's greedy tokens [B, STEPS + 1] and
    logits [STEPS, B, V]) for ``arch``'s SMOKE config, f32 throughout."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as R
    from repro.models import transformer as RT

    cfg = R.get_smoke_config(arch)
    tree = noised(numpy_tree(RT.init_params(cfg, jax.random.PRNGKey(0))),
                  np.random.default_rng(9))
    params = jax.tree.map(jnp.asarray, tree)
    step = jax.jit(functools.partial(RT.decode_step, cfg, compute_dtype=jnp.float32))
    b = 2
    cache = RT.init_cache(cfg, b, STEPS + 4, dtype=jnp.float32)
    tok = np.random.default_rng(5).integers(0, cfg.vocab, (b, 1)).astype(np.int32)
    toks, logits = [tok], []
    for t in range(STEPS):
        lg, cache = step(params, toks[-1], cache, jnp.int32(t))
        logits.append(np.asarray(lg))
        toks.append(np.asarray(jnp.argmax(lg, -1)).astype(np.int32)[:, None])
    return cfg, tree, np.concatenate(toks, 1), np.stack(logits)


def port_logits(arch, attn_fn):
    """The port's logits on the reference's tokens and weights."""
    _, tree, toks, _ = lm_reference(arch)
    cfg = registry.get_smoke_config(arch)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    cache = T.init_cache(cfg, toks.shape[0], STEPS + 4, dtype=torch.float32, device="cpu")
    out = []
    for t in range(STEPS):
        lg, cache = T.decode_step(cfg, params, torch.from_numpy(toks[:, t:t + 1]), cache, t,
                                  compute_dtype=torch.float32, attn_fn=attn_fn)
        out.append(lg.numpy())
    return np.stack(out)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_step_matches_reference(arch):
    want = lm_reference(arch)[3]
    np.testing.assert_allclose(port_logits(arch, None), want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("arch", GLOBAL_ARCHS)
def test_flash_decode_route_matches_reference(arch):
    want = lm_reference(arch)[3]
    np.testing.assert_allclose(port_logits(arch, flash_attn_fn), want, rtol=3e-4, atol=3e-4)


def test_flash_attn_fn_groups_heads_as_reference():
    """Head h belongs to KV head h // G (q.reshape(b, kv, g, dh)), the live
    length is pos + 1, and the result is decode_attention_ref's."""
    rng = np.random.default_rng(6)
    b, s, kv, g, dh, pos = 2, 40, 2, 5, 128, 29
    q = torch.from_numpy(rng.normal(size=(b, 1, kv * g, dh)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, s, kv, dh)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, s, kv, dh)).astype(np.float32))
    for cap in (None, 50.0):
        got = flash_attn_fn(q, k, v, pos, s, cap)
        want = T.decode_attention_ref(q, k, v, pos, s, cap)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    seen = []

    def spy(qg, k_, v_, kv_len, softcap=None):
        seen.append((qg, kv_len))
        return flash_decode_ref(qg, k_, v_, kv_len, softcap=softcap)

    make_flash_attn_fn(spy)(q, k, v, pos, s, None)
    qg, kv_len = seen[0]
    assert torch.equal(qg[:, 1, 2], q[:, 0, 1 * g + 2])
    assert kv_len.tolist() == [pos + 1] * b


def test_flash_route_refuses_sliding_window_layers():
    cfg = registry.get_smoke_config("gemma2-27b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = T.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="sliding-window"):
        T.decode_step(cfg, params, torch.zeros((1, 1), dtype=torch.int32), cache, 0,
                      compute_dtype=torch.float32, attn_fn=flash_attn_fn)


def test_decode_step_writes_the_cache_in_place():
    cfg = registry.get_smoke_config("qwen2.5-14b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = T.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    k = cache["k"]
    _, out = T.decode_step(cfg, params, torch.ones((2, 1), dtype=torch.int32), cache, 3,
                           compute_dtype=torch.float32)
    assert out is cache and out["k"] is k
    assert k[:, :, 3].abs().sum() > 0
    assert k[:, :, :3].abs().sum() == 0 and k[:, :, 4:].abs().sum() == 0


@pytest.mark.parametrize("make", [
    lambda cfg, bst, g: T.init_cache(cfg, 1, 8, dtype=torch.float32),
    lambda cfg, bst, g: T.init_params(cfg, g),
    lambda cfg, bst, g: B.init_params(bst, g),
    lambda cfg, bst, g: C.dense_init(g, (4, 4)),
    lambda cfg, bst, g: C.embed_init(g, (4, 4)),
    lambda cfg, bst, g: lm_params_from_numpy(cfg, {}),
    lambda cfg, bst, g: bst_params_from_numpy(bst, {}),
], ids=["init_cache", "lm_init_params", "bst_init_params", "dense_init", "embed_init",
        "lm_params_from_numpy", "bst_params_from_numpy"])
def test_model_state_without_device_raises(make):
    """Caches and parameters name their device: without one they cannot
    land on the host by default."""
    cfg = registry.get_smoke_config("qwen2.5-14b")
    bst = registry.get_smoke_config("bst")
    with pytest.raises(TypeError, match="device"):
        make(cfg, bst, torch.Generator().manual_seed(0))


def leaf_kinds(tree):
    """Each leaf's shape and whether it is all 0, all 1 or drawn."""
    def kind(a):
        a = np.asarray(a, np.float32)
        return (a.shape, "0" if not a.any() else "1" if (a == 1).all() else "drawn")

    return {k: leaf_kinds(v) if isinstance(v, dict) else kind(v) for k, v in tree.items()}


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_init_params_match_reference_layout_and_count(arch):
    import jax

    from repro.configs import registry as R
    from repro.models import transformer as RT

    cfg = registry.get_smoke_config(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    want = RT.init_params(R.get_smoke_config(arch), jax.random.PRNGKey(0))
    assert leaf_kinds(numpy_tree(params)) == leaf_kinds(numpy_tree(want))
    assert C.count_params(params) == cfg.n_params


def test_params_bridge_rejects_mismatched_trees():
    _, tree, _, _ = lm_reference("qwen2.5-14b")
    cfg = registry.get_smoke_config("qwen2.5-14b")
    with pytest.raises(KeyError):
        lm_params_from_numpy(cfg, {k: v for k, v in tree.items() if k != "final_norm"},
                             device="cpu")
    bad = dict(tree, final_norm=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_numpy(cfg, bad, device="cpu")


# ---------------------------------------------------------------------------
# shared blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_common_blocks_match_reference(dtype):
    import jax.numpy as jnp

    from repro.models import common as RC

    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
    w = rng.normal(size=16).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 3)).astype(np.int32)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    for zc in (False, True):
        want = RC.rms_norm(jx, jnp.asarray(w, dtype), 1e-6, zc)
        got = C.rms_norm(tx, torch.from_numpy(w).to(tx.dtype), 1e-6, zc)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    js, jc = RC.make_rope(jnp.asarray(pos), 16, 1e6)
    ts, tc = C.make_rope(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    want = RC.apply_rope(jx, js, jc)
    got = C.apply_rope(tx, ts, tc)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    for name in ("silu", "gelu", "gelu_tanh", "relu"):
        np.testing.assert_allclose(
            C.activation(name)(tx).float().numpy(),
            np.asarray(RC.activation(name)(jx), np.float32), **tol)
    np.testing.assert_allclose(C.softcap(tx, 0.5).float().numpy(),
                               np.asarray(RC.softcap(jx, 0.5), np.float32), **tol)


def test_dense_init_is_truncated_and_fan_in_scaled():
    g = torch.Generator().manual_seed(2)
    t = C.dense_init(g, (256, 512), device="cpu")
    std = 1.0 / math.sqrt(256)
    assert t.abs().max() <= 2.0 * std * (1 + 1e-6)
    # a normal truncated at +-2 sigma has std 0.8796 sigma
    assert abs(float(t.std()) / std - 0.8796) < 0.01
    again = C.dense_init(torch.Generator().manual_seed(2), (256, 512), device="cpu")
    assert torch.equal(t, again)


def one_draw(g, shape, kind):
    """The whole leaf drawn at once in f32 (``torch.randn`` or
    ``trunc_normal_``, fan-in scaled)."""
    if kind == "embed":
        return torch.randn(shape, generator=g, dtype=torch.float32).mul_(0.02)
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
    return t.mul_(1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1]))


def block_draw(g, shape, kind, rows, dtype):
    """Each block of ``rows`` slices of the leading axis drawn in f32 in
    turn from ``g`` (the whole leaf's fan-in scale) and cast."""
    std = 1.0 / math.sqrt(shape[-2])
    parts = []
    for i in range(0, shape[0], rows):
        t = torch.empty((min(rows, shape[0] - i), *shape[1:]), dtype=torch.float32)
        if kind == "embed":
            t.normal_(generator=g).mul_(0.02)
        else:
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
            t.mul_(std)
        parts.append(t.to(dtype))
    return torch.cat(parts)


INIT = {"dense": lambda g, shape, dtype: C.dense_init(g, shape, dtype=dtype, device="cpu"),
        "embed": lambda g, shape, dtype: C.embed_init(g, shape, dtype, device="cpu")}


@pytest.mark.parametrize("kind,shape", [("dense", (3, 17, 19)), ("dense", (7,)),
                                        ("dense", (256, 512)), ("embed", (40, 8)),
                                        ("embed", (3, 5, 7))], ids=str)
def test_init_in_f32_is_one_draw_of_the_leaf(kind, shape):
    """An f32 leaf is one draw of the whole leaf, bitwise."""
    got = INIT[kind](torch.Generator().manual_seed(4), shape, torch.float32)
    assert torch.equal(got, one_draw(torch.Generator().manual_seed(4), shape, kind))


@pytest.mark.parametrize("block", [17 * 19, 3 * 17 * 19, 2 * 17 * 19 + 5], ids=str)
@pytest.mark.parametrize("kind,shape", [("dense", (5, 17, 19)), ("embed", (5, 17, 19)),
                                        ("dense", (5, 323)), ("embed", (5, 323))], ids=str)
def test_init_in_bf16_is_its_f32_draw_cast_block_by_block(kind, shape, block, monkeypatch):
    """A bf16 leaf is allocated in bf16 and drawn in f32 a block of whole
    leading-axis slices at a time (``DRAW_BLOCK`` elements), each block
    cast into place: equal, slice for slice, to drawing those blocks in
    turn in f32 and casting them; the fan-in scale stays the whole
    leaf's."""
    monkeypatch.setattr(C, "DRAW_BLOCK", block)
    got = INIT[kind](torch.Generator().manual_seed(4), shape, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    rows = max(1, block // (17 * 19))
    want = block_draw(torch.Generator().manual_seed(4), shape, kind, rows, torch.bfloat16)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# BST
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def bst_case():
    import jax

    from repro.configs import registry as R
    from repro.models import bst as RB

    cfg = R.get_smoke_config("bst")
    rng = np.random.default_rng(8)
    b = 6
    inputs = dict(
        hist=rng.integers(0, cfg.n_items, (b, cfg.seq_len)).astype(np.int32),
        target=rng.integers(0, cfg.n_items, b).astype(np.int32),
        feats=rng.normal(size=(b, cfg.n_other_feats)).astype(np.float32),
        cands=rng.integers(0, cfg.n_items, 50).astype(np.int32),
    )
    tree = noised(numpy_tree(RB.init_params(cfg, jax.random.PRNGKey(3))), rng)
    return cfg, tree, inputs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bst_serving_matches_reference(dtype):
    import jax
    import jax.numpy as jnp

    from repro.models import bst as RB

    cfg, tree, x = bst_case()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    params = bst_params_from_numpy(registry.get_smoke_config("bst"), tree, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    t = {k: torch.from_numpy(v) for k, v in x.items()}

    want = RB.forward(cfg, jp, x["hist"], x["target"], x["feats"], compute_dtype=jd)
    got = B.forward(cfg, params, t["hist"], t["target"], t["feats"], compute_dtype=td)
    assert got.dtype == torch.float32 and got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)

    want_u = RB.user_tower(cfg, jp, x["hist"][:1], x["feats"][:1], compute_dtype=jd)
    got_u = B.user_tower(cfg, params, t["hist"][:1], t["feats"][:1], compute_dtype=td)
    assert got_u.dtype == td
    np.testing.assert_allclose(got_u.float().numpy(), np.asarray(want_u, np.float32), **tol)

    want_s = RB.retrieval_scores(cfg, jp, want_u, x["cands"], compute_dtype=jd)
    got_s = B.retrieval_scores(cfg, params, got_u, t["cands"], compute_dtype=td)
    assert got_s.dtype == torch.float32 and got_s.shape == (50,)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **tol)

    labels = (np.arange(6) % 2).astype(np.float32)
    np.testing.assert_allclose(
        B.bst_loss(got, torch.from_numpy(labels)).item(),
        float(RB.bst_loss(want, jnp.asarray(labels))), **tol)


def test_bst_user_tower_lookup_fn_route_agrees():
    """The mean bag and the injected-lookup route compute the same tower."""
    cfg, tree, x = bst_case()
    params = bst_params_from_numpy(cfg, tree, device="cpu")
    hist = torch.from_numpy(x["hist"])
    bag = B.user_tower(cfg, params, hist, None, compute_dtype=torch.float32)
    looked = B.user_tower(cfg, params, hist, None, lookup_fn=B.embedding_lookup,
                          compute_dtype=torch.float32)
    torch.testing.assert_close(bag, looked, rtol=1e-6, atol=1e-7)


def test_bst_init_params_match_reference_layout():
    import jax

    from repro.models import bst as RB

    cfg, _, _ = bst_case()
    params = B.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = RB.init_params(cfg, jax.random.PRNGKey(3))
    assert leaf_kinds(numpy_tree(params)) == leaf_kinds(numpy_tree(want))


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
def test_serve_main_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main

    res = main(["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu",
                "--prompt-len", "6", "--decode-tokens", "5", "--max-seq", "16"])
    assert "tok/s" in capsys.readouterr().out
    cfg = res["cfg"]
    assert res["tokens"].shape == (4, 6) and res["pos"] == 11
    assert res["tokens"].min() >= 0 and res["tokens"].max() < cfg.vocab
    assert torch.isfinite(res["logits"]).all()
    # the same greedy loop through the plain attention gives the same tokens
    cache = T.init_cache(cfg, 4, 16, dtype=torch.float32, device="cpu")
    step = make_decode_step(cfg, compute_dtype=torch.float32)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(4, 6), dtype=np.int32))
    for t in range(6):
        _, nxt, cache = step(res["params"], cache, prompt[:, t:t + 1], t)
    toks = [nxt[:, None]]
    for i in range(5):
        _, nxt, cache = step(res["params"], cache, toks[-1], 6 + i)
        toks.append(nxt[:, None])
    assert torch.equal(torch.cat(toks, 1), res["tokens"])
    torch.testing.assert_close(cache["k"], res["cache"]["k"], rtol=1e-5, atol=1e-6)


def test_serve_main_decodes_gemma2_as_the_reference():
    """Gemma-2's SMOKE config through the launcher at its defaults (cache
    128, past the local window of 8): the reference's decode loop on the
    same parameters gives the same tokens, and the prompt's and the last
    step's logits within rtol=atol=3e-4."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as R
    from repro.models import transformer as RT
    from repro.serve.decode import make_decode_step as ref_decode_step
    from repro_torch.launch.serve import main

    res = main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu"])
    cfg = R.get_smoke_config("gemma2-27b")
    assert res["cfg"].local_window < 128
    params = jax.tree.map(lambda p: jnp.asarray(p.numpy()), res["params"])
    step = jax.jit(ref_decode_step(cfg, compute_dtype=jnp.float32))
    cache = RT.init_cache(cfg, 4, 128, dtype=jnp.float32)
    prompt = res["prompt"].numpy()
    for t in range(prompt.shape[1]):
        logits, nxt, cache = step(params, cache, prompt[:, t:t + 1], jnp.int32(t))
    np.testing.assert_allclose(res["prompt_logits"].numpy(), np.asarray(logits),
                               rtol=3e-4, atol=3e-4)
    toks = [np.asarray(nxt)[:, None]]
    for i in range(res["tokens"].shape[1] - 1):
        logits, nxt, cache = step(params, cache, toks[-1], jnp.int32(prompt.shape[1] + i))
        toks.append(np.asarray(nxt)[:, None])
    assert np.array_equal(np.concatenate(toks, 1), res["tokens"].numpy())
    np.testing.assert_allclose(res["logits"].numpy(), np.asarray(logits), rtol=3e-4, atol=3e-4)


def test_serve_attn_fn_routes_global_layers_to_the_kernel():
    """The launcher's route, chosen per layer before any call: Gemma-2's
    global layers go to the flash-decode route, its local layers (window 8
    below the 16-row cache) to ``decode_attention_ref``; Qwen2.5's layers
    are all global."""
    for arch in ("gemma2-27b", "qwen2.5-14b"):
        cfg = registry.get_smoke_config(arch)
        params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        cache = T.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
        seen = []

        def spy(name, fn):
            def attn(q, k, v, pos, window, cap):
                seen.append((name, window))
                return fn(q, k, v, pos, window, cap)
            return attn

        attn_fn = make_serve_attn_fn(spy("flash", flash_attn_fn),
                                     spy("plain", T.decode_attention_ref))
        tok = torch.zeros((2, 1), dtype=torch.int32)
        for pos in range(10):
            T.decode_step(cfg, params, tok, cache, pos, compute_dtype=torch.float32,
                          attn_fn=attn_fn)
        local = T.layer_is_local(cfg)
        want = [("plain", cfg.local_window) if loc else ("flash", 16) for loc in local] * 10
        assert seen == want
        assert ("plain" in dict(seen)) == (arch == "gemma2-27b")


# the serve launcher's f32 route at the full-width heads, two layers:
# Gemma-2-27B's (dh 144, 4 heads over 2 KV heads, window 8, softcaps 50/30)
# and Qwen3-32B's (dh 80, 8 heads over 1 KV head, qk-norm)
WIDE_HEADS = {"gemma2-27b": dict(d_head=144, n_heads=4, n_kv_heads=2, local_window=8),
              "qwen3-32b": dict(d_head=80, n_heads=8, n_kv_heads=1)}


@pytest.mark.parametrize("arch", sorted(WIDE_HEADS))
def test_serve_decode_at_full_width_heads_matches_reference(arch):
    """``make_decode_step`` with ``serve_attn_fn`` in f32 (the kernel's
    "simt" route on the card; its plain version here) against the
    reference's ``make_decode_step`` on the same parameters, 12 greedy
    steps on a 16-row cache (past Gemma-2's window): logits within
    rtol=atol=3e-4, the same tokens."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import registry as R
    from repro.models import transformer as RT
    from repro.serve.decode import make_decode_step as ref_decode_step
    from repro_torch.kernels.flash_decode import route
    from repro_torch.serve.decode import serve_attn_fn

    rcfg = dataclasses.replace(R.get_smoke_config(arch), **WIDE_HEADS[arch])
    cfg = dataclasses.replace(registry.get_smoke_config(arch), **WIDE_HEADS[arch])
    assert route(torch.float32, cfg.d_head) == "simt"
    tree = noised(numpy_tree(RT.init_params(rcfg, jax.random.PRNGKey(1))),
                  np.random.default_rng(9))
    rstep = jax.jit(ref_decode_step(rcfg, compute_dtype=jnp.float32))
    rcache = RT.init_cache(rcfg, 2, 16, dtype=jnp.float32)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    step = make_decode_step(cfg, torch.float32, attn_fn=serve_attn_fn)
    cache = T.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    tok = np.random.default_rng(5).integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    params_j = jax.tree.map(jnp.asarray, tree)
    for t in range(STEPS):
        want, rnext, rcache = rstep(params_j, rcache, tok, jnp.int32(t))
        got, nxt, cache = step(params, cache, torch.from_numpy(tok), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4, atol=3e-4)
        assert np.array_equal(nxt.numpy(), np.asarray(rnext))
        tok = np.array(rnext)[:, None]


@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen3-32b"])
def test_prefill_step_matches_reference_and_forward(arch, monkeypatch):
    """``make_prefill_step`` on the SMOKE config, f32: the reference's
    ``make_prefill_step`` within rtol=atol=1e-5, the port's
    ``forward(...)[:, -1]`` within 1e-6 (the unembedding's f32 sums in
    another product shape); the unembedding sees the last position alone."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as R
    from repro.serve.decode import make_prefill_step as ref_prefill_step
    from repro_torch.serve.decode import make_prefill_step

    _, tree, _, _ = lm_reference(arch)
    cfg = registry.get_smoke_config(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want = jax.jit(ref_prefill_step(R.get_smoke_config(arch), compute_dtype=jnp.float32,
                                    attn_chunk=4))(jax.tree.map(jnp.asarray, tree), toks)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    seen = []
    unembed = T._logits

    def spy(cfg_, params_, x, cd):
        seen.append(x.shape[1])
        return unembed(cfg_, params_, x, cd)

    monkeypatch.setattr(T, "_logits", spy)
    got = make_prefill_step(cfg, torch.float32, attn_chunk=4)(params, torch.from_numpy(toks))
    assert seen == [1] and got.shape == (2, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        full = T.forward(cfg, params, torch.from_numpy(toks), torch.float32, attn_chunk=4)
    assert seen == [1, 16]
    torch.testing.assert_close(got, full[:, -1], rtol=1e-6, atol=1e-6)


def test_serve_main_refuses_non_lm_and_overlong_runs():
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit):
        main(["--arch", "bst", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu", "--max-seq", "40"])


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_copies_match_reference(get):
    from dataclasses import asdict

    from repro.configs import registry as R

    assert registry.arch_ids() == R.arch_ids() and registry.FAMILY == R.FAMILY
    for arch in registry.arch_ids():
        mine, ref = getattr(registry, get)(arch), getattr(R, get)(arch)
        assert type(mine).__name__ == type(ref).__name__
        assert asdict(mine) == asdict(ref)
