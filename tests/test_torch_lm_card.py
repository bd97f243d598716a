"""The LM full-sequence path and BST training on the card (``cuda`` marker;
skipped where torch sees no CUDA device).  Imports no JAX, so it collects
where only torch is installed: each card route against the port's own CPU
route on the same inputs.  The card's ``index_add_`` (the MoE combine, the
lookup's backward) adds with atomics, so sums are held within f32 rounding
of their order, not bitwise."""

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import RecsysBatches, SyntheticTokens
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models import bst as B
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.optim.tree import tree_leaves, tree_map
from repro_torch.serve.decode import (flash_attn_fn, make_decode_step, make_prefill_step,
                                      serve_attn_fn)
from repro_torch.train.step import bst_value_and_grad, lm_value_and_grad

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")]

MOE_ARCHS = ("granite-moe-3b-a800m", "grok-1-314b")


def leaf_errs(got, want):
    return [float((g.cpu().double() - w.cpu().double()).abs().max()
                  / max(float(w.double().abs().max()), 1e-30)) for g, w in zip(got, want)]


def both(fn, tree):
    """``fn(tree on device)`` on the CPU and on the card."""
    return [fn(tree_map(lambda t: t.to(dev), tree)) for dev in ("cpu", "cuda")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 32, 2, 3, 8, None, 32, 8), (1, 64, 4, 2, 16, 50.0, 64, 16),
                                  (2, 48, 1, 4, 8, None, 10, 16)], ids=["gqa", "softcap", "window"])
def test_flash_attention_on_card_matches_cpu(case, dtype):
    from repro_torch.models.flash_attention import flash_attention

    B_, S, KV, G, dh, cap, win, qc = case
    g = torch.Generator().manual_seed(S)
    x = {"q": torch.randn((B_, S, KV, G, dh), generator=g),
         "k": torch.randn((B_, S, KV, dh), generator=g),
         "v": torch.randn((B_, S, KV, dh), generator=g)}
    cot = torch.randn((B_, S, KV, G, dh), generator=g)

    def run(t):
        ins = [t[k].to(dtype).requires_grad_() for k in ("q", "k", "v")]
        out = flash_attention(*ins, win, cap, qc, qc)
        grads = torch.autograd.grad((out * cot.to(out.device)).sum(), ins)
        return [out.detach()] + [gr.float() for gr in grads]

    cpu, card = both(run, x)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8  # bf16: one rounding of p or ds
    assert max(leaf_errs(card, cpu)) <= tol


@pytest.mark.parametrize("impl", ["ragged", "capacity", "dense"])
def test_moe_on_card_matches_cpu(impl):
    from dataclasses import replace

    cfg = registry.get_smoke_config("granite-moe-3b-a800m")
    cfg = replace(cfg, moe=replace(cfg.moe, impl=impl))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lw = {k: params["layers"][k][0] for k in TM.moe_shapes(cfg)}
    lw["x"] = torch.randn((64, cfg.d_model), generator=torch.Generator().manual_seed(1))

    def run(t):
        w = {k: v.requires_grad_() for k, v in t.items()}
        out = TM.moe_ffn(cfg, w, w["x"])
        return [out.detach()] + list(torch.autograd.grad(torch.sin(out).sum(), list(w.values())))

    cpu, card = both(run, lw)
    assert max(leaf_errs(card, cpu)) <= 1e-5


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_grads_on_card_match_cpu(arch):
    """f32 and float64: the loss and every gradient leaf of the card within
    1e-5 (f32) and 1e-9 (float64) of the CPU's, of each leaf's magnitude."""
    cfg = registry.get_smoke_config(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = SyntheticTokens(cfg.vocab, 2, 32)[0]
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-9)):
        def run(p):
            dev = tree_leaves(p)[0].device
            toks, tgts = (torch.from_numpy(batch[k]).to(dev) for k in ("tokens", "targets"))
            loss, grads = lm_value_and_grad(cfg, tree_map(lambda t: t.to(dtype), p), toks, tgts,
                                            compute_dtype=dtype, attn_chunk=8)
            return [loss] + tree_leaves(grads)

        cpu, card = both(run, params)
        assert max(leaf_errs(card, cpu)) <= tol, dtype


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_on_card_matches_flash_decode(arch):
    """Prefill's last logits against the flash-decode route's after the
    last prompt token, both on the card, f32 (3e-4, the reference's
    decode-vs-forward limit); every decode step launches the kernel once a
    layer."""
    cfg = registry.get_smoke_config(arch)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(2)).cuda()
    step = make_decode_step(cfg, torch.float32, attn_fn=flash_attn_fn)
    cache = T.init_cache(cfg, 2, 16, dtype=torch.float32, device="cuda")
    n0 = flash_decode.launches
    for t in range(16):
        logits, _, cache = step(params, cache, toks[:, t:t + 1], t)
    assert flash_decode.launches - n0 == 16 * cfg.n_layers
    last = make_prefill_step(cfg, torch.float32, attn_chunk=8)(params, toks)
    torch.testing.assert_close(last, logits, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen3-32b"])
def test_full_width_decode_on_card_matches_cpu(arch, cache_dtype):
    """Two layers at full width (Gemma-2: one local layer of window 4,096
    and one global, softcaps 50 and 30; Qwen3: qk-norm), f32 weights and
    a cache of 8,192 rows filled to 6,000, past the window: three steps
    through the serve launcher's route on the card (``flash_decode`` for a
    global layer: its tensor-core route with a bf16 cache, its CUDA-core
    "simt" route with the f32 cache the launcher keeps, rows of 36 words at
    dh 144 and 20 at dh 80; ``decode_attention_ref`` for the local one)
    against the plain route on the CPU on the same weights and cache.
    Logits within 3e-4 of their largest magnitude; one launch a global
    layer a step."""
    from dataclasses import replace

    from repro_torch.kernels.flash_decode import route

    cfg = replace(registry.get_config(arch), n_layers=2)
    assert route(cache_dtype, cfg.d_head) == ("mma" if cache_dtype == torch.bfloat16 else "simt")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    cache = T.init_cache(cfg, 2, 8192, dtype=cache_dtype, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    first = 6000
    for name in ("k", "v"):
        cache[name][:, :, :first].normal_(generator=g)
    host = {"params": tree_map(lambda t: t.cpu(), params),
            "cache": {k: v.cpu() for k, v in cache.items()}}
    card_step = make_decode_step(cfg, torch.float32, attn_fn=serve_attn_fn)
    cpu_step = make_decode_step(cfg, torch.float32)
    tok = torch.randint(0, cfg.vocab, (2, 1), generator=torch.Generator().manual_seed(2),
                        dtype=torch.int32)
    globals_ = cfg.n_layers - sum(T.layer_is_local(cfg))
    n0 = flash_decode.launches
    for i in range(3):
        got, _, _ = card_step(params, cache, tok.cuda(), first + i)
        want, nxt, _ = cpu_step(host["params"], host["cache"], tok, first + i)
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 3e-4 * scale, i
        tok = nxt[:, None]
    assert flash_decode.launches - n0 == 3 * globals_


def test_bst_grads_on_card_match_cpu():
    """The kernel route on the card (one ``embedding_bag`` launch a step)
    against the plain version on the CPU: the loss and every leaf within
    1e-5 in f32; in float64 (the table f32, the kernel's type) the loss
    within 1e-12 and every leaf within 1e-6 (the table's gradient adds f32
    rows with atomics)."""
    cfg = registry.get_smoke_config("bst")
    params = B.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    data = RecsysBatches(cfg.n_items, 64, cfg.seq_len, cfg.n_other_feats, seed=1)[0]
    for dtype, tol, loss_tol in ((torch.float32, 1e-5, 1e-6), (torch.float64, 1e-6, 1e-12)):
        def run(p):
            dev = p["item_emb"].device
            p = {k: (v if k == "item_emb" else tree_map(lambda t: t.to(dtype), v))
                 for k, v in p.items()}
            x = [torch.from_numpy(data[k]).to(dev) for k in ("hist", "target", "other", "label")]
            x[2:] = [t.to(dtype) for t in x[2:]]
            n0 = embedding_bag.launches
            loss, grads = bst_value_and_grad(cfg, p, *x, compute_dtype=dtype)
            return embedding_bag.launches - n0, [loss] + tree_leaves(grads)

        (n_cpu, cpu), (n_card, card) = both(run, params)
        assert (n_cpu, n_card) == (0, 1)
        assert abs(float(card[0]) - float(cpu[0])) <= loss_tol * abs(float(cpu[0]))
        assert max(leaf_errs(card[1:], cpu[1:])) <= tol, dtype


def test_train_main_on_card_with_resume(tmp_path):
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.launch.train import main

    argv = ["--arch", "granite-moe-3b-a800m", "--smoke", "--batch", "2", "--seq", "32",
            "--ckpt-every", "3", "--ckpt-dir", str(tmp_path)]
    first = main(argv + ["--steps", "6"])
    assert tree_leaves(first["params"])[0].is_cuda and np.isfinite(first["losses"]).all()
    (params, opt), _ = ckpt.restore(first["ckpt_dir"], (first["params"], first["opt"]))
    for a, b in zip(tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu),
                    tree_leaves(first["params"]) + tree_leaves(first["opt"].mu)
                    + tree_leaves(first["opt"].nu)):
        assert torch.equal(a, b)
    second = main(argv + ["--steps", "8", "--resume"])
    assert second["start"] == 6 and len(second["losses"]) == 2
