"""Decoder-only transformer LM, decode half: one token against a KV cache.

Ported from the reference's unified LM for dense configs (Qwen2.5, Qwen3,
Gemma-2): GQA, RoPE (half-split rotation), RMSNorm, qk-norm, QKV bias,
attention and final logit softcaps, pre+post norms, zero-centered norms,
local/global layer windows and the embedding scale.  MoE FFNs, prefill
through ``forward``/``flash_attention`` and training come with later
slices.

Parameters are a dict with layer-stacked ``[L, ...]`` leaves, as in the
reference; ``decode_step`` walks the layers in a Python loop (the
reference's ``lax.scan``).  The large products stay ``torch.matmul``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..configs.base import LMConfig
from .common import (
    activation,
    apply_rope,
    dense_init,
    embed_init,
    fill_tree,
    make_rope,
    rms_norm,
    softcap,
)

NEG_INF = -2.0e38

MOE_LATER = "MoE FFN (models/moe.py) is not ported yet: it comes with a later slice"


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def lm_shapes(cfg: LMConfig) -> Dict:
    """The parameter tree of a dense LM as key -> shape (leaves of
    ``layers`` stacked ``[L, ...]``), as the reference lays it out."""
    L, D, H, KV, dh, F = (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
    )
    layers = {"attn_norm": (L, D), "ffn_norm": (L, D), "wq": (L, D, H * dh),
              "wk": (L, D, KV * dh), "wv": (L, D, KV * dh), "wo": (L, H * dh, D),
              "w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D)}
    if cfg.qkv_bias:
        layers.update(bq=(L, H * dh), bk=(L, KV * dh), bv=(L, KV * dh))
    if cfg.qk_norm:
        layers.update(q_norm=(L, dh), k_norm=(L, dh))
    if cfg.post_norms:
        layers.update(post_attn_norm=(L, D), post_ffn_norm=(L, D))
    tree = {"embed": (cfg.vocab, D), "final_norm": (D,), "layers": layers}
    if not cfg.tie_embeddings:
        tree["unembed"] = (D, cfg.vocab)
    return tree


def init_params(cfg: LMConfig, generator: torch.Generator, dtype=torch.float32,
                *, device) -> Dict:
    """Random parameters from ``generator`` on ``device`` (the generator's
    device) in ``lm_shapes``' layout, initialized as the reference does:
    projections fan-in scaled, the embedding N(0, 0.02), biases and
    post-norms 0, qk-norms 1, the other norms 1 (0 when zero-centered)."""
    if cfg.moe is not None:
        raise NotImplementedError(MOE_LATER)
    dev = torch.device(device)
    zeros = {"bq", "bk", "bv", "post_attn_norm", "post_ffn_norm"}
    if cfg.zero_centered_norm:
        zeros |= {"attn_norm", "ffn_norm", "final_norm"}

    def make(name, shape):
        if name == "embed":
            return embed_init(generator, shape, dtype, device=dev)
        if name.endswith("norm") or name in zeros:
            fill = torch.zeros if name in zeros else torch.ones
            return fill(shape, dtype=dtype, device=dev)
        return dense_init(generator, shape, dtype=dtype, device=dev)

    return fill_tree(lm_shapes(cfg), make)


def layer_is_local(cfg: LMConfig) -> List[bool]:
    """Per-layer sliding-window flag. Gemma-2: even layers local."""
    if cfg.layer_pattern == "local_global":
        return [i % 2 == 0 for i in range(cfg.n_layers)]
    return [False] * cfg.n_layers


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def decode_attention_ref(
    q: torch.Tensor,  # [B, 1, H, dh]
    k_cache: torch.Tensor,  # [B, S, KV, dh]
    v_cache: torch.Tensor,
    pos: int,  # decode position (right-aligned batch)
    window: int,
    cap: Optional[float],
) -> torch.Tensor:
    """Plain decode attention (one token vs the whole cache) -> [B, 1, H, dh] f32."""
    b, s, kv, dh = k_cache.shape
    h = q.shape[2]
    qg = q.reshape(b, kv, h // kv, dh)
    sc = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float())
    sc = softcap(sc * (1.0 / math.sqrt(dh)), cap)
    dist = pos - torch.arange(s, device=k_cache.device)
    valid = (dist >= 0) & (dist < window)
    sc = torch.where(valid[None, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, h, dh)


# ---------------------------------------------------------------------------
# layer pieces
# ---------------------------------------------------------------------------
def _project_qkv(cfg: LMConfig, lw: Dict, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = x @ lw["wq"], x @ lw["wk"], x @ lw["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q = q.reshape(b, s, H, dh)
    k = k.reshape(b, s, KV, dh)
    v = v.reshape(b, s, KV, dh)
    if cfg.qk_norm:
        q = rms_norm(q, lw["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lw["k_norm"], cfg.norm_eps)
    sin, cos = make_rope(positions, dh, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _ffn(cfg: LMConfig, lw: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.moe is not None:
        raise NotImplementedError(MOE_LATER)
    h = activation(cfg.act)(x @ lw["w_gate"]) * (x @ lw["w_up"])
    return h @ lw["w_down"]


# ---------------------------------------------------------------------------
# decode (one token, KV cache)
# ---------------------------------------------------------------------------
def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               *, device) -> Dict:
    """A zero KV cache ``{"k", "v": [L, B, max_seq, KV, dh]}`` on ``device``,
    which the caller names: pass ``"cpu"`` to decode on the host."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(
    cfg: LMConfig,
    params: Dict,
    tokens: torch.Tensor,  # [B, 1] int
    cache: Dict,  # {"k": [L, B, S, KV, dh], "v": ...}
    pos: int,  # write position (right-aligned batch)
    compute_dtype=torch.bfloat16,
    attn_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Dict]:
    """One decoding step: returns (logits [B, vocab] f32, cache).

    The new keys and values are written into ``cache`` at ``pos`` IN PLACE
    (the reference returns an updated copy); the returned cache is the
    same dict.  Each layer's weights are cast to ``compute_dtype``, which
    is free when the parameters already have that dtype: keep them so on
    the card, where a cast per step would move the whole model.

    ``attn_fn(q, k_cache, v_cache, pos, window, cap) -> [B, 1, H, dh]``
    defaults to the plain ``decode_attention_ref``; serve/decode.py
    injects the flash-decode kernel.
    """
    cd = compute_dtype
    zc = cfg.zero_centered_norm
    b = tokens.shape[0]
    attn_fn = attn_fn or decode_attention_ref
    x = params["embed"][tokens.long()].to(cd)  # [B, 1, D]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(cd)
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    is_local = layer_is_local(cfg)
    s_max = cache["k"].shape[2]
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lw = {name: t[i].to(cd) for name, t in layers.items()}
        window = (cfg.local_window if is_local[i] and cfg.local_window is not None
                  else s_max)
        h = rms_norm(x, lw["attn_norm"], cfg.norm_eps, zc)
        q, k, v = _project_qkv(cfg, lw, h, positions)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
        v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
        attn = attn_fn(q, k_cache, v_cache, pos, window, cfg.attn_softcap)
        attn = attn.reshape(b, 1, -1).to(x.dtype) @ lw["wo"]
        if cfg.post_norms:
            attn = rms_norm(attn, lw["post_attn_norm"], cfg.norm_eps, zc)
        x = x + attn
        h = rms_norm(x, lw["ffn_norm"], cfg.norm_eps, zc)
        f = _ffn(cfg, lw, h)
        if cfg.post_norms:
            f = rms_norm(f, lw["post_ffn_norm"], cfg.norm_eps, zc)
        x = x + f
    x = rms_norm(x, params["final_norm"].to(cd), cfg.norm_eps, zc)
    unembed = params.get("unembed")
    if unembed is None:
        logits = x @ params["embed"].to(cd).T
    else:
        logits = x @ unembed.to(cd)
    return softcap(logits[:, 0].float(), cfg.final_softcap), cache
