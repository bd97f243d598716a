"""Decoder-only transformer LM covering the five archs of the registry.

Ported from the reference's unified LM: GQA, RoPE (half-split rotation),
RMSNorm, qk-norm, QKV bias, attention and final logit softcaps, pre+post
norms, zero-centered norms, local/global layer windows, the embedding
scale, and MoE FFNs (``models/moe.py``: granite, grok; a ``moe_fn`` puts
one of its sharded forms in their place).  ``forward`` runs a
whole sequence through ``flash_attention`` (hand-written backward) with
``torch.utils.checkpoint`` around each ``remat_block`` of layers;
``lm_loss`` is the next-token cross entropy; ``decode_step`` feeds one
token against a KV cache.

Parameters are a dict with layer-stacked ``[L, ...]`` leaves, as in the
reference; both walk the layers in a Python loop (the reference's
``lax.scan``).  The large products stay ``torch.matmul``.  Where the
reference computes in f32 (norms, RoPE tables, softmax, attention sums,
the logits' softcap, the loss), the port computes in at least f32:
float64 models stay float64 throughout.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

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
    upcast,
)
from .flash_attention import NEG_INF, attention_forward, flash_attention
from .moe import moe_ffn, moe_shapes


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def lm_shapes(cfg: LMConfig) -> Dict:
    """The parameter tree of an LM as key -> shape (leaves of ``layers``
    stacked ``[L, ...]``), as the reference lays it out: a dense FFN's
    ``w_gate``/``w_up``/``w_down`` or MoE's router and experts."""
    L, D, H, KV, dh, F = (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
    )
    layers = {"attn_norm": (L, D), "ffn_norm": (L, D), "wq": (L, D, H * dh),
              "wk": (L, D, KV * dh), "wv": (L, D, KV * dh), "wo": (L, H * dh, D)}
    if cfg.moe is not None:
        layers.update(moe_shapes(cfg))
    else:
        layers.update(w_gate=(L, D, F), w_up=(L, D, F), w_down=(L, F, D))
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


def layer_window(cfg: LMConfig, is_local: bool, span: int) -> int:
    """A layer's live attention span: the local window, or ``span``."""
    return cfg.local_window if is_local and cfg.local_window is not None else span


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def chunked_attention(
    q: torch.Tensor,  # [B, S, H, dh]
    k: torch.Tensor,  # [B, S, KV, dh]
    v: torch.Tensor,  # [B, S, KV, dh]
    *,
    window: int,  # live attention span (S for global)
    cap: Optional[float],
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    causal: bool = True,
) -> torch.Tensor:
    """Chunked attention with online softmax -> [B, S, H, dh] in at least
    f32; every operand is upcast (no rounding of the probabilities), and
    autograd runs through the chunk loop (no custom backward)."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    out, _, _ = attention_forward(q.reshape(b, s, kv, h // kv, dh), k, v, int(window), cap,
                                  min(q_chunk, s), min(kv_chunk, s), causal, upcast(q.dtype))
    return out.reshape(b, s, h, dh)


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
    sin, cos = make_rope(positions, dh, cfg.rope_theta, dtype=upcast(x.dtype))
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _ffn(cfg: LMConfig, lw: Dict, x: torch.Tensor, moe_fn=None) -> torch.Tensor:
    if cfg.moe is not None:
        b, s, d = x.shape
        if moe_fn is not None:  # sharded dispatch (moe.make_sharded_moe_ffn)
            return moe_fn(lw, x.reshape(b * s, d)).reshape(b, s, d)
        return moe_ffn(cfg, lw, x.reshape(b * s, d)).reshape(b, s, d)
    h = activation(cfg.act)(x @ lw["w_gate"]) * (x @ lw["w_up"])
    return h @ lw["w_down"]


def _layer(cfg: LMConfig, lw: Dict, window: int, x: torch.Tensor, positions: torch.Tensor,
           chunk: int, moe_fn=None) -> torch.Tensor:
    zc = cfg.zero_centered_norm
    h = rms_norm(x, lw["attn_norm"], cfg.norm_eps, zc)
    q, k, v = _project_qkv(cfg, lw, h, positions)
    b, s, _, dh = q.shape
    qg = q.reshape(b, s, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, dh)
    attn = flash_attention(qg, k, v, window, cfg.attn_softcap, chunk, chunk)
    attn = attn.reshape(b, s, -1).to(x.dtype) @ lw["wo"]
    if cfg.post_norms:
        attn = rms_norm(attn, lw["post_attn_norm"], cfg.norm_eps, zc)
    x = x + attn
    h = rms_norm(x, lw["ffn_norm"], cfg.norm_eps, zc)
    f = _ffn(cfg, lw, h, moe_fn)
    if cfg.post_norms:
        f = rms_norm(f, lw["post_ffn_norm"], cfg.norm_eps, zc)
    return x + f


def _embed(cfg: LMConfig, params: Dict, tokens: torch.Tensor, cd) -> torch.Tensor:
    """Token embeddings in ``cd`` (times sqrt(d_model) where the config asks)."""
    embed = params["embed"]
    x = embed.index_select(0, tokens.reshape(-1).long()).reshape(*tokens.shape, -1).to(cd)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(cd)
    return x


def _logits(cfg: LMConfig, params: Dict, x: torch.Tensor, cd) -> torch.Tensor:
    """Final norm and unembedding (the embedding's transpose when tied)."""
    x = rms_norm(x, params["final_norm"].to(cd), cfg.norm_eps, cfg.zero_centered_norm)
    unembed = params.get("unembed")
    if unembed is None:
        return x @ params["embed"].to(cd).T
    return x @ unembed.to(cd)


def forward(
    cfg: LMConfig,
    params: Dict,
    tokens: torch.Tensor,  # [B, S] int
    compute_dtype=torch.bfloat16,
    remat: bool = True,
    attn_chunk: Optional[int] = None,  # None -> 1024; <= 0 -> unchunked (full S)
    moe_fn: Optional[Callable] = None,  # sharded MoE dispatch (moe.make_sharded_moe_ffn)
) -> torch.Tensor:
    """Full forward -> logits [B, S, vocab] in the compute dtype.

    The final softcap is applied in at least f32, then the logits are cast
    back to ``compute_dtype`` (an f32 copy of [B, S, V] would double the
    loss's memory); ``lm_loss`` upcasts them.  Each layer's weights are
    cast to ``compute_dtype`` inside its block.  With ``remat`` (and
    autograd recording) every ``cfg.remat_block`` layers run under
    ``torch.utils.checkpoint`` and are recomputed in the backward.
    """
    x = _hidden(cfg, params, tokens, compute_dtype, remat, attn_chunk, moe_fn)
    return _head(cfg, params, x, compute_dtype)


def _hidden(cfg: LMConfig, params: Dict, tokens: torch.Tensor, cd, remat: bool,
            attn_chunk: Optional[int], moe_fn: Optional[Callable]) -> torch.Tensor:
    """``forward``'s layers: the residual stream [B, S, D] in ``cd`` after
    the last layer, before the final norm (prefill takes its last
    position alone)."""
    s = tokens.shape[1]
    x = _embed(cfg, params, tokens, cd)
    positions = torch.arange(s, device=x.device)[None, :]
    windows = [layer_window(cfg, loc, s) for loc in layer_is_local(cfg)]
    chunk = 1024 if attn_chunk is None else (s if attn_chunk <= 0 else attn_chunk)
    L, blk = cfg.n_layers, max(1, cfg.remat_block)
    if L % blk or L // blk == 1:
        blk = 1
    layers = params["layers"]

    def block(x, first: int):
        for i in range(first, first + blk):
            lw = {name: t[i].to(cd) for name, t in layers.items()}
            x = _layer(cfg, lw, windows[i], x, positions, chunk, moe_fn)
        return x

    for first in range(0, L, blk):
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, first, use_reentrant=False)
        else:
            x = block(x, first)
    return x


def _head(cfg: LMConfig, params: Dict, x: torch.Tensor, cd) -> torch.Tensor:
    """Logits of the positions of ``x`` in ``cd``: final norm, unembedding,
    the final softcap in at least f32."""
    logits = _logits(cfg, params, x, cd)
    return softcap(logits.to(upcast(cd)), cfg.final_softcap).to(cd)


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy (targets already shifted), in at least
    f32.  ``gather`` picks the target's logit; the reference's one-hot
    contraction sums the same value with exact zeros."""
    logits = logits.to(upcast(logits.dtype))
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - tgt)


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


def _write_kv(layer_cache, pos: int, new: torch.Tensor) -> None:
    """``layer_cache[:, pos] = new`` in place; a placed cache (a
    ``collectives.Placed``, one slice of the sequence a shard) writes into
    the blocks that hold ``pos``."""
    if isinstance(layer_cache, torch.Tensor):
        layer_cache[:, pos] = new.to(layer_cache.dtype)
    else:
        layer_cache.write(1, pos, new)


def decode_step(
    cfg: LMConfig,
    params: Dict,
    tokens: torch.Tensor,  # [B, 1] int
    cache: Dict,  # {"k": [L, B, S, KV, dh], "v": ...}
    pos: int,  # write position (right-aligned batch)
    compute_dtype=torch.bfloat16,
    attn_fn: Optional[Callable] = None,
    moe_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Dict]:
    """One decoding step: returns (logits [B, vocab] in at least f32, cache).

    The new keys and values are written into ``cache`` at ``pos`` IN PLACE
    (the reference returns an updated copy); the returned cache is the
    same dict.  Its leaves may be placed over a mesh
    (``serve.decode.init_sp_cache``), each shard holding its slice.  Each
    layer's weights are cast to ``compute_dtype``, which is free when the
    parameters already have that dtype: keep them so on the card, where a
    cast per step would move the whole model.

    ``attn_fn(q, k_cache, v_cache, pos, window, cap) -> [B, 1, H, dh]``
    defaults to the plain ``decode_attention_ref``; serve/decode.py
    injects the flash-decode kernel or the sequence-parallel attention.
    ``moe_fn(lw, x [T, D]) -> [T, D]`` replaces a MoE layer's
    ``moe_ffn`` (``models/moe.py``'s sharded forms).
    """
    cd = compute_dtype
    zc = cfg.zero_centered_norm
    b = tokens.shape[0]
    attn_fn = attn_fn or decode_attention_ref
    x = _embed(cfg, params, tokens, cd)  # [B, 1, D]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    is_local = layer_is_local(cfg)
    s_max = cache["k"].shape[2]
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lw = {name: t[i].to(cd) for name, t in layers.items()}
        window = layer_window(cfg, is_local[i], s_max)
        h = rms_norm(x, lw["attn_norm"], cfg.norm_eps, zc)
        q, k, v = _project_qkv(cfg, lw, h, positions)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        _write_kv(k_cache, pos, k[:, 0])
        _write_kv(v_cache, pos, v[:, 0])
        attn = attn_fn(q, k_cache, v_cache, pos, window, cfg.attn_softcap)
        attn = attn.reshape(b, 1, -1).to(x.dtype) @ lw["wo"]
        if cfg.post_norms:
            attn = rms_norm(attn, lw["post_attn_norm"], cfg.norm_eps, zc)
        x = x + attn
        h = rms_norm(x, lw["ffn_norm"], cfg.norm_eps, zc)
        f = _ffn(cfg, lw, h, moe_fn)
        if cfg.post_norms:
            f = rms_norm(f, lw["post_ffn_norm"], cfg.norm_eps, zc)
        x = x + f
    logits = _logits(cfg, params, x, cd)
    return softcap(logits[:, 0].to(upcast(cd)), cfg.final_softcap), cache
