"""Serving steps: greedy decode of one token against a KV cache, and prefill.

``make_decode_step`` builds ``step(params, cache, tokens, pos)``;
``flash_attn_fn`` serves its decode attention through the ``flash_decode``
kernel, ``serve_attn_fn`` chooses per layer (the kernel for a global
layer, ``decode_attention_ref`` for a sliding-window one), and
``make_sp_attn_fn`` sequence-parallel over a mesh: the cache's
sequence axis splits over mesh axes, every shard computes softmax partials
over its slice, and the partials merge with one pmax and two psums whose
payload is O(B*H*dh), independent of the sequence length.  A ``moe_fn``
(``models/moe.py``'s sharded forms) replaces a MoE layer's dispatch.
``make_prefill_step`` builds ``step(params, tokens)``, the whole prompt's
forward returning the last position's logits.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import LMConfig
from ..kernels.flash_decode import flash_decode
from ..launch.collectives import P, axis_index, place, place_zeros, pmax, psum, shard, unshard
from ..launch.mesh import axes_tuple
from ..models import transformer as T
from ..models.common import softcap as _softcap


def make_flash_attn_fn(decode=flash_decode):
    """An ``attn_fn`` for ``decode_step`` that runs
    ``decode(q [B, KV, G, dh], k, v, kv_len, softcap)`` over the whole
    right-aligned batch with ``kv_len = pos + 1``.

    Query head ``h`` belongs to KV head ``h // G``, as the reference's
    ``q.reshape(b, kv, g, dh)`` groups them.  For a global layer this is
    ``decode_attention_ref``; a sliding-window layer (``window`` below the
    cache length) raises: the kernel, as the reference's ``flash_decode``,
    has no lower bound on positions, and a local layer decodes through
    ``decode_attention_ref`` or ``make_sp_attn_fn``'s mask.
    ``decode`` is ``flash_decode`` (the kernel on the card) unless a caller
    passes a plain version to check against.
    """

    def attn_fn(q, k_cache, v_cache, pos, window, cap):
        b, _, h, dh = q.shape
        s_max, kv = k_cache.shape[1], k_cache.shape[2]
        if window < s_max:
            raise NotImplementedError(
                "flash-decode attention serves global layers only: decode a "
                "sliding-window layer through decode_attention_ref or make_sp_attn_fn")
        kv_len = torch.full((b,), int(pos) + 1, dtype=torch.int32, device=q.device)
        out = decode(q.reshape(b, kv, h // kv, dh), k_cache, v_cache, kv_len, softcap=cap)
        return out.reshape(b, 1, h, dh)

    return attn_fn


flash_attn_fn = make_flash_attn_fn()


def make_serve_attn_fn(flash=flash_attn_fn, plain=T.decode_attention_ref):
    """The serve launcher's ``attn_fn``: the route chosen per layer, before
    any call.  A global layer (``window`` at least the cache length) goes
    through ``flash`` (the ``flash_decode`` kernel on the card); a
    sliding-window layer through ``plain``, the port's counterpart of the
    reference's XLA decode attention, which masks positions more than
    ``window`` behind ``pos`` (the kernel has no window)."""

    def attn_fn(q, k_cache, v_cache, pos, window, cap):
        route = plain if window < k_cache.shape[1] else flash
        return route(q, k_cache, v_cache, pos, window, cap)

    return attn_fn


serve_attn_fn = make_serve_attn_fn()


def make_sp_attn_fn(mesh, seq_axes, batch_axes=None):
    """Sequence-parallel decode attention over ``seq_axes`` of ``mesh``.

    q:       [B, 1, H, dh]   B split over ``batch_axes``, whole over seq_axes
    k/v:     [B, S, KV, dh]  B over batch_axes, S over seq_axes
    Returns  [B, 1, H, dh]   f32, on q's device.

    The reference's arithmetic, torch ops per shard (no kernel, as the
    reference computes it outside Pallas): f32 scores, the softcap, the
    window mask with -2.0e38, one pmax and two psums over ``seq_axes`` (one
    axis at a time, as the reference's loop), ``acc / max(l, 1e-30)``.  No
    collective touches the batch axes.  A cache from ``init_sp_cache`` (or
    ``place_sp_cache``) is read in place: each shard's slice lives on its
    card, and a step moves only q, the partials and the output.  A whole
    cache tensor is cut on every call (one copy a step for each shard on
    another card).
    """
    axes = axes_tuple(seq_axes)
    bspec = batch_axes

    def attn_fn(q, k_cache, v_cache, pos, window, cap):
        h = q.shape[2]
        local_s = k_cache.shape[1] // mesh.axis_size(axes)
        q_l = shard(q, mesh, P(bspec, None, None, None))
        k_l = shard(k_cache, mesh, P(bspec, axes, None, None))
        v_l = shard(v_cache, mesh, P(bspec, axes, None, None))
        scores, m_loc = [], []
        for k, idx in enumerate(axis_index(mesh, axes)):
            bl, _, kv, dh = k_l[k].shape
            qg = q_l[k].reshape(bl, kv, h // kv, dh).float()
            sc = torch.einsum("bhgd,bshd->bhgs", qg, k_l[k].float()) * (1.0 / math.sqrt(dh))
            sc = _softcap(sc, cap)
            dist = int(pos) - (idx * local_s + torch.arange(local_s, device=sc.device))
            valid = (dist >= 0) & (dist < int(window))
            sc = torch.where(valid[None, None, None, :], sc, -2.0e38)
            scores.append(sc)
            m_loc.append(torch.amax(sc, dim=-1))  # [B_local, KV, G]
        m_glob = m_loc
        for a in axes:
            m_glob = pmax(m_glob, mesh, a)
        ls, accs = [], []
        for k, sc in enumerate(scores):
            p = torch.exp(sc - m_glob[k][..., None])
            ls.append(torch.sum(p, dim=-1))
            accs.append(torch.einsum("bhgs,bshd->bhgd", p, v_l[k].float()))
        for a in axes:
            ls, accs = psum(ls, mesh, a), psum(accs, mesh, a)
        outs = [(acc / torch.clamp_min(l[..., None], 1e-30)).reshape(acc.shape[0], 1, h, -1)
                for acc, l in zip(accs, ls)]
        return unshard(outs, mesh, P(bspec, None, None, None), device=q.device)

    return attn_fn


def sp_cache_spec(seq_axes, batch_axes=None) -> P:
    """The spec of a layer-stacked cache leaf ``[L, B, S, KV, dh]`` under
    ``make_sp_attn_fn(mesh, seq_axes, batch_axes)``."""
    return P(None, batch_axes, axes_tuple(seq_axes), None, None)


def init_sp_cache(cfg: LMConfig, batch: int, max_seq: int, mesh, seq_axes, batch_axes=None,
                  dtype=torch.bfloat16) -> dict:
    """A zero KV cache ``{"k", "v"}`` for sequence-parallel decode, each
    shard's slice ``[L, B/batch, S/seq, KV, dh]`` allocated on its own
    card (the whole cache never exists); ``decode_step`` writes a new
    token into the slice that holds its position."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    spec = sp_cache_spec(seq_axes, batch_axes)
    return {name: place_zeros(shape, dtype, mesh, spec) for name in ("k", "v")}


def place_sp_cache(cache: dict, mesh, seq_axes, batch_axes=None) -> dict:
    """A whole cache (``transformer.init_cache``'s) placed for
    ``make_sp_attn_fn``: each shard's slice copied to its card once."""
    spec = sp_cache_spec(seq_axes, batch_axes)
    return {name: place(t, mesh, spec) for name, t in cache.items()}


def make_decode_step(cfg: LMConfig, compute_dtype=torch.bfloat16, attn_fn=None,
                     moe_fn=None):
    """``step(params, cache, tokens [B, 1], pos) -> (logits [B, V] f32,
    next_tok [B] int32, cache)``; the cache is updated in place."""

    def step(params, cache, tokens, pos):
        logits, cache = T.decode_step(cfg, params, tokens, cache, pos,
                                      compute_dtype=compute_dtype, attn_fn=attn_fn,
                                      moe_fn=moe_fn)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, next_tok, cache

    return step


def make_prefill_step(cfg: LMConfig, compute_dtype=torch.bfloat16, attn_chunk=None,
                      moe_fn=None):
    """``step(params, tokens [B, S]) -> logits [B, V]`` of the last position:
    ``forward``'s layers (no remat, no autograd) in the compute dtype, then
    the final norm, unembedding and softcap of the last position alone: the
    reference's jitted ``forward(...)[:, -1]``, whose other rows XLA never
    materialises ([B, S, V] is 16.8 GB for Gemma-2 at 32,768 tokens in
    bf16).  The reference's ``activation_spec``/``carry_spec`` (XLA
    sharding constraints) and ``unroll`` (a layer-scan option) have no
    counterpart."""

    def step(params, tokens):
        with torch.no_grad():
            x = T._hidden(cfg, params, tokens, compute_dtype, False, attn_chunk, moe_fn)
            return T._head(cfg, params, x[:, -1:], compute_dtype)[:, 0]

    return step
