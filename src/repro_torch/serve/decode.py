"""Serving steps: greedy decode of one token against a KV cache, and prefill.

``make_decode_step`` builds ``step(params, cache, tokens, pos)``;
``flash_attn_fn`` serves its decode attention through the ``flash_decode``
kernel.  ``make_prefill_step`` builds ``step(params, tokens)``, the whole
prompt's forward returning the last position's logits.  The
sequence-parallel attention of the reference waits for the multi-GPU plane.
"""

from __future__ import annotations

import torch

from ..configs.base import LMConfig
from ..kernels.flash_decode import flash_decode
from ..models import transformer as T


def make_flash_attn_fn(decode=flash_decode):
    """An ``attn_fn`` for ``decode_step`` that runs
    ``decode(q [B, KV, G, dh], k, v, kv_len, softcap)`` over the whole
    right-aligned batch with ``kv_len = pos + 1``.

    Query head ``h`` belongs to KV head ``h // G``, as the reference's
    ``q.reshape(b, kv, g, dh)`` groups them.  For a global layer this is
    ``decode_attention_ref``; a sliding-window layer (``window`` below the
    cache length) raises, since the kernel has no lower bound on the window.
    ``decode`` is ``flash_decode`` (the kernel on the card) unless a caller
    passes a plain version to check against.
    """

    def attn_fn(q, k_cache, v_cache, pos, window, cap):
        b, _, h, dh = q.shape
        s_max, kv = k_cache.shape[1], k_cache.shape[2]
        if window < s_max:
            raise NotImplementedError(
                "flash-decode attention serves global layers only: sliding-window "
                "decode (Gemma-2's local layers) comes with a later slice")
        kv_len = torch.full((b,), int(pos) + 1, dtype=torch.int32, device=q.device)
        out = decode(q.reshape(b, kv, h // kv, dh), k_cache, v_cache, kv_len, softcap=cap)
        return out.reshape(b, 1, h, dh)

    return attn_fn


flash_attn_fn = make_flash_attn_fn()


def make_decode_step(cfg: LMConfig, compute_dtype=torch.bfloat16, attn_fn=None):
    """``step(params, cache, tokens [B, 1], pos) -> (logits [B, V] f32,
    next_tok [B] int32, cache)``; the cache is updated in place."""

    def step(params, cache, tokens, pos):
        logits, cache = T.decode_step(cfg, params, tokens, cache, pos,
                                      compute_dtype=compute_dtype, attn_fn=attn_fn)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, next_tok, cache

    return step


def make_prefill_step(cfg: LMConfig, compute_dtype=torch.bfloat16, attn_chunk=None):
    """``step(params, tokens [B, S]) -> logits [B, V]`` of the last position:
    the full-prompt forward (no remat, no autograd), in the compute dtype.
    The reference's sharding arguments (``activation_spec``, ``carry_spec``,
    ``moe_fn``) and ``unroll`` have no single-device counterpart."""

    def step(params, tokens):
        with torch.no_grad():
            logits = T.forward(cfg, params, tokens, compute_dtype=compute_dtype,
                               remat=False, attn_chunk=attn_chunk)
        return logits[:, -1]

    return step
