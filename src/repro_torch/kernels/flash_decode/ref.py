"""Plain PyTorch versions of GQA decode attention for one new token (the
CPU path and the kernel's oracle on the card)."""

import math

import torch

NEG_INF = -1e30  # the reference kernel's mask value


def _scores(q, k, kv_len, softcap):
    """Scaled (and softcapped) scores [B, KV, G, S] in f32 and the live mask."""
    s = k.shape[1]
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(k.shape[-1]))
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(s, device=k.device)[None, None, None, :]
    return scores, pos < kv_len.to(k.device)[:, None, None, None]


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, softcap=None) -> torch.Tensor:
    """softmax(q·K^T / sqrt(dh)) V over the first ``kv_len[b]`` positions.

    q: [B, KV, G, dh] (query heads grouped under KV heads); k, v:
    [B, S, KV, dh]; kv_len: [B] int32 -> [B, KV, G, dh] f32.
    """
    scores, mask = _scores(q, k, kv_len, softcap)
    p = torch.softmax(torch.where(mask, scores, -torch.inf), dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float())


def flash_decode_partial_ref(q, k, v, kv_len, softcap=None):
    """(acc [B,KV,G,dh], m [B,KV,G], l [B,KV,G]), unnormalized: m is the max
    live score, l = Σ exp(s - m) and acc = Σ exp(s - m) v over live
    positions.  A sequence with no live position gives (0, -1e30, 0), which
    ``merge_partials`` weighs by 0 beside any live partial."""
    scores, mask = _scores(q, k, kv_len, softcap)
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.where(mask, torch.exp(scores - m[..., None]), 0.0)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return acc, m, p.sum(dim=-1)
