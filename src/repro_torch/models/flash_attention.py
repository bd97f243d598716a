"""Flash attention (forward + hand-written backward) in torch ops.

A plain chunked-softmax attention keeps every (q-chunk x kv-chunk)
probability tile alive for the backward: O(S^2) activation memory a layer.
The flash pattern (Dao et al.) saves only (out, m, l) per query row and
recomputes the probability tiles inside the backward, so activation memory
stays O(S * d) while the backward does about twice the forward's work.

GQA grouping, causal masking, sliding windows and tanh softcaps (with the
cap's derivative in the backward) are supported.  Products take the
operands upcast to at least f32 (a bf16 x bf16 product is exact in f32, as
the reference's ``preferred_element_type=float32``), the probabilities are
rounded to the input's dtype before ``p @ V`` (and ``ds``/``p`` before the
backward's products), as the reference rounds them.  Float64 inputs compute
in float64 throughout.

Tiles that the mask empties entirely are skipped: the reference computes
them, but such a tile adds exact zeros to every sum, forward and backward;
tiles that it leaves whole are not masked.
Within a tile, query rows are ordered (position, group): ``[B, KV, qc*G, .]``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .common import upcast

NEG_INF = -2.0e38


def _live_kv(qi: int, s: int, qc: int, kc: int, window: int, causal: bool):
    """The kv tiles with at least one live (query, key) pair for q tile ``qi``."""
    out = []
    for ki in range(s // kc):
        min_dist = qi * qc - (ki * kc + kc - 1)
        max_dist = qi * qc + qc - 1 - ki * kc
        if not ((causal and max_dist < 0) or min_dist >= window):
            out.append(ki)
    return out


def _valid(qi: int, ki: int, qc: int, kc: int, g: int, window: int, causal: bool, device):
    """The tile's mask [qc*G, kc] (rows ordered position-major, then group),
    or None where every pair is live (no mask to apply)."""
    min_dist = qi * qc - (ki * kc + kc - 1)
    max_dist = qi * qc + qc - 1 - ki * kc
    if max_dist < window and (min_dist >= 0 or not causal):
        return None
    q_pos = qi * qc + torch.div(torch.arange(qc * g, device=device), g, rounding_mode="floor")
    k_pos = ki * kc + torch.arange(kc, device=device)
    dist = q_pos[:, None] - k_pos[None, :]
    valid = dist < window
    return valid & (dist >= 0) if causal else valid


def _layout(q, k, v, acc_t):
    """q [B,S,KV,G,dh] -> [B,KV,S*G,dh]; k/v [B,S,KV,dh] -> [B,KV,S,dh], in acc_t."""
    b, s, kvh, g, dh = q.shape
    qt = q.to(acc_t).permute(0, 2, 1, 3, 4).reshape(b, kvh, s * g, dh)
    kt = k.to(acc_t).permute(0, 2, 1, 3).contiguous()
    return qt, kt, v.to(acc_t).permute(0, 2, 1, 3).contiguous()


def _check_chunks(s: int, qc: int, kc: int) -> None:
    if s % qc or s % kc:
        raise ValueError(f"flash_attention: sequence {s} must divide by the chunks {qc}, {kc}")


def attention_forward(q, k, v, window: int, cap: Optional[float], qc: int, kc: int,
                      causal: bool, p_dtype: torch.dtype):
    """(out [B,S,KV,G,dh], m, l [B,KV,S*G]) in at least f32, by online softmax
    over kv tiles; ``p`` is rounded to ``p_dtype`` before ``p @ V``."""
    b, s, kvh, g, dh = q.shape
    _check_chunks(s, qc, kc)
    acc_t = upcast(q.dtype)
    scale = 1.0 / math.sqrt(dh)
    qt, kt, vt = _layout(q, k, v, acc_t)
    rows = qc * g
    outs, ms, ls = [], [], []
    for qi in range(s // qc):  # no in-place state: autograd may run through this loop
        q_t = qt[:, :, qi * rows:(qi + 1) * rows]
        m = torch.full((b, kvh, rows), NEG_INF, dtype=acc_t, device=q.device)
        l = torch.zeros((b, kvh, rows), dtype=acc_t, device=q.device)
        acc = torch.zeros((b, kvh, rows, dh), dtype=acc_t, device=q.device)
        for ki in _live_kv(qi, s, qc, kc, window, causal):
            c = slice(ki * kc, (ki + 1) * kc)
            sc = (q_t @ kt[:, :, c].transpose(-1, -2)) * scale
            if cap is not None:
                sc = cap * torch.tanh(sc / cap)
            valid = _valid(qi, ki, qc, kc, g, window, causal, q.device)
            if valid is not None:
                sc = torch.where(valid, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p.to(p_dtype).to(acc_t) @ vt[:, :, c]
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append(acc / l[..., None])
        ms.append(m)
        ls.append(l)
    out = torch.cat(outs, 2).reshape(b, kvh, s, g, dh).permute(0, 2, 1, 3, 4)
    return out, torch.cat(ms, 2), torch.cat(ls, 2)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, cap, qc, kc, causal):
        out, m, l = attention_forward(q, k, v, window, cap, qc, kc, causal, q.dtype)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (window, cap, qc, kc, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        window, cap, qc, kc, causal = ctx.args
        b, s, kvh, g, dh = q.shape
        acc_t, cdt = out.dtype, q.dtype
        scale = 1.0 / math.sqrt(dh)
        qt, kt, vt = _layout(q, k, v, acc_t)
        dot = dout.to(acc_t).permute(0, 2, 1, 3, 4).reshape(b, kvh, s * g, dh)
        ot = out.permute(0, 2, 1, 3, 4).reshape(b, kvh, s * g, dh)
        delta = torch.sum(dot * ot, dim=-1)  # rowsum(dout * out): the softmax jacobian's diagonal
        dq, dk, dv = torch.zeros_like(qt), torch.zeros_like(kt), torch.zeros_like(vt)
        rows = qc * g
        for qi, ki in ((qi, ki) for qi in range(s // qc)
                       for ki in _live_kv(qi, s, qc, kc, window, causal)):
            r, c = slice(qi * rows, (qi + 1) * rows), slice(ki * kc, (ki + 1) * kc)
            q_t, k_t, v_t, do_t = qt[:, :, r], kt[:, :, c], vt[:, :, c], dot[:, :, r]
            s_c = (q_t @ k_t.transpose(-1, -2)) * scale
            if cap is not None:
                s_c = cap * torch.tanh(s_c / cap)
            valid = _valid(qi, ki, qc, kc, g, window, causal, q.device)
            s_m = s_c if valid is None else torch.where(valid, s_c, NEG_INF)
            p = torch.exp(s_m - m[:, :, r, None]) / l[:, :, r, None]
            ds = p * (do_t @ v_t.transpose(-1, -2) - delta[:, :, r, None])
            if cap is not None:  # d tanh-cap / d s_pre
                ds = ds * (1.0 - (s_c / cap) ** 2)
            if valid is not None:
                ds = torch.where(valid, ds, 0.0)
            ds = ds.to(cdt).to(acc_t)
            p = p.to(cdt).to(acc_t)
            dq[:, :, r] += (ds @ k_t) * scale
            dk[:, :, c] += (ds.transpose(-1, -2) @ q_t) * scale
            dv[:, :, c] += p.transpose(-1, -2) @ do_t
        dq = dq.reshape(b, kvh, s, g, dh).permute(0, 2, 1, 3, 4).to(q.dtype)
        dk = dk.permute(0, 2, 1, 3).to(k.dtype)
        dv = dv.permute(0, 2, 1, 3).to(v.dtype)
        return dq, dk, dv, None, None, None, None, None  # window gets no gradient


def flash_attention(q, k, v, window: int, cap: Optional[float] = None, qc: int = 1024,
                    kc: int = 1024, causal: bool = True) -> torch.Tensor:
    """q [B,S,KV,G,dh], k/v [B,S,KV,dh] -> out [B,S,KV,G,dh] in at least f32.

    ``window`` is the live span (>= S disables it); ``S`` must divide by
    ``min(qc, S)`` and ``min(kc, S)``.
    """
    s = q.shape[1]
    return _FlashAttention.apply(q, k, v, int(window), cap, min(qc, s), min(kc, s), causal)
