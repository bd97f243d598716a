"""Flash-decode attention for one new token: the CUDA kernels
(``csrc/flash_decode.cu``) on the card, the plain versions on the CPU.

Two kernels serve the card, chosen by :func:`route` from the K/V type and
dh alone: ``"mma"`` (tensor cores, bf16 with dh a multiple of 16) and
``"simt"`` (CUDA cores: f32, and bf16 rows of other widths; any row of a
multiple of 16 bytes up to dh 256).  Both count in
``flash_decode.launches``.

``flash_decode_partial`` returns the unnormalized (acc, m, l) form that
sequence-parallel decode merges across shards with ``merge_partials``
(the log-sum-exp rule) before the final division.
"""

from __future__ import annotations

import torch

from ..runtime import (check, check_operands, count_launch, cuda_input, kernel_fn,
                       launch_on, on_cpu, stream_ptr)
from .ref import flash_decode_partial_ref, flash_decode_ref

WARPS = 4  # csrc/flash_decode.cu: warps a block (both routes)
# cache rows per block on route "simt": a multiple of WARPS x 32, the most
# rows a block step takes (simt::kMaxTile positions a warp tile), so every
# tile size the kernel picks divides it
CHUNK_ROWS = 1024
MMA_TILE = 16  # csrc/flash_decode.cu tc::kTile: positions per warp step (route "mma")
MMA_CHUNK_ROWS = 2048  # cache rows per block on route "mma" (whole block steps)


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel that serves K/V of ``dtype`` and head width ``dh``, a pure
    function of the two: ``"mma"`` (tensor cores) for bf16 with dh a
    multiple of 16 in [16, 256]; ``"simt"`` (CUDA cores) for the other rows
    of a multiple of 16 bytes up to dh 256 (f32 dh a multiple of 4, bf16 a
    multiple of 8); raises for the rest."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_decode: K/V must be f32 or bf16, got {dtype}")
    if dtype == torch.bfloat16 and dh % 16 == 0 and 16 <= dh <= 256:
        return "mma"
    row = dh * (2 if dtype == torch.bfloat16 else 4)
    if dh < 1 or row % 16 or dh > 256:
        raise ValueError(f"flash_decode: no kernel for dh={dh} in {dtype}: a row must "
                         "be a multiple of 16 bytes and dh at most 256")
    return "simt"


def _chunk_rows(dh: int, dtype: torch.dtype) -> int:
    """Cache rows per block: CHUNK_ROWS on "simt", and on "mma" whole block
    steps (every warp takes tiles of MMA_TILE) of about MMA_CHUNK_ROWS."""
    if route(dtype, dh) == "simt":
        return CHUNK_ROWS
    step = WARPS * MMA_TILE
    return step * max(1, MMA_CHUNK_ROWS // step)


def _launch(q, k, v, kv_len, softcap, normalize: bool):
    """The kernel on CUDA tensors: acc / l, or (acc, m, l)."""
    q = cuda_input(q.float(), torch.float32, 4, "flash_decode q")
    kernel = route(k.dtype, q.shape[-1])
    k = cuda_input(k, k.dtype, 4, "flash_decode k")
    v = cuda_input(v, k.dtype, 4, "flash_decode v")
    kv_len = cuda_input(kv_len, torch.int32, 1, "flash_decode kv_len")
    b, kv, g, dh = q.shape
    s = k.shape[1]
    if k.shape != (b, s, kv, dh) or v.shape != k.shape or kv_len.shape != (b,):
        raise ValueError(
            f"flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            f"and kv_len {tuple(kv_len.shape)} disagree")
    if g > 8:
        raise ValueError(f"flash_decode: no kernel for {g} query heads per KV head (max 8)")
    chunk = _chunk_rows(dh, k.dtype)
    n_chunks = -(-s // chunk)
    f32 = dict(dtype=torch.float32, device=q.device)
    pacc = torch.empty((b, kv, n_chunks, g, dh), **f32)
    pm = torch.empty((b, kv, n_chunks, g), **f32)
    pl = torch.empty((b, kv, n_chunks, g), **f32)
    out = torch.empty((b, kv, g, dh), **f32)
    m = l = None
    if not normalize:
        m = torch.empty((b, kv, g), **f32)
        l = torch.empty((b, kv, g), **f32)
    if b and kv and g:
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                pacc.data_ptr(), pm.data_ptr(), pl.data_ptr(), out.data_ptr(),
                m.data_ptr() if m is not None else None,
                l.data_ptr() if l is not None else None,
                b, s, kv, g, dh, chunk]
        cap = float(softcap) if softcap is not None else 0.0
        with launch_on(q.device):
            if kernel == "mma":
                fn = kernel_fn("flash_decode", "flash_decode_mma_launch", "ppppppppppiiiiiifip")
                err = fn(*args, cap, int(normalize), stream_ptr(q))
            else:
                fn = kernel_fn("flash_decode", "flash_decode_launch", "ppppppppppiiiiiiifip")
                err = fn(*args, int(k.dtype == torch.bfloat16), cap, int(normalize),
                         stream_ptr(q))
        check(err, "flash_decode")
        count_launch(flash_decode, q.device)
    return out if normalize else (out, m, l)


def flash_decode(q, k, v, kv_len, softcap=None) -> torch.Tensor:
    """GQA decode attention for one token: q [B, KV, G, dh] against
    k, v [B, S, KV, dh] (f32 or bf16) over the first ``kv_len[b]`` positions
    -> [B, KV, G, dh] f32.  ``kv_len >= 1`` is a precondition."""
    k = torch.as_tensor(k)
    check_operands("flash_decode", k, q, v, kv_len)
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=k.device)
    if on_cpu(k, "flash_decode"):
        return flash_decode_ref(q, k, v, kv_len, softcap=softcap)
    return _launch(q, k, v, kv_len, softcap, normalize=True)


def flash_decode_partial(q, k, v, kv_len, softcap=None):
    """(acc [B,KV,G,dh], m [B,KV,G], l [B,KV,G]) — unnormalized; its kernel
    launches count in ``flash_decode.launches``."""
    k = torch.as_tensor(k)
    check_operands("flash_decode_partial", k, q, v, kv_len)
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=k.device)
    if on_cpu(k, "flash_decode_partial"):
        return flash_decode_partial_ref(q, k, v, kv_len, softcap=softcap)
    return _launch(q, k, v, kv_len, softcap, normalize=False)


flash_decode.launches = 0


def merge_partials(accs, ms, ls) -> torch.Tensor:
    """Log-sum-exp merge of sequence-parallel partials -> acc / l."""
    m_all = torch.max(torch.stack(list(ms)), dim=0).values
    scale = [torch.exp(mi - m_all) for mi in ms]
    l = sum(si * li for si, li in zip(scale, ls))
    acc = sum(si[..., None] * ai for si, ai in zip(scale, accs))
    return acc / l[..., None]


__all__ = ["flash_decode", "flash_decode_partial", "flash_decode_ref", "merge_partials", "route"]
