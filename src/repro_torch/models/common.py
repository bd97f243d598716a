"""Shared model building blocks (functional, dicts of tensors)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# f32 elements a leaf of another type draws at a time (512 MiB): whole
# slices of its leading axis, one slice where a slice is larger
DRAW_BLOCK = 1 << 27


def _drawn(shape, dtype, device, fill) -> torch.Tensor:
    """A leaf of ``shape`` in ``dtype`` whose values ``fill(t)`` draws in
    place into f32 tensors ``t``.  An f32 leaf (or a 1-D one) is one draw;
    any other type is allocated in that type and drawn block by block of
    whole slices of the leading axis (at most DRAW_BLOCK elements unless one
    slice is larger), each block cast into place, so that the f32 transient
    is one block and not the leaf (a stacked [46, 4608, 36864] bf16 leaf
    would need a 31 GB one)."""
    if dtype == torch.float32 or len(shape) < 2:
        t = torch.empty(shape, dtype=torch.float32, device=device)
        fill(t)
        return t.to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, DRAW_BLOCK // math.prod(shape[1:]))
    for i in range(0, shape[0], rows):
        t = torch.empty(out[i:i + rows].shape, dtype=torch.float32, device=device)
        fill(t)
        out[i:i + rows] = t
        del t  # before the next block is allocated
    return out


def dense_init(generator: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32, *, device) -> torch.Tensor:
    """Truncated normal at ±2σ, fan-in scaled (maxtext-style); drawn in f32
    on ``device`` (the generator's device) and cast to ``dtype`` (``_drawn``:
    block by block of the leading axis for a type other than f32)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = (scale if scale is not None else 1.0) / math.sqrt(fan_in)

    def fill(t):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(std)

    return _drawn(shape, dtype, device, fill)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32, *,
               device) -> torch.Tensor:
    """N(0, 0.02), drawn in f32 and cast as ``dense_init``."""
    return _drawn(shape, dtype, device,
                  lambda t: t.normal_(generator=generator).mul_(0.02))


def upcast(dtype: torch.dtype) -> torch.dtype:
    """``dtype`` raised to at least f32: where the reference computes in f32,
    the port does too, and in float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm in at least f32, cast back to ``x``'s dtype.

    ``zero_centered`` follows Gemma's (1 + w) parameterization.
    """
    dtype = x.dtype
    x = x.to(upcast(dtype))
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    w = (1.0 + weight) if zero_centered else weight
    return (x * w).to(dtype)


def make_rope(positions: torch.Tensor, d_head: int, theta: float = 10000.0,
              dtype=torch.float32):
    """(sin, cos) tables for rotary embedding in ``dtype`` (f32, as the
    reference, unless a float64 model asks for float64); positions [..., S]."""
    half = d_head // 2
    exps = torch.arange(0, half, dtype=dtype, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.to(dtype)[..., None] * freqs  # [..., S, half]
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Half-split rotation: (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin)
    with x1 the first and x2 the second half of the head dimension.

    x: [..., S, n_heads, d_head]; sin/cos: [..., S, half] broadcast over heads.
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin_ = sin[..., None, :].to(x.dtype)  # add head axis
    cos_ = cos[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_], dim=-1)


def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def fill_tree(shapes, make):
    """The tree of ``shapes`` (nested dicts of key -> shape) with each leaf
    ``make(key, shape)``."""
    return {k: fill_tree(v, make) if isinstance(v, dict) else make(k, v)
            for k, v in shapes.items()}


def count_params(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(count_params(v) for v in params.values())
