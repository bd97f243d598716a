"""Int8 gradient compression with error feedback (cross-pod DP reduce).

At 1000+-node scale the inter-pod reduce dominates the step; compressing
the payload 4x (f32 -> int8 with a per-tensor scale) cuts it
proportionally.  Error feedback (Seide et al.; 1-bit SGD lineage)
accumulates the quantization residual into the next step so convergence
is preserved.

Usage (train step): g_q, scale = compress(g + err); err = (g + err) - decompress(...)
The reduce then runs over the int8 payload: ``psum_compressed`` over a
mesh axis (:mod:`repro_torch.launch.collectives`).  The arithmetic is the
reference's, in f32: ``torch.round`` rounds half to even as ``jnp.round``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..launch.collectives import psum
from .tree import tree_leaves, tree_map, tree_unflatten


class ErrorFeedbackState(NamedTuple):
    err: dict


def init_error_feedback(params) -> ErrorFeedbackState:
    """Zero f32 residuals beside ``params``."""
    return ErrorFeedbackState(err=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 in [-127, 127], 0-d f32 scale = max|x| / 127 + 1e-12)."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, ef: ErrorFeedbackState):
    """Returns (quantized pytree of (q, scale), new error-feedback state)."""
    corrected = tree_map(lambda g, e: g.to(torch.float32) + e, grads, ef.err)
    pairs = [quantize_int8(c) for c in tree_leaves(corrected)]
    qs = tree_unflatten(corrected, [q for q, _ in pairs])
    ss = tree_unflatten(corrected, [s for _, s in pairs])
    deq = tree_map(dequantize_int8, qs, ss)
    new_err = tree_map(lambda c, d: c - d, corrected, deq)
    return (qs, ss), ErrorFeedbackState(err=new_err)


def decompress_grads(qs, ss):
    return tree_map(dequantize_int8, qs, ss)


def psum_compressed(qs: Sequence, ss: Sequence, mesh, axis) -> List:
    """All-reduce int8 payloads over ``axis`` of ``mesh``: ``qs``/``ss`` hold
    one tree a shard (shard ``k``'s quantized gradients and scales); each
    shard's int8 leaves are widened (int32, then f32, exact), times their
    scale, summed over the axis and divided by its size.  Returns each
    shard's dequantized mean gradient tree."""
    n = mesh.axis_size(axis)
    leaves = [[dequantize_int8(q.to(torch.int32), s)
               for q, s in zip(tree_leaves(qk), tree_leaves(sk))] for qk, sk in zip(qs, ss)]
    per_leaf = [psum([shard_leaves[i] for shard_leaves in leaves], mesh, axis)
                for i in range(len(leaves[0]))]
    return [tree_unflatten(qs[k], [summed[k] / n for summed in per_leaf])
            for k in range(mesh.size)]
