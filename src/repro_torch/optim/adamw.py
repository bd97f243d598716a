"""AdamW with fp32 master weights and configurable moment dtype.

Moments default to bf16 (memory-halving); set ``moment_dtype=torch.float32``
for exact parity with reference AdamW.  ``update`` is functional: it
returns new tensors and changes none of its inputs in place, so a caller
that still holds the old parameters or state keeps them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: dict  # first moment (moment_dtype)
    nu: dict  # second moment (moment_dtype)


def init(params, moment_dtype=torch.bfloat16) -> AdamWState:
    """Zero moments beside ``params`` (on each leaf's device); step 0 on the
    device of the first leaf."""
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def update(
    grads,
    state: AdamWState,
    params,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    """Returns (new_params, new_state). ``lr`` may be a scalar or a 0-d
    tensor (a schedule's value)."""
    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(g, m, v, p):
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        mhat = m32 / c1
        vhat = v32 / c2
        p32 = p.detach().float()
        new_p = p32 - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32)
        return new_p.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, grads, state.mu, state.nu, params)
    pick = lambda i: tree_map(lambda t: t[i], out)
    return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2))
