"""AdamW with fp32 master weights and configurable moment dtype.

Moments default to bf16 (memory-halving); set ``moment_dtype=torch.float32``
for exact parity with reference AdamW.  ``update`` is functional: it
returns new tensors and changes none of its inputs in place, so a caller
that still holds the old parameters or state keeps them.  ``update_`` does
the same arithmetic in place, a slice at a time, for models whose old and
new trees would not fit beside each other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .tree import leaf_slices, tree_leaves, tree_map


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


def _corrections(step: torch.Tensor, b1: float, b2: float):
    return 1.0 - b1 ** step.float(), 1.0 - b2 ** step.float()


def _leaf(g, m, v, p, lr, c1, c2, b1, b2, eps, weight_decay):
    """One leaf's (new p, new m, new v) in p's and the moments' dtypes."""
    g32 = g.float()
    m32 = b1 * m.float() + (1 - b1) * g32
    v32 = b2 * v.float() + (1 - b2) * g32 * g32
    mhat = m32 / c1
    vhat = v32 / c2
    p32 = p.detach().float()
    new_p = p32 - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32)
    return new_p.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


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
    c1, c2 = _corrections(step, b1, b2)
    out = tree_map(lambda g, m, v, p: _leaf(g, m, v, p, lr, c1, c2, b1, b2, eps, weight_decay),
                   grads, state.mu, state.nu, params)
    pick = lambda i: tree_map(lambda t: t[i], out)
    return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2))


def update_(
    grads,
    state: AdamWState,
    params,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> AdamWState:
    """``update`` in place: every parameter and moment is overwritten with
    the values ``update`` returns (bitwise: the same elementwise arithmetic),
    one ``leaf_slices`` slice at a time, so the temporaries stay one layer
    of a stacked leaf large.  Returns the new state, which holds the same
    moment tensors; ``state.step`` itself is not changed."""
    step = state.step + 1
    c1, c2 = _corrections(step, b1, b2)
    with torch.no_grad():
        for leaves in zip(tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
                          tree_leaves(params)):
            for g, m, v, p in zip(*map(leaf_slices, leaves)):
                new = _leaf(g, m, v, p, lr, c1, c2, b1, b2, eps, weight_decay)
                for dst, src in zip((p, m, v), new):
                    dst.copy_(src)
    return AdamWState(step=step, mu=state.mu, nu=state.nu)
