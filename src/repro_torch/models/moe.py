"""Mixture-of-Experts FFN: top-k routing, sorted dispatch, scatter-add combine.

Tokens' (token, expert) assignments are sorted stably by expert id, so each
expert's tokens form one contiguous group; the expert products run on those
groups and the results come back to their tokens with ``index_add_`` (the
reference's ``segment_sum``).  Three forms of the same function, as in the
reference:

- ``ragged`` (the default): one ``torch.matmul`` per expert over its group,
  exactly the top-k products (the reference's ``jax.lax.ragged_dot``);
- ``capacity``: every expert's group padded or cut to a fixed capacity C,
  then batched ``[E, C, D] x [E, D, F]`` products; assignments beyond an
  expert's capacity are dropped, in the stable sort's order;
- ``dense``: every token through every expert, masked by the combine
  weights (tests and tiny configs).

Routing (softmax, top-k) is computed in at least f32.  The sharded forms
over a mesh (``make_sharded_moe_ffn``: local dispatch per data shard and
expert weights split on F; ``make_weight_stationary_moe_ffn``: the decode
form, weights split on D and F, activations gathered) are ``moe_fn``s for
``transformer.forward``/``decode_step``, written with
:mod:`repro_torch.launch.collectives`.  ``place_experts`` places each
layer's router and expert weights once by a form's specs
(``sharded_specs``, ``weight_stationary_specs``); a form handed such
parameters moves no weight between cards.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import LMConfig
from ..launch.collectives import P, all_gather, axis_index, place, psum, shard, unshard
from ..launch.mesh import axes_tuple
from .common import activation, upcast

CAPACITY_FACTOR = 1.25


def moe_shapes(cfg: LMConfig) -> Dict:
    """The layer-stacked MoE leaves as key -> shape; ``transformer.init_params``
    draws them fan-in scaled, as the reference's ``init_moe_layer`` does."""
    L, D = cfg.n_layers, cfg.d_model
    E, F = cfg.moe.n_experts, cfg.moe.d_ff
    return {"router": (L, D, E), "we_gate": (L, E, D, F), "we_up": (L, E, D, F),
            "we_down": (L, E, F, D)}


def moe_ffn(cfg: LMConfig, lw: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: [T, D] -> [T, D]. ``lw`` holds this layer's (unstacked) weights."""
    impl = {"dense": _moe_dense, "capacity": _moe_capacity}.get(cfg.moe.impl, _moe_ragged)
    return impl(cfg, lw, x)


def router_probs(cfg: LMConfig, lw: Dict, x: torch.Tensor):
    """(top_p [T, K] renormalized, top_i [T, K]) from the router's softmax."""
    dt = upcast(x.dtype)
    probs = torch.softmax(x.to(dt) @ lw["router"].to(dt), dim=-1)
    top_p, top_i = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return top_p / torch.sum(top_p, dim=-1, keepdim=True), top_i  # renormalize (Mixtral)


def _dispatch(cfg: LMConfig, lw: Dict, x: torch.Tensor):
    """The assignments sorted stably by expert: (the token of each, its
    weight, each expert's group size [E] int64)."""
    top_p, top_i = router_probs(cfg, lw, x)
    flat_e = top_i.reshape(-1)  # [T*K]
    order = torch.argsort(flat_e, stable=True)  # groups tokens by expert
    tok_of = torch.div(order, cfg.moe.top_k, rounding_mode="floor")
    # a scatter of ones, not bincount, which reads the largest id back to the host
    group_sizes = torch.zeros(cfg.moe.n_experts, dtype=flat_e.dtype, device=x.device)
    group_sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    return tok_of, top_p.reshape(-1)[order], group_sizes


def _moe_ragged(cfg: LMConfig, lw: Dict, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    tok_of, w_of, group_sizes = _dispatch(cfg, lw, x)
    xs = x.index_select(0, tok_of)  # [T*K, D] in expert order
    ys, start = [], 0
    for e, n in enumerate(group_sizes.tolist()):
        xe = xs[start:start + n]
        h = act(xe @ lw["we_gate"][e]) * (xe @ lw["we_up"][e])
        ys.append(h @ lw["we_down"][e])
        start += n
    y = torch.cat(ys)  # [T*K, D]
    out = torch.zeros_like(y[:x.shape[0]])
    return out.index_add_(0, tok_of, y * w_of.to(y.dtype)[:, None]).to(x.dtype)


def capacity(n_tokens: int, cfg: LMConfig) -> int:
    """Slots per expert: ceil(T*K / E) * 1.25, cut to an int, then rounded
    up to a multiple of 128 (the reference's expression, token for token)."""
    c = int(-(-(n_tokens * cfg.moe.top_k) // cfg.moe.n_experts * CAPACITY_FACTOR))
    return -(-c // 128) * 128


def _capacity_slots(cfg: LMConfig, lw: Dict, x: torch.Tensor, c: int):
    """Each expert's ``c`` slots over ``x``'s assignments: (the token of
    each slot [E*C], which slots hold one [E, C], their combine weights
    [E, C], 0 in empty slots)."""
    T, K = x.shape[0], cfg.moe.top_k
    tok_of, w_of, group_sizes = _dispatch(cfg, lw, x)
    starts = torch.cumsum(group_sizes, 0) - group_sizes  # [E]
    arange = torch.arange(c, device=x.device)
    slot = torch.clamp(starts[:, None] + arange[None, :], 0, T * K - 1)  # [E, C]
    valid = arange[None, :] < group_sizes[:, None]
    return tok_of[slot].reshape(-1), valid, w_of[slot] * valid


def _combine(y: torch.Tensor, rows: torch.Tensor, wslot: torch.Tensor,
             n_tokens: int) -> torch.Tensor:
    """Slot outputs y [E, C, d] weighted and added onto their tokens -> [T, d]."""
    E, c, d = y.shape
    out = torch.zeros((n_tokens, d), dtype=y.dtype, device=y.device)
    return out.index_add_(0, rows, (y * wslot.to(y.dtype)[..., None]).reshape(E * c, d))


def _moe_capacity(cfg: LMConfig, lw: Dict, x: torch.Tensor) -> torch.Tensor:
    """Capacity-based dispatch (GShard lineage): bounded memory (E*C*F),
    identical shapes for any routing; overflowing assignments are dropped."""
    T, D = x.shape
    E = cfg.moe.n_experts
    act = activation(cfg.act)
    c = capacity(T, cfg)
    rows, valid, wslot = _capacity_slots(cfg, lw, x, c)
    xs = x.index_select(0, rows).reshape(E, c, D) * valid[..., None].to(x.dtype)
    h = act(torch.bmm(xs, lw["we_gate"])) * torch.bmm(xs, lw["we_up"])
    y = torch.bmm(h, lw["we_down"])  # [E, C, D]
    return _combine(y, rows, wslot, T).to(x.dtype)


def _moe_dense(cfg: LMConfig, lw: Dict, x: torch.Tensor) -> torch.Tensor:
    """Masked all-experts path (O(T*E) compute): tests and tiny configs."""
    act = activation(cfg.act)
    top_p, top_i = router_probs(cfg, lw, x)
    comb = torch.zeros((x.shape[0], cfg.moe.n_experts), dtype=top_p.dtype, device=x.device)
    comb = comb.scatter(1, top_i, top_p)  # combine weights [T, E]
    h = act(torch.einsum("td,edf->tef", x, lw["we_gate"]))
    h = h * torch.einsum("td,edf->tef", x, lw["we_up"])
    y = torch.einsum("tef,efd->ted", h, lw["we_down"])
    return torch.einsum("ted,te->td", y, comb.to(y.dtype)).to(x.dtype)



# ---------------------------------------------------------------------------
# sharded forms over a mesh
# ---------------------------------------------------------------------------
_EXPERT_KEYS = ("router", "we_gate", "we_up", "we_down")


def _shard_layer(lw: Dict, mesh, specs: Dict) -> list:
    """This layer's router and expert weights by ``specs``: one dict a
    shard (placed weights as they are, whole ones cut for this call)."""
    parts = {k: shard(lw[k], mesh, specs[k]) for k in _EXPERT_KEYS}
    return [{k: parts[k][i] for k in _EXPERT_KEYS} for i in range(mesh.size)]


def weight_stationary_specs(dp, tp: str = "model") -> Dict[str, P]:
    """Per-layer specs of ``make_weight_stationary_moe_ffn``'s weights."""
    return {"router": P(), "we_gate": P(None, dp, tp), "we_up": P(None, dp, tp),
            "we_down": P(None, tp, dp)}


def sharded_specs(tp: str = "model") -> Dict[str, P]:
    """Per-layer specs of ``make_sharded_moe_ffn``'s weights."""
    return {"router": P(), "we_gate": P(None, None, tp), "we_up": P(None, None, tp),
            "we_down": P(None, tp, None)}


def place_experts(params: Dict, mesh, specs: Dict) -> Dict:
    """``params`` with each layer-stacked router and expert leaf placed on
    ``mesh`` by ``specs`` (the layer dim whole): every block on its
    shard's card, once.  The other leaves are ``params``' own; the whole
    expert tensors are not kept, so dropping ``params`` frees them."""
    layers = {k: (place(v, mesh, P(None, *specs[k])) if k in _EXPERT_KEYS else v)
              for k, v in params["layers"].items()}
    return {**params, "layers": layers}


def make_weight_stationary_moe_ffn(cfg: LMConfig, mesh, dp, tp: str = "model"):
    """Decode-path MoE: activations move, weights do not.

    The expert weights split ``[E, D/dp, F/tp]`` (``we_down`` ``[E, F/tp,
    D/dp]``, ``weight_stationary_specs``); placed once by
    ``place_experts``, each block stays on its shard's card (a whole layer
    is cut on every call).  The (tiny) token batch ``x [T, D]``, split
    over ``dp``, is all-gathered, every shard dispatches the whole batch
    (capacity from the gathered T), contracts its (D, F) tile, and the
    partials merge with activation-sized psums: over ``dp`` for the gate
    and up products, over ``tp`` for the down product, then an all-gather
    of the D slices.
    Returns ``moe_fn(lw, x) -> [T, D]`` on x's device.
    """
    dp_axes = axes_tuple(dp)
    n_dp = mesh.axis_size(dp_axes)
    specs = weight_stationary_specs(dp, tp)
    act = activation(cfg.act)
    E = cfg.moe.n_experts

    def moe_fn(lw: Dict, x2d: torch.Tensor) -> torch.Tensor:
        lw_l = _shard_layer(lw, mesh, specs)
        xg = all_gather(shard(x2d, mesh, P(dp, None)), mesh, dp_axes, axis=0, tiled=True)
        T, D = xg[0].shape
        d_loc, c = D // n_dp, capacity(T, cfg)
        slots, gates, ups = [], [], []
        for k, idx in enumerate(axis_index(mesh, dp_axes)):
            rows, valid, wslot = _capacity_slots(cfg, lw_l[k], xg[k], c)
            xs = xg[k].index_select(0, rows).reshape(E, c, D) * valid[..., None].to(xg[k].dtype)
            xs_loc = xs[:, :, idx * d_loc:(idx + 1) * d_loc]  # this shard's D tile
            gates.append(torch.bmm(xs_loc, lw_l[k]["we_gate"]))
            ups.append(torch.bmm(xs_loc, lw_l[k]["we_up"]))
            slots.append((rows, wslot))
        gates, ups = psum(gates, mesh, dp_axes), psum(ups, mesh, dp_axes)
        outs = []
        for k, (rows, wslot) in enumerate(slots):
            y = torch.bmm(act(gates[k]) * ups[k], lw_l[k]["we_down"])  # [E, C, D/dp]
            outs.append(_combine(y, rows, wslot, T))
        out = all_gather(psum(outs, mesh, tp), mesh, dp_axes, axis=1, tiled=True)
        return unshard(out, mesh, P(), device=x2d.device).to(x2d.dtype)

    return moe_fn


def make_sharded_moe_ffn(cfg: LMConfig, mesh, dp, tp: str = "model"):
    """MoE block over a mesh: local dispatch per data shard + expert TP.

    Tokens ``x [T, D]`` stay on their ``dp`` shard (each shard's capacity
    dispatch is its own, over its T/dp tokens); the expert weights split
    their hidden axis over ``tp`` (``[E, D, F/tp]``, ``we_down`` ``[E,
    F/tp, D]``, ``sharded_specs``; placed once by ``place_experts`` or cut
    per call), and the down product's partials merge with one psum over
    ``tp``.  Returns ``moe_fn(lw, x) -> [T, D]`` on x's device.
    """
    specs = sharded_specs(tp)

    def moe_fn(lw: Dict, x2d: torch.Tensor) -> torch.Tensor:
        lw_l = _shard_layer(lw, mesh, specs)
        x_l = shard(x2d, mesh, P(dp, None))
        ys = [_moe_capacity(cfg, lw_l[k], x_l[k]) for k in range(mesh.size)]
        return unshard(psum(ys, mesh, tp), mesh, P(dp, None), device=x2d.device)

    return moe_fn


def load_balance_loss(cfg: LMConfig, lw: Dict, x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * p_e, with f_e the share
    of the top-k assignments that go to expert e and p_e its mean router
    probability, from f32 router logits."""
    logits = x.float() @ lw["router"].float()
    probs = torch.softmax(logits, dim=-1)
    _, top_i = torch.topk(probs, cfg.moe.top_k, dim=-1)
    E = cfg.moe.n_experts
    counts = torch.bincount(top_i.reshape(-1), minlength=E).float()
    f = counts / torch.clamp(counts.sum(), min=1.0)
    p = probs.mean(dim=0)
    return E * torch.sum(f * p)
