"""Mixture-of-Experts: a softmax top-k router and two dispatch engines, the
PyTorch port of :mod:`repro.models.moe`.

``moe_apply`` (the default): *sorted* dispatch. The token-expert
assignments are sorted by expert (a stable sort, as ``jnp.argsort``), each
expert's first ``capacity`` of them gathered into a buffer ``[E, C, D]``,
run through batched expert matmuls, and gathered back. The combine sums a
token's ``top_k`` rows in a fixed order, so the result does not depend on
the order of atomic adds (a scatter-add on the card would).

``moe_apply_onehot``: the reference einsum dispatch (Switch-style),
``O(T * E * C)`` memory, the plain cross-check of the sorted engine.

``moe_apply_auto`` (what the blocks call) takes the expert-parallel
dispatch of :mod:`repro_torch.models.moe_ep` under a mesh whose
``experts`` axis divides the experts and whose ``batch`` axes divide the
batch, and the sorted path otherwise.

All drop the assignments beyond an expert's capacity (their combine
weight is 0) and return the load-balancing aux loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (_axis_extent, current_mesh,
                                       current_rules)
from repro_torch.models.common import ACTIVATIONS, dense_init
from repro_torch.models.ffn import ffn_apply, init_ffn


def init_moe(generator: torch.Generator, d_model: int, expert_d_ff: int,
             n_experts: int, *, n_shared: int = 0,
             shared_d_ff: int | None = None, dtype=torch.float32,
             pad_to: int = 16) -> dict:
    """``pad_to``: the physical expert count is padded to a multiple of it
    (granite's 40 experts become 48). The router stays ``n_experts`` wide,
    so the padding experts never receive a token; the router is fp32 in
    every dtype."""
    e_phys = -(-n_experts // pad_to) * pad_to

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w.mul_(scale).to(dtype)

    p = {"router": dense_init(generator, d_model, n_experts, torch.float32),
         "experts_gate": normal((e_phys, d_model, expert_d_ff),
                                d_model ** -0.5),
         "experts_up": normal((e_phys, d_model, expert_d_ff),
                              d_model ** -0.5),
         "experts_down": normal((e_phys, expert_d_ff, d_model),
                                expert_d_ff ** -0.5)}
    if n_shared:
        p["shared"] = init_ffn(generator, d_model,
                               shared_d_ff or n_shared * expert_d_ff,
                               gated=True, dtype=dtype)
    return p


def moe_capacity(tokens: int, top_k: int, capacity_factor: float,
                 n_experts: int) -> int:
    """Assignments an expert takes; Python's ``round`` (half to even), as
    the reference."""
    return int(max(top_k, round(tokens * top_k * capacity_factor
                                / n_experts)))


def _route(params: dict, xt: torch.Tensor, top_k: int):
    """Router over ``xt: [T, D]`` in fp32. Returns ``(gate_vals [T, K],
    gate_idx [T, K], aux_loss)``: the top-k probabilities renormalized, and
    the Switch load-balance loss."""
    e = params["router"].shape[-1]
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    assigned = torch.zeros_like(probs).scatter_(1, gate_idx, 1.0)
    aux = e * torch.sum(probs.mean(0) * assigned.mean(0)) / top_k
    return gate_vals, gate_idx, aux


def _expert_ffn(params: dict, xe: torch.Tensor, activation: str,
                n_experts: int) -> torch.Tensor:
    """Batched per-expert GLU of the first ``n_experts`` experts:
    ``xe: [E, C, D] -> [E, C, D]``."""
    act = ACTIVATIONS[activation]
    gate, up, down = (params[k][:n_experts] for k in (
        "experts_gate", "experts_up", "experts_down"))
    return (act(xe @ gate) * (xe @ up)) @ down


def _with_shared(params: dict, y: torch.Tensor, x: torch.Tensor,
                 activation: str) -> torch.Tensor:
    if "shared" in params:
        y = y + ffn_apply(params["shared"], x, activation=activation)
    return y


def _sort_assignments(gate_idx: torch.Tensor, n_experts: int):
    """The assignments ``i = token * top_k + k`` sorted by expert, ties in
    order (a stable sort, as ``jnp.argsort``). Returns ``(flat_expert [TK],
    order [TK], start [E], count [E], rank [TK])``: an expert's first
    position in the sorted order and its number of assignments, and each
    assignment's rank within its expert, in (token, k) order."""
    tk = gate_idx.numel()
    dev = gate_idx.device
    flat_expert = gate_idx.reshape(tk)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    experts = torch.arange(n_experts, device=dev)
    start = torch.searchsorted(sorted_expert, experts)
    count = torch.searchsorted(sorted_expert, experts, right=True) - start
    rank = torch.empty_like(order)
    rank[order] = torch.arange(tk, device=dev) - start[sorted_expert]
    return flat_expert, order, start, count, rank


def _fill_buffer(xt: torch.Tensor, order: torch.Tensor, start: torch.Tensor,
                 count: torch.Tensor, capacity: int,
                 top_k: int) -> torch.Tensor:
    """The capacity buffers ``[E, C, D]`` of the experts whose ``start`` /
    ``count`` are given: row ``(e, c)`` holds the token of the expert's
    c-th assignment, zeros past its count. A gather, so no row is written
    twice and none out of range (the reference's scatter with
    ``mode="drop"``)."""
    c = torch.arange(capacity, device=xt.device)
    src = (start[:, None] + c).clamp(max=order.numel() - 1)
    filled = c < count[:, None]                               # [E, C]
    rows = xt[order[src] // top_k]
    return torch.where(filled[..., None], rows,
                       torch.zeros((), dtype=xt.dtype, device=xt.device))


def _combine(ye: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
             gate_vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``[T, D]``: each token's kept rows ``ye[dest]`` weighted by their
    gates, its ``top_k`` rows summed in fp32 in a fixed order (no atomics),
    then cast to ``dtype``."""
    t, top_k = gate_vals.shape
    out = torch.where(keep[:, None], ye[dest], torch.zeros(
        (), dtype=ye.dtype, device=ye.device))
    contrib = out * gate_vals.reshape(-1, 1).to(out.dtype)
    y = contrib.reshape(t, top_k, -1).sum(dim=1, dtype=torch.float32)
    return y.to(dtype)


def moe_apply(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, activation: str = "silu"):
    """Sorted-dispatch MoE. ``x: [B, S, D]`` -> ``(y, aux_loss)``."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    t, tk = b * s, b * s * top_k
    xt = x.reshape(t, d)
    gate_vals, gate_idx, aux = _route(params, xt, top_k)
    capacity = moe_capacity(t, top_k, capacity_factor, e)
    flat_expert, order, start, count, rank = _sort_assignments(gate_idx, e)
    buf = _fill_buffer(xt, order, start, count, capacity, top_k)
    ye = _expert_ffn(params, buf, activation, e).reshape(e * capacity, d)
    keep = rank < capacity
    dest = flat_expert * capacity + rank.clamp(max=capacity - 1)
    y = _combine(ye, dest, keep, gate_vals, x.dtype).reshape(b, s, d)
    return _with_shared(params, y, x, activation), aux


def moe_apply_onehot(params: dict, x: torch.Tensor, *, top_k: int,
                     capacity_factor: float = 1.25,
                     activation: str = "silu"):
    """Reference einsum dispatch (small inputs only)."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    t = b * s
    xt = x.reshape(t, d)
    gate_vals, gate_idx, aux = _route(params, xt, top_k)
    capacity = moe_capacity(t, top_k, capacity_factor, e)

    onehot = F.one_hot(gate_idx, e)                            # [T, K, E]
    flat = onehot.reshape(t * top_k, e)
    pos_in_expert = (flat.cumsum(0) - flat).reshape(t, top_k, e)
    pos = (pos_in_expert * onehot).sum(-1)                     # [T, K]
    keep = pos < capacity
    pos_oh = (F.one_hot(pos.clamp(max=capacity - 1), capacity)
              * keep[..., None])
    disp = torch.einsum("tke,tkc->tec", onehot.to(x.dtype),
                        pos_oh.to(x.dtype))
    comb = torch.einsum("tke,tkc,tk->tec", onehot.float(), pos_oh.float(),
                        gate_vals).to(x.dtype)
    xe = torch.einsum("tec,td->ecd", disp, xt)
    ye = _expert_ffn(params, xe, activation, e)
    y = torch.einsum("tec,ecd->td", comb, ye).reshape(b, s, d)
    return _with_shared(params, y, x, activation), aux


def moe_apply_auto(params: dict, x: torch.Tensor, *, top_k: int,
                   capacity_factor: float = 1.25, activation: str = "silu",
                   tp=None):
    """The dispatch engine of the blocks: the expert-parallel dispatch
    (``moe_ep.moe_apply_ep``, then the shared experts) when a mesh is
    active whose ``experts`` extent ``ep`` is above 1 and divides the
    physical experts and whose ``batch`` extent divides ``x.shape[0]``,
    exactly the reference's condition (over the global batch); the sorted
    path otherwise, over the global batch (on a mesh over ranks,
    ``moe_ep.moe_apply_gathered``). The sorted path carries none of the
    reference's
    activation annotations, so under a mesh it runs where the reference's
    raises (``ROADMAP.md`` R29a: its ``shard(h, "experts", None, "ff")``
    names the model axis twice).

    ``tp`` (a ``sharding.TpGroup``): the shared experts' FFN splits its
    columns over the group as ``ffn_apply(..., tp=)`` does (its leaves
    this rank's slices), beside either dispatch of the routed experts."""
    if tp is not None and "shared" in params:
        routed = {k: v for k, v in params.items() if k != "shared"}
        y, aux = moe_apply_auto(routed, x, top_k=top_k,
                                capacity_factor=capacity_factor,
                                activation=activation)
        return y + ffn_apply(params["shared"], x, activation=activation,
                             tp=tp), aux
    mesh = current_mesh()
    if mesh is not None:
        from repro_torch.models.moe_ep import moe_apply_ep
        rules = current_rules()
        ep = _axis_extent(mesh, rules.resolve("experts", mesh=mesh)[0])
        dp = _axis_extent(mesh, rules.resolve("batch", mesh=mesh)[0])
        e_phys = params["experts_gate"].shape[0]
        # on a mesh over ranks x holds this rank's rows of the batch
        b = x.shape[0] * (dp if mesh.on_ranks else 1)
        if ep > 1 and e_phys % ep == 0 and b % max(dp, 1) == 0:
            y, aux = moe_apply_ep(params, x, top_k=top_k,
                                  capacity_factor=capacity_factor,
                                  activation=activation)
            return _with_shared(params, y, x, activation), aux
        if mesh.on_ranks:
            from repro_torch.models.moe_ep import moe_apply_gathered
            return moe_apply_gathered(params, x, top_k=top_k,
                                      capacity_factor=capacity_factor,
                                      activation=activation)
    return moe_apply(params, x, top_k=top_k, capacity_factor=capacity_factor,
                     activation=activation)
