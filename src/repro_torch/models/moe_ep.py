"""Expert-parallel MoE dispatch, the PyTorch port of
:mod:`repro.models.moe_ep`.

The reference makes the parallelism explicit under ``shard_map``:

* tokens are data-parallel (split over the ``batch`` axes, replicated
  across the ``experts`` axis),
* each model rank owns ``E / ep`` experts,
* every rank routes its local tokens, gathers *only the assignments that
  target its own experts* into a local capacity buffer, runs its experts
  and combines locally,
* one ``psum`` over the experts axis sums the ranks' partial outputs.

Here the ``shard_map`` body is a loop over the data shards and, within
each, over the ranks: a shard's tokens and a rank's expert slice go to
that position's mesh device, the router statistics are averaged over the
data shards (the reference's ``pmean``), and the ranks' partials are summed
in rank order on the output's device (its ``psum``). The capacity is the
reference's, from the *local* token count, so an expert drops other
assignments than the sorted path over the whole batch would. The buffer
fill and the combine are ``moe.py``'s: a stable sort, a masked gather, a
token's ``top_k`` rows summed in a fixed order, no atomics. Differentiable
end to end; the mesh train step goes through it.

On a mesh over ranks (one process a position,
:mod:`repro_torch.dist.ranks`) the loop becomes collectives. The rank at
experts coordinate ``r`` holds its data shard's tokens, as every rank of
its experts group does, and runs experts ``[r e_local, (r+1) e_local)``.
Each rank routes the shard and sorts its assignments (the same choices and
capacity slots on every rank of the group), then sends each rank of the
group a capacity buffer of that rank's experts holding the slots of its own
``1 / ep`` of the tokens (``all_to_all``). A rank's slots from all sources
make the one-process loop's buffer, so each expert runs once on it; the
outputs go back to every source (the second ``all_to_all``), which combines
its tokens' parts in ascending rank order, as the loop adds them, and the
group sums the disjoint token slices (``psum_disjoint``). The router
statistics are summed over the data group (``psum``) and divided by its
size. The backward sums over the group the gradients each rank computes for
only its slice (``psum_grads``); an expert leaf's gradient lies on the
rank that runs the expert, and the train step sums those over the group.
"""
from __future__ import annotations

import torch

from repro_torch.dist.ranks import (all_gather, all_to_all, axis_group, psum,
                                    psum_disjoint, psum_grads)
from repro_torch.dist.sharding import (EXPERT_LEAVES, _axis_extent, _names,
                                       current_mesh, current_rules,
                                       expert_parallel_leaf, mesh_coords,
                                       shard)
from repro_torch.models.moe import (_combine, _expert_ffn, _fill_buffer,
                                    _sort_assignments, moe_apply,
                                    moe_capacity)

__all__ = ["moe_apply_ep", "moe_apply_gathered", "expert_parallel_leaf"]

def _route_local(router_w: torch.Tensor, xt: torch.Tensor, top_k: int):
    """One data shard's router over ``xt: [T, D]`` in fp32: ``(gate_vals
    [T, K], gate_idx [T, K], me [E], ce [E])``, the renormalized top-k and
    the shard's mean router probability and assigned share per expert,
    which the caller averages over the data shards before the aux loss."""
    probs = torch.softmax(xt.float() @ router_w, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    assigned = torch.zeros_like(probs).scatter_(1, gate_idx, 1.0)
    return gate_vals, gate_idx, probs.mean(0), assigned.mean(0)


def _positions(mesh, dp_axes, ep_name) -> dict:
    """``{(data shard, rank): device}``: the first mesh position of each
    pair, data shards numbered row-major over the ``batch`` axes."""
    out = {}
    for at, dev in mesh_coords(mesh):
        i = 0
        for n in _names(dp_axes):
            i = i * mesh.shape[n] + at[n]
        out.setdefault((i, at[ep_name]), torch.device(dev))
    return out


def moe_apply_ep(params: dict, x: torch.Tensor, *, top_k: int,
                 capacity_factor: float = 1.25, activation: str = "silu"):
    """Expert-parallel MoE. Requires an active mesh whose ``experts`` axis
    divides the expert count and whose ``batch`` axes divide ``x.shape[0]``
    (on a mesh over ranks ``x`` is this rank's rows of the batch).
    ``x: [B, S, D]`` -> ``(y, aux)``, ``y`` on ``x``'s device; the shared
    experts are the caller's (``moe_apply_auto``)."""
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("moe_apply_ep needs an active mesh (use_mesh)")
    rules = current_rules()
    e_total = params["router"].shape[-1]          # routable experts
    e_phys = params["experts_gate"].shape[0]      # padded physical experts
    ep_axes = rules.resolve("experts", mesh=mesh)[0]
    dp_axes = rules.resolve("batch", mesh=mesh)[0]
    ep = _axis_extent(mesh, ep_axes)
    dp = _axis_extent(mesh, dp_axes)
    b, s, d = x.shape
    if mesh.on_ranks:
        b *= dp
    if e_phys % ep or b % dp:
        raise ValueError(f"moe_apply_ep: {e_phys} experts over an experts "
                         f"extent of {ep}, a batch of {b} over {dp} shards")
    ep_name = _names(ep_axes)[0]
    if mesh.shape[ep_name] != ep:
        raise NotImplementedError(
            f"experts spread over several mesh axes {ep_axes}")
    e_local = e_phys // ep
    # the reference re-shards the EP x FSDP storage to pure EP here
    weights = [shard(params[k], "experts", None, None) for k in EXPERT_LEAVES]
    if mesh.on_ranks:
        return _moe_apply_ranks(params, weights, x, mesh, _names(dp_axes),
                                ep_name, top_k, capacity_factor, activation)
    at = _positions(mesh, dp_axes, ep_name)

    bl = b // dp
    t = bl * s
    cap = moe_capacity(t, top_k, capacity_factor, e_total)
    routed = []
    for i in range(dp):
        dev = at[(i, 0)]
        xt = x[i * bl:(i + 1) * bl].reshape(t, d).to(dev)
        routed.append((xt, *_route_local(params["router"].to(dev), xt,
                                         top_k)))
    # global router statistics (the Switch aux is nonlinear in the batch);
    # every shard's aux is this one value, and so is their mean
    me = torch.stack([r[3].to(x.device) for r in routed]).mean(0)
    ce = torch.stack([r[4].to(x.device) for r in routed]).mean(0)
    aux = e_total * torch.sum(me * ce) / top_k

    ys = []
    for i, (xt, gate_vals, gate_idx, _, _) in enumerate(routed):
        flat_e, order, start, count, rank = _sort_assignments(gate_idx,
                                                              e_phys)
        keep = rank < cap
        y = None
        for r in range(ep):
            dev = at[(i, r)]
            e0 = r * e_local
            local = {k: w[e0:e0 + e_local].to(dev)
                     for k, w in zip(EXPERT_LEAVES, weights)}
            buf = _fill_buffer(xt.to(dev), order.to(dev),
                               start[e0:e0 + e_local].to(dev),
                               count[e0:e0 + e_local].to(dev), cap, top_k)
            ye = _expert_ffn(local, buf, activation, e_local).reshape(
                e_local * cap, d)
            mine = keep & (flat_e >= e0) & (flat_e < e0 + e_local)
            dest = ((flat_e - e0).clamp(0, e_local - 1) * cap
                    + rank.clamp(max=cap - 1))
            part = _combine(ye, dest.to(dev), mine.to(dev),
                            gate_vals.to(dev), x.dtype).to(x.device)
            y = part if y is None else y + part      # the psum, rank order
        ys.append(y.reshape(bl, s, d))
    return torch.cat(ys), aux


def _moe_apply_ranks(params, weights, x, mesh, dp_names, ep_name, top_k,
                     capacity_factor, activation):
    """:func:`moe_apply_ep` on a mesh over ranks; ``x``: this rank's rows."""
    e_total = params["router"].shape[-1]
    ep = mesh.shape[ep_name]
    e_local = weights[0].shape[0] // ep
    me_r = mesh.coords()[ep_name]
    experts = axis_group(mesh, ep_name)
    data = axis_group(mesh, dp_names)
    dp = _axis_extent(mesh, dp_names)
    b, s, d = x.shape
    t = b * s
    cap = moe_capacity(t, top_k, capacity_factor, e_total)
    xt = x.reshape(t, d)

    gate_vals, gate_idx, me, ce = _route_local(params["router"], xt, top_k)
    me = psum(me, data) / dp
    ce = psum(ce, data) / dp
    aux = e_total * torch.sum(me * ce) / top_k

    flat_e, order, start, count, rank = _sort_assignments(
        gate_idx, weights[0].shape[0])
    keep = rank < cap
    # this rank's slice of the group's tokens: it sends their slots and
    # combines their outputs
    tok = torch.arange(t, device=x.device)
    ours = (tok >= me_r * t // ep) & (tok < (me_r + 1) * t // ep)
    sent = torch.where(ours[:, None], psum_grads(xt, experts),
                       torch.zeros((), dtype=x.dtype, device=x.device))
    buf = _fill_buffer(sent, order, start, count, cap, top_k)
    got = all_to_all(buf.reshape(ep, e_local, cap, d), experts).sum(0)
    local = {k: w[me_r * e_local:(me_r + 1) * e_local]
             for k, w in zip(EXPERT_LEAVES, weights)}
    ye = _expert_ffn(local, got, activation, e_local)
    back = all_to_all(ye.expand(ep, *ye.shape), experts)

    gv = psum_grads(gate_vals, experts)
    ours = ours.repeat_interleave(top_k)
    y = None
    for r in range(ep):
        e0 = r * e_local
        mine = ours & keep & (flat_e >= e0) & (flat_e < e0 + e_local)
        dest = ((flat_e - e0).clamp(0, e_local - 1) * cap
                + rank.clamp(max=cap - 1))
        part = _combine(back[r].reshape(e_local * cap, d), dest, mine, gv,
                        x.dtype)
        y = part if y is None else y + part      # the psum, rank order
    return psum_disjoint(y, experts).reshape(b, s, d), aux


def moe_apply_gathered(params: dict, x: torch.Tensor, *, top_k: int,
                       capacity_factor: float = 1.25,
                       activation: str = "silu"):
    """The sorted-dispatch MoE (``moe.moe_apply``, shared experts included)
    on a mesh over ranks where the expert-parallel branch is not taken:
    its capacity and router statistics are the global batch's, so the data
    group's rows are gathered (``all_gather``, as GSPMD would gather them),
    every rank runs the global batch, and each keeps its own rows."""
    mesh = current_mesh()
    dp_names = _names(current_rules().resolve("batch", mesh=mesh)[0])
    data = axis_group(mesh, dp_names)
    b = x.shape[0]
    y, aux = moe_apply(params, all_gather(x, data), top_k=top_k,
                       capacity_factor=capacity_factor, activation=activation)
    i = mesh.coords()
    at = 0
    for n in dp_names:
        at = at * mesh.shape[n] + i[n]
    return y[at * b:(at + 1) * b], aux
