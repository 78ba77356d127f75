"""GPipe-style pipeline parallelism over a mesh axis, the PyTorch port of
:mod:`repro.dist.pipeline`.

Each stage holds its own weights (``ws`` split over the stage axis); the
microbatch stream enters at stage 0 and flows one hop per tick. With M
microbatches and S stages the schedule runs ``M + S - 1`` ticks, written
out here as a loop (the reference's ``shard_map`` over a ``lax.scan``):
at every tick every stage runs on its mesh device, and each stage's output
is copied to the next stage's device (the reference's ring ``ppermute``).
Outputs are collected on the last stage. Warm-up and drain ticks compute
on zero buffers whose results are never written back — the usual bubble,
made explicit.

The mesh may list one device k times or distinct devices: the stages'
copies are then transfers between cards (written, not measured: the
machine this port is measured on has one card).
"""
from __future__ import annotations

import torch

from repro_torch.dist.elastic import Mesh
from repro_torch.dist.sharding import mesh_coords
from repro_torch.train.optim import tree_map


def split_microbatches(batch, n_micro: int):
    """Reshape ``[B, ...]`` leaves to ``[n_micro, B // n_micro, ...]``."""
    return tree_map(
        lambda a: a.reshape(n_micro, a.shape[0] // n_micro, *a.shape[1:]),
        batch)


def pipeline_forward(stage_fn, mesh: Mesh, axis: str, n_micro: int):
    """Build ``fwd(ws, xs)``: ``ws: [S, ...]`` per-stage weights, ``xs:
    [M, mb, ...]`` microbatches -> ``[M, mb, ...]`` outputs of the last
    stage, on its device. ``stage_fn(w, x)`` must be shape-preserving
    (stage interfaces match by construction in a layered model). Stage
    ``s`` runs on the first mesh device whose ``axis`` coordinate is
    ``s``; the other axes replicate, as the reference's ``P(axis)``.
    ``n_micro`` is the reference's argument; as there, the schedule takes
    the count of microbatches from ``xs``."""
    n_stages = mesh.shape[axis]
    devs = [None] * n_stages
    for at, dev in mesh_coords(mesh):
        if devs[at[axis]] is None:
            devs[at[axis]] = torch.device(dev)

    def fwd(ws, xs):
        if ws.shape[0] != n_stages:
            raise ValueError(f"{ws.shape[0]} stage weights for a stage axis "
                             f"of {n_stages}")
        w = [ws[s].to(devs[s]) for s in range(n_stages)]
        xs_in = xs.to(devs[0])
        m = xs.shape[0]
        # buf[s]: what stage s consumes this tick (stage 0 reads xs)
        buf = [torch.zeros_like(xs[0], device=d) for d in devs]
        outs = [None] * m
        for t in range(m + n_stages - 1):
            nxt = list(buf)
            for s in range(n_stages):
                inp = xs_in[min(t, m - 1)] if s == 0 else buf[s]
                out = stage_fn(w[s], inp)
                if s + 1 < n_stages:
                    nxt[s + 1] = out.to(devs[s + 1])
                elif t >= n_stages - 1:
                    # the last stage finishes microbatch t - (S-1) at tick t
                    outs[t - (n_stages - 1)] = out
            buf = nxt
        return torch.stack(outs)

    return fwd
