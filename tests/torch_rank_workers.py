"""The rank workers of the CPU rank tests (``test_torch_ranks.py``,
``test_torch_rank_train.py``). Each runs in a process that
``repro_torch.dist.ranks.spawn_ranks`` starts, one a rank over gloo, and
returns numpy arrays and plain values. This module imports only numpy,
torch and ``repro_torch``: a child imports it to find its worker, and a
child that imported JAX would be slow.
"""
import contextlib
import io
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import shard_batch
from repro_torch.dist import ranks
from repro_torch.dist.elastic import Mesh, best_mesh
from repro_torch.dist.pipeline import pipeline_forward, split_microbatches
from repro_torch.dist.sharding import (P, AxisRules, NamedSharding,
                                       device_put, mesh_device, use_mesh)
from repro_torch.launch import train as launch_train
from repro_torch.models import moe_ep
from repro_torch.models.lm import init_lm, lm_params_from_numpy
from repro_torch.train import trainer
from repro_torch.train.optim import (AdamConfig, constant_schedule,
                                     tree_leaves)

AXES = (("data",), ("model",), ("data", "model"))


def fail_on(rank, bad):
    """Raise on rank ``bad``; the others wait in a collective that never
    completes."""
    if rank == bad:
        raise ValueError(f"rank {rank} of {dist.get_world_size()} is out")
    dist.barrier()


def stall(rank, seconds):
    """Every rank but 0 sleeps ``seconds``; rank 0 waits for them."""
    if rank:
        time.sleep(seconds)
    dist.barrier()


def mesh_layout(rank, mps):
    """For each model-parallel degree: the mesh over the ranks, this rank's
    position and device, and the ranks of its group over each of
    ``AXES`` (built once, then read from the mesh)."""
    out = {}
    for mp in mps:
        mesh = best_mesh(model_parallel=mp)
        groups = {}
        for names in AXES:
            g = ranks.axis_group(mesh, names)
            assert ranks.axis_group(mesh, names[::-1]) is g
            groups[names] = dist.get_process_group_ranks(g)
        out[mp] = {"shape": mesh.shape, "coords": mesh.coords(),
                   "ranks": mesh.ranks.tolist(),
                   "device": str(mesh_device(mesh)), "groups": groups,
                   "on_ranks": mesh.on_ranks}
    return out


def placements(rank, mps, arrays, specs, batch):
    """This rank's blocks: ``device_put`` of each array under each spec
    and ``shard_batch`` of ``batch``, on each mesh."""
    out = {}
    for mp in mps:
        mesh = best_mesh(model_parallel=mp)
        put = {}
        for name, a in arrays.items():
            for spec in specs:
                t = device_put(torch.from_numpy(a),
                               NamedSharding(mesh, P(*spec)))
                put[(name, spec)] = (t.numpy(), tuple(t.sharding.spec))
        placed = shard_batch({k: torch.from_numpy(v)
                              for k, v in batch.items()}, mesh)
        out[mp] = {"put": put, "coords": mesh.coords(),
                   "batch": {k: (v.numpy(), tuple(v.sharding.spec))
                             for k, v in placed.items()}}
    return out


def moe_forward_backward(rank, mps, params, x, r, top_k, cfs):
    """For each model-parallel degree, ``moe_apply_ep`` on this rank's rows
    of ``x`` at each capacity factor, and the loss ``sum(y * r) + aux``
    backward: the gradients reduced as the train step reduces them
    (expert stacks summed over the experts group, then averaged over the
    data group), and ``x``'s."""
    return {mp: _moe_on(best_mesh(model_parallel=mp), params, x, r, top_k,
                        cfs) for mp in mps}


def _moe_on(mesh, params, x, r, top_k, cfs):
    rules = AxisRules()
    out = {"coords": mesh.coords()}
    for cf in cfs:
        live = {k: torch.from_numpy(v).requires_grad_(True)
                for k, v in params.items()}
        before = dict(ranks.COLLECTIVES)
        with use_mesh(mesh, rules):
            rows = shard_batch({"x": torch.from_numpy(x),
                                "r": torch.from_numpy(r)}, mesh, rules)
            xl = rows["x"].requires_grad_(True)
            y, aux = moe_ep.moe_apply_ep(live, xl, top_k=top_k,
                                         capacity_factor=cf)
            loss = torch.sum(y * rows["r"]) + aux
            loss.backward()
            grads, _ = trainer._reduce_over_ranks(
                {k: p.grad for k, p in live.items()},
                {"loss": loss.detach()}, mesh, rules)
        out[cf] = {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
                   "grads": {k: g.numpy() for k, g in grads.items()},
                   "dx": xl.grad.numpy(),
                   "collectives": {k: v - before[k] for k, v in
                                   ranks.COLLECTIVES.items()}}
    return out


def bucket_reduction(rank, mps):
    """For each model-parallel degree, ``trainer._reduce_over_ranks`` of a
    tree of fp32 and bf16 leaves (values of this rank, exact in bf16) and
    two fp32 metrics: the reduced leaves as fp32 arrays with their dtypes,
    the metrics, and the all-reduces it issued."""
    out = {}
    for mp in mps:
        mesh = best_mesh(model_parallel=mp)
        base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        grads = {"a": base + rank, "b": (base * 0.5 - rank).to(torch.bfloat16),
                 "c": [torch.full((5,), 0.25 * rank),
                       torch.full((4,), 2.0 * rank, dtype=torch.bfloat16)]}
        metrics = {"loss": torch.tensor(1.0 + rank),
                   "tokens": torch.tensor(8.0)}
        before = ranks.COLLECTIVES["all_reduce"]
        got, m = trainer._reduce_over_ranks(grads, metrics, mesh,
                                            AxisRules())
        out[mp] = {"coords": mesh.coords(),
                   "grads": [(g.float().numpy(), str(g.dtype))
                             for g in tree_leaves(got)],
                   "metrics": {k: float(v) for k, v in m.items()},
                   "all_reduce": ranks.COLLECTIVES["all_reduce"] - before}
    return out


def pipelines(rank, cases):
    """For each ``(shape, names, ws, x, n_micro)``: ``pipeline_forward`` of
    ``tanh(x @ w)`` stages on a mesh over the ranks of ``shape`` (the
    stage axis first)."""
    out = []
    for shape, names, ws, x, n_micro in cases:
        mesh = Mesh(np.array(ranks.rank_devices(), dtype=object).reshape(
            shape), names, ranks=np.arange(int(np.prod(shape))).reshape(
                shape))
        fwd = pipeline_forward(lambda w, xm: torch.tanh(xm @ w), mesh,
                               names[0], n_micro)
        xs = split_microbatches(torch.from_numpy(x), n_micro)
        out.append(fwd(torch.from_numpy(ws), xs).numpy())
    return out


def _routes(calls):
    orig = moe_ep._route_local

    def route(router_w, xt, k):
        out = orig(router_w, xt, k)
        probs = torch.softmax(xt.float() @ router_w, -1).detach()
        top = probs.sort(-1, descending=True).values
        calls.append((out[1].numpy().copy(),
                      float((top[:, k - 1] - top[:, k]).min())))
        return out
    return route


def train_step(rank, arch, mps, params, tokens, accum, lr):
    """One step of ``make_lm_train_step_fn`` (``grad_accum=accum``, the
    ZeRO-1 ``accum_rules``) from the replicated state ``params`` on this
    rank's rows of ``tokens``, on each mesh: metrics, parameters in leaf
    order, and each router call's choices and top-k gap."""
    cfg = get_config(arch).reduced()
    rules = AxisRules()
    out = {}
    for mp in mps:
        mesh = best_mesh(model_parallel=mp)
        calls = []
        moe_ep._route_local, orig = _routes(calls), moe_ep._route_local
        try:
            step = trainer.make_lm_train_step_fn(
                cfg, AdamConfig(schedule=constant_schedule(lr)),
                grad_accum=accum, accum_rules=AxisRules())
            with use_mesh(mesh, rules):
                state = device_put(
                    trainer.init_train_state(lm_params_from_numpy(
                        params, device="cpu")), NamedSharding(mesh, P()))
                batch = shard_batch({"tokens": torch.from_numpy(tokens)},
                                    mesh, rules)
                new, metrics = step(state, batch)
        finally:
            moe_ep._route_local = orig
        out[mp] = {"coords": mesh.coords(),
                   "metrics": {k: float(v) for k, v in metrics.items()},
                   "params": [p.detach().numpy()
                              for p in tree_leaves(new.params)],
                   "routes": calls}
    return out


def launch(rank, argv):
    """``launch.train.main(argv)`` on the group this rank joined: its
    losses, the lines it printed and the checkpoint managers it made."""
    made = []
    orig = launch_train.CheckpointManager

    def manager(*a, **kw):
        made.append(rank)
        return orig(*a, **kw)
    launch_train.CheckpointManager = manager
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            run = launch_train.main(argv)
    finally:
        launch_train.CheckpointManager = orig
    return {"losses": run["losses"], "start": run["start"],
            "lines": text.getvalue().splitlines(), "managers": len(made)}


def refused_capture(rank, arch, tokens):
    """The compiled LM step over the ranks with a capture that fails (as
    NCCL refusing to capture its collective would): the error it raises,
    its stats and the state's step count after it."""
    cfg = get_config(arch).reduced()

    def refuse(body):
        raise RuntimeError("capture refused by the stub")
    trainer._capture_for = lambda device: refuse
    mesh = best_mesh()
    step = trainer.make_lm_train_step(
        cfg, AdamConfig(schedule=constant_schedule(1e-3)))
    with use_mesh(mesh, AxisRules()):
        state = trainer.init_train_state(init_lm(0, cfg, device="cpu"))
        batch = shard_batch({"tokens": torch.from_numpy(tokens)}, mesh)
        try:
            step(state, batch)
            err = None
        except RuntimeError as e:
            err = str(e)
    return {"error": err, "stats": dict(step.stats),
            "step": int(state.step)}
