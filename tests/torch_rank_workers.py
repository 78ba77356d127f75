"""The rank workers of the CPU rank tests (``test_torch_ranks.py``,
``test_torch_rank_train.py``, ``test_torch_fsdp.py``). Each runs in a process that
``repro_torch.dist.ranks.spawn_ranks`` starts, one a rank over gloo, and
returns numpy arrays and plain values. This module imports only numpy,
torch and ``repro_torch``: a child imports it to find its worker, and a
child that imported JAX would be slow.
"""
import contextlib
import io
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import shard_batch
from repro_torch.dist import ranks
from repro_torch.dist.elastic import Mesh, best_mesh
from repro_torch.dist.pipeline import pipeline_forward, split_microbatches
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (P, AxisRules, NamedSharding,
                                       device_put, mesh_device, use_mesh)
from repro_torch.ft import checkpoint
from repro_torch.launch import specs
from repro_torch.launch import train as launch_train
from repro_torch.launch.dryrun import RULE_VARIANTS
from repro_torch.models import moe_ep
from repro_torch.models.lm import init_lm, lm_params_from_numpy
from repro_torch.train import trainer
from repro_torch.train.optim import (AdamConfig, constant_schedule,
                                     tree_leaves, tree_map)

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
    rank's rows of ``tokens`` (its block of each microbatch), on each
    mesh: metrics, parameters in leaf order, and each router call's
    choices and top-k gap."""
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
                                    mesh, rules, grad_accum=accum)
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
    losses, the lines it printed, the checkpoint managers it made and the
    steps it wrote checkpoints of."""
    made, wrote = [], []
    orig, orig_save = launch_train.CheckpointManager, checkpoint.save

    def manager(*a, **kw):
        made.append(rank)
        return orig(*a, **kw)

    def save(*a, **kw):
        wrote.append(a[1])
        return orig_save(*a, **kw)
    launch_train.CheckpointManager = manager
    checkpoint.save = save
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            run = launch_train.main(argv)
    finally:
        launch_train.CheckpointManager = orig
        checkpoint.save = orig_save
    return {"losses": run["losses"], "start": run["start"],
            "lines": text.getvalue().splitlines(), "managers": len(made),
            "saved": wrote}


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


# -- the train state sharded over the ranks (test_torch_fsdp.py) -------------

def sharded_norm(rank, tree, some):
    """``optim.global_norm(tree, over=(mine, WORLD))`` with every leaf, the
    leaves named in ``some`` and none marked as this rank's."""
    from repro_torch.train.optim import global_norm
    group = dist.group.WORLD
    return {name: global_norm(tree, ({k: pick(k) for k in tree}, group))
            for name, pick in (("every", lambda k: True),
                               ("some", lambda k: k in some),
                               ("none", lambda k: False))}


def _layout_rules(layout):
    """The parameters' rules and the moments' of a layout: FSDP
    (``AxisRules()`` for both, the reference launcher's), ZeRO-1 (the
    parameters under the dry-run's ``zero1`` variant), and the replicated
    rules for both."""
    if layout == "repl":
        rules = AxisRules().with_overrides(embed_fsdp=None, experts_fsdp=None)
        return rules, rules
    if layout == "zero1":
        return AxisRules().with_overrides(**RULE_VARIANTS["zero1"]), AxisRules()
    return AxisRules(), AxisRules()


def _cotangent(index, shape, data, model):
    gen = torch.Generator().manual_seed(1000 * index + 10 * data + model)
    return torch.randn(shape, generator=gen)


def _gather_pair(arch, params, mesh, layout):
    """Each parameter leaf's block under ``layout`` gathered by
    ``sharding.gather_tree`` (against the global tensor, bitwise), then the
    backward of ``sum(gathered * c)``, ``c`` a seeded cotangent of this
    rank's data coordinate (and, for an expert stack the expert-parallel
    dispatch splits, its experts coordinate), its gradient summed as the
    step sums it (``StateLayout.to_moments``, then ``_reduce_over_ranks``
    with the layout's pending sums): against the moments' block of the
    reduced gradient built from every rank's cotangent here, the largest
    error over each leaf's largest."""
    rules = AxisRules()
    param_rules, opt_rules = _layout_rules(layout)
    whole = lm_params_from_numpy(params, device="cpu")
    state = trainer.init_train_state(whole)
    st_sh = specs.train_state_sharding(state, mesh, param_rules, opt_rules)
    shape = mesh.shape
    with use_mesh(mesh, rules):
        blocks = device_put(whole, st_sh.params)
        live = tree_map(lambda p: p.detach().requires_grad_(True), blocks)
        p_specs = tree_map(lambda s: s.spec, st_sh.params)
        before = dict(ranks.COLLECTIVES)
        got = sharding.gather_tree(live, p_specs)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(whole)))
        paths = []
        sharding._map_with_path(lambda p, x: paths.append(p), whole)
        at = mesh.coords()
        ep = shape["model"]
        order = trainer._in_order(whole)
        split = [sharding.expert_parallel_leaf(p, x, ep)
                 for p, x in zip(paths, order)]
        cot = [_cotangent(i, x.shape, at["data"], at["model"] if s else 0)
               for i, (x, s) in enumerate(zip(order, split))]
        got_order = trainer._in_order(got)
        loss = sum((g * c).sum() for g, c in zip(got_order, cot))
        loss.backward()
        lay = trainer.StateLayout(blocks, st_sh, mesh, rules)
        grads, _ = trainer._reduce_over_ranks(
            lay.to_moments(tree_map(lambda p: p.grad, live)),
            {"x": loss.detach()}, mesh, rules, lay.pending)
        issued = {k: v - before[k] for k, v in ranks.COLLECTIVES.items()
                  if v - before[k]}
        errs = []
        for i, (g, x, s, sh) in enumerate(zip(
                trainer._in_order(grads), order, split,
                trainer._in_order(st_sh.opt["mu"]))):
            ms = range(shape["model"]) if s else [0]
            want = sum(sum(_cotangent(i, x.shape, d, m) for m in ms)
                       for d in range(shape["data"])) / shape["data"]
            want = sharding._local_block(want, sh)
            errs.append(float((g - want).abs().max() / want.abs().max()))
    return {"same": same, "errs": errs, "issued": issued}


def sharded_steps(rank, arch, params, tokens, lr, cases):
    """For each ``(model-parallel degree, layout, microbatches)`` of
    ``cases``: one step of ``make_lm_train_step_fn`` (``accum_rules`` the
    moments' rules) from the state of ``params`` placed by
    ``specs.train_state_sharding`` under the layout (``state_sharding=``),
    beside the replicated step (``device_put`` of ``P()``, no layout) on
    the same ranks and rows: both steps' metrics, the gradients handed to
    the update (the replicated step's cut to this rank's blocks of the
    moments, and the largest error over each leaf's largest), the new
    state gathered to global leaves (``ft.checkpoint.host_state``; the
    replicated step's new state too), whether every parameter, moment and
    accumulator leaf is the block of its spec, the collectives issued; and
    for each (degree, layout) the gather / scatter pair
    (``_gather_pair``)."""
    cfg = get_config(arch).reduced()
    rules = AxisRules()
    out = {}
    base = {}
    for mp, layout, accum in cases:
        mesh = best_mesh(model_parallel=mp)
        param_rules, opt_rules = _layout_rules(layout)
        kept = {}

        def keep(name):
            def fn(grads):
                kept[name] = grads
                return grads
            return fn
        with use_mesh(mesh, rules):
            whole = trainer.init_train_state(lm_params_from_numpy(
                params, device="cpu"))
            st_sh = specs.train_state_sharding(whole, mesh, param_rules,
                                               opt_rules)
            batch = shard_batch({"tokens": torch.from_numpy(tokens)}, mesh,
                                rules, grad_accum=accum)
            opt = AdamConfig(schedule=constant_schedule(lr))
            if (mp, accum) not in base:
                step = trainer.make_lm_train_step_fn(
                    cfg, opt, grad_accum=accum, accum_rules=AxisRules(),
                    grad_transform=keep("repl"))
                new, m = step(device_put(whole, NamedSharding(mesh, P())),
                              batch)
                base[(mp, accum)] = (
                    {k: float(v) for k, v in m.items()}, kept.pop("repl"),
                    [p.numpy() for p in tree_leaves(new)])
            metrics, grads_r, state_r = base[(mp, accum)]
            repl_grads = [g.numpy() for g in tree_leaves(grads_r)]
            step = trainer.make_lm_train_step_fn(
                cfg, opt, grad_accum=accum, accum_rules=opt_rules,
                grad_transform=keep("sharded"), state_sharding=st_sh)
            state = device_put(whole, st_sh)
            abstract = trainer._in_order(whole.params)
            lay = trainer.StateLayout(state.params, st_sh, mesh, rules)
            acc = trainer._in_order(lay.accum_zeros(state.params))
            blocks = all(
                t.numel() * math.prod(
                    sharding._axis_extent(mesh, e) for e in sh.spec)
                == a.numel()
                for tree, shs in ((state.params, st_sh.params),
                                  (state.opt["mu"], st_sh.opt["mu"]),
                                  (state.opt["nu"], st_sh.opt["nu"]))
                for t, a, sh in zip(trainer._in_order(tree), abstract,
                                    trainer._in_order(shs)))
            blocks = blocks and all(
                t.numel() * math.prod(
                    sharding._axis_extent(mesh, e) for e in sh.spec)
                == a.numel() for t, a, sh in zip(
                    acc, abstract, trainer._in_order(st_sh.opt["mu"])))
            held = sum(t.numel() for t in tree_leaves(state))
            before = dict(ranks.COLLECTIVES)
            new, m = step(state, batch)
            issued = {k: v - before[k] for k, v in ranks.COLLECTIVES.items()
                      if v - before[k]}
            want = device_put(grads_r, st_sh.opt["mu"])
            gerr = [float((a - b).abs().max() / b.abs().max().clamp_min(
                1e-30)) for a, b in zip(trainer._in_order(kept["sharded"]),
                                        trainer._in_order(want))]
            same_grads = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(kept["sharded"]), tree_leaves(want)))
            host = checkpoint.host_state(new, st_sh)
        out[(mp, layout, accum)] = {
            "coords": mesh.coords(), "metrics": {
                k: float(v) for k, v in m.items()},
            "repl_metrics": metrics, "gerr": gerr, "same_grads": same_grads,
            "state": [np.asarray(x) for x in tree_leaves(host)],
            "repl_state": state_r, "repl_grads": repl_grads,
            "blocks": blocks, "held": held,
            "whole": sum(t.numel() for t in tree_leaves(whole)),
            "issued": issued}
    pairs = {}
    for mp, layout, _ in cases:
        if (mp, layout) not in pairs:
            pairs[(mp, layout)] = _gather_pair(
                arch, params, best_mesh(model_parallel=mp), layout)
    return {"steps": out, "pairs": pairs}


def save_sharded(rank, arch, params, ckpt_dir, global_state):
    """Under FSDP over the mesh of all ranks: with ``global_state`` None,
    the state of ``params`` placed in blocks, one step taken, gathered to
    the lead (``host_state``) and saved there at step 1; this rank's
    blocks of it come back, with the specs. Otherwise the checkpoint in
    ``ckpt_dir`` restored into blocks (``restore(shardings=)``), against
    ``global_state``'s blocks (bitwise)."""
    cfg = get_config(arch).reduced()
    rules = AxisRules()
    mesh = best_mesh()
    with use_mesh(mesh, rules):
        abstract = specs.abstract_train_state(cfg)
        st_sh = specs.train_state_sharding(abstract, mesh, rules)
        if global_state is not None:
            got = checkpoint.restore(ckpt_dir, abstract, shardings=st_sh)
            want = device_put(tree_map(torch.from_numpy, global_state),
                              st_sh)
            return {"same": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(got), tree_leaves(want))),
                "numel": sum(t.numel() for t in tree_leaves(got))}
        state = device_put(trainer.init_train_state(lm_params_from_numpy(
            params, device="cpu")), st_sh)
        step = trainer.make_lm_train_step_fn(
            cfg, AdamConfig(schedule=constant_schedule(1e-3)),
            state_sharding=st_sh)
        tokens = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, (8, 32)).astype(np.int32))
        state, _ = step(state, shard_batch({"tokens": tokens}, mesh, rules))
        host = checkpoint.host_state(state, st_sh, lead=rank == 0)
        if rank == 0:
            checkpoint.save(ckpt_dir, 1, host)
        dist.barrier()
    return {"coords": mesh.coords(), "mesh": mesh.shape,
            "blocks": [t.numpy() for t in tree_leaves(state)],
            "specs": [tuple(sh.spec) for sh in tree_leaves(st_sh)]}


def resume_sharded(rank, arch, layout, ckpt_dir):
    """Under ``layout`` on the mesh of all ranks, from ``launch.train.
    init_state``'s blocks: three steps of ``make_lm_train_step_fn``
    (``state_sharding=``, two microbatches) uninterrupted; then two, the
    state gathered to the lead (``host_state``) and saved at step 2,
    restored into blocks (``restore(shardings=)``) and the third step. The
    losses and final blocks of both runs, and, of the restore, the most
    bytes of global leaves read from the files that the host held at once
    (each read counted until it is freed) beside the largest leaf's bytes,
    this rank's blocks' and the whole state's."""
    import weakref
    cfg = get_config(arch).reduced()
    rules = AxisRules()
    param_rules, opt_rules = _layout_rules(layout)
    mesh = best_mesh()
    cpu = torch.device("cpu")
    rng = np.random.default_rng(11)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab, (8, 32)).astype(
        np.int32)) for _ in range(3)]
    with use_mesh(mesh, rules):
        state, st_sh = launch_train.init_state(cfg, 0, cpu, mesh,
                                               param_rules, opt_rules)
        step = trainer.make_lm_train_step_fn(
            cfg, AdamConfig(schedule=constant_schedule(1e-3)), grad_accum=2,
            accum_rules=opt_rules, state_sharding=st_sh)

        def run(state, at):
            losses = []
            for i in at:
                state, m = step(state, shard_batch({"tokens": batches[i]},
                                                   mesh, rules, grad_accum=2))
                losses.append(float(m["loss"]))
            return state, losses
        whole, want = run(state, range(3))
        state, _ = launch_train.init_state(cfg, 0, cpu, mesh, param_rules,
                                           opt_rules)
        state, first = run(state, range(2))
        host = checkpoint.host_state(state, st_sh, lead=rank == 0)
        if rank == 0:
            checkpoint.save(ckpt_dir, 2, host)
        del host, state
        dist.barrier()
        live, peak, orig = [], [0], np.load

        def load(*a, **kw):
            arr = orig(*a, **kw)
            held = [r() for r in live]
            peak[0] = max(peak[0], arr.nbytes + sum(
                x.nbytes for x in held if x is not None))
            live.append(weakref.ref(arr))
            return arr
        np.load = load
        try:
            back = checkpoint.restore(ckpt_dir,
                                      specs.abstract_train_state(cfg),
                                      shardings=st_sh)
        finally:
            np.load = orig
        blocks = sum(t.numel() * t.element_size() for t in tree_leaves(back))
        resumed, rest = run(back, [2])
    abstract = tree_leaves(specs.abstract_train_state(cfg))
    return {"want": want, "got": first + rest,
            "same": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(whole), tree_leaves(resumed))),
            "peak": peak[0], "blocks": blocks,
            "largest": max(a.numel() * a.element_size() for a in abstract),
            "whole": sum(a.numel() * a.element_size() for a in abstract)}


# -- tensor parallelism over the model axis (test_torch_tensor_parallel.py) --

def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def tp_steps(rank, arch, params, batch, lr, cases, count_flops):
    """For each ``(model-parallel degree, microbatches)`` of ``cases``, on
    the mesh over the ranks: one step of ``make_lm_train_step_fn`` from the
    replicated state of ``params`` (``device_put`` of ``P()``, no layout)
    and one from the same state laid out under FSDP
    (``specs.train_state_sharding``, ``state_sharding=``), both splitting
    the work over ``model``, on the rank's rows of ``batch`` (its block of
    each microbatch): both steps' metrics, the gradients each hands the
    update (the replicated step's as global leaves; the FSDP step's
    largest error over each leaf's largest against the replicated step's
    cut to this rank's blocks), both new states as global leaves, the
    collectives the FSDP step issued, each of its all-gathers' group
    (``"model"`` or ``"data"``) and gathered elements, and, where
    ``count_flops`` names the degree, the FSDP step's matmul FLOPs under
    ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config(arch).reduced()
    rules = AxisRules()
    out = {}
    for mp, accum in cases:
        mesh = best_mesh(model_parallel=mp)
        kept = {}

        def keep(name):
            def fn(grads):
                kept[name] = grads
                return grads
            return fn
        gathered = []
        orig = ranks._gather_into

        def record(dst, x, group):
            over = ("model" if group is ranks.axis_group(mesh, "model")
                    else "data")
            gathered.append((over, dst.numel()))
            return orig(dst, x, group)
        with use_mesh(mesh, rules):
            whole = trainer.init_train_state(lm_params_from_numpy(
                params, device="cpu"))
            st_sh = specs.train_state_sharding(whole, mesh, rules)
            placed = shard_batch(_tensors(batch), mesh, rules,
                                 grad_accum=accum)
            opt = AdamConfig(schedule=constant_schedule(lr))
            step = trainer.make_lm_train_step_fn(
                cfg, opt, grad_accum=accum, accum_rules=rules,
                grad_transform=keep("repl"))
            new_r, m_r = step(device_put(whole, NamedSharding(mesh, P())),
                              placed)
            step = trainer.make_lm_train_step_fn(
                cfg, opt, grad_accum=accum, accum_rules=rules,
                grad_transform=keep("fsdp"), state_sharding=st_sh)
            before = dict(ranks.COLLECTIVES)
            ranks._gather_into = record
            try:
                new, m = step(device_put(whole, st_sh), placed)
            finally:
                ranks._gather_into = orig
            issued = {k: v - before[k] for k, v in ranks.COLLECTIVES.items()
                      if v - before[k]}
            want = device_put(kept["repl"], st_sh.opt["mu"])
            gerr = [float((a - b).abs().max() / b.abs().max().clamp_min(
                1e-30)) for a, b in zip(trainer._in_order(kept["fsdp"]),
                                        trainer._in_order(want))]
            flops = None
            if mp == count_flops and accum == 1:
                with FlopCounterMode(display=False) as fc:
                    step(device_put(whole, st_sh), placed)
                flops = fc.get_total_flops()
            host = checkpoint.host_state(new, st_sh)
        out[(mp, accum)] = {
            "coords": mesh.coords(),
            "metrics": {k: float(v) for k, v in m.items()},
            "repl_metrics": {k: float(v) for k, v in m_r.items()},
            "gerr": gerr,
            "state": [np.asarray(x) for x in tree_leaves(host)],
            "repl_state": [p.detach().numpy() for p in tree_leaves(new_r)],
            "repl_grads": [g.numpy() for g in tree_leaves(kept["repl"])],
            "issued": issued, "gathered": gathered, "flops": flops}
    return out


def row_products(rank, h, w, g, mp):
    """``models.common.row_parallel`` in bf16 of this rank's columns of
    ``h`` and rows of ``w`` over the ``ff`` split at ``model`` extent
    ``mp``, and its backward of ``g``: the output and the two gradients
    (fp32 arrays) and the rank's first column."""
    from repro_torch.dist.sharding import tp_group
    from repro_torch.models.common import row_parallel
    mesh = best_mesh(model_parallel=mp)
    with use_mesh(mesh, AxisRules()):
        tp = tp_group("ff", h.shape[-1])
        cols = h.shape[-1] // tp.parts
        lo = tp.index * cols
        hs = torch.from_numpy(h[..., lo:lo + cols]).bfloat16()
        ws = torch.from_numpy(w[lo:lo + cols]).bfloat16()
        hs.requires_grad_(True)
        ws.requires_grad_(True)
        y = row_parallel(hs, ws, tp)
        y.backward(torch.from_numpy(g).bfloat16())
    return {"lo": lo, "cols": cols, "dtype": str(y.dtype),
            "y": y.detach().float().numpy(),
            "dh": hs.grad.float().numpy(), "dw": ws.grad.float().numpy()}


def tp_forward(rank, arch, params, batch, mp):
    """``lm_forward`` of ``params`` on ``batch`` under the mesh over the
    ranks with ``model`` extent ``mp`` (the rank's rows; the teacher-forced
    forward, split where the arch splits), with grad mode off: its logits
    gathered over ``model`` where the vocabulary splits, and the aux
    loss."""
    from repro_torch.models.lm import lm_forward
    from repro_torch.dist.sharding import tp_group
    cfg = get_config(arch).reduced()
    mesh = best_mesh(model_parallel=mp)
    rules = AxisRules()
    with use_mesh(mesh, rules), torch.no_grad():
        rows = shard_batch(_tensors(batch), mesh, rules)
        logits, aux = lm_forward(
            lm_params_from_numpy(params, device="cpu"), cfg, rows["tokens"],
            image_embeds=rows.get("image_embeds"),
            audio_frames=rows.get("audio_frames"))
        vocab = tp_group("vocab", cfg.vocab)
        cols = logits.shape[-1]
        if vocab is not None:
            logits = ranks.gather_dim(logits, logits.ndim - 1, vocab.group)
    return {"coords": mesh.coords(), "cols": cols,
            "logits": logits.numpy(), "aux": float(aux)}


def tp_checkpoint(rank, arch, params, tokens, ckpt_dir, mp):
    """Under FSDP at ``model`` extent ``mp`` over all the ranks: one split
    step from the state of ``params``, gathered to global leaves and
    saved by the lead at step 1; then the files restored into the blocks
    of the (world, 1) mesh's FSDP layout, against those blocks of the
    saved leaves (bitwise). Returns the saved leaves."""
    cfg = get_config(arch).reduced()
    rules = AxisRules()
    mesh = best_mesh(model_parallel=mp)
    with use_mesh(mesh, rules):
        whole = trainer.init_train_state(lm_params_from_numpy(
            params, device="cpu"))
        st_sh = specs.train_state_sharding(whole, mesh, rules)
        step = trainer.make_lm_train_step_fn(
            cfg, AdamConfig(schedule=constant_schedule(1e-3)),
            state_sharding=st_sh)
        new, _ = step(device_put(whole, st_sh), shard_batch(
            {"tokens": torch.from_numpy(tokens)}, mesh, rules))
        host = checkpoint.host_state(new, st_sh)
        if rank == 0:
            checkpoint.save(ckpt_dir, 1, host)
        dist.barrier()
    flat = best_mesh()
    with use_mesh(flat, rules):
        abstract = specs.abstract_train_state(cfg)
        sh = specs.train_state_sharding(abstract, flat, rules)
        got = checkpoint.restore(ckpt_dir, abstract, shardings=sh)
        want = device_put(tree_map(torch.as_tensor, host), sh)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(want)))
    return {"same": same, "mesh": mesh.shape,
            "state": [np.asarray(x) for x in tree_leaves(host)]}


def launches(rank, argvs):
    """:func:`launch` of each of ``argvs`` in turn on the group."""
    return [launch(rank, argv) for argv in argvs]
