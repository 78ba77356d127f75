"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--reduced] [--device cpu] [...]``, the PyTorch port of
:mod:`repro.launch.train`.

Runs real steps of any registry arch on one device (the card by default;
``--device cpu`` runs the plain versions): seeded ``init_lm`` weights, the
synthetic ``lm_batch_stream`` behind a ``Prefetcher``, AdamW with a
warmup-cosine schedule, ``--grad-accum`` microbatches, checkpoints through
``CheckpointManager`` with a resume from the latest one, and a log line
every ``--log-every`` steps. As in the reference, init and steps run
under ``use_mesh(best_mesh(model_parallel=k, devices=[device]),
AxisRules())``: the state is placed by ``specs.train_state_sharding`` and
the stream by ``prefetch_to_mesh``. The step is compiled with donation, as
the reference jits it (``donate_argnums=(0,)``): on the card each step is
one CUDA-graph replay that updates the state in place
(:class:`repro_torch.train.trainer.CompiledTrainStep`), ``--grad-accum``
and ``--model-parallel`` included. ``best_mesh`` clamps
``--model-parallel`` to the one device, so any ``k`` gives a (1, 1) mesh
and the same losses in one process. Checkpoints hold numpy arrays, so a
bf16 state does not save (as the reference's does not restore).

The batch of step ``i`` is seeded ``(1, i)`` whether the run started at 0
or resumed (:mod:`repro_torch.data.lm_data`), so a resumed run repeats the
losses of an uninterrupted one. The last line lists the losses run, each a
JSON number that reads back as the same float.

Under torchrun (``python -m torch.distributed.run --nproc-per-node N -m
repro_torch.launch.train ...``, whose ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` it reads) each process is a rank
(:func:`repro_torch.dist.ranks.init_ranks`): on ``cuda:<LOCAL_RANK>``, or
the CPU with ``--device cpu``, and the mesh is ``best_mesh(model_parallel=
k)`` over the ranks, ``(N / k, k)``: ``--model-parallel k`` splits the
work of the dense layers over the ``model`` axis, as the reference's GSPMD
splits it (each rank its attention heads, FFN columns and vocabulary slice
of the embedding, the logits and the loss; ``repro_torch.models.lm.
lm_splits``), and the ranks of a ``model`` group hold the same rows. Every
rank draws the same seeded global batch and keeps its rows (with
``--grad-accum``, its block of each microbatch). The
state is laid out as the reference's launcher lays it out
(:func:`init_state` under ``AxisRules()``, FSDP): every parameter of 2
dims or more and both moments sharded over the ``data`` axis. Each rank
holds its blocks (``device_put``); over one rank, or in one process, every
block is the whole leaf. Rank 0 alone prints and writes checkpoints, of
global leaves that every rank gathers to it leaf by leaf
(:func:`repro_torch.ft.checkpoint.host_state`); a resume reads the global
leaves one at a time and places each rank's blocks, so a checkpoint
restores over any number of ranks. A caller that joined a group itself
(``init_ranks``) gets the same run from ``main``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.lm_data import lm_batch_stream
from repro_torch.data.pipeline import prefetch_to_mesh
from repro_torch.dist.elastic import best_mesh
from repro_torch.dist.ranks import (destroy_ranks, init_ranks, rank_device,
                                    ranks_ready)
from repro_torch.dist.sharding import (AxisRules, block_shape, device_put,
                                       use_mesh)
from repro_torch.ft.checkpoint import (CheckpointManager, due, host_state,
                                       latest_step, restore)
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch import specs
from repro_torch.models.lm import init_lm, lm_dtype
from repro_torch.train.optim import (AdamConfig, tree_map,
                                     warmup_cosine_schedule)
from repro_torch.train.trainer import (CompiledTrainStep, TrainState,
                                       make_lm_train_step_fn)


def init_state(cfg, seed: int, device, mesh, param_rules: AxisRules,
               opt_rules: AxisRules | None = None):
    """``(state, state_sharding)``: the train state of ``init_lm(seed, cfg)``
    laid out by ``specs.train_state_sharding(..., mesh, param_rules,
    opt_rules)`` on ``device``. On a mesh over ranks each rank holds its
    blocks: the parameters are drawn whole, placed (``device_put``) and the
    whole tree dropped; the moments are zeros of the blocks' shapes, so
    the whole state is never held. The values are those of
    ``init_train_state(init_lm(seed, cfg))``."""
    abstract = specs.abstract_train_state(cfg)
    st_sh = specs.train_state_sharding(abstract, mesh, param_rules,
                                       opt_rules)
    params = device_put(init_lm(seed, cfg, device=device), st_sh.params)

    def zeros(p, sh):
        z = torch.zeros(block_shape(p.shape, sh.spec, mesh) if
                        mesh.on_ranks else p.shape, dtype=torch.float32,
                        device=device)
        z.sharding = sh
        return z
    opt = {k: tree_map(zeros, abstract.opt[k], st_sh.opt[k])
           for k in ("mu", "nu")}
    opt["step"] = device_put(torch.zeros((), dtype=torch.int32),
                             st_sh.opt["step"])
    return TrainState(params, opt), st_sh


def main(argv=None) -> dict:
    """Parse ``argv`` (default ``sys.argv[1:]``) and train. Returns
    ``{"start": first step, "losses": [...], "step_ms": [...], "compiled":
    the compiled step's stats}``, one entry a step run, each loss read back
    as a float (which waits for the step)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config (smoke/example scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if ranks_ready():           # a caller that joined the group itself
        dev = rank_device()
        if dev.type != resolve_device(args.device).type:
            raise ValueError(f"--device {args.device} on a rank of {dev}")
        return _train(args, dev, best_mesh(
            model_parallel=args.model_parallel))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dev = init_ranks(args.device)
        try:
            return _train(args, dev, best_mesh(
                model_parallel=args.model_parallel))
        finally:
            destroy_ranks()
    dev = resolve_device(args.device)
    return _train(args, dev, best_mesh(model_parallel=args.model_parallel,
                                       devices=[dev]))


def _train(args, dev, mesh) -> dict:
    lead = not mesh.on_ranks or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rules = AxisRules()
    say(f"[train] {cfg.name} on mesh {mesh.shape}")

    opt = AdamConfig(schedule=warmup_cosine_schedule(args.lr, 20, args.steps),
                     weight_decay=0.1)

    with use_mesh(mesh, rules):
        state, st_sh = init_state(cfg, 0, dev, mesh, rules)
        step_fn = CompiledTrainStep(
            make_lm_train_step_fn(cfg, opt, grad_accum=args.grad_accum,
                                  state_sharding=st_sh),
            donate=True)

        mgr = None
        start = 0
        if args.ckpt_dir:
            if lead:
                mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
            if latest_step(args.ckpt_dir):
                # each global leaf read on the host, this rank's block kept
                state = restore(args.ckpt_dir,
                                specs.abstract_train_state(cfg),
                                shardings=st_sh)
                start = int(state.step)
                say(f"[train] resumed from step {start}")

        stream = prefetch_to_mesh(
            lm_batch_stream((1, start), cfg, args.batch, args.seq,
                            dtype=lm_dtype(cfg), device=dev), mesh, rules,
            grad_accum=args.grad_accum)
        losses, t_hist = [], []
        for i in range(start, args.steps):
            batch = next(stream)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            losses.append(loss)
            t_hist.append(dt)
            if (i + 1) % args.log_every == 0:
                say(f"step {i + 1:5d} loss {loss:8.4f} "
                      f"{dt * 1e3:7.1f} ms/step "
                      f"acc {float(metrics['accuracy']):.3f}")
            if args.ckpt_dir and due(i + 1, args.ckpt_every):
                # every rank gathers, the lead writes
                host = host_state(state, st_sh, lead)
                if mgr:
                    mgr.maybe_save(i + 1, host)
        stream.close()
        for _ in stream:      # the worker stops at its next batch and exits
            pass
        if mgr:
            mgr.wait()
    if t_hist:
        say(f"[train] done: final loss {losses[-1]:.4f}; median step "
            f"{sorted(t_hist)[len(t_hist) // 2] * 1e3:.1f} ms")
    else:
        say(f"[train] done: step {start} of {args.steps} already reached")
    say(f"[train] losses {json.dumps(losses)}")
    return {"start": start, "losses": losses,
            "step_ms": [1e3 * t for t in t_hist],
            "compiled": dict(step_fn.stats)}


if __name__ == "__main__":
    main()
