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
and the same losses. Checkpoints hold numpy arrays, so a bf16 state does
not save (as the reference's does not restore).

The batch of step ``i`` is seeded ``(1, i)`` whether the run started at 0
or resumed (:mod:`repro_torch.data.lm_data`), so a resumed run repeats the
losses of an uninterrupted one. The last line lists the losses run, each a
JSON number that reads back as the same float.

Under torchrun (``python -m torch.distributed.run --nproc-per-node N -m
repro_torch.launch.train ...``, whose ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` it reads) each process is a rank
(:func:`repro_torch.dist.ranks.init_ranks`): on ``cuda:<LOCAL_RANK>``, or
the CPU with ``--device cpu``, and the mesh is ``best_mesh(model_parallel=
k)`` over the ranks. Every rank draws the same seeded global batch and
keeps its rows; the state is replicated, so rank 0 alone prints and writes
checkpoints, and every rank restores on a resume. A caller that joined a
group itself (``init_ranks``) gets the same run from ``main``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch.distributed as dist

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.lm_data import lm_batch_stream
from repro_torch.data.pipeline import prefetch_to_mesh
from repro_torch.dist.elastic import best_mesh
from repro_torch.dist.ranks import (destroy_ranks, init_ranks, rank_device,
                                    ranks_ready)
from repro_torch.dist.sharding import (P, AxisRules, NamedSharding,
                                       device_put, use_mesh)
from repro_torch.ft.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch import specs
from repro_torch.models.lm import init_lm, lm_dtype
from repro_torch.train.optim import AdamConfig, warmup_cosine_schedule
from repro_torch.train.trainer import (CompiledTrainStep, init_train_state,
                                       make_lm_train_step_fn)


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
    step_fn = CompiledTrainStep(
        make_lm_train_step_fn(cfg, opt, grad_accum=args.grad_accum),
        donate=True)

    with use_mesh(mesh, rules):
        state = init_train_state(init_lm(0, cfg, device=dev))
        # over ranks the state is replicated: its FSDP / tensor-parallel
        # specs stay layouts that this port does not take
        st_sh = (NamedSharding(mesh, P()) if mesh.on_ranks
                 else specs.train_state_sharding(state, mesh, rules))
        state = device_put(state, st_sh)

        mgr = None
        start = 0
        if args.ckpt_dir:
            if lead:
                mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
            if latest_step(args.ckpt_dir):
                state = device_put(restore(args.ckpt_dir, state, device=dev),
                                   st_sh)
                start = int(state.step)
                say(f"[train] resumed from step {start}")

        stream = prefetch_to_mesh(
            lm_batch_stream((1, start), cfg, args.batch, args.seq,
                            dtype=lm_dtype(cfg), device=dev), mesh, rules)
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
            if mgr:
                mgr.maybe_save(i + 1, state)
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
