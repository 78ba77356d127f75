"""Dry-run of the (architecture x input-shape) grid, the PyTorch port of
:mod:`repro.launch.dryrun`.

For every cell of ``configs.registry.grid()`` it runs the real step (the
train step with the reference's microbatching and rule variants, prefill,
decode) under the production mesh's sharding context, over the abstract
structures of :mod:`repro_torch.launch.specs` (meta tensors: nothing is
allocated, on the card or the host), and records:

* ``memory.argument_bytes``: the bytes one device holds of the step's
  arguments (state or parameters, caches, batch) laid out by their specs;
* ``cost``: the step's FLOPs, HBM traffic and peak live bytes
  (:func:`repro_torch.launch.hlo_cost.step_costs`);
* ``memory.fits``: an estimate, ``argument_bytes + peak_live_bytes /
  (data x pod extent)`` against the card's memory (the H100 SXM data
  sheet's 80 GB when the mesh lists the CPU): the activations spread over
  the batch axes, and the arguments as their specs say.

Trip counts. An eager step runs its loops trip by trip, and on the meta
device each op still costs the host tens of microseconds, so a 64-layer
step with 16 microbatches takes minutes. The layer loop is counted the way
the reference's walker counts a scan over layers, by trips: the step runs
at one and at two periods of the arch's block schedule (and one and two
encoder layers), and every count is extended linearly to the full depth,
``c(1) + (n - 1) (c(2) - c(1))``. Every period of a schedule entry has the
same shapes, so FLOPs and traffic extend exactly (``run_cell(...,
full_depth=True)`` runs the whole stack, to check it); the peak is an
estimate. The plain scans' loop
over time counts one trip ``T`` times (``kernels/ops.py::scan_trips``).
The scan kernels and ``delta_spmv`` dispatch their plain versions on meta
tensors, as the reference's dry-run lowers its jnp references.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k [--multi-pod] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The mesh lists the card once per position unless ``--device`` names
another device (``cpu``); nothing runs on it. Each cell's record is
written to ``--out`` (default ``artifacts/dryrun_torch/``). Importing this
module sets nothing and touches no device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, as_completed

import numpy as np
import torch

from repro_torch.configs.base import ALL_SHAPES, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, grid
from repro_torch.dist.elastic import Mesh
from repro_torch.dist.sharding import AxisRules, mesh_device, use_mesh
from repro_torch.launch import hlo_cost, specs
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.blocks import make_schedule
from repro_torch.models.lm import lm_decode, lm_prefill
from repro_torch.train.optim import AdamConfig, warmup_cosine_schedule
from repro_torch.train.trainer import make_lm_train_step_fn

DEFAULT_OUT = "artifacts/dryrun_torch"
H100_HBM_BYTES = 80e9          # H100 SXM data sheet: 80 GB of HBM3

_COUNTS = ("flops_per_device", "hbm_traffic_per_device",
           "hbm_traffic_core_per_device", "peak_live_bytes")


def _grad_accum_for(cfg, shape, dp_extent: int = 16) -> int:
    """Microbatch so per-device live activations stay within HBM, while the
    microbatch batch dim still covers the DP extent (else activations stop
    sharding and per-device work replicates)."""
    tokens = shape.global_batch * shape.seq_len
    # ~64k tokens per microbatch globally for d_model >= 4096, 256k
    # otherwise; clamped to divisors of global_batch
    target = 65536 if cfg.d_model >= 4096 else 262144
    accum = max(1, min(tokens // target, shape.global_batch // dp_extent))
    while shape.global_batch % accum:
        accum -= 1
    return accum


RULE_VARIANTS = {
    "baseline": {},
    # ZeRO-1: params replicated over data (no per-microbatch FSDP gathers);
    # optimizer state + grad accumulator stay data-sharded
    "zero1": {"embed_fsdp": None},
    # serving: expert weights resident in pure-EP layout (no per-step
    # ZeRO gathers on the decode path)
    "ep_resident": {"experts_fsdp": None},
}


def depth_points(cfg) -> list:
    """``[(cfg_at_depth, n), ...]``: the arch at one period of each
    repeated schedule entry (the first point), then with one of them at
    two periods, beside that entry's full count ``n``. The main schedule's
    layer loop and the encoder's are the repeated entries; one of two
    periods or fewer runs at full depth."""
    (pattern, count), *rest = make_schedule(cfg)
    rem = sum(len(p) * c for p, c in rest)
    loops = [("n_layers", lambda k: k * len(pattern) + rem, count)]
    if cfg.encdec:
        loops.append(("n_encoder_layers", lambda k: k, cfg.n_encoder_layers))
    loops = [loop for loop in loops if loop[2] > 2]
    base = {name: at(1) for name, at, _ in loops}
    points = [(dataclasses.replace(cfg, **base), 1)]
    for name, at, n in loops:
        points.append((dataclasses.replace(cfg, **{**base, name: at(2)}), n))
    return points


def _step(cfg, shape: ShapeConfig, rules: AxisRules, opt_rules: AxisRules,
          variant: str, ga: int):
    """``(fn, args)`` of the cell's step over meta structures at ``cfg``'s
    depth."""
    batch = specs.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = AdamConfig(schedule=warmup_cosine_schedule(3e-4, 100, 10000),
                         weight_decay=0.1)
        fn = make_lm_train_step_fn(
            cfg, opt, grad_accum=ga,
            accum_rules=opt_rules if variant == "zero1" else None)
        return fn, (specs.abstract_train_state(cfg), batch)
    params = specs.abstract_params(cfg)
    caches = specs.abstract_caches(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        def fn(params, batch, caches):
            return lm_prefill(params, cfg, batch["tokens"], caches,
                              image_embeds=batch.get("image_embeds"),
                              audio_frames=batch.get("audio_frames"))
    else:
        def fn(params, batch, caches):
            return lm_decode(params, cfg, batch["token"], caches)
    return fn, (params, batch, caches)


def _arguments(cfg, shape: ShapeConfig, mesh, rules, opt_rules) -> int:
    """Per-device bytes of the full-depth step's arguments."""
    batch = specs.input_specs(cfg, shape)
    total = specs.per_device_bytes(
        batch, specs.batch_sharding(batch, mesh, rules))
    if shape.kind == "train":
        state = specs.abstract_train_state(cfg)
        return total + specs.per_device_bytes(
            state, specs.train_state_sharding(state, mesh, rules,
                                              opt_rules=opt_rules))
    params = specs.abstract_params(cfg)
    caches = specs.abstract_caches(cfg, shape.global_batch, shape.seq_len)
    return (total
            + specs.per_device_bytes(params,
                                     specs.param_sharding(params, mesh, rules))
            + specs.per_device_bytes(
                caches, specs.cache_sharding(cfg, caches, mesh, rules)))


def _device_bytes(mesh) -> float:
    dev = mesh_device(mesh)
    if dev.type == "cuda":
        return float(torch.cuda.get_device_properties(dev).total_memory)
    return H100_HBM_BYTES


def run_cell(arch: str, shape: ShapeConfig, multi_pod: bool = False,
             rules: AxisRules | None = None, grad_accum: int | None = None,
             variant: str = "baseline", *, mesh=None, device=None,
             full_depth: bool = False, point: int | None = None) -> dict:
    """One cell's record (``ok`` and the numbers, or ``error`` and its
    traceback). ``mesh``: default the production mesh over ``device``
    (default the card). ``point``: run only that depth point of
    :func:`depth_points` and return the part for :func:`merge` (the CLI
    spreads a cell's points over its workers)."""
    t0 = time.perf_counter()
    record = {"arch": arch, "shape": shape.name, "kind": shape.kind,
              "ok": False, "variant": variant}
    try:
        mesh = mesh or make_production_mesh(multi_pod=multi_pod,
                                            devices=device)
        record["mesh"] = "x".join(map(str, mesh.devices.shape))
        record["n_devices"] = mesh.size
        cfg = get_config(arch)
        rules = rules or AxisRules()
        opt_rules = rules
        if variant != "baseline":
            rules = rules.with_overrides(**RULE_VARIANTS[variant])
        dp_extent = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
        ga = 1
        if shape.kind == "train":
            ga = grad_accum if grad_accum is not None else _grad_accum_for(
                cfg, shape, dp_extent)
            record["grad_accum"] = ga
        record["memory"] = {
            "argument_bytes": _arguments(cfg, shape, mesh, rules, opt_rules),
            "device_bytes": _device_bytes(mesh), "dp_extent": dp_extent}
        points = [(cfg, 1)] if full_depth else depth_points(cfg)
        record["depth_points"] = [(c.n_layers, c.n_encoder_layers, n)
                                  for c, n in points]
        # the step's mesh: the same axes over the meta device, where the
        # expert-parallel loop places each shard's tensors
        abstract = Mesh(np.full(mesh.devices.shape, specs.META, dtype=object),
                        mesh.axis_names)
        record["runs"] = {}
        with use_mesh(abstract, rules):
            for k in (range(len(points)) if point is None else [point]):
                fn, args = _step(points[k][0], shape, rules, opt_rules,
                                 variant, ga)
                record["runs"][k] = hlo_cost.step_costs(fn, *args)
                del fn, args
        record["ok"] = True
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
    record["total_s"] = time.perf_counter() - t0
    return record if point is not None else merge([record])


def merge(parts: list) -> dict:
    """A cell's record from the parts that ran its depth points: each count
    extended linearly to the full depth from the first point, and the
    memory estimate. ``total_s`` sums the parts' seconds."""
    bad = [p for p in parts if not p["ok"]]
    record = dict(bad[0] if bad else parts[0])
    record["total_s"] = sum(p["total_s"] for p in parts)
    if bad:
        return record
    runs = {}
    for p in parts:
        runs.update(p["runs"])
    del record["runs"]
    counts = [n for *_, n in record["depth_points"]]
    cost = dict(runs[0])
    for k in range(1, len(counts)):
        for key in _COUNTS:
            cost[key] += (counts[k] - 1) * (runs[k][key] - runs[0][key])
    record["cost"] = cost
    mem = dict(record["memory"])
    mem["peak_live_bytes_per_device"] = (cost["peak_live_bytes"]
                                         / mem.pop("dp_extent"))
    mem["fits"] = (mem["argument_bytes"] + mem["peak_live_bytes_per_device"]
                   <= mem["device_bytes"])
    record["memory"] = mem
    return record


def summary(rec: dict) -> str:
    """One line of a cell's record."""
    head = f"{rec['arch']} x {rec['shape']} @ {rec.get('mesh', '?')}"
    if rec.get("skipped"):
        return f"{head}: skipped ({rec['skip_reason']})"
    if not rec["ok"]:
        return f"{head}: FAIL {rec['error']}"
    m, c = rec["memory"], rec["cost"]
    return (f"{head}: ok, arguments {m['argument_bytes'] / 2**30:.3f} GiB "
            f"a device, {c['flops_per_device']:.4e} FLOPs a device, core "
            f"bytes {c['hbm_traffic_core_per_device']:.4e} a device, peak "
            f"live {c['peak_live_bytes'] / 2**30:.3f} GiB "
            f"({m['peak_live_bytes_per_device'] / 2**30:.3f} a device), "
            f"fits {m['fits']} ({rec['total_s']:.2f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--variant", default="baseline",
                    choices=sorted(RULE_VARIANTS))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the device the mesh lists (default: the card)")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)
    resolve_device(args.device)          # no card and no --device: raise

    os.makedirs(args.out, exist_ok=True)
    cells = [(arch, shape, skip) for arch, shape, skip in grid()
             if (not args.arch or arch == args.arch)
             and (not args.shape or shape.name == args.shape)]
    if not cells:
        raise SystemExit("no cells selected")

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    jobs = []
    for arch, shape, skip in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            suffix = "" if args.variant == "baseline" else f"__{args.variant}"
            fn = os.path.join(args.out,
                              f"{arch}__{shape.name}__{mesh_name}{suffix}.json")
            if args.skip_existing and os.path.exists(fn):
                print(f"[skip existing] {fn}")
                continue
            if skip:
                rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                       "ok": True, "skipped": True, "skip_reason": skip}
                jobs.append((fn, None, rec))
            else:
                jobs.append((fn, (arch, shape, mp), None))
    kw = {"grad_accum": args.grad_accum, "variant": args.variant,
          "device": args.device}

    def done(fn, rec):
        print(summary(rec), flush=True)
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
        results.append(rec)

    results = []
    for fn, _, rec in jobs:
        if rec is not None:
            done(fn, rec)
    todo = [(fn, cell) for fn, cell, rec in jobs if rec is None]
    if args.workers > 1:
        # every depth point of every cell a job of its own, the deepest
        # points of the train cells first: they take longest
        parts = {fn: [] for fn, _ in todo}
        points = [(fn, cell, k) for fn, cell in todo
                  for k in range(len(depth_points(get_config(cell[0]))))]
        points.sort(key=lambda j: (j[1][1].kind != "train", -j[2]))
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.workers, mp_context=ctx) as pool:
            futures = {pool.submit(run_cell, *cell, **kw, point=k): fn
                       for fn, cell, k in points}
            for fut in as_completed(futures):
                fn = futures[fut]
                parts[fn].append(fut.result())
                if len(parts[fn]) == sum(f == fn for f in futures.values()):
                    done(fn, merge(parts[fn]))
    else:
        for fn, cell in todo:
            done(fn, run_cell(*cell, **kw))

    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells OK")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
