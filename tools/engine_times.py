#!/usr/bin/env python3
"""End-to-end times of ``DeltaStreamEngine`` and ``GruStreamBatcher`` on the
eight paths of ``chip_smoke.py``, through the public entry points of one or
more source trees of the port, on one NVIDIA GPU.

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:
``python3 tools/engine_times.py SRC [SRC ...]``, each SRC a ``src``
directory that holds ``repro_torch`` (this checkout's, or that of an older
commit unpacked with ``git archive``). Each tree runs in a process of its
own, since the package name is the same, and builds its own kernels; give
the trees as ``A B B A`` to compare two on one card in one call.

The paths: the 2L-768H GRU and LSTM (``fused``, ``fused_q8``,
``fused_q4``), RWKV6 at D = 2048 with its 24 layers and RG-LRU at
D = W = 4096 with 4 layers, each ``fused``, from seeded random weights at
θx = θh = 0.25, frames and requests drawn as ``chip_smoke.py`` draws them
(every tree the same). Per path, with the helpers of this checkout's
``chip_smoke.py``: kernels a step, device-busy time a step and the idle
share of ``step_many`` (``torch.profiler``, 50 steps, 10 on the LM paths),
the step's kernels by name (launches a step, names cut to 90 characters),
the frame guard's kernels a step (the kernels a step named as those of
the guard's plain ops, ``torch.all(x - x == 0)`` and ``torch.where``, on
one frame, less those the head's matmul and bias add take of the same
names: 4 where the guard runs in plain ops, 0 where layer 0's Delta Unit
runs it),
``step_many``'s wall time a step over 300 frames, the latency of ``step``
(median and p95 over 300 frames) and the frames per second of an 8-slot
batcher draining 16 requests of 20-60 frames; the Delta Unit's and the
epilogue's device µs a step by their kernel names in the step, and alone
(``kernels_alone``: one step's launches at the path's shapes, graph
replays, the same work in every tree). Then the same engine at
N = 128 slots (a fabric shard's tile: the frames shifted by 0.01 a slot):
kernels, busy µs and idle share a step over 10 profiled steps, and the two
kernels' µs a step. Before the profiled and the
timed ``step_many`` the engine runs 31 frames and is reset, so a tree
that captures a graph per chunk length (16, 8, 4, 2, 1 steps) has them
all and captures nothing inside the measurement. One JSON line per path,
with the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_TILE = 128     # a fabric shard's slots


def time_tree(src: Path) -> None:
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.configs.edgedrnn import CONFIG_2L768H as cfg
    from repro_torch.configs.recurrentgemma_9b import CONFIG as RGLRU
    from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV6
    from repro_torch.core.deltarglru import init_deltarglru_model
    from repro_torch.core.deltarwkv import init_deltarwkv_model
    from repro_torch.core.program import compile_delta_program
    from repro_torch.models.gru_rnn import (GruTaskConfig, init_gru_model,
                                            init_lstm_model)
    from repro_torch.serve.engine import DeltaStreamEngine
    from repro_torch.serve.scheduler import GruStreamBatcher
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    rng = np.random.default_rng(cs.SEED)

    def paths():
        task = GruTaskConfig(cfg.input_size, cfg.hidden_size,
                             cfg.num_layers, cfg.output_size,
                             theta_x=cs.THETA, theta_h=cs.THETA)
        frames = cs.smooth_frames(rng, cs.N_FRAMES, 1, cfg.input_size)[:, 0]
        requests = [cs.smooth_frames(rng, int(t), 1, cfg.input_size)[:, 0]
                    for t in rng.integers(20, 61, 16)]
        for cell, init in (("gru", init_gru_model),
                           ("lstm", init_lstm_model)):
            model = init(cs.SEED, cfg, device="cuda")
            for be in ("fused", "fused_q8", "fused_q4"):
                yield (f"{cell} {be}",
                       compile_delta_program(model, be, cell=cell), task,
                       frames, requests, 50)
        for cell, init, d, layers in (
                ("rwkv6", init_deltarwkv_model, RWKV6.d_model,
                 RWKV6.n_layers),
                ("rglru", init_deltarglru_model, RGLRU.d_model,
                 cs.RGLRU_LAYERS)):
            model = init(cs.SEED, d, layers, cs.LM_OUTPUT, device="cpu")
            prog = compile_delta_program(model, "fused", cell=cell)
            del model
            task = GruTaskConfig(d, d, layers, cs.LM_OUTPUT,
                                 theta_x=cs.THETA, theta_h=cs.THETA)
            frames = cs.lm_stream(rng, cs.N_FRAMES, d)
            requests = [cs.lm_stream(rng, int(t), d)
                        for t in rng.integers(20, 61, 16)]
            yield f"{cell} fused", prog, task, frames, requests, 10

    def warm(eng):
        """Every chunk graph captured (31 = 16 + 8 + 4 + 2 + 1 frames),
        then a fresh state in the same buffers."""
        eng.step_many(frames[:31])
        eng.reset()
        torch.cuda.synchronize()
        return eng

    def kernels_by_name(run, n: int, times: dict | None = None) -> dict:
        """Launches a step of each kernel name of ``run()`` (``n``
        steps); with ``times``, also the device µs a step of each name
        into it."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            run()
            torch.cuda.synchronize()
        names, us = {}, {}
        for e in p.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = e.name[:90]
                names[key] = names.get(key, 0) + 1
                us[key] = us.get(key, 0.0) + e.time_range.elapsed_us()
        if times is not None:
            times.update({k: v / n for k, v in us.items()})
        return {k: v / n for k, v in sorted(names.items(),
                                            key=lambda kv: -kv[1])}

    def step_kernel_us(times: dict) -> dict:
        """Device µs a step of the engine step's two kernels (all their
        launches in a step), by their kernel names."""
        return {what: sum(v for k, v in times.items() if name in k)
                for what, name in (("delta_unit_us_per_step",
                                    "delta_unit_kernel"),
                                   ("epilogue_us_per_step",
                                    "engine_epilogue_kernel"))}

    def kernels_alone(prog, n: int) -> dict:
        """The two kernels alone at the path's shapes and ``n`` slots,
        the device µs of one step's launches (``cs.device_ms``: graph
        replays of 20 steps' launches), the same work in every tree: the
        Delta Unit launches of a step without the frame guard, the
        epilogue over a fresh state copying the frame into last_x."""
        from repro_torch.core.sparsity import cell_dims
        from repro_torch.kernels import engine_epilogue as ep
        from repro_torch.kernels import ops
        d_in, hid, layers = prog.input_size, prog.hidden_size, \
            prog.num_layers
        if prog.cell == "rwkv6":
            shapes = [(l, [hid] * 3, [hid]) for l in range(layers)]
        elif prog.cell == "rglru":
            shapes = [(l, w, u) for l in range(layers)
                      for w, u in (([hid], []), ([], [hid]))]
        else:
            shapes = [(l, [d_in if l == 0 else hid], [hid])
                      for l in range(layers)]
        grid = ((256.0, -128.0, 128.0 - 1.0 / 256)
                if prog.backend.startswith("fused_q") else None)
        calls = [(l, cs.du_streams(rng, n, wx, "cuda", cs.THETA,
                                   grid is not None, prog.cell == "rwkv6"),
                  cs.du_streams(rng, n, wh, "cuda", cs.THETA, False, False))
                 for l, wx, wh in shapes]
        th = torch.full((), cs.THETA, device="cuda")

        def du_step():
            return [(l, ops.delta_unit(xs, hs, cs.THETA, th,
                                       act_grid=grid)[2])
                    for l, xs, hs in calls]

        counts = du_step()
        cols = [(0, 0)] * layers
        for l, xs, hs in calls:
            cols[l] = (cols[l][0] + sum(s.shape[1] for s, _ in xs),
                       cols[l][1] + sum(s.shape[1] for s, _ in hs))
        leaves = cs.tree_leaves(prog.init_state((n,)))
        carry = {k: torch.zeros((n,), device="cuda")
                 for k in ep.PER_STREAM}
        carry.update({k: torch.zeros((), device="cuda")
                      for k in ep.AGGREGATES})
        carry["last_x"] = torch.zeros((n, d_in), device="cuda")
        x = torch.rand((n, d_in), device="cuda")
        finite = torch.ones((n,), dtype=torch.bool, device="cuda")
        consts = ep.EpilogueConsts(cell_dims(prog.cell, d_in, hid, layers),
                                   8.0 * 125e6, 8)
        words = (ep.epilogue_workspace_words(n, layers)
                 if hasattr(ep, "epilogue_workspace_words") else n + 1)
        ws = torch.zeros((words,), dtype=torch.int32, device="cuda")
        out = {"du_alone_us": 1e3 * cs.device_ms(du_step),
               "ep_alone_us": 1e3 * cs.device_ms(lambda: ops.engine_epilogue(
                   leaves, counts, cols, carry, x, finite, consts, ws))}
        del calls, counts, leaves
        return out

    def guard_kernels(prog, task, by_name: dict) -> float:
        """The plain guard's kernels among a step's (``by_name``): the
        names the guard's ops launch on one frame, each counted a step less
        the head's launches of the same name."""
        x = torch.randn((1, task.input_size), device="cuda")
        last = torch.zeros_like(x)
        guard = kernels_by_name(lambda: torch.where(
            torch.all(x - x == 0, dim=-1)[:, None], x, last), 1)
        y = torch.randn((1, prog.head.shape[0]), device="cuda")
        out = torch.empty((1, prog.head.shape[1]), device="cuda")
        head = kernels_by_name(
            lambda: torch.add(y @ prog.head, prog.head_b, out=out), 1)
        return sum(max(0.0, by_name.get(k, 0.0) - head.get(k, 0.0))
                   for k in guard)

    for path, prog, task, frames, requests, n_prof in paths():
        DeltaStreamEngine(prog, task).step_many(frames[:4])     # warm-up
        torch.cuda.synchronize()
        eng = warm(DeltaStreamEngine(prog, task))
        prof = cs.engine_profile(lambda: eng.step_many(frames[:n_prof]),
                                 n_prof)
        times = {}
        by_name = kernels_by_name(lambda: eng.step_many(frames[:n_prof]),
                                  n_prof, times)
        eng = warm(DeltaStreamEngine(prog, task))
        t0 = time.perf_counter()
        eng.step_many(frames)
        torch.cuda.synchronize()
        step_many_us = 1e6 * (time.perf_counter() - t0) / len(frames)
        lat = cs.step_latencies_us(DeltaStreamEngine(prog, task).step,
                                   frames)
        batcher = GruStreamBatcher(DeltaStreamEngine(prog, task,
                                                     n_streams=8))
        for fr in requests:
            batcher.submit(fr)
        t0 = time.perf_counter()
        batcher.run_until_drained()
        torch.cuda.synchronize()
        fps = sum(len(fr) for fr in requests) / (time.perf_counter() - t0)
        print(json.dumps({
            "tree": str(src), "path": path, **prof,
            "kernels_by_name": by_name,
            "guard_kernels_per_step": guard_kernels(prog, task, by_name),
            **step_kernel_us(times), **kernels_alone(prog, 1),
            "step_many_us_per_step": step_many_us,
            "latency_median_us": float(np.median(lat)),
            "latency_p95_us": float(np.percentile(lat, 95)),
            "batcher_frames_per_s": fps, "card": smi}), flush=True)
        # a fabric shard's tile: N = 128 slots (the *_batch siblings of the
        # GRU / LSTM paths), 10 profiled steps after the chunk graphs
        wide = np.stack([frames[:41] + 0.01 * k for k in range(N_TILE)], 1)
        eng = DeltaStreamEngine(prog, task, n_streams=N_TILE)
        eng.step_many(wide[:31])
        eng.reset()
        torch.cuda.synchronize()
        prof = cs.engine_profile(lambda: eng.step_many(wide[31:41]), 10)
        times = {}
        kernels_by_name(lambda: eng.step_many(wide[31:41]), 10, times)
        print(json.dumps({
            "tree": str(src), "path": path, "n_streams": N_TILE, **prof,
            **step_kernel_us(times), **kernels_alone(prog, N_TILE),
            "card": smi}), flush=True)
        del eng, wide, prog


def main(argv: list) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        time_tree(Path(argv[1]).resolve())
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for src in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", src])
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
