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
``step_many``'s wall time a step over 300 frames, the latency of ``step``
(median and p95 over 300 frames) and the frames per second of an 8-slot
batcher draining 16 requests of 20-60 frames. One JSON line per path,
with the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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

    for path, prog, task, frames, requests, n_prof in paths():
        DeltaStreamEngine(prog, task).step_many(frames[:4])     # warm-up
        torch.cuda.synchronize()
        eng = DeltaStreamEngine(prog, task)
        prof = cs.engine_profile(lambda: eng.step_many(frames[:n_prof]),
                                 n_prof)
        eng = DeltaStreamEngine(prog, task)
        torch.cuda.synchronize()
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
            "step_many_us_per_step": step_many_us,
            "latency_median_us": float(np.median(lat)),
            "latency_p95_us": float(np.percentile(lat, 95)),
            "batcher_frames_per_s": fps, "card": smi}), flush=True)
        del prog


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
