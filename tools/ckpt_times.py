#!/usr/bin/env python3
"""Where the time of ``DeltaStreamEngine.checkpoint`` and ``restore`` goes,
on one NVIDIA GPU, at the paper's 2L-768H network (``fused_q8``, seed-0
weights, θ = 0.25), for a 1-stream and an 8-slot engine after 50 frames.

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:
``python3 tools/ckpt_times.py``. Each figure is the median of 5 runs, in
ms: the copies of the checkpoint tree's leaves to the host as
``ft/checkpoint.py`` makes them (one synchronising copy a leaf), the same
copies issued without blocking into pinned buffers and waited for once,
the ``np.save`` of every leaf into a fresh directory under the temporary
directory, the checksums, the whole ``checkpoint``; then the engine's
construction (its warm-up step and graph capture), ``ft.checkpoint.
restore`` of the tree alone, and the whole ``DeltaStreamEngine.restore``.
One JSON line per engine, with the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 5


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ckpt_times: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs.edgedrnn import CONFIG_2L768H as cfg
    from repro_torch.ft import checkpoint as ck
    from repro_torch.models.gru_rnn import GruTaskConfig, init_gru_model
    from repro_torch.quant.export import quantize_delta_model
    from repro_torch.serve.engine import DeltaStreamEngine

    smi = cs.nvidia_smi_line()
    task = GruTaskConfig(cfg.input_size, cfg.hidden_size, cfg.num_layers,
                         cfg.output_size, theta_x=cs.THETA,
                         theta_h=cs.THETA)
    prog = quantize_delta_model(init_gru_model(cs.SEED, cfg))
    rng = np.random.default_rng(cs.SEED)

    def timed(fn) -> float:
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    for n in (1, 8):
        eng = DeltaStreamEngine(prog, task, n_streams=n)
        eng.step_many(cs.smooth_frames(rng, 50, n, cfg.input_size)
                      if n > 1 else
                      cs.smooth_frames(rng, 50, 1, cfg.input_size)[:, 0])
        leaves = [leaf for _, leaf in ck.tree_paths(eng._ckpt_tree())]
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                  for t in tensors]

        def batched():
            for p, t in zip(pinned, tensors):
                p.copy_(t, non_blocking=True)

        host = [ck._to_host(leaf) for leaf in leaves]
        with tempfile.TemporaryDirectory() as tmp:
            dirs = iter(range(10 ** 6))

            def save():
                d = os.path.join(tmp, f"save_{next(dirs)}")
                os.makedirs(d)
                for i, a in enumerate(host):
                    np.save(os.path.join(d, f"arr_{i:05d}.npy"), a)

            row = {
                "n_streams": n, "leaves": len(leaves),
                "bytes": int(sum(a.nbytes for a in host)),
                "host_copies_ms": timed(
                    lambda: [ck._to_host(leaf) for leaf in leaves]),
                "host_copies_one_wait_ms": timed(batched),
                "np_save_ms": timed(save),
                "checksums_ms": timed(
                    lambda: [ck._checksum(a) for a in host]),
                "checkpoint_ms": timed(lambda: eng.checkpoint(
                    os.path.join(tmp, f"ckpt_{next(dirs)}"))),
            }
            src = os.path.join(tmp, "src")
            eng.checkpoint(src)
            row["construct_ms"] = timed(
                lambda: DeltaStreamEngine(prog, task, n_streams=n))
            row["tree_restore_ms"] = timed(lambda: ck.restore(
                src, eng._ckpt_tree(), device=eng.device))
            row["restore_ms"] = timed(lambda: DeltaStreamEngine.restore(
                src, prog, task, n_streams=n))
        row["card"] = smi
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
