#!/usr/bin/env python3
"""Train-step times of one or more source trees of the port on one NVIDIA
GPU, through the public entry points: the paper's GRU step
(``make_gru_train_step``, ``chip_smoke.py`` phase 5d) dense and QAT, and
the llama3.2-1b LM step (``make_lm_train_step``, phase 5h (a)).

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:
``python3 tools/train_times.py SRC [SRC ...]``, each SRC a ``src``
directory that holds ``repro_torch`` (this checkout's, or that of an older
commit unpacked with ``git archive``). Each tree runs in a process of its
own, since the package name is the same, and builds its own kernels; give
the trees as ``A B B A`` to compare two on one card in one call. A tree
whose steps are compiled captures at its first call; one whose steps are
eager runs them op by op: the script calls ``step(state, batch)`` alike.

Per tree, with the helpers of this checkout's ``chip_smoke.py``:

- GRU: 2L-768H CTC (``PAPER_NETWORKS["2L-768H"]``, seeded
  ``init_gru_model``), ``digit_batch`` B = 32, T = 96, Adam 1e-3; the
  dense step and the QAT DeltaGRU step at θ = 0.25: 2 warm steps, 10 timed
  (each ended by reading its loss; wall p50, frames a second), one
  profiled (kernels, device busy, idle share, the fused Adam kernel's
  device time where the tree has it; the idle share also against the
  unprofiled wall), the Adam update alone on one step's gradients
  (``adam_update`` between two synchronisations: norm, schedule and
  update), the peak memory of the steps (a capture's pool included).
- LM: llama3.2-1b at full size (bf16, fp32 moments, remat), [8, 128],
  the launcher's AdamW (warmup to 3e-4 over 20 steps, decay 0.1): 2 warm
  steps, 6 timed (p50, tokens a second), 2 profiled, the Adam update alone
  (``chip_smoke.lm_step_split``), the steps' peak memory above the state.
- The optimizer's two calls alone, at both trees (the 2L-768H GRU's fp32
  leaves, llama3.2-1b's bf16 ones), on seeded gradients and fp32 moments:
  the clip norm (``optim.global_norm``: the kernel where the tree has it,
  plain ops where not) and the fused AdamW update in place
  (``kernels.fused_adam.fused_adam``), each beside its bytes bound; graph
  replays at the GRU tree, CUDA events over eager calls at llama's.

In the profiles, ``match_us_by`` holds the device time a step of the
fused Adam's and the global norm's kernels. One JSON line per tree and
path, with the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GRU_WARM, GRU_TIMED = 2, 10
LM_WARM, LM_TIMED = 2, 6


def timed_steps(step, state, batches, warm: int):
    """``warm`` untimed steps (a compiled step's capture in the first),
    then one timed step a remaining batch, each ended by reading its loss.
    Returns the state, the walls (ms) and the peak memory of all the steps
    above what the loop began with (a graph's private pool included)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for b in batches[:warm]:
        state, m = step(state, b)
        float(m["loss"])
    walls = []
    for b in batches[warm:]:
        t0 = time.perf_counter()
        state, m = step(state, b)
        float(m["loss"])
        walls.append(1e3 * (time.perf_counter() - t0))
    return state, walls, torch.cuda.max_memory_allocated() - base


def gru_times(cs, dev, smi, tree: str) -> None:
    import numpy as np
    import torch
    from repro_torch.data.synthetic import digit_batch
    from repro_torch.models.gru_rnn import PAPER_NETWORKS, init_gru_model
    from repro_torch.quant.qat import EDGEDRNN_QAT, FP32
    from repro_torch.train.optim import AdamConfig, constant_schedule
    from repro_torch.train.trainer import (init_train_state,
                                           make_gru_train_step)
    task = PAPER_NETWORKS["2L-768H"]
    gen = torch.Generator().manual_seed(cs.SEED + 2)
    batches = [digit_batch(gen, 32, 96, device=dev)
               for _ in range(GRU_WARM + GRU_TIMED)]
    opt = AdamConfig(schedule=constant_schedule(cs.TRAIN_LR))
    stages = {"dense": (task, FP32, False),
              "qat": (dataclasses.replace(task, theta_x=cs.THETA,
                                          theta_h=cs.THETA),
                      EDGEDRNN_QAT, True)}
    for name, (task_s, qat, use_delta) in stages.items():
        step = make_gru_train_step(task_s, opt, qat=qat, use_delta=use_delta)
        state = init_train_state(init_gru_model(cs.SEED, task, device=dev))
        state, walls, peak = timed_steps(step, state, batches, GRU_WARM)
        bt = batches[-1]
        prof = cs.engine_profile(lambda: step(state, bt), 1,
                                 match=cs.OPT_KERNELS)
        split = cs.train_split_ms(state.params, task_s, bt, qat, use_delta,
                                  state.opt, opt)
        p50 = float(np.median(walls))
        frames = bt["features"].shape[0] * bt["features"].shape[1]
        print(json.dumps({
            "tree": tree, "path": f"gru {name} 2L-768H CTC B=32 T=96",
            "step_p50_ms": p50, "step_ms": walls,
            "frames_per_s": 1e3 * frames / p50, **prof,
            "idle_vs_wall": 1 - prof["device_busy_us_per_step"] / 1e3 / p50,
            "adam_ms": split["adam_ms"], "forward_ms": split["forward_ms"],
            "backward_ms": split["backward_ms"], "peak_bytes": peak,
            "compiled": getattr(step, "stats", None), "card": smi}),
            flush=True)
        del step, state
        torch.cuda.empty_cache()


def lm_times(cs, dev, smi, tree: str) -> None:
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optim import AdamConfig, warmup_cosine_schedule
    from repro_torch.train.trainer import (init_train_state,
                                           make_lm_train_step)
    cfg = get_config(cs.LM_TRAIN_ARCH)
    opt = AdamConfig(schedule=warmup_cosine_schedule(3e-4, 20, 100),
                     weight_decay=0.1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = {"s": init_train_state(init_lm(cs.SEED, cfg, device=dev))}
    held = torch.cuda.memory_allocated() - base
    batches = [lm_batch((cs.SEED, 9 + i), cfg, cs.LM_TRAIN_BATCH,
                        cs.LM_TRAIN_SEQ, device=dev)
               for i in range(LM_WARM + LM_TIMED)]
    step = make_lm_train_step(cfg, opt)
    state["s"], walls, peak = timed_steps(step, state["s"], batches, LM_WARM)

    def two_steps():
        for _ in range(2):
            state["s"], m = step(state["s"], batches[-1])
        float(m["loss"])
    prof = cs.engine_profile(two_steps, 2, match=cs.OPT_KERNELS)
    split = cs.lm_step_split(cfg, state, batches[-1], opt, {})
    p50 = float(np.median(walls))
    tokens = cs.LM_TRAIN_BATCH * cs.LM_TRAIN_SEQ
    print(json.dumps({
        "tree": tree, "path": f"lm {cs.LM_TRAIN_ARCH} full size bf16 "
                              f"[{cs.LM_TRAIN_BATCH}, {cs.LM_TRAIN_SEQ}]",
        "step_p50_ms": p50, "step_ms": walls,
        "tokens_per_s": 1e3 * tokens / p50, **prof,
        "idle_vs_wall": 1 - prof["device_busy_us_per_step"] / 1e3 / p50,
        "adam_ms": split["adam_ms"], "forward_ms": split["forward_ms"],
        "backward_ms": split["backward_ms"], "state_bytes": held,
        "peak_bytes_above_state": peak,
        "compiled": getattr(step, "stats", None), "card": smi}), flush=True)
    del step, state
    torch.cuda.empty_cache()


def optimizer_times(cs, dev, smi, tree: str) -> None:
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.fused_adam import fused_adam
    from repro_torch.models.gru_rnn import PAPER_NETWORKS, init_gru_model
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optim import global_norm, tree_leaves
    trees = (("gru 2L-768H fp32", 0.0, False, lambda: init_gru_model(
                 cs.SEED, PAPER_NETWORKS["2L-768H"], device=dev)),
             (f"{cs.LM_TRAIN_ARCH} full size bf16", 0.1, True,
              lambda: init_lm(cs.SEED, get_config(cs.LM_TRAIN_ARCH),
                              device=dev)))
    for name, wd, large, init in trees:
        p = tree_leaves(init())
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 29)
        g = [torch.randn(t.shape, generator=gen, device=dev).mul_(1e-3).to(
            t.dtype) for t in p]
        mu = [torch.zeros_like(t, dtype=torch.float32) for t in p]
        nu = [torch.zeros_like(t, dtype=torch.float32) for t in p]
        kw = dict(cs.adam_scalars(g, 8, 1.0, dev), b1=cs.ADAM_B1,
                  b2=cs.ADAM_B2, eps=cs.ADAM_EPS, weight_decay=wd)
        timer = (lambda fn: cs.events_ms(fn, 5)) if large else cs.device_ms
        adam_ms = timer(lambda: fused_adam(p, g, mu, nu, out=(p, mu, nu),
                                           **kw))
        norm_ms = timer(lambda: global_norm(g))
        g_bytes = sum(t.numel() * t.element_size() for t in g)
        adam_bytes = cs.adam_bytes(p, g)
        print(json.dumps({
            "tree": tree, "path": f"optimizer {name}",
            "elements": sum(t.numel() for t in p), "leaves": len(p),
            "adam_ms": adam_ms, "norm_ms": norm_ms,
            "adam_bound_ms": 1e3 * adam_bytes / cs.HBM_BYTES_PER_S,
            "norm_bound_ms": 1e3 * g_bytes / cs.HBM_BYTES_PER_S,
            "adam_bytes": adam_bytes, "norm_bytes": g_bytes,
            "timed_by": "CUDA events over eager calls" if large
            else "CUDA graph replays", "card": smi}), flush=True)
        del p, g, mu, nu
        torch.cuda.empty_cache()


def time_tree(src: Path) -> None:
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    gru_times(cs, dev, smi, str(src))
    lm_times(cs, dev, smi, str(src))
    optimizer_times(cs, dev, smi, str(src))


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
