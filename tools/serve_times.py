#!/usr/bin/env python3
"""End-to-end times of the port's two serving paths, through the public
entry points of one or more source trees of the port, on one NVIDIA GPU:
the serving fabric's tick (``chip_smoke.py`` phase 5e (b)) and
``LmEngine``'s decode step (phases 5f, 5g).

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:
``python3 tools/serve_times.py SRC [SRC ...]``, each SRC a ``src``
directory that holds ``repro_torch`` (this checkout's, or that of an older
commit unpacked with ``git archive``). Each tree runs in a process of its
own, since the package name is the same, and builds its own kernels; give
the trees as ``A B B A`` to compare two on one card in one call.

Per tree, with the helpers of this checkout's ``chip_smoke.py``:

- fabric: ``benchmarks/BENCH_fabric.json``'s traffic (8 shards x 128
  slots on the card, 2000 Poisson arrivals, shard 5 lost at tick 12) at
  2L-768H ``fused_q8`` (seed-0 ``init_gru_model``, θx = θh = 0.25, frames
  of 40), run twice through ``chip_smoke.fabric_run``: each run's steady
  tick p50 and p99 (``loadgen_fabric``'s rule), streams and frames a
  second, the host ms in the fleet's opens, steps, carry reads and closes
  and in the router's own work, and the host µs an open. The first run
  captures each shard's graphs.
- decode: llama3.2-1b and deepseek-v2-lite-16b at full size in bf16
  (seeded ``init_lm`` on the card), ``LmEngine(batch=4, max_len=256)``, a
  prefill of 4 prompts of 128 random tokens, 3 warm decode steps, then 32
  greedy steps each between two synchronisations (p50, p95), and 5 more
  under ``torch.profiler`` (kernels, device busy and idle share a step).

One JSON line per tree and path, with the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DECODE_ARCHS = ("llama3.2-1b", "deepseek-v2-lite-16b")
DECODE_STEPS = 32


def fabric_times(cs, dev, smi, tree: str) -> None:
    import numpy as np
    from repro_torch.configs.edgedrnn import CONFIG_2L768H
    from repro_torch.models.gru_rnn import PAPER_NETWORKS, init_gru_model
    from repro_torch.quant.export import quantize_delta_model
    from repro_torch.serve.loadgen import poisson_arrivals
    cfg = json.loads(cs.FABRIC_JSON.read_text())["config"]
    task = dataclasses.replace(PAPER_NETWORKS["2L-768H"], theta_x=cs.THETA,
                               theta_h=cs.THETA)
    prog = quantize_delta_model(init_gru_model(cs.SEED, CONFIG_2L768H,
                                               device=dev), device=dev)
    arrivals = poisson_arrivals(cfg["n_arrivals"], cfg["rate_per_tick"],
                                min_len=cfg["min_len"],
                                max_len=cfg["max_len"],
                                input_size=task.input_size, seed=cfg["seed"])
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(2):
            run = cs.fabric_run(prog, task, cfg, arrivals, dev,
                                str(Path(tmp) / str(k)), quiet_no_sync=False)
            walls = run["router"].tick_wall_s
            cons = run["router"].conservation()
            host = {name: 1e3 * v for name, v in run["host_s"].items()}
            ticks_ms = 1e3 * sum(walls)
            inside = sum(v for name, v in host.items() if name != "submit")
            opens = run["host_calls"]["open_stream"]
            print(json.dumps({
                "tree": tree, "path": "fabric 2L-768H fused_q8 8 x 128",
                "run": k, "wall_s": run["wall_s"],
                "ticks": len(walls),
                "p50_tick_ms": 1e3 * cs.steady_percentile(walls, 0.50),
                "p99_tick_ms": 1e3 * cs.steady_percentile(walls, 0.99),
                "median_tick_ms": 1e3 * float(np.median(walls)),
                "streams_per_s": cons["completed"] / run["wall_s"],
                "frames_per_s": cons["frames_out"] / run["wall_s"],
                "host_ms": host, "router_own_ms": ticks_ms - inside,
                "ticks_ms": ticks_ms, "opens": opens,
                "open_us": 1e3 * host["open_stream"] / opens,
                "open_share_of_ticks": host["open_stream"] / ticks_ms,
                "card": smi}), flush=True)
            del run


def decode_times(cs, dev, smi, tree: str) -> None:
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import LmEngine
    rng = np.random.default_rng(cs.SEED)
    for arch in DECODE_ARCHS:
        cfg = get_config(arch)
        params, init_s, _ = cs.lm_build(cfg, dev, {})
        eng = LmEngine(params, cfg, cs.LM_SLOTS, cs.LM_MAX_LEN, device=dev)
        toks = rng.integers(1, cfg.vocab, (cs.LM_SLOTS, cs.LM_T))
        logits = eng.prefill(toks)
        cur = torch.argmax(logits[:, -1:], dim=-1)
        for _ in range(3):
            cur = torch.argmax(eng.decode_step(cur)[:, -1:], dim=-1)
        walls = []
        for _ in range(DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cur = torch.argmax(eng.decode_step(cur)[:, -1:], dim=-1)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        prof = cs.engine_profile(lambda: [eng.decode_step(cur)
                                          for _ in range(5)], 5)
        print(json.dumps({
            "tree": tree, "path": f"decode {arch} B={cs.LM_SLOTS} bf16",
            "init_s": init_s,
            "decode_p50_ms": float(np.percentile(walls, 50)),
            "decode_p95_ms": float(np.percentile(walls, 95)),
            "decode_ms": walls, **prof,
            "decode_stats": getattr(eng, "decode_stats", None),
            "card": smi}), flush=True)
        del params, eng, logits, cur
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
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    fabric_times(cs, dev, smi, str(src))
    decode_times(cs, dev, smi, str(src))


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
