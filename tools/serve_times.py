#!/usr/bin/env python3
"""End-to-end times of the port's two serving paths, through the public
entry points of one or more source trees of the port, on one NVIDIA GPU:
the serving fabric's tick (``chip_smoke.py`` phase 5e (b)) and
``LmEngine``'s decode step and prefill (phases 5f, 5g).

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:
``python3 tools/serve_times.py [--paths fabric,decode,prefill] SRC [SRC
...]``, each SRC a ``src`` directory that holds ``repro_torch`` (this
checkout's, or that of an older commit unpacked with ``git archive``).
``--paths`` picks the paths timed (all four by default). Each tree runs
in a process of its own, since the package name is the same, and builds
its own kernels; give the trees as ``A B B A`` to compare two on one card
in one call.

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
  under ``torch.profiler`` (kernels, device busy and idle share a step);
  deepseek-v2-lite-16b again at ``max_len=32768`` (``DECODE_LONG``).
- prefill: llama3.2-1b and rwkv6-1.6b at full size in bf16, the same
  engine, 4 prompts of 128 random tokens: the first prefill (a tree whose
  prefill is a CUDA graph captures it here) timed on its own, then 10
  more each between two synchronisations (p50, p95), and one more under
  ``torch.profiler`` (kernels, device busy and idle share); before that
  one, for llama3.2-1b, ``chip_smoke.py`` phase 5f (a)'s batcher load (12 prompts of
  16-96 random tokens, 32 new tokens each, 4 slots) and a load of mixed
  budgets (``MIXED_REQUESTS`` prompts of 16-96 random tokens, 4-48 new
  tokens each, so slots free one at a time and most waves are one prompt
  of a length of its own), each drained on a new engine, on that engine
  again and on another new engine (``drain_runs``; a tree with prefill
  graphs captures one a wave length the engine has not met): waves,
  distinct wave lengths, captures, the share of waves that replayed a
  graph already held, tokens a second; the mixed load on a tree with
  prefill graphs once more with ``PREFILL_GRAPHS`` set to
  ``SMALL_BOUND``.
- capture (a tree whose ``ops.capture_cuda_graph`` takes ``pool=``):
  llama3.2-1b's and rwkv6-1.6b's prefill at full size captured at the
  ``CAPTURE_LENGTHS`` through ``ops.capture_cuda_graph`` directly, each
  into a private pool on a new stream, then each into the first's pool on
  one stream (one warm-up before the first, as ``LmEngine`` runs it),
  the two ways in the order ``CAPTURE_WAYS``:
  the host ms of the warm-up and of each capture's body and end, the
  pools' MiB, the driver's used MiB and the caching allocator's reserved
  MiB after all (their difference a graph: what the driver holds for a
  graph outside the allocator), a replay's ms, and the two ways' logits
  bitwise.

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
# longer caches a model's decode is also timed at: the absorbed MLA decode
# scores every row of its cache (the dry-run's decode_32k length)
DECODE_LONG = {"deepseek-v2-lite-16b": (32768,)}
PREFILL_ARCHS = ("llama3.2-1b", "rwkv6-1.6b")
PREFILL_CALLS = 10
PATHS = ("fabric", "decode", "prefill", "capture")
MIXED_REQUESTS = 32
SMALL_BOUND = 8
CAPTURE_LENGTHS = (128, 120, 112, 104, 96, 88, 80, 72)
# A B B A: the first way of a process also pays the lazy loading of the
# kernels its lengths use
CAPTURE_WAYS = ("private", "shared", "shared", "private")


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
        for max_len in (cs.LM_MAX_LEN, *DECODE_LONG.get(arch, ())):
            eng = LmEngine(params, cfg, cs.LM_SLOTS, max_len, device=dev)
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
                "max_len": max_len, "init_s": init_s,
                "decode_p50_ms": float(np.percentile(walls, 50)),
                "decode_p95_ms": float(np.percentile(walls, 95)),
                "decode_ms": walls, **prof,
                "decode_stats": getattr(eng, "decode_stats", None),
                "card": smi}), flush=True)
            del eng, logits, cur
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()


def prefill_times(cs, dev, smi, tree: str) -> None:
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import LmEngine
    rng = np.random.default_rng(cs.SEED)
    for arch in PREFILL_ARCHS:
        cfg = get_config(arch)
        params, init_s, _ = cs.lm_build(cfg, dev, {})
        eng = LmEngine(params, cfg, cs.LM_SLOTS, cs.LM_MAX_LEN, device=dev)
        toks = rng.integers(1, cfg.vocab, (cs.LM_SLOTS, cs.LM_T))
        walls = []
        for _ in range(1 + PREFILL_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.prefill(toks)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        if arch == PREFILL_ARCHS[0]:
            drain_times(cs, params, cfg, dev, smi, tree)
        prof = cs.engine_profile(lambda: eng.prefill(toks), 1)
        graphs = (list(eng.prefill_graphs().values())
                  if hasattr(eng, "prefill_graphs") else [])
        print(json.dumps({
            "tree": tree,
            "path": f"prefill {arch} [{cs.LM_SLOTS}, {cs.LM_T}] bf16",
            "init_s": init_s, "first_ms": walls[0],
            "prefill_p50_ms": float(np.percentile(walls[1:], 50)),
            "prefill_p95_ms": float(np.percentile(walls[1:], 95)),
            "prefill_ms": walls[1:], **prof,
            "prefill_stats": getattr(eng, "prefill_stats", None),
            "prefill_graphs": [{k: v for k, v in g.items() if k != "pool"}
                               for g in graphs],
            "card": smi}), flush=True)
        del params, eng
        torch.cuda.empty_cache()


def drain_times(cs, params, cfg, dev, smi, tree: str) -> None:
    import numpy as np
    from repro_torch.serve import engine
    rng = np.random.default_rng(cs.SEED)
    prompts = [rng.integers(1, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, 97, cs.LM_REQUESTS)]
    bound = getattr(engine, "PREFILL_GRAPHS", None)
    drain_runs(cs, params, cfg, dev, smi, tree,
               f"drain {cfg.name} {cs.LM_REQUESTS} x {cs.LM_NEW} tokens",
               prompts, [cs.LM_NEW] * cs.LM_REQUESTS, bound)
    rng = np.random.default_rng(cs.SEED + 1)
    prompts = [rng.integers(1, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, 97, MIXED_REQUESTS)]
    budgets = [int(n) for n in rng.integers(4, 49, MIXED_REQUESTS)]
    for b in ((bound, SMALL_BOUND) if bound is not None else (None,)):
        drain_runs(cs, params, cfg, dev, smi, tree,
                   f"mixed drain {cfg.name} {MIXED_REQUESTS} requests, "
                   f"4-48 tokens", prompts, budgets, b)
    if bound is not None:
        engine.PREFILL_GRAPHS = bound


def drain_runs(cs, params, cfg, dev, smi, tree: str, what: str, prompts,
               budgets, bound) -> None:
    """Three ``ContinuousBatcher`` drains of ``prompts`` (``budgets`` new
    tokens each) at ``PREFILL_GRAPHS = bound`` (``None``: a tree without
    prefill graphs): on a new engine (run 0: the first drain of these
    lengths in the process), on that engine again (run 1) and on another
    new engine (run 2: lengths the process has seen). One line a run,
    with the warm-up, body and end ms of each graph the engine holds."""
    import torch
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import ContinuousBatcher
    if bound is not None:
        engine.PREFILL_GRAPHS = bound
    first, eng = None, None
    for k in range(3):
        if k != 1:
            eng = engine.LmEngine(params, cfg, cs.LM_SLOTS, cs.LM_MAX_LEN,
                                  device=dev)
            waves, prefill = [], eng.prefill

            def recorded(tokens, prefill=prefill, waves=waves, **mod):
                waves.append(tokens.shape[1])
                return prefill(tokens, **mod)

            eng.prefill = recorded
        stats0 = dict(getattr(eng, "prefill_stats", {}))
        n0 = len(waves)
        cb = ContinuousBatcher(eng)
        for p, b in zip(prompts, budgets):
            cb.submit(p, max_new_tokens=b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = cb.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs = {r.uid: r.output for r in done}
        first = outs if first is None else first
        stats = getattr(eng, "prefill_stats", None)
        run = waves[n0:]
        captures = (None if stats is None
                    else stats["captures"] - stats0["captures"])
        n_tok = sum(map(len, outs.values()))
        held = (list(eng.prefill_graphs().values())
                if hasattr(eng, "prefill_graphs") else [])
        split = {k: [1e3 * g[k] for g in held]
                 for k in ("warmup_s", "body_s", "end_s")
                 if held and k in held[0]}
        print(json.dumps({
            "tree": tree, "path": f"{what}, {cs.LM_SLOTS} slots",
            "held_capture_ms": split,
            "bound": bound, "run": k, "wall_s": wall, "tokens": n_tok,
            "tokens_per_s": n_tok / wall, "waves": len(run),
            "distinct_lengths": len(set(run)), "wave_lengths": run,
            "captures": captures,
            "hit_share": (None if captures is None
                          else 1 - captures / len(run)),
            "same_tokens": outs == first, "prefill_stats": stats,
            "card": smi}), flush=True)


def capture_times(cs, dev, smi, tree: str) -> None:
    import inspect

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import init_lm_caches, lm_prefill
    if "pool" not in inspect.signature(ops.capture_cuda_graph).parameters:
        print(json.dumps({"tree": tree, "path": "capture",
                          "skipped": "capture_cuda_graph takes no pool"}),
              flush=True)
        return
    rng = np.random.default_rng(cs.SEED)
    for arch in PREFILL_ARCHS:
        cfg = get_config(arch)
        params, _, _ = cs.lm_build(cfg, dev, {})
        toks = {t: torch.from_numpy(rng.integers(
            1, cfg.vocab, (cs.LM_SLOTS, t))).to(dev) for t in CAPTURE_LENGTHS}
        logits = {}
        for k, way in enumerate(CAPTURE_WAYS):
            caches = init_lm_caches(cfg, cs.LM_SLOTS, cs.LM_MAX_LEN, dev)
            stream = torch.cuda.Stream() if way == "shared" else None
            pool, replays, rows = None, [], []
            torch.cuda.synchronize()
            pools0 = cs.graph_pools()
            used0 = torch.cuda.mem_get_info()
            reserved0 = torch.cuda.memory_reserved()
            with torch.no_grad():
                for t in CAPTURE_LENGTHS:
                    t0 = time.perf_counter()
                    if not replays:
                        ops.run_aside(dev, lambda: lm_prefill(
                            params, cfg, toks[t],
                            tree_map(torch.clone, caches)))
                    t1 = time.perf_counter()

                    def body(t=t):
                        return lm_prefill(params, cfg, toks[t], caches)[0]

                    replay = ops.capture_cuda_graph(body, pool=pool,
                                                    stream=stream)
                    if way == "shared":
                        pool = replay.pool
                    rows.append({"length": t,
                                 "warmup_ms": 1e3 * (t1 - t0),
                                 "body_ms": 1e3 * replay.split["body_s"],
                                 "end_ms": 1e3 * replay.split["end_s"],
                                 "total_ms": 1e3 * (time.perf_counter()
                                                    - t0)})
                    replays.append(replay)
                torch.cuda.synchronize()
                used1 = torch.cuda.mem_get_info()
                reserved1 = torch.cuda.memory_reserved()
                pool_bytes = cs.new_pool_bytes(pools0)
                walls, outs = [], []
                for replay in replays:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    outs.append(replay().clone())
                    torch.cuda.synchronize()
                    walls.append(1e3 * (time.perf_counter() - t0))
            logits.setdefault(way, outs)
            print(json.dumps({
                "tree": tree, "path": f"capture {arch} [{cs.LM_SLOTS}, "
                                      f"{list(CAPTURE_LENGTHS)}] bf16",
                "way": way, "run": k, "captures": rows,
                "pool_mib": (None if pool_bytes is None
                             else pool_bytes / 2 ** 20),
                "driver_used_mib": (used0[0] - used1[0]) / 2 ** 20,
                "reserved_mib": (reserved1 - reserved0) / 2 ** 20,
                "outside_allocator_mib_a_graph": (
                    (used0[0] - used1[0]) - (reserved1 - reserved0))
                / 2 ** 20 / len(CAPTURE_LENGTHS),
                "replay_ms": walls, "card": smi}), flush=True)
            del replays, caches, outs
            torch.cuda.empty_cache()
        same = all(torch.equal(a, b) for a, b in zip(logits["private"],
                                                     logits["shared"]))
        print(json.dumps({"tree": tree, "path": f"capture {arch}",
                          "private_and_shared_bitwise": same,
                          "card": smi}), flush=True)
        del params, logits
        torch.cuda.empty_cache()


def time_tree(src: Path, paths) -> None:
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
    timers = {"fabric": fabric_times, "decode": decode_times,
              "prefill": prefill_times, "capture": capture_times}
    for path in paths:
        timers[path](cs, dev, smi, str(src))


def main(argv: list) -> int:
    paths = PATHS
    if argv[:1] == ["--paths"] and len(argv) > 1:
        paths = tuple(argv[1].split(","))
        argv = argv[2:]
    if not argv or any(p not in PATHS for p in paths):
        print(__doc__, file=sys.stderr)
        return 2
    if len(argv) == 2 and argv[0] == "--one":
        time_tree(Path(argv[1]).resolve(), paths)
        return 0
    rc = 0
    for src in argv:
        proc = subprocess.run([sys.executable, __file__, "--paths",
                               ",".join(paths), "--one", src])
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
