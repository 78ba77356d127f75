#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold every
hand-written kernel against its plain PyTorch version.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``PATH`` or ``CUDA_HOME``, default ``/usr/local/cuda``)
and the repository's ``src/repro_torch``; without them it exits non-zero
and prints no result. Phases, in order (any failure ends the run with a
traceback and a non-zero exit):

1. environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions; TF32 is switched off for matmuls and cuDNN
   (the plain int8/int4 version is exact only in full fp32);
2. build: every kernel source compiled with ``nvcc``, all at once;
3. kernels against their plain versions at the two layer shapes of the
   paper's 2L-768H network (k = 896 and 1536), B in {1, 8}, with 0 %,
   about 10 % and 100 % of the column blocks fired: fp32 within
   ``TOL_F32``; int8 and int4 bitwise equal to the plain version on the
   card and on the CPU;
4. the int8/int4 kernel's own activation stage over every Q8.8 input,
   bitwise against ``torch.sigmoid`` / ``torch.tanh`` on the CPU after the
   LUT rounding;
5. the main path, per backend (``fused``, ``fused_q8``, ``fused_q4``):
   ``compile_deltagru`` from seeded random 2L-768H weights, a 1-stream
   ``DeltaStreamEngine.step_many`` over smooth synthetic frames at
   θx = θh = 0.25 under ``torch.cuda.set_sync_debug_mode("error")``, then a
   ``GruStreamBatcher`` over an 8-slot engine draining 16 requests of mixed
   lengths. Launch counts must equal steps × layers in each run; the
   results must match the same program compiled with ``device="cpu"``;
6. times on the card: each kernel at B = 1 and its plain version (device
   time from CUDA-graph replay between CUDA events, and the kernel's time
   per call launched from Python), the dense ``torch.addmm`` over the fp32
   volume as a yardstick the port never calls, and the engine's wall time
   per step with its kernels per step and idle share (``torch.profiler``),
   the per-frame latency of ``step`` (median and p95 over the frames) and
   the batcher's frames per second.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# fp32 kernel vs its plain version: both sum up to 1536 products per
# output in different orders. The error of such a sum grows like sqrt(k)
# ulps of the terms' magnitude: 1e-5 bounds it at the test widths of the
# CPU suite (k <= 288, the JAX package's own batch-against-solo bound), and
# 1e-4 at k <= 1536 keeps a factor of four over that sqrt(k) scaling.
TOL_F32 = 1e-4
# The head is a plain fp32 matmul (768 x 12) left to the library on each
# device; the order of its sum differs between the card and the CPU.
TOL_HEAD = 1e-5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
THETA = 0.25                  # Q8.8 64
N_FRAMES = 300
SEED = 0


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def smooth_frames(rng, t: int, n: int, i: int):
    """Smooth synthetic sensor frames ``[t, n, i]``: a few sinusoids per
    channel plus small noise (the repository has no dataset)."""
    import numpy as np
    tt = np.arange(t, dtype=np.float64)[:, None, None]
    out = np.zeros((t, n, i))
    for _ in range(3):
        f = rng.uniform(0.005, 0.05, (1, n, i))
        ph = rng.uniform(0, 2 * np.pi, (1, n, i))
        out += rng.uniform(0.2, 0.6, (1, n, i)) * np.sin(2 * np.pi * f * tt + ph)
    out += rng.normal(0, 0.02, out.shape)
    return out.astype(np.float32)


def tree_to(tree, device):
    """A program state's tensors copied to ``device``."""
    import dataclasses

    import torch
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, stack=tree_to(tree.stack, device))
    vals = [tree_to(x, device) for x in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def tree_leaves(tree):
    import dataclasses

    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return tree_leaves(tree.stack)
    return [leaf for x in tree for leaf in tree_leaves(x)]


def device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph and replayed ``reps`` times between CUDA events, so the host's
    launch cost is not in it. Weights stay in L2 across calls (the 2L-768H
    volumes are at most 22.4 MB of the 50 MB), as they do between the
    steps of a stream."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * calls)


def eager_ms(fn, iters: int = 100) -> float:
    """Time per call issued from Python, launch overhead included."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def step_latencies_us(eng, frames) -> list:
    """Per-frame latency of ``eng.step``: frame in on the host to output
    ready on the device (each step ends in a synchronise), after warm-up."""
    import torch
    for x in frames[:10]:
        eng.step(x)
    torch.cuda.synchronize()
    lat = []
    for x in frames:
        t0 = time.perf_counter()
        eng.step(x)
        torch.cuda.synchronize()
        lat.append(1e6 * (time.perf_counter() - t0))
    return lat


def engine_profile(eng, frames) -> dict:
    """Kernels per step, device-busy time per step and the idle share of
    ``eng.step_many(frames)``, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step_many(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    n = len(frames)
    return {"kernels_per_step": len(kernels) / n,
            "device_busy_us_per_step": busy_us / n,
            "wall_us_per_step": 1e6 * wall / n,
            "idle_share": 1.0 - busy_us / (1e6 * wall) if kernels else None}


def layer_inputs(rng, b, i_dim, h_dim, block_k, ip, fire, quant):
    """Random kernel inputs for one layer: deltas fired in a random subset
    of the k-blocks (``fire`` of them per stream, at least one unless
    ``fire == 0``), dense inside a fired block. On the Q8.8 grid when
    ``quant``. Returns numpy arrays and the real (unpadded) x and h
    columns of the blocks fired in any stream."""
    import numpy as np
    k = ip + h_dim + (-h_dim) % block_k
    nbk = k // block_k
    d = np.zeros((b, k), np.float32)
    n_fire = 0 if fire == 0 else max(1, round(fire * nbk))
    for s in range(b):
        for blk in rng.choice(nbk, n_fire, replace=False):
            d[s, blk * block_k:(blk + 1) * block_k] = rng.uniform(
                -1, 1, block_k)
    d[:, i_dim:ip] = 0.0
    d[:, ip + h_dim:] = 0.0
    union = np.any(d.reshape(b, nbk, block_k) != 0, axis=(0, 2))
    cols = np.concatenate([np.arange(ip) < i_dim,
                           np.arange(k - ip) < h_dim])
    fired_cols = int((cols.reshape(nbk, block_k).sum(1) * union).sum())
    m = rng.normal(0, 1.0, (b, 4 * h_dim)).astype(np.float32)
    h = rng.uniform(-1, 1, (b, h_dim)).astype(np.float32)
    if quant:
        d = np.round(d * 256) / 256
        m = np.round(m * 256 * 32) / 256
        h = np.round(h * 256) / 256
    dx = np.ascontiguousarray(d[:, :i_dim])
    dh = np.ascontiguousarray(d[:, ip:ip + h_dim])
    return (m.astype(np.float32), h.astype(np.float32),
            dx.astype(np.float32), dh.astype(np.float32), fired_cols)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run it from "
              "the root of a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    from repro_torch.configs.edgedrnn import CONFIG_2L768H
    from repro_torch.core.program import compile_deltagru
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.delta_q8 import (deltagru_q8_step,
                                              deltagru_q8_step_ref,
                                              lut_activation_grid,
                                              lut_activation_grid_ref)
    from repro_torch.kernels.deltagru_seq import (deltagru_seq_step,
                                                  deltagru_seq_step_ref)
    from repro_torch.models.gru_rnn import GruTaskConfig, init_gru_model
    from repro_torch.serve.engine import DeltaStreamEngine
    from repro_torch.serve.scheduler import GruStreamBatcher

    # -- 1. environment ---------------------------------------------------
    smi = nvidia_smi_line()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"  {src}: {line.strip()}")

    cfg = CONFIG_2L768H
    model = init_gru_model(SEED, cfg, device="cuda")
    model_cpu = init_gru_model(SEED, cfg, device="cpu")
    progs = {be: compile_deltagru(model, be)
             for be in ("fused", "fused_q8", "fused_q4")}
    cpu_progs = {be: compile_deltagru(model_cpu, be, device="cpu")
                 for be in progs}
    kernel_of = {"fused": ops.DELTAGRU_SEQ_F32,
                 "fused_q8": ops.DELTA_Q8_GRU_I8,
                 "fused_q4": ops.DELTA_Q8_GRU_I4}
    step_of = {"fused": (deltagru_seq_step, deltagru_seq_step_ref),
               "fused_q8": (deltagru_q8_step, deltagru_q8_step_ref),
               "fused_q4": (deltagru_q8_step, deltagru_q8_step_ref)}

    # -- 3. kernels against their plain versions --------------------------
    rng = np.random.default_rng(SEED)
    max_err = {be: 0.0 for be in progs}
    for be, prog in progs.items():
        kern, ref = step_of[be]
        quant = be != "fused"
        for li, lay in enumerate(prog.layouts):
            lay_cpu = cpu_progs[be].layouts[li]
            for b in (1, 8):
                for fire in (0.0, 0.1, 1.0):
                    m, h, dx, dh, _ = layer_inputs(
                        rng, b, lay.input_size, lay.hidden_size,
                        lay.block_k, lay.ip, fire, quant)
                    args = [torch.from_numpy(a) for a in (m, h, dx, dh)]
                    gpu = [a.to(dev) for a in args]
                    km, kh = kern(lay, *gpu)
                    rm, rh = ref(lay, *gpu)
                    cm, ch = ref(lay_cpu, *args)
                    torch.cuda.synchronize()
                    err = max(float((km - rm).abs().max()),
                              float((kh - rh).abs().max()))
                    max_err[be] = max(max_err[be], err)
                    if quant:
                        ok = (torch.equal(km, rm) and torch.equal(kh, rh)
                              and torch.equal(km.cpu(), cm)
                              and torch.equal(kh.cpu(), ch))
                    else:
                        err_cpu = max(float((km.cpu() - cm).abs().max()),
                                      float((kh.cpu() - ch).abs().max()))
                        ok = err <= TOL_F32 and err_cpu <= TOL_F32
                    log(f"kernel {be} layer {li} B={b} fire={fire}: "
                        f"max|kernel-plain|={err:.3e} "
                        f"{'ok' if ok else 'MISMATCH'}")
                    if not ok:
                        raise AssertionError(
                            f"{be} kernel disagrees with its plain version "
                            f"(layer {li}, B={b}, fire={fire})")

    # -- 4. exhaustive activation grid ------------------------------------
    lay_q = progs["fused_q8"].layouts[0]
    sig, tnh = lut_activation_grid(lay_q, dev)
    rsig, rtnh = lut_activation_grid_ref(lay_q)
    n_bad = int((sig.cpu() != rsig).sum()) + int((tnh.cpu() != rtnh).sum())
    log(f"activation grid: {sig.numel()} Q8.8 inputs, sigmoid+tanh "
        f"mismatches after LUT rounding: {n_bad}")
    if n_bad:
        raise AssertionError(f"{n_bad} activation-grid mismatches")

    # -- 5. main path -----------------------------------------------------
    task = GruTaskConfig(cfg.input_size, cfg.hidden_size, cfg.num_layers,
                         cfg.output_size, theta_x=THETA, theta_h=THETA)
    frames = smooth_frames(rng, N_FRAMES, 1, cfg.input_size)[:, 0]
    lengths = rng.integers(20, 61, 16)
    requests = [smooth_frames(rng, int(t), 1, cfg.input_size)[:, 0]
                for t in lengths]
    launches = {}
    wall_us = {}
    batch_fps = {}
    for be, prog in progs.items():
        kinfo = kernel_of[be]
        # warm-up (cuBLAS handle, allocator), then the counted runs
        DeltaStreamEngine(prog, task).step_many(frames[:4])
        torch.cuda.synchronize()

        eng = DeltaStreamEngine(prog, task)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = eng.step_many(frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall_us[be] = 1e6 * (time.perf_counter() - t0) / N_FRAMES
        n1 = ops.launch_counts()
        want = N_FRAMES * cfg.num_layers
        if n1[kinfo.name] != want or sum(n1.values()) != want:
            raise AssertionError(f"{be}: launches {n1}, want {want} of "
                                 f"{kinfo.name}")

        eng8 = DeltaStreamEngine(prog, task, n_streams=8)
        batcher = GruStreamBatcher(eng8)
        for fr in requests:
            batcher.submit(fr)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = batcher.run_until_drained()
        torch.cuda.synchronize()
        batch_fps[be] = sum(len(fr) for fr in requests) / (
            time.perf_counter() - t0)
        n8 = ops.launch_counts()
        want8 = batcher.counters["ticks"] * cfg.num_layers
        if n8[kinfo.name] != want8 or sum(n8.values()) != want8:
            raise AssertionError(f"{be} batcher: launches {n8}, want "
                                 f"{want8}")
        launches[be] = n1[kinfo.name] + n8[kinfo.name]
        log(f"main path {be}: 1 stream {N_FRAMES} steps -> "
            f"{n1[kinfo.name]} launches; 8-slot batcher {len(done)} "
            f"requests in {batcher.counters['ticks']} ticks -> "
            f"{n8[kinfo.name]} launches; {wall_us[be]:.1f} us/step wall; "
            f"report {eng.report()['gamma_dx']:.4f} gamma_dx")

        # the same program on the CPU
        cpu_prog = cpu_progs[be]
        if be == "fused":
            # θ = 0: no threshold decision can flip, so the engines agree
            # within the fp32 bound over a whole run
            t0_task = GruTaskConfig(cfg.input_size, cfg.hidden_size,
                                    cfg.num_layers, cfg.output_size)
            g = DeltaStreamEngine(prog, t0_task).step_many(frames[:50])
            c = DeltaStreamEngine(cpu_prog, t0_task,
                                  device="cpu").step_many(frames[:50])
            err0 = float((g.cpu() - c).abs().max())
            # θ > 0: a 1-ulp difference can flip a threshold decision, so
            # feed both the same state each step (lockstep)
            st = prog.init_state((1,))
            errs = 0.0
            for x in frames[:20]:
                xg = torch.from_numpy(x[None]).to(dev)
                yg, st_g, _ = prog.step(st, xg, THETA, THETA)
                yc, st_c, _ = cpu_prog.step(tree_to(st, "cpu"), xg.cpu(),
                                            THETA, THETA)
                for a, bb in zip(tree_leaves(st_g), tree_leaves(st_c)):
                    errs = max(errs, float((a.cpu() - bb).abs().max()))
                st = st_g
            log(f"  fp32 vs cpu: theta=0 outputs {err0:.3e}, "
                f"theta={THETA} lockstep state {errs:.3e}")
            if err0 > TOL_F32 or errs > TOL_F32:
                raise AssertionError("fp32 main path disagrees with the "
                                     "CPU program")
        else:
            ce = DeltaStreamEngine(cpu_prog, task, device="cpu")
            c_outs = ce.step_many(frames)
            same_state = all(torch.equal(a.cpu(), bb) for a, bb in zip(
                tree_leaves(eng.state), tree_leaves(ce.state)))
            head_err = float((outs.cpu() - c_outs).abs().max())
            cb = GruStreamBatcher(DeltaStreamEngine(cpu_prog, task,
                                                    n_streams=8,
                                                    device="cpu"))
            for fr in requests:
                cb.submit(fr)
            c_done = {r.uid: r for r in cb.run_until_drained()}
            b_err = max(float(np.abs(np.stack(r.outputs)
                                     - np.stack(c_done[r.uid].outputs)).max())
                        for r in done)
            log(f"  {be} vs cpu: final state bitwise {same_state}, "
                f"outputs {head_err:.3e}, batcher outputs {b_err:.3e}")
            if not same_state or head_err > TOL_HEAD or b_err > TOL_HEAD:
                raise AssertionError(f"{be} main path disagrees with the "
                                     "CPU program")
        if not torch.isfinite(outs).all():
            raise AssertionError(f"{be}: non-finite outputs")

    # -- 6. times on the card ---------------------------------------------
    entries = []
    for be, prog in progs.items():
        kern, ref = step_of[be]
        kinfo = kernel_of[be]
        fp32 = progs["fused"].layouts
        for fire in (0.1, 1.0):
            row = {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0,
                   "library_ms": 0.0, "bytes": 0}
            for li, lay in enumerate(prog.layouts):
                m, h, dx, dh, fired_cols = layer_inputs(
                    rng, 1, lay.input_size, lay.hidden_size, lay.block_k,
                    lay.ip, fire, be != "fused")
                gpu = [torch.from_numpy(a).to(dev) for a in (m, h, dx, dh)]
                row["ms"] += device_ms(lambda: kern(lay, *gpu))
                row["eager_ms"] += eager_ms(lambda: kern(lay, *gpu))
                row["plain_ms"] += device_ms(lambda: ref(lay, *gpu))
                wf = fp32[li].w
                w2 = wf.reshape(-1, wf.shape[-1])
                d_cat = torch.zeros((1, wf.shape[-1]), device=dev)
                acc = torch.zeros((1, w2.shape[0]), device=dev)
                row["library_ms"] += device_ms(
                    lambda: torch.addmm(acc, d_cat, w2.T))
                wbytes = {"fused": 4.0, "fused_q8": 1.0,
                          "fused_q4": 0.5}[be]
                # the weights the function needs: the real rows and columns
                # of the fired blocks, not the block padding of the layout
                fired_w = 3 * lay.hidden_size * fired_cols * wbytes
                side = 0 if be == "fused" else (3 + 4) * lay.hidden_size * 4
                io = 4 * (4 * lay.hidden_size * 2 + lay.hidden_size * 2
                          + lay.input_size + lay.hidden_size)
                row["bytes"] += int(fired_w + side + io)
            bound = 1e3 * row["bytes"] / HBM_BYTES_PER_S
            log(f"time {be} B=1 fire={fire} per 2-layer step: kernel "
                f"{row['ms']:.5f} ms on the device ({row['eager_ms']:.4f} ms "
                f"launched from Python), plain {row['plain_ms']:.5f} ms, "
                f"addmm {row['library_ms']:.5f} ms, bound {bound:.5f} ms "
                f"({row['bytes']} B) [{smi}]")
        per = row                            # the 100 % firing row
        entries.append({
            "name": kinfo.name, "route": "cuda", "source": kinfo.source,
            "replaces": kinfo.replaces, "launches": launches[be],
            "max_abs_err": max_err[be], "ms": per["ms"],
            "plain_ms": per["plain_ms"],
            "bound_ms": 1e3 * per["bytes"] / HBM_BYTES_PER_S,
            "bound_by": "bytes", "library_ms": per["library_ms"]})
        prof = engine_profile(DeltaStreamEngine(prog, task), frames[:50])
        lat = step_latencies_us(DeltaStreamEngine(prog, task), frames)
        log(f"engine {be}: frame-to-output latency at 1 stream over "
            f"{len(lat)} frames: median {np.median(lat):.1f} us, p95 "
            f"{np.percentile(lat, 95):.1f} us; step_many {wall_us[be]:.1f} "
            f"us/step; 8-slot batcher {batch_fps[be]:.0f} frames/s; "
            f"profiled: {json.dumps(prof)} [{smi}]")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
