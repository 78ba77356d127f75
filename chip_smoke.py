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
   (the plain int8/int4 versions are exact only in full fp32);
2. build: every kernel source compiled with ``nvcc``, all at once; the
   registers, spills and static shared memory of every kernel instance
   (``-Xptxas -v``);
3. kernels against their plain versions: first ``deltagru_act`` (B in
   {1, 2, 8, 9}, H in {768, 770, 4097}, all operands 16-byte aligned and
   each of the four in turn 4-byte aligned; within ``TOL_F32`` on the
   card and the CPU, every case launched twice and the two results
   bitwise equal) and ``ops.deltagru_cell_fused`` against the dense GRU
   step; then at the two layer shapes of the
   paper's 2L-768H network (k = 896 and 1536), for both cells (GRU and
   LSTM), B in {1, 2, 8, 9} (the one-stream instance, the tile instance,
   two tile passes) with exactly 0, 1, U - 1, U, U + 1 and all column
   blocks fired (U: the fired blocks one unrolled group of the walk
   covers), a group across the x/h seam and, at B > 1, every block fired
   by one stream other than stream 0: fp32 within ``TOL_F32``; int8 and
   int4 bitwise equal to the plain version on the card and on the CPU, and
   each buffered instance (``buffered=True``) bitwise equal to its
   unbuffered twin; an LSTM step whose cell state saturates at the Q8.8
   rail; and narrow layouts (int8 ``block_k`` 8 and 4, int4 16 and 4)
   through the narrow-load instance, their buffered form (a ring filled by
   ``cp.async`` or 2-byte copies) bitwise equal to it, also launched after
   an L2 flush (copies that land late);
4. the int8/int4 kernels' own activation stage over every Q8.8 input,
   bitwise against ``torch.sigmoid`` / ``torch.tanh`` on the CPU after the
   LUT rounding;
5. the main path, per cell (``gru``: ``compile_deltagru`` of
   ``init_gru_model``; ``lstm``: ``compile_delta_program(cell="lstm")`` of
   ``init_lstm_model``) and backend (``fused``, ``fused_q8``,
   ``fused_q4``), from seeded random 2L-768H weights: a 1-stream
   ``DeltaStreamEngine.step_many`` over smooth synthetic frames at
   θx = θh = 0.25 under ``torch.cuda.set_sync_debug_mode("error")``, then a
   ``GruStreamBatcher`` over an 8-slot engine draining 16 requests of mixed
   lengths (its sessions open and close between replays). Each engine
   steps by replaying the one CUDA graph it captured at construction (one
   capture, a replay a step); its state, carry and report must equal, bit
   for bit, the same frames stepped op by op through the engine's
   ``_one_step`` on a second engine (``eager_steps``), its outputs too or
   within ``TOL_HEAD``. Launch counts, the capture's taken back and each
   replay's added, must equal steps × layers of that path's kernel, and
   no other kernel may launch, in each run; the results must match the
   same program compiled with ``device="cpu"``;
5c. resilience (after 5b, below), on the main path's engines: (a) each
   of the eight 1-stream engines opens a session, steps, snapshots and
   ``checkpoint``s; ``DeltaStreamEngine.restore`` builds a second engine
   on the card (its graph captured, then the checkpoint written into its
   buffers); both step 20 frames bitwise alike in state, carry, shadows,
   outputs and report, the restored one through one capture over the
   buffers it captured; ``corrupt_slot_state`` on it is flagged in
   ``bad_state`` by its next replay and ``rollback_stream`` restores the
   snapshot bitwise; ``step_many``, ``snapshot_streams``,
   ``rollback_stream`` and the corruption run under
   ``set_sync_debug_mode("error")``, and each engine's launches are
   exact; (b) the seeded chaos soak of ``tests/test_resilience.py::
   TestChaosSoak`` through ``serve_resumable`` at 2L-768H
   (``quantize_delta_model``, 8 slots, θ = 0.25; poison, a slot
   corruption, a stall and a crash at tick 120): every arrival terminal,
   one restart, ``recovered == quarantined >= 2``, every ``ok`` stream
   bitwise equal to a clean run of its sanitized frames on an 8-slot
   engine on the card, a second card run and a run of the same program
   with ``device="cpu"`` equal in every status and tick-based counter;
   (c) checkpoint and restore times, the soak's p99 tick wall and frames
   per second;
5d. training, the paper's recipe (Sec. IV-A) at 2L-768H CTC
   (``PAPER_NETWORKS["2L-768H"]``, seeded ``init_gru_model``, batches of
   ``digit_batch`` at its defaults, B = 32, T = 96): (a) 10 steps of
   ``make_gru_train_step(use_delta=False)``, Adam at 1e-3; (b) 10 steps with
   ``qat=EDGEDRNN_QAT`` at θx = θh = 0.25 from the pretrained weights
   (a fresh Adam state, as ``examples/train_gas_regression.py``); every
   loss finite and each stage's last 3 below its first. Each stage's first
   step is held against the same step with ``device="cpu"`` from the same
   weights and batch: the loss within ``TOL_TRAIN_LOSS``, every gradient
   leaf within ``TOL_TRAIN_GRAD`` of its largest element, every updated
   parameter within what Adam's first step makes of that; in (b) the CPU
   replays the card's LUT outputs where its own differ, each such flip
   within ``FLIP_MARGIN`` of a rounding boundary, and the flips are
   counted. No hand-written kernel launches while training. (c) A
   ``CheckpointManager`` saves the state after step 5 of (b); it restores
   bitwise, and steps 6-10 from it and from the state in memory, both under
   ``torch.use_deterministic_algorithms(True)``, are bitwise equal. (d)
   ``quantize_delta_model`` exports the trained stack to ``fused_q8`` on
   the card; an engine of 32 streams replays its captured graph over a
   fresh digit batch under ``set_sync_debug_mode("error")``, with exact
   launches of the int8 GRU kernel and no other, its final state bitwise
   and its outputs within ``TOL_HEAD`` of the same program compiled with
   ``device="cpu"``; the greedy-decode edit distance is reported;
5e. the serving fabric (``ShardedStreamFleet`` behind ``StreamRouter``,
   driven by ``run_fabric_load``), at ``benchmarks/BENCH_fabric.json``'s
   configuration: 8 shards × 128 streams on the one card (the mesh lists
   it once a shard), 2000 Poisson arrivals at 120 a tick of 6-20 frames
   (seed 777), queues of 64, shard 5 lost at tick 12 (drain checkpoint,
   replay of its streams from frame 0 on the survivors). (a) At the
   record's own width (I = 8, H = 16, L = 2, O = 3, θ = 0.05,
   ``quantize_delta_model`` of seed-0 ``init_gru_model``): the record's
   ``counts`` block key for key, as ``benchmarks/loadgen_fabric.py``
   computes it, and every completed stream bitwise equal to a clean run
   on a same-width reference engine on the card. (b) The same traffic at
   2L-768H (``fused_q8``, θx = θh = 0.25, frames of 40): the same counts in
   two runs, every completed stream bitwise its reference on the card, the
   first reference group rerun with ``device="cpu"`` (state bitwise,
   outputs within ``TOL_HEAD``), the drain checkpoint restored through
   ``DeltaStreamEngine.restore`` equal in state, carry and report to the
   dying shard's export taken just before ``remove_shard``, launches of
   the int8 GRU kernel exactly layers × (live shards summed over the ticks
   + every other engine's warm-up and replays) and no other kernel, every
   tick on which no stream can finish run under
   ``set_sync_debug_mode("error")``; ticks 6-10 of the second run profiled.
   Then a ``fused`` fleet of 4 × 8 through ``step_many`` (20 frames),
   every shard's state and outputs bitwise a standalone 8-stream engine,
   with exact launches of the fp32 GRU kernel;
5f. the LM zoo's serving path (``lm_phase``), from seeded weights drawn
   on the card by ``init_lm``: (a) llama3.2-1b at full size in bf16, an
   ``LmEngine(batch=4, max_len=256)`` under a ``ContinuousBatcher``
   draining 12 prompts of 16-96 tokens, 32 new tokens each, twice with the
   same tokens, a staggered admission that leaves the live request's
   tokens those of its solo run, and no hand-written kernel; (b)
   rwkv6-1.6b at full size in bf16, ``generate_greedy`` on 4 prompts of
   128 tokens for 32 steps, ``rwkv6_scan_bf16`` launched exactly 24 times
   by the prefill and by each decode step and no other kernel, each launch
   of the prefill and the first decode step held against its plain version
   on the inputs the path gave it (within ``TOL_F32``); (c)
   recurrentgemma-9b at full width, reduced to 3 of its 38 layers (one
   rglru, rglru, local_attn period), prefill at T = 128 and 32 decode
   steps, ``rglru_scan`` launched twice by the prefill and never by a
   decode step, bitwise its plain version; the bf16 prefill-then-decode
   logits of (a) and (c) within ``TOL_LM_BF16_RMS`` of the teacher-forced
   forward; (d) llama3.2-1b and rwkv6-1.6b in fp32 at full width and 2
   layers, the card against the CPU within ``TOL_LM`` and prefill-then-
   decode against the forward within ``TOL_F32``; with each model's init,
   prefill and
   decode times, kernels a decode step and idle share, peak memory, and the
   drain's tokens a second;
5g. the rest of the LM zoo (``zoo_phase``), seeded ``init_lm`` on the
   card, bf16, full size: (a) deepseek-v2-lite-16b (MLA, MoE) under the
   batcher as (a) of 5f (two drains the same tokens, a staggered
   admission that leaves the live request's tokens those of its run with
   the same waves); (b) granite-moe-3b-a800m, (c) llama-3.2-vision-11b
   with seeded image embeddings [4, 1601, 7680] and (d)
   seamless-m4t-large-v2 with seeded audio frames [4, 1536, 160], through
   ``generate_greedy`` on 4 prompts of 128 tokens for 32 steps; each
   model's prefill-then-decode logits within ``TOL_LM_BF16_RMS`` of its
   teacher-forced forward (MoE with capacity for every token; routing
   flips held to ``ROUTE_MARGIN_BF16``); (e) the four in fp32 at full
   width and the fewest layers that hold each block kind, card against
   CPU within ``TOL_LM`` (a flip within ``ROUTE_MARGIN_F32`` replayed)
   and decode against forward within ``TOL_F32``; no hand-written kernel
   launched; per model the times of 5f, the init's peak and the host RSS;
5h. LM training (``lm_train_phase``): (a) ``repro_torch.launch.train``
   trains llama3.2-1b at full size (the registry config: bf16 weights,
   fp32 Adam moments, remat) for 8 steps of [8, 128], every loss finite,
   and 2 steps with ``--grad-accum 2``; 5 steps of ``make_lm_train_step``
   on one fixed batch with the launcher's optimizer, whose loss falls, 2
   more profiled (kernels a step, device busy, idle share), the step cut
   into forward, backward and Adam, peak memory, tokens/s, beside the
   step's bound; (b) one train step on the card against the same step on
   the CPU in fp32 from the same seeded weights and batch [2, 32]:
   llama3.2-1b, rwkv6-1.6b and granite-moe-3b-a800m at full width and 2
   layers, recurrentgemma-9b at full width and 3 layers (its vocabulary
   cut), deepseek-v2-lite-16b, llama-3.2-vision-11b and
   seamless-m4t-large-v2 at ``reduced()`` widths: the loss within
   ``TOL_LM``, every gradient leaf within ``TOL_LM_TRAIN_GRAD`` of its
   largest (``TOL_LM_TRAIN_GRAD_RWKV6``), no zero card gradient on a
   scan's leaves, the parameters after Adam within its first-step bound,
   MoE choices replayed (flips within ``ROUTE_MARGIN_F32``); (c) the same
   3 ``--reduced`` steps of llama3.2-1b and granite-moe-3b-a800m twice,
   losses bitwise equal, and a run stopped at step 4 by its checkpoint
   and resumed to 6 bitwise an uninterrupted run's steps 5-6. The blocks
   run the plain scans under autograd: no hand-written kernel launches;
5i. the mesh paths (``mesh_phase``) on a (4, 2) mesh over the card listed
   8 times (``best_mesh(devices=[card] * 8, model_parallel=2)``): (a) the
   expert-parallel forward of granite-moe-3b-a800m and
   deepseek-v2-lite-16b at full width, 2 layers, fp32, against the CPU
   under its mesh and against the sorted path within ``TOL_LM`` (choices
   replayed, flips within ``ROUTE_MARGIN_F32``), and granite at full size
   in bf16 once beside the sorted path; (b) llama3.2-1b's train step at
   full size under the mesh (``grad_accum=2``, the ZeRO-1
   ``accum_rules``, the one-hot embedding): loss bitwise the step without
   a mesh, gradients within ``TOL_LM_TRAIN_GRAD``, parameters within
   Adam's first-step bound; timed steps; (c) a granite mesh step against
   the CPU, every fed expert with a nonzero gradient; (d)
   ``pipeline_forward`` over 4 stages bitwise the stages applied in turn
   and within ``TOL_F32`` of the CPU; (e) ``--model-parallel 2`` bitwise
   ``--model-parallel 1`` and ``prefetch_to_mesh``'s spec; no
   hand-written kernel launches;
6. times on the card: each kernel instance at B = 1 and its plain version
   (device time from CUDA-graph replay between CUDA events, also with the
   L2 flushed before each call, and the kernel's time per call launched
   from Python), each GRU/LSTM step also at B = 8 (the tile instance), the
   floor under a launch (an empty kernel of the q8 build, two launches),
   the dense ``torch.addmm``
   over the cell's fp32 volume as a yardstick the port never calls,
   ``deltagru_act`` also cold, at B = 8 and beside an empty kernel of its
   build at its grid, ``ops.deltagru_cell_fused`` at I = 40 and 768, and
   per path the engine, through its graph and op by op
   (``eager_steps``): wall and CUDA-event time per step with its kernels
   per step and idle share (``torch.profiler``, which sees the kernels of
   a replay one by one), the per-frame latency of ``step`` (median and p95
   over the frames), the capture's time and the batcher's frames per
   second; per training stage of 5d the wall per train step, frames per
   second, kernels per step and idle share, the step cut into forward,
   backward and Adam, the peak memory, and the export's time; for 5e (b)
   the wall, streams and frames a second, the steady tick p50 and p99
   (``loadgen_fabric``'s rule: ticks over 10 × the median dropped), replays
   a tick, kernels, device busy and idle share a profiled tick, and the
   scale-down's time.

The delta-ized LM cells run through the same phases: in phase 3
``delta_spmv`` with fp32 and with bf16 operands (the LM layer shapes, the
64-row decay call whose k blocks a cluster splits, unpacked ragged edges,
``ldw % 4 != 0``; B in {1, 2, 8, 9} on the walk's tails as above; every
case launched twice and the two results bitwise equal), ``rwkv6_scan`` (B
in {1, 2, 8, 9}, T in {1, 37, 128}, H in {32, 3}, with and without s0, and
4-byte aligned operands; within ``TOL_F32``), ``rglru_scan`` (the same B
and T, W in {4096, 4094, 4097}, with and without h0, and each operand in
turn 4-byte aligned; bitwise on the card), every scan case launched twice
and the two results bitwise equal; in phase 5 ``rwkv6 fused`` (RWKV6 at
D = 2048, 24 layers) and ``rglru fused`` (RG-LRU at D = W = 4096, 4
layers) from seeded random weights over the smooth stream ``c <- 0.9 c +
0.35 n``, through their captured graphs held to the eager steps as
above, with exact launch counts of ``delta_spmv`` (4 per layer step)
and of the cell's scan (1 per layer step) and no other kernel, against
the CPU program at θ = 0 over 50 frames and layer by layer in lockstep at
θ = 0.25; in phase 6 their kernels' times at the main path's shapes,
``delta_spmv`` (fp32 and bf16) per layer step at 0 %, ~10 % and 100 %
fired, also with a cold L2, the scans also cold, at B = 8, at T = 128 and
beside an empty kernel of their build at the same grid, and the engine
profile of both paths. Row 9b, ``rwkv6_scan``'s bf16 instance (bf16 r, k,
v with fp32 w, u and state, the bf16 RWKV6 models' operands), is held in
phase 3 at B in {1, 4, 9}, T in {1, 37, 128}, H in {32, 3}, with and
without s0 and with r 2-byte aligned, within ``TOL_F32``, and timed in 5f
at the LM path's shapes.

The line before the last is ``{"kernels": [...]}`` (every kernel instance;
the ``launches`` of a main-path instance are those of phases 5, 5b, 5c, 5d,
5e and 5f (the fabric's runs add to the int8 and fp32 GRU kernels', 5f to
the scans'; 5g, 5h and 5i launch none), each run counted from zero; those of an
instance on no main path, a buffered one, ``delta_spmv_bf16`` or
``deltagru_act``, are those of phases 3 and 6, and its ``path`` names the
entry that reaches it); the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# fp32 kernel vs its plain version: both sum up to 1536 products per
# output in different orders. The error of such a sum grows like sqrt(k)
# ulps of the terms' magnitude: 1e-5 bounds it at the test widths of the
# CPU suite (k <= 288, the JAX package's own batch-against-solo bound), and
# 1e-4 at k <= 1536 keeps a factor of four over that sqrt(k) scaling.
TOL_F32 = 1e-4
# The LM-path kernels are held to TOL_F32 times the magnitude of the plain
# result, max(1, max|plain|). delta_spmv at k = 4096 sums 4096 products per
# output: a random-sign sum's rounding error grows like sqrt(k) ulps of its
# own magnitude, 64 * 6e-8 = 3.8e-6 of it, and 1e-4 keeps a factor of 26
# over that. The scans sum 64 products (WKV) or none (RG-LRU) per step, but
# their state carries the error of every earlier step over T <= 128 steps.
# The head is a plain fp32 matmul (768 x 12) left to the library on each
# device; the order of its sum differs between the card and the CPU.
TOL_HEAD = 1e-5
# bf16 delta_spmv against its plain version: the same exact fp32 products
# (of bf16 values) summed in other orders, then one rounding to bf16 each,
# so the two may land one bf16 step apart: at most 2**-7 of the result's
# magnitude, held against max(1, max|plain|) like TOL_F32.
TOL_BF16 = 2.0 ** -7
# The LM paths against the CPU program, per state tensor and output, scaled
# the same way: the error of one layer (matvecs over 2048 or 4096 products,
# the WKV sum, group norm, which divides by a head's standard deviation and
# so amplifies a head's absolute error) passes on to the next, through 24
# layers of group norm in RWKV6. On the CPU, fp32 against fp64 at D = 512
# the scaled error stayed at 1e-6 or less in every layer; 1e-3 keeps a
# factor of ten over TOL_F32 for what 24 layers add.
TOL_LM = 1e-3
# The train step on the card against the same step on the CPU (phase 5d):
# the loss is a mean of CTC log-likelihoods over 96-frame recursions on a
# forward whose sums (808 and 768 products a gate, 96 steps, 2 layers) run
# in other orders on each device: 1e-5 of it. A gradient leaf sums BPTT
# over 96 steps: the CPU suite measured 2e-6 of a leaf's largest element at
# H = 32, T = 24; H = 768 sums 24 times the terms and T = 96 four times the
# steps, a factor of ~10 under sqrt growth, and 1e-4 keeps five over that.
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-4
# A LUT output of the CPU's QAT forward may differ from the card's only
# where its pre-rounding value lies this close (in Q1.4 grid steps) to a
# rounding boundary: the two devices' arguments differ by float32 sum
# orders (~1e-6 after 96 steps of accumulation, 4e-6 of a step through the
# sigmoid's slope, 16 steps a unit), so 1e-3 of a step keeps a factor of
# ~250.
FLIP_MARGIN = 1e-3
TRAIN_STEPS = 10
TRAIN_LR = 1e-3
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM data sheet, fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
THETA = 0.25                  # Q8.8 64
N_FRAMES = 300
SEED = 0
# The delta-ized LM cells at full width: RWKV6 at rwkv6-1.6b's d_model and
# depth (configs/rwkv6_1_6b.py); RG-LRU at recurrentgemma-9b's width with 4
# of its 26 recurrent layers (configs/recurrentgemma_9b.py): all 26 would be
# 15.7 GB on the card and again on the host for the CPU program. The head
# maps to 48 outputs, OUTPUT_SIZE of benchmarks/lm_delta_bench.py.
LM_OUTPUT = 48
RGLRU_LAYERS = 4


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def ptxas_summary(text: str) -> list:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its registers,
    spill stores and loads, and static shared memory (names demangled by
    ``c++filt`` where the host has it)."""
    import re
    import shutil
    entries, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            entries[cur] = {"regs": None, "spill": (0, 0), "smem": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entries[cur]["spill"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[cur]["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            entries[cur]["smem"] = int(sm.group(1)) if sm else 0
    names = list(entries)
    shown = dict(zip(names, names))
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        plain = out.stdout.splitlines()
        if out.returncode == 0 and len(plain) == len(names):
            shown = {n: re.sub(r"\(anonymous namespace\)::|^void |\(.*$",
                               "", p) for n, p in zip(names, plain)}
    return [f"{shown[n]}: {e['regs']} registers, spill stores "
            f"{e['spill'][0]} B / loads {e['spill'][1]} B, static smem "
            f"{e['smem']} B" for n, e in entries.items()]


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


def step_latencies_us(step, frames) -> list:
    """Per-frame latency of ``step(frame)`` (an engine's ``step``): frame
    in on the host to output ready on the device (each step ends in a
    synchronise), after warm-up."""
    import torch
    for x in frames[:10]:
        step(x)
    torch.cuda.synchronize()
    lat = []
    for x in frames:
        t0 = time.perf_counter()
        step(x)
        torch.cuda.synchronize()
        lat.append(1e6 * (time.perf_counter() - t0))
    return lat


def engine_profile(run, n: int, match: str | None = None) -> dict:
    """Kernels per step, device-busy time per step and the idle share of
    ``run()``, ``n`` steps (an engine's ``step_many``), from
    ``torch.profiler``; beside them the wall time and the device time
    between two CUDA events around the run, per step; with ``match``, the
    busy time per step of the kernels whose name holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    out = {"kernels_per_step": len(kernels) / n,
           "device_busy_us_per_step": busy_us / n,
           "wall_us_per_step": 1e6 * wall / n,
           "event_us_per_step": 1e3 * start.elapsed_time(stop) / n,
           "idle_share": 1.0 - busy_us / (1e6 * wall) if kernels else None}
    if match is not None:
        out["match_us_per_step"] = sum(
            e.time_range.elapsed_us() for e in kernels if match in e.name) / n
    return out


def eager_steps(eng, frames):
    """``eng``'s step run op by op, the engine's ``_one_step`` over
    ``frames`` (``[T, I]`` or ``[T, N, I]``) from its buffers, as the
    engine stepped before its step was a captured graph: the reference the
    graph's replays are held to. One host-to-device copy for the chunk.
    The final state and carry are written into the engine's buffers, so its
    ``report()`` reads them. Returns the outputs ``[T, N, O]``."""
    import torch
    xs = eng._to_device(frames).reshape(len(frames), eng.n_streams, -1)
    state, carry = eng.state, eng._carry
    outs = []
    for x in xs:
        out, state, carry = eng._one_step(state, carry, x)
        outs.append(out)
    eng._write(eng.state, eng._carry, state, carry)
    eng._n_steps += len(frames)
    return torch.stack(outs)


def graph_against_eager(path, eng, ref, outs, ref_outs) -> str:
    """Hold a graph engine's run (``outs``, its state, carry and report)
    against the eager run of the same frames (``ref``, ``ref_outs``) on the
    card: the state and the carry bitwise, the report equal, the outputs
    bitwise or, where the head's library matmul differs under capture,
    within ``TOL_HEAD``. Returns a line for the log; raises on a
    difference."""
    import torch
    g_leaves, r_leaves = tree_leaves(eng.state), tree_leaves(ref.state)
    state_same = all(torch.equal(a, b) for a, b in zip(g_leaves, r_leaves))
    state_err = max(scaled_err(a, b) for a, b in zip(g_leaves, r_leaves))
    carry_same = all(torch.equal(eng._carry[k], ref._carry[k])
                     for k in ref._carry)
    outs = outs.reshape(ref_outs.shape)
    out_same = torch.equal(outs, ref_outs)
    out_err = float((outs - ref_outs).abs().max())
    rep_same = eng.report() == ref.report()
    line = (f"  {path} graph vs eager on the card: state bitwise "
            f"{state_same} (scaled {state_err:.3e}), carry bitwise "
            f"{carry_same}, outputs bitwise {out_same} ({out_err:.3e}), "
            f"report equal {rep_same}")
    if not (state_same and carry_same and rep_same
            and out_err <= TOL_HEAD):
        raise AssertionError(f"{path}: the graph's steps differ from the "
                             f"eager steps:\n{line}")
    return line


def buffer_ptrs(eng) -> list:
    """Data pointers of an engine's buffers: the live state, carry and frame
    its captured step reads and writes, and the rollback shadows."""
    bufs = (tree_leaves(eng.state) + list(eng._carry.values()) + [eng._x]
            + tree_leaves(eng._snap_state) + list(eng._snap_carry.values()))
    return [t.data_ptr() for t in bufs]


def recording(engine_cls):
    """A subclass of ``engine_cls`` that keeps every engine it makes and
    the buffer pointers each captured its graph over."""
    class Recorded(engine_cls):
        made = []

        def __init__(self, *args, **kwargs):
            self.captured_ptrs = None
            super().__init__(*args, **kwargs)
            Recorded.made.append(self)

        def _capture_step(self):
            self.captured_ptrs = buffer_ptrs(self)
            super()._capture_step()

    return Recorded


class no_sync:
    """Inside, a host sync on a CUDA device raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        import torch
        if self.cuda:
            torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        import torch
        if self.cuda:
            torch.cuda.set_sync_debug_mode("default")
        return False


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def same_buffers(a, b) -> bool:
    """Two engines' state, carry and rollback shadows bit for bit."""
    import torch
    leaves = zip(tree_leaves(a.state) + tree_leaves(a._snap_state),
                 tree_leaves(b.state) + tree_leaves(b._snap_state))
    return (all(torch.equal(x, y) for x, y in leaves)
            and all(torch.equal(a._carry[k], b._carry[k])
                    and torch.equal(a._snap_carry[k], b._snap_carry[k])
                    for k in a._carry))


def restore_round_trip(path, eng, prog, task, frames, engine_cls,
                       ckpt_dir) -> dict:
    """The resilience phase's part (a) on one main-path engine ``eng``
    (one stream, 41 ``frames``): open a session, step, snapshot, step,
    ``checkpoint``; ``engine_cls.restore`` a second engine (built, its
    graph captured, then the checkpoint written into its buffers); both
    step 20 frames, bitwise equal in state, carry, shadows, outputs and
    report, the restored engine through its one capture over the buffers
    it captured; then ``corrupt_slot_state`` on the restored engine is
    flagged in ``bad_state`` by its next step, ``rollback_stream`` brings
    back its snapshot bit for bit, and both engines, rolled back, step 5
    frames alike. ``step_many``, ``snapshot_streams``, ``rollback_stream``
    and the corruption run under ``no_sync``. Returns the times and the
    number of engine steps run (each launches its step's kernels)."""
    import torch
    from repro_torch.serve.faults import corrupt_slot_state
    dev = eng.device
    sid = eng.open_stream()
    with no_sync(dev):
        eng.step_many(frames[:10])
        eng.snapshot_streams()
        eng.step_many(frames[10:15])
    sync(dev)
    t0 = time.perf_counter()
    eng.checkpoint(ckpt_dir)
    ckpt_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    back = engine_cls.restore(ckpt_dir, prog, task, device=dev)
    sync(dev)
    restore_ms = 1e3 * (time.perf_counter() - t0)
    cuda = dev.type == "cuda"
    if not same_buffers(eng, back) or (back._slot_busy, back._n_steps) != (
            eng._slot_busy, eng._n_steps):
        raise AssertionError(f"{path}: the restored engine differs")
    with no_sync(dev):
        a = eng.step_many(frames[15:35])
        b = back.step_many(frames[15:35])
    graphs = back.graph_stats
    if not (torch.equal(a, b) and same_buffers(eng, back)
            and back.report() == eng.report()):
        raise AssertionError(f"{path}: the restored engine stepped apart "
                             "from the one it was checkpointed from")
    if cuda and (graphs["captures"] != 1 or graphs["replays"] != 20
                 or back.captured_ptrs != buffer_ptrs(back)):
        raise AssertionError(f"{path}: restored engine graph {graphs}, "
                             "want 1 capture, 20 replays over the buffers "
                             "it captured")
    snap = [t.clone() for t in tree_leaves(back._snap_state)]
    keys = back._PER_STREAM_KEYS + ("last_x",)
    snap_carry = {k: back._snap_carry[k].clone() for k in keys}
    with no_sync(dev):
        corrupt_slot_state(back, sid)
        back.step(frames[35])
    bad = float(back.host_carry()["bad_state"][sid])
    with no_sync(dev):
        back.rollback_stream(sid)
        eng.rollback_stream(sid)
    rolled = (all(torch.equal(x, y) for x, y in zip(tree_leaves(back.state),
                                                    snap))
              and all(torch.equal(back._carry[k], snap_carry[k])
                      for k in keys))
    with no_sync(dev):
        a = eng.step_many(frames[36:41])
        b = back.step_many(frames[36:41])
    if bad != 1.0 or not rolled or not torch.equal(a, b):
        raise AssertionError(f"{path}: corruption flagged {bad} (want 1.0), "
                             f"rollback bitwise {rolled}, after it equal "
                             f"{torch.equal(a, b)}")
    return {"ckpt_ms": ckpt_ms, "restore_ms": restore_ms,
            "capture_ms": 1e3 * graphs["capture_s"],
            "steps": 40 + 26 + graphs["captures"]}


SOAK_ARRIVALS = 200
SOAK_SLOTS = 8


def soak_arrivals(input_size: int) -> list:
    """The chaos soak's schedule (``tests/test_resilience.py::
    TestChaosSoak``): 200 arrivals of 5-29 standard-normal frames, 0-3
    ticks apart, seed 1234."""
    import numpy as np
    rng = np.random.default_rng(1234)
    arrivals, t = [], 0
    for _ in range(SOAK_ARRIVALS):
        n = int(rng.integers(5, 30))
        arrivals.append((t, rng.standard_normal((n, input_size)).astype(
            np.float32)))
        t += int(rng.integers(0, 4))
    return arrivals


def soak_plan():
    from repro_torch.serve.faults import FaultPlan
    return FaultPlan(seed=99, poison_streams=(17, 90), inf_streams=(55,),
                     poison_frames=4, corrupt_slot_at=((40, 3),),
                     stall_ticks=(25,), crash_at_tick=120)


def chaos_soak(prog, task, device, ckpt_dir) -> dict:
    """The seeded chaos soak through ``serve_resumable`` (8 slots, the
    ``TestChaosSoak`` policy, a checkpoint every 32 ticks, the crash at
    tick 120). Returns its results, server, restarts, wall time and the
    frames of the streams it completed ``ok``."""
    from repro_torch.serve import resilience
    pol = resilience.ResiliencePolicy(
        max_queue=64, deadline_ticks=60, quarantine_after=3,
        on_quarantine="readmit", check_every=8, ckpt_dir=ckpt_dir,
        ckpt_every=32)
    arrivals = soak_arrivals(task.input_size)
    sync(device)
    t0 = time.perf_counter()
    results, srv, restarts = resilience.serve_resumable(
        prog, task, arrivals, pol, n_streams=SOAK_SLOTS,
        engine_kwargs={"device": device}, fault_plan=soak_plan())
    sync(device)
    wall = time.perf_counter() - t0
    ok_frames = sum(len(r.outputs) for r in results.values()
                    if r.status == "ok")
    return {"results": results, "srv": srv, "restarts": restarts,
            "wall_s": wall, "ok_frames": ok_frames,
            "statuses": {i: r.status for i, r in results.items()},
            "counters": {k: v for k, v in srv.counters.items()
                         if k not in ("straggler_flags",
                                      "missed_heartbeats")}}


def check_soak(run, what) -> None:
    """What ``TestChaosSoak`` asserts of one run."""
    c = run["counters"]
    if not (run["restarts"] == 1 and len(run["results"]) == SOAK_ARRIVALS
            and c["quarantined"] >= 2 and c["recovered"] == c["quarantined"]
            and c["poison_frames"] > 0
            and sum(s == "ok" for s in run["statuses"].values())
            >= SOAK_ARRIVALS // 2):
        raise AssertionError(f"{what}: restarts {run['restarts']}, "
                             f"{len(run['results'])} terminal, counters {c}")


def soak_reference_check(prog, task, run, device) -> int:
    """Every ``ok`` stream of a soak bitwise equal to a clean run of its
    sanitized frames through slot 0 of an 8-slot engine. Returns how many
    streams were checked."""
    import numpy as np
    from repro_torch.serve.engine import DeltaStreamEngine
    from repro_torch.serve.faults import sanitize_frames
    plan = soak_plan()
    ref = DeltaStreamEngine(prog, task, n_streams=SOAK_SLOTS, device=device)
    checked = 0
    for i, (_, frames) in enumerate(soak_arrivals(task.input_size)):
        r = run["results"][i]
        if r.status != "ok":
            continue
        fed = sanitize_frames(plan.poison_stream(i, frames))
        ref.reset()
        sid = ref.open_stream()
        xs = np.zeros((len(fed), SOAK_SLOTS, task.input_size), np.float32)
        xs[:, sid] = fed
        want = ref.step_many(xs)[:, sid].cpu().numpy()
        got = np.stack([np.asarray(o) for o in r.outputs])
        if not np.array_equal(got, want):
            raise AssertionError(f"soak arrival {i} differs from a clean "
                                 f"run: {np.abs(got - want).max():.3e}")
        checked += 1
    return checked


def layer_inputs(rng, b, lay, fire, quant):
    """Random kernel inputs for one layer: deltas fired in a random subset
    of the k-blocks (``fire`` of them per stream, at least one unless
    ``fire == 0``), dense inside a fired block. On the Q8.8 grid when
    ``quant``. Returns numpy arrays ``(m, h, c, dx, dh)`` and the real
    (unpadded) x and h columns of the blocks fired in any stream."""
    import numpy as np
    i_dim, h_dim, block_k, ip = (lay.input_size, lay.hidden_size,
                                 lay.block_k, lay.ip)
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
    m = rng.normal(0, 1.0, (b, 4 * h_dim))
    h = rng.uniform(-1, 1, (b, h_dim))
    c = rng.uniform(-3, 3, (b, h_dim))
    if quant:
        d = np.round(d * 256) / 256
        m = np.round(m * 256 * 32) / 256
        h = np.round(h * 256) / 256
        c = np.round(c * 256) / 256
    dx = np.ascontiguousarray(d[:, :i_dim])
    dh = np.ascontiguousarray(d[:, ip:ip + h_dim])
    return [a.astype(np.float32) for a in (m, h, c, dx, dh)], fired_cols


def fired_inputs(rng, b, lay, fired, solo=False, quant=True):
    """Kernel inputs for one layer whose deltas fire exactly the column
    blocks ``fired`` in the union of the streams, dense inside a fired
    block, on the Q8.8 grid (``m`` in the code domain) when ``quant``. Each
    block has an owner, a stream drawn at random, that fires it; every
    other stream fires it with odds of one half, or, with ``solo``, none
    does and the owner is never stream 0 (at ``b > 1``), so only the union
    over the streams finds the block. Returns numpy arrays
    ``(m, h, c, dx, dh)``."""
    import numpy as np
    i_dim, h_dim, bk, ip = (lay.input_size, lay.hidden_size, lay.block_k,
                            lay.ip)
    k = ip + lay.hk
    d = np.zeros((b, k))
    for blk in fired:
        owner = int(rng.integers(1 if solo and b > 1 else 0, b))
        for s in range(b):
            if s == owner or (not solo and rng.uniform() < 0.5):
                d[s, blk * bk:(blk + 1) * bk] = rng.uniform(-1, 1, bk)
    d[:, i_dim:ip] = 0.0
    d[:, ip + h_dim:] = 0.0
    m = rng.normal(0, 1.0, (b, 4 * h_dim))
    h = rng.uniform(-1, 1, (b, h_dim))
    c = rng.uniform(-3, 3, (b, h_dim))
    if quant:
        d = np.round(d * 256) / 256
        m = np.round(m * 256 * 32) / 256
        h = np.round(h * 256) / 256
        c = np.round(c * 256) / 256
    union = np.flatnonzero(d.reshape(b, k // bk, bk).any(axis=(0, 2)))
    if tuple(union) != tuple(fired):
        raise AssertionError(f"inputs fire {list(union)}, want {fired}")
    return [a.astype(np.float32) for a in
            (m, h, c, d[:, :i_dim], d[:, ip:ip + h_dim])]


def run_step(cell, fn, lay, ins):
    """One layer step of ``cell`` on ``ins = (m, h, c, dx, dh)``: the GRU
    step takes no cell state. Returns ``(m, h)`` or ``(m, h, c)``."""
    m, h, c, dx, dh = ins
    if cell == "gru":
        return fn(lay, m, h, dx, dh)
    return fn(lay, m, h, c, dx, dh)


def step_bytes(cell, be, lay, fired_cols, b: int = 1) -> int:
    """Bytes one layer step of ``b`` streams must move: the real rows and
    columns of the blocks fired in any stream once (not the block padding
    of the layout), the per-row scales and biases of the int8/int4
    layouts, and each stream's operands in and out once."""
    gates = 3 if cell == "gru" else 4
    h, i = lay.hidden_size, lay.input_size
    wbytes = {"fused": 4.0, "fused_q8": 1.0, "fused_q4": 0.5}[be]
    side = 0 if be == "fused" else (gates + 4) * h * 4
    # m in and out, h in and out (GRU) or c in, h and c out (LSTM), dx, dh
    io = 4 * b * (4 * h * 2 + h * (2 if cell == "gru" else 3) + i + h)
    return int(gates * h * fired_cols * wbytes + side + io)


def device_ms_cold(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` (captured in a CUDA graph) with a
    cold L2: before each replay a reduction reads a buffer of twice the L2,
    then the card sleeps while the host enqueues the timed replay, so
    neither the host's launch cost nor the flush is between the events."""
    import torch
    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32, device="cuda")
    flush.fill_(1.0)
    sink = torch.empty((), dtype=torch.float32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        torch.sum(flush, dim=0, out=sink)
        torch.cuda._sleep(2_000_000)        # ~1 ms at the H100's clock
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def lm_stream(rng, t: int, d: int):
    """The smooth stream of ``benchmarks/lm_delta_bench.py``: a first-order
    low-pass ``c <- 0.9 c + 0.35 n`` over white noise, ``[t, d]``."""
    import numpy as np
    noise = rng.normal(size=(t, d))
    out = np.zeros((t, d))
    c = np.zeros(d)
    for i in range(t):
        c = 0.9 * c + 0.35 * noise[i]
        out[i] = c
    return out.astype(np.float32)


def scaled_err(a, b) -> float:
    """max|a - b| over max(1, max|b|), on the host."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.numel() == 0:
        return 0.0
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def spmv_case(rng, i_dim, o_dim, b, fire):
    """Random ``delta_spmv`` operands: weights ``[o_dim, i_dim]``, deltas
    fired in ``fire`` of the 128-wide column blocks of each stream (at
    least one unless 0, dense inside a fired block) and an accumulator.
    Returns numpy ``(w, dx, acc)`` and the real columns of the blocks fired
    in any stream."""
    import numpy as np
    nbk = -(-i_dim // 128)
    w = rng.normal(0, i_dim ** -0.5, (o_dim, i_dim)).astype(np.float32)
    d = np.zeros((b, nbk * 128), np.float32)
    n_fire = 0 if fire == 0 else max(1, round(fire * nbk))
    for s in range(b):
        for blk in rng.choice(nbk, n_fire, replace=False):
            d[s, blk * 128:(blk + 1) * 128] = rng.uniform(-1, 1, 128)
    union = (d.reshape(b, nbk, 128) != 0).any(axis=(0, 2))
    cols = np.minimum(128, i_dim - 128 * np.arange(nbk))
    acc = rng.normal(0, 1, (b, o_dim)).astype(np.float32)
    return (w, np.ascontiguousarray(d[:, :i_dim]), acc,
            int((cols * union).sum()))


def spmv_fired(rng, i_dim, o_dim, b, fired, solo=False):
    """``delta_spmv`` deltas ``[b, i_dim]`` that fire exactly the 128-wide
    column blocks ``fired`` in the union of the streams (owners drawn as in
    ``fired_inputs``; the last block may be ragged), and an accumulator
    ``[b, o_dim]``. Returns numpy ``(dx, acc)``."""
    import numpy as np
    d = np.zeros((b, -(-i_dim // 128) * 128))
    for blk in fired:
        owner = int(rng.integers(1 if solo and b > 1 else 0, b))
        for s in range(b):
            if s == owner or (not solo and rng.uniform() < 0.5):
                d[s, blk * 128:(blk + 1) * 128] = rng.uniform(-1, 1, 128)
    d = d[:, :i_dim]
    acc = rng.normal(0, 1, (b, o_dim))
    return d.astype(np.float32), acc.astype(np.float32)


def lm_layer_lockstep(prog, cpu_prog, frames, theta, tree_to, tree_leaves):
    """Layer by layer, feed the card's and the CPU's copies of the program
    the same layer input and state (the card's), for every frame, and
    compare the layer output and new state scaled by magnitude. A layer
    step whose firing masks differ (one ulp moved a value across θ) is
    counted and not compared. Returns ``(max scaled error, flips, layer
    steps)``."""
    import torch
    step = prog.spec.step
    state = prog.init_state((1,))
    layers = list(state.stack.layers)
    err, flips, n = 0.0, 0, 0
    in_max = [0.0] * prog.num_layers
    for x in frames:
        inp = torch.from_numpy(x[None]).to(prog.device)
        for li in range(prog.num_layers):
            in_max[li] = max(in_max[li], float(inp.abs().max()))
            g = step(prog.layers[li], layers[li], inp, theta, theta,
                     layout=prog.layouts[li])
            c = step(cpu_prog.layers[li], tree_to(layers[li], "cpu"),
                     inp.cpu(), theta, theta, layout=cpu_prog.layouts[li])
            n += 1
            same_fire = all(torch.equal((a.cpu() != 0), (bb != 0)) for a, bb
                            in ((g.delta_x, c.delta_x),
                                (g.delta_h, c.delta_h)))
            if not same_fire:
                flips += 1
            else:
                for a, bb in zip([g.h] + tree_leaves(g.state),
                                 [c.h] + tree_leaves(c.state)):
                    err = max(err, scaled_err(a, bb))
            layers[li] = g.state
            inp = g.h
    return err, flips, n, in_max


def train_grads(params, task, batch, qat, use_delta):
    """The loss and gradients (in ``tree_leaves`` order) of the paper's
    train step, by autograd: what ``make_gru_train_step`` computes before
    its Adam update."""
    from repro_torch.models.gru_rnn import gru_model_forward
    from repro_torch.train.losses import ctc_loss_mean
    from repro_torch.train.optim import tree_leaves, tree_map
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    out, _ = gru_model_forward(p, task, batch["features"],
                               use_delta=use_delta, qat=qat)
    loss = ctc_loss_mean(out, batch["labels"], batch["in_lens"],
                         batch["lab_lens"])[0]
    loss.backward()
    return loss.detach(), [t.grad for t in tree_leaves(p)]


def lut_lockstep(margin: float):
    """Two QAT policies on ``EDGEDRNN_QAT``'s grids for holding a card's QAT
    train step against the CPU's: ``record`` keeps every LUT output of a
    forward on the card, in call order; ``replay``, on the CPU, computes its
    own and, where the two differ (a one-ulp difference of the LUT's
    argument, a float32 sum, moved the output a grid step), takes the
    card's, after checking that its own pre-rounding value lies within
    ``margin`` grid steps of a rounding boundary (else it raises: no flip
    explains the difference). The backward is the exact function's either
    way. Returns ``(record, replay, stats)``; ``stats`` counts the LUT
    sites, the flips and the largest flip margin."""
    import dataclasses

    import torch
    from repro_torch.quant.fake_quant import quantize
    from repro_torch.quant.lut import LutNonlinearity
    from repro_torch.quant.qat import QatPolicy

    log = []
    stats = {"sites": 0, "flips": 0, "max_margin": 0.0}

    @dataclasses.dataclass(frozen=True)
    class Recording(LutNonlinearity):
        def __call__(self, x):
            y = LutNonlinearity.__call__(self, x)
            log.append(y.detach())
            return y

    @dataclasses.dataclass(frozen=True)
    class Replaying(LutNonlinearity):
        calls: object = None

        def __call__(self, x):
            exact = self.fn(x)
            lut = quantize(exact, self.out_fmt)
            card = next(self.calls).to(lut.device)
            stats["sites"] += lut.numel()
            differs = lut.detach() != card
            n = int(differs.sum())
            if n:
                s = exact.detach()[differs].double() * self.out_fmt.scale
                m = float((s - torch.floor(s) - 0.5).abs().max())
                if m > margin:
                    raise AssertionError(
                        f"a LUT output differs from the card's {m:.3e} grid "
                        f"steps from a rounding boundary (> {margin})")
                stats["flips"] += n
                stats["max_margin"] = max(stats["max_margin"], m)
                lut = torch.where(differs, card, lut)
            return exact + (lut - exact).detach()

    @dataclasses.dataclass(frozen=True)
    class Record(QatPolicy):
        def act_fns(self):
            sig, tanh = QatPolicy.act_fns(self)
            return (Recording(sig.fn, sig.out_fmt),
                    Recording(tanh.fn, tanh.out_fmt))

    @dataclasses.dataclass(frozen=True)
    class Replay(QatPolicy):
        def act_fns(self):
            sig, tanh = QatPolicy.act_fns(self)
            calls = iter(log)      # one forward's calls, in order
            return (Replaying(sig.fn, sig.out_fmt, calls),
                    Replaying(tanh.fn, tanh.out_fmt, calls))

    return Record(), Replay(), stats


def adam_first_step_bound(g, delta, scale, lr, eps=1e-8):
    """How far Adam's first update ``lr * c g / (|c g| + eps)`` (``c`` the
    clip scale) moves when the gradient ``g`` moves by ``delta``: monotone
    in ``g``, so the worst case is at an end of ``[g - delta, g + delta]``;
    plus 8 ulps of ``lr`` for the bias corrections' rounding."""
    import numpy as np

    def upd(v):
        v = scale * np.asarray(v, np.float64)
        return v / (np.abs(v) + eps)
    u = upd(g)
    reach = np.maximum(np.abs(upd(g + delta) - u), np.abs(upd(g - delta) - u))
    return lr * (reach + 8 * 2.0 ** -24)


def first_step_against_cpu(what, step, cpu_step, state, cpu_state, batch,
                           qat, cpu_qat, task, use_delta, lr):
    """The first step of a training stage on the card held against the same
    step run with ``device="cpu"`` from the same weights and batch: the
    loss within ``TOL_TRAIN_LOSS``, every gradient leaf within
    ``TOL_TRAIN_GRAD`` of its largest element, every updated parameter
    within what Adam's first step makes of that bound. The gradients come
    from ``train_grads`` (with ``qat`` / ``cpu_qat``, the recording and
    replaying policies for a QAT stage), the updated parameters from the
    two packages' ``step``. Returns ``(card state, metrics, report)``."""
    import numpy as np
    import torch
    from repro_torch.train.optim import tree_leaves
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    loss, grads = train_grads(state.params, task, batch, qat, use_delta)
    c_loss, c_grads = train_grads(cpu_state.params, task, cpu_batch,
                                  cpu_qat, use_delta)
    new, metrics = step(state, batch)
    c_new, c_metrics = cpu_step(cpu_state, cpu_batch)
    loss_err = abs(float(loss) - float(c_loss)) / abs(float(c_loss))
    step_loss_err = abs(float(metrics["loss"]) - float(c_metrics["loss"])) \
        / abs(float(c_metrics["loss"]))
    scale = min(1.0, 1.0 / (float(c_metrics["grad_norm"]) + 1e-9))
    grad_err, param_excess = 0.0, -float("inf")
    for g, cg, p, cp in zip(grads, c_grads, tree_leaves(new.params),
                            tree_leaves(c_new.params)):
        cg = cg.numpy()
        top = float(np.abs(cg).max())
        grad_err = max(grad_err, float(np.abs(g.cpu().numpy() - cg).max())
                       / top)
        bound = adam_first_step_bound(cg, TOL_TRAIN_GRAD * top, scale, lr)
        cp = cp.numpy()
        excess = (np.abs(p.cpu().numpy() - cp)
                  - bound - np.spacing(np.abs(cp)))
        param_excess = max(param_excess, float(excess.max()))
    report = (f"{what} first step, card against CPU: loss {loss_err:.3e} "
              f"(step {step_loss_err:.3e}) relative, gradients "
              f"{grad_err:.3e} of each leaf's largest, updated parameters "
              f"within the Adam bound with {-param_excess:.3e} to spare at "
              f"the closest")
    if (loss_err > TOL_TRAIN_LOSS or step_loss_err > TOL_TRAIN_LOSS
            or grad_err > TOL_TRAIN_GRAD or param_excess > 0
            or not torch.isfinite(loss)):
        raise AssertionError(f"{report}: outside the bounds")
    return new, metrics, report


def train_split_ms(params, task, batch, qat, use_delta, opt_state, opt_cfg):
    """One train step cut at its joints, each part ended by a synchronise:
    the forward with its loss, the backward, the Adam update (ms)."""
    import torch
    from repro_torch.models.gru_rnn import gru_model_forward
    from repro_torch.train.losses import ctc_loss_mean
    from repro_torch.train.optim import adam_update, tree_map
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    out, _ = gru_model_forward(p, task, batch["features"],
                               use_delta=use_delta, qat=qat)
    loss = ctc_loss_mean(out, batch["labels"], batch["in_lens"],
                         batch["lab_lens"])[0]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    adam_update(tree_map(lambda t: t.grad, p), opt_state, params, opt_cfg)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return {"forward_ms": 1e3 * (t1 - t0), "backward_ms": 1e3 * (t2 - t1),
            "adam_ms": 1e3 * (t3 - t2)}


def graph_check(what, eng, steps):
    """The engine stepped through its one captured graph: captured
    once (at construction), replayed once a step."""
    g = eng.graph_stats
    if g["captures"] != 1 or g["replays"] != steps:
        raise AssertionError(f"{what}: graph {g}, want 1 capture and "
                             f"{steps} replays")


def training_phase(dev, train_task, batch: int = 32, max_t: int = 96):
    """Phase 5d on ``train_task`` (a CTC ``GruTaskConfig``): (a) 10 steps of
    the dense pretrain, (b) 10 of the QAT DeltaGRU retrain at θ = 0.25, each
    stage's first step held against the CPU, (c) a checkpoint after step 5
    of (b), restored and steps 6-10 replayed under deterministic
    algorithms, (d) the trained stack exported to ``fused_q8`` and streamed
    through the engine's captured graph. Returns the per-stage records
    (losses, final state, step, step times, peak memory) with the served
    export's under ``"serve"`` (launches, export ms, decode errors), the
    batches and the optimizer config."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import digit_batch
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.ft.checkpoint import restore as ckpt_restore
    from repro_torch.kernels import ops
    from repro_torch.models.gru_rnn import gru_model_forward, init_gru_model
    from repro_torch.quant.export import quantize_delta_model
    from repro_torch.quant.qat import EDGEDRNN_QAT, FP32
    from repro_torch.serve.engine import DeltaStreamEngine
    from repro_torch.train.ctc import ctc_greedy_decode, edit_distance
    from repro_torch.train.losses import ctc_loss_mean
    from repro_torch.train.optim import (AdamConfig, constant_schedule,
                                         tree_leaves as opt_leaves, tree_map)
    from repro_torch.train.trainer import (LoopHooks, init_train_state,
                                           make_gru_train_step, train_loop)
    delta_task = dataclasses.replace(train_task, theta_x=THETA,
                                     theta_h=THETA)
    gen = torch.Generator().manual_seed(SEED + 2)
    batches = [digit_batch(gen, batch, max_t, device=dev)
               for _ in range(2 * TRAIN_STEPS)]
    serve_draws = digit_batch(gen, batch, max_t, device=dev)
    opt_cfg = AdamConfig(schedule=constant_schedule(TRAIN_LR))
    train = {}
    ops.reset_launch_counts()
    record, replay, qat_stats = lut_lockstep(FLIP_MARGIN)
    stages = {"dense": (train_task, FP32, False, FP32, FP32),
              "qat": (delta_task, EDGEDRNN_QAT, True, record, replay)}
    train_params = init_gru_model(SEED, train_task, device=dev)
    cpu_train_params = init_gru_model(SEED, train_task, device="cpu")
    stash = {}
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, every=5, keep=2)
        for si, (name, spec) in enumerate(stages.items()):
            task_s, qat, use_delta, rec, rep = spec
            step = make_gru_train_step(task_s, opt_cfg, qat=qat,
                                       use_delta=use_delta)
            cpu_step = make_gru_train_step(task_s, opt_cfg, qat=rep,
                                           use_delta=use_delta)
            tstate, m1, report = first_step_against_cpu(
                f"train {name}", step, cpu_step,
                init_train_state(train_params),
                init_train_state(cpu_train_params), batches[si * TRAIN_STEPS],
                rec, rep, task_s, use_delta, TRAIN_LR)
            log(report)

            def keep(i, st, name=name):
                if name == "qat":
                    mgr.maybe_save(int(st.step), st)
                    if int(st.step) == 5:
                        stash[5] = st
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            tstate, hist = train_loop(
                step, tstate,
                batches[si * TRAIN_STEPS + 1:(si + 1) * TRAIN_STEPS],
                TRAIN_STEPS - 1, LoopHooks(checkpoint_every=1,
                                           save_checkpoint=keep))
            losses = [float(m1["loss"])] + [h["loss"] for h in hist]
            if not all(np.isfinite(losses)) or not (
                    np.mean(losses[-3:]) < losses[0]):
                raise AssertionError(f"train {name}: losses {losses}")
            train[name] = {"losses": losses, "state": tstate, "step": step,
                           "task": task_s, "qat": qat, "use_delta": use_delta,
                           "step_ms": [1e3 * h["step_time_s"] for h in hist],
                           "peak_bytes": torch.cuda.max_memory_allocated()
                           - base, "base_bytes": base}
            cell = f"QAT DeltaGRU, theta={THETA}" if use_delta else "GRU"
            log(f"train {name} ({cell}, {train_task.num_layers}L-"
                f"{train_task.hidden_size}H CTC, B={batch} T={max_t}, Adam "
                f"{TRAIN_LR}): losses "
                + ", ".join(f"{v:.4f}" for v in losses))
            train_params = tstate.params
            cpu_train_params = {
                k2: (v.cpu() if isinstance(v, torch.Tensor)
                     else [p.to("cpu") for p in v])
                for k2, v in tstate.params.items()}
        mgr.wait()
        stray = {k2: v for k2, v in ops.launch_counts().items() if v}
        if stray:
            raise AssertionError(f"training launched hand-written kernels: "
                                 f"{stray}")

        # (c) resume: steps 6-10 of the QAT stage from the in-memory state
        # at step 5 and from its checkpoint, both under deterministic
        # algorithms (gather's backward, a scatter-add, otherwise adds with
        # atomics); PyTorch then refuses cuBLAS unless its workspace is fixed
        prior_ws = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        q = train["qat"]
        tail = batches[TRAIN_STEPS + 5:2 * TRAIN_STEPS]
        torch.use_deterministic_algorithms(True)
        try:
            restored = ckpt_restore(tmp, stash[5], step=5, device=dev)
            same_restore = all(torch.equal(a, b) for a, b in zip(
                opt_leaves(restored), opt_leaves(stash[5])))
            a_state, _ = train_loop(q["step"], stash[5], tail, 5)
            b_state, _ = train_loop(q["step"], restored, tail, 5)
        finally:
            torch.use_deterministic_algorithms(False)
            if prior_ws is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = prior_ws
        resume_bitwise = all(torch.equal(a, b) for a, b in zip(
            opt_leaves(a_state), opt_leaves(b_state)))
        timed_diff = max(float((a - b).abs().max()) for a, b in zip(
            opt_leaves(a_state.params), opt_leaves(q["state"].params)))
        # which part of the step differs between runs with the default
        # algorithms: the CTC loss's gradient w.r.t. the logits, and the
        # network's gradient under a fixed cotangent, each taken twice
        p = tree_map(lambda t: t.detach().requires_grad_(True),
                     q["state"].params)
        bt = batches[TRAIN_STEPS]
        out, _ = gru_model_forward(p, delta_task, bt["features"],
                                   qat=EDGEDRNN_QAT)
        logits = out.detach().requires_grad_(True)
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            SEED)).to(dev)

        def ctc_grad():
            loss = ctc_loss_mean(logits, bt["labels"], bt["in_lens"],
                                 bt["lab_lens"])[0]
            return [torch.autograd.grad(loss, logits)[0]]

        def net_grad():
            return torch.autograd.grad(out, opt_leaves(p), cot,
                                       retain_graph=True)
        twice = {}
        for part, fn in (("ctc", ctc_grad), ("net", net_grad)):
            g1, g2 = fn(), fn()
            twice[part] = max(float((a - b).abs().max())
                              for a, b in zip(g1, g2))
        log(f"train resume: checkpoint at step 5 restored bitwise "
            f"{same_restore}; steps 6-10 replayed from it under "
            f"deterministic algorithms bitwise equal to the same steps from "
            f"the state in memory: {resume_bitwise}; the timed run's step 10 "
            f"(default algorithms) differs from them by {timed_diff:.3e} in "
            f"the parameters; with the default algorithms, twice over: the "
            f"CTC loss's gradient w.r.t. the logits differs by "
            f"{twice['ctc']:.3e}, the network's gradient under a fixed "
            f"cotangent by {twice['net']:.3e}")
        if not (same_restore and resume_bitwise):
            raise AssertionError("train resume is not bitwise")
    # the CPU ran two forwards (gradients, then the step) over one log
    log(f"train qat first step: {qat_stats['sites'] // 2} LUT sites a "
        f"forward; {qat_stats['flips'] // 2} of the CPU's outputs differed "
        f"from the card's and took the card's value (largest distance of "
        f"such a pre-rounding value from a rounding boundary: "
        f"{qat_stats['max_margin']:.3e} of a Q1.4 step)")

    # (d) export the trained stack and stream a fresh digit batch through
    # the engine's captured graph at θ = 0.25
    trained = train["qat"]["state"].params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_prog = quantize_delta_model(trained)
    torch.cuda.synchronize()
    export_ms = 1e3 * (time.perf_counter() - t0)
    serve_cpu = quantize_delta_model(
        {k2: (v.cpu() if isinstance(v, torch.Tensor)
              else [p.to("cpu") for p in v]) for k2, v in trained.items()},
        device="cpu")
    feats = serve_draws["features"].cpu().numpy()
    n_serve = feats.shape[1]
    eng = DeltaStreamEngine(serve_prog, delta_task, n_streams=n_serve)
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = eng.step_many(feats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n_served = ops.launch_counts()
    q8 = ops.DELTA_Q8_GRU_I8
    want = feats.shape[0] * train_task.num_layers
    if n_served[q8.name] != want or sum(n_served.values()) != want:
        raise AssertionError(f"served export: launches {n_served}, want "
                             f"{want} of {q8.name}")
    graph_check("served export", eng, feats.shape[0])
    ce = DeltaStreamEngine(serve_cpu, delta_task, n_streams=n_serve,
                           device="cpu")
    c_outs = ce.step_many(feats)
    same_state = all(torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves(eng.state), tree_leaves(ce.state)))
    head_err = float((outs.cpu() - c_outs).abs().max())
    if not same_state or head_err > TOL_HEAD or not torch.isfinite(
            outs).all():
        raise AssertionError(f"served export disagrees with the CPU program: "
                             f"state bitwise {same_state}, outputs "
                             f"{head_err:.3e}")
    decoded = ctc_greedy_decode(torch.log_softmax(outs, -1),
                                serve_draws["in_lens"]).cpu().numpy()
    labels = serve_draws["labels"].cpu().numpy()
    lab_lens = serve_draws["lab_lens"].cpu().numpy()
    errors = sum(edit_distance([v for v in d if v >= 0],
                               list(lab[:ln]))
                 for d, lab, ln in zip(decoded, labels, lab_lens))
    train["serve"] = {"export_ms": export_ms, "errors": errors,
                      "labels": int(lab_lens.sum()),
                      "launches": n_served[q8.name]}
    log(f"served export (fused_q8, {n_serve} streams, {feats.shape[0]} "
        f"frames, theta={THETA}): {n_served[q8.name]} launches of "
        f"{q8.name}; final state bitwise the CPU program's, outputs "
        f"{head_err:.3e}; greedy "
        f"decode edit distance {errors} over {int(lab_lens.sum())} labels "
        f"({errors / lab_lens.sum():.4f} a label); report gamma_dx "
        f"{eng.report()['gamma_dx']:.4f}")
    return train, batches, opt_cfg


# -- phase 5e: the serving fabric --------------------------------------------

FABRIC_JSON = ROOT / "benchmarks" / "BENCH_fabric.json"
# the fabric's own tick-exact record (benchmarks/loadgen_fabric.py, the JAX
# package's): its config is the run, its counts the gate
FABRIC_PROFILE_TICKS = (6, 10)     # ticks profiled in (b)'s second run


def steady_percentile(walls, q):
    """``benchmarks/loadgen_fabric.py::_steady_percentile``: the percentile
    of the tick walls after dropping ticks over 10 × the median."""
    if not walls:
        return 0.0
    walls = sorted(walls)
    med = walls[len(walls) // 2]
    steady = [w for w in walls if w <= 10 * med] or walls
    return steady[min(len(steady) - 1, int(q * len(steady)))]


def fabric_check_contract(router, summary, cfg) -> None:
    """The hard asserts of ``benchmarks/loadgen_fabric.py`` on one run:
    both books close, the scale-down displaced streams and every one of
    them completed, and the full fleet reached ``min_concurrent``."""
    cons = router.conservation()
    replayed = [r for r in summary.results.values() if r.replayed]
    if not (cons["conserved"] and cons["queued"] == 0
            and cons["in_flight"] == 0
            and cons["submitted"] == cfg["n_arrivals"]
            == cons["completed"] + cons["rejected"] + cons["shed"]
            and cons["frames_conserved"]
            and summary.scale_info is not None and cons["rebalanced"] > 0
            and len(replayed) == cons["rebalanced"]
            and all(r.status == "ok" for r in replayed)
            and summary.peak_concurrent_full >= cfg["min_concurrent"]):
        raise AssertionError(f"fabric contract: {cons}, peak on the full "
                             f"fleet {summary.peak_concurrent_full}")


def fabric_counts(router, summary, fleet, parity_ok) -> dict:
    """The tick-exact ``counts`` block, computed as
    ``benchmarks/loadgen_fabric.py`` computes it."""
    cons = router.conservation()
    results = summary.results
    ok_lat = sorted(r.latency_ticks for r in results.values()
                    if r.status == "ok")
    rep = router.report()
    return {
        "submitted": cons["submitted"],
        "completed": cons["completed"],
        "rejected": cons["rejected"],
        "shed": cons["shed"],
        "rebalanced": cons["rebalanced"],
        "replayed_completed": sum(r.replayed for r in results.values()),
        "parity_ok": parity_ok,
        "frames_out": cons["frames_out"],
        "harvested_steps": cons["harvested_steps"],
        "ticks": summary.ticks,
        "peak_concurrent": summary.peak_concurrent,
        "peak_concurrent_full": summary.peak_concurrent_full,
        "peak_active": summary.peak_active,
        "latency_ticks_p50": ok_lat[len(ok_lat) // 2],
        "latency_ticks_p99": ok_lat[min(len(ok_lat) - 1,
                                        int(0.99 * len(ok_lat)))],
        "per_shard_completed": (
            [b["completed"] for b in rep["retired_shards"]]
            + [b["completed"] for b in rep["per_shard"]]),
        "fleet_shards_final": fleet.n_shards,
    }


def fabric_parity(arrivals, results, fleet, keep_first=False):
    """``benchmarks/loadgen_fabric.py::_check_parity`` on the fleet's
    device: every completed stream bitwise equal to a clean run on a
    same-width reference engine (``fleet.reference_engine()``), B streams
    a reference run, short streams padded with their last frame. Returns
    the count and, with ``keep_first``, the first group's frames, outputs
    and final state (for the CPU rerun)."""
    import numpy as np
    b = fleet.streams_per_shard
    ref = fleet.reference_engine()
    completed = [(i, r) for i, r in sorted(results.items())
                 if r.status == "ok"]
    parity_ok, first = 0, None
    for base in range(0, len(completed), b):
        group = completed[base:base + b]
        t_max = max(len(arrivals[i][1]) for i, _ in group)
        xs = np.zeros((t_max, b, fleet.dims.input_size), np.float32)
        for j, (i, _) in enumerate(group):
            frames = arrivals[i][1]
            xs[:len(frames), j] = frames
            xs[len(frames):, j] = frames[-1]
        ref.reset()
        want = ref.step_many(xs).cpu().numpy()
        if keep_first and first is None:
            first = {"xs": xs, "outs": want,
                     "state": [t.to("cpu", copy=True)
                               for t in tree_leaves(ref.state)]}
        for j, (i, r) in enumerate(group):
            got = np.stack([np.asarray(o) for o in r.outputs])
            if want[:len(got), j].tobytes() != got.tobytes():
                raise AssertionError(
                    f"fabric parity: arrival {i} (shard {r.shard}, replayed="
                    f"{r.replayed}, {len(got)} frames) diverged from its "
                    "clean same-width reference")
            parity_ok += 1
    return parity_ok, first


class TickProfile:
    """``torch.profiler`` (device activity only: recording every host op
    of ~1000 streams' bookkeeping would slow the ticks it measures) and
    two CUDA events over router ticks ``first`` to ``last`` (the arrivals
    submitted between them included), driven from ``run_fabric_load``'s
    ``on_tick`` hook: kernels, device busy and idle share a tick, as
    ``engine_profile`` reads them."""

    def __init__(self, first: int, last: int):
        self.first, self.last = first, last
        self.result = None

    def __call__(self, router, tick):
        import torch
        from torch.profiler import ProfilerActivity, profile
        if tick == self.first - 1:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.start = torch.cuda.Event(enable_timing=True)
            self.stop = torch.cuda.Event(enable_timing=True)
            self.t0 = time.perf_counter()
            self.start.record()
        elif tick == self.last:
            self.stop.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
            n = self.last - self.first + 1
            kernels = [e for e in self.prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_us = sum(e.time_range.elapsed_us() for e in kernels)
            self.result = {
                "ticks": n, "kernels_per_tick": len(kernels) / n,
                "device_busy_us_per_tick": busy_us / n,
                "wall_us_per_tick": 1e6 * wall / n,
                "event_us_per_tick": 1e3 * self.start.elapsed_time(
                    self.stop) / n,
                "idle_share": 1.0 - busy_us / (1e6 * wall)}


def timed(obj, name, acc) -> None:
    """Wrap the method ``name`` of ``obj`` so that ``acc[name]`` sums the
    host seconds spent in its calls."""
    fn = getattr(obj, name)
    acc[name] = 0.0

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[name] += time.perf_counter() - t0

    setattr(obj, name, call)


def fabric_run(prog, task, cfg, arrivals, dev, ckpt_dir, *, quiet_no_sync,
               on_tick=None) -> dict:
    """One load run of the committed fabric configuration ``cfg``
    (``BENCH_fabric.json``'s): a ``ShardedStreamFleet`` of
    ``n_shards × streams_per_shard`` slots on ``dev`` (the mesh lists the
    device once a shard), a ``StreamRouter`` with ``max_queue``, the
    arrivals through ``run_fabric_load`` with the scale-down of
    ``scale_down_shard`` at ``scale_down_at`` into ``ckpt_dir``. With
    ``quiet_no_sync`` every tick on which no stream can finish runs under
    ``no_sync``. Records the ticks that stepped the fleet with the live
    shards, the export of the dying shard taken just before
    ``remove_shard`` and the scale-down's time (drain checkpoint and
    remove)."""
    from repro_torch.dist.elastic import best_mesh
    from repro_torch.dist.serving import ShardedStreamFleet
    from repro_torch.serve.loadgen import run_fabric_load
    from repro_torch.serve.router import RouterPolicy, StreamRouter
    n_shards = cfg["n_shards"]
    mesh = best_mesh(n_shards, devices=[dev] * n_shards)
    fleet = ShardedStreamFleet(prog, task,
                               n_streams=n_shards * cfg["streams_per_shard"],
                               mesh=mesh)
    router = StreamRouter(fleet, RouterPolicy(max_queue=cfg["max_queue"]))
    rec = {"quiet_ticks": 0, "shard_steps": 0, "before_remove": None,
           "scale_ms": None}
    router_tick, fleet_remove = router.tick, fleet.remove_shard

    def tick():
        # a stream finishes this tick iff it is in flight on its last
        # frame, or queued with a single frame (admitted and finished)
        harvest = (any(r.cursor + 1 >= len(r.frames)
                       for r in router._slot_rec.values())
                   or any(len(r.frames) == 1 for q in router.queues
                          for r in q))
        ticks = fleet._n_ticks
        if quiet_no_sync and not harvest:
            rec["quiet_ticks"] += 1
            with no_sync(dev):
                out = router_tick()
        else:
            out = router_tick()
        if fleet._n_ticks > ticks:
            rec["shard_steps"] += fleet.n_shards
        return out

    def remove_shard(dead, ckpt_dir=None):
        rec["before_remove"] = fleet.export_shard_engine(dead)
        sync(dev)
        t0 = time.perf_counter()
        info = fleet_remove(dead, ckpt_dir=ckpt_dir)
        sync(dev)
        rec["scale_ms"] = 1e3 * (time.perf_counter() - t0)
        return info

    router.tick, fleet.remove_shard = tick, remove_shard
    # host seconds in the fleet's calls and the router's submits (a carry
    # read waits for the tick's replays to finish)
    rec["host_s"] = {}
    for obj, name in ((fleet, "step"), (fleet, "open_stream"),
                      (fleet, "host_carry"), (fleet, "close_stream"),
                      (router, "submit")):
        timed(obj, name, rec["host_s"])
    sync(dev)
    t0 = time.perf_counter()
    summary = run_fabric_load(
        router, arrivals, scale_down_at=cfg["scale_down_at"],
        scale_down_shard=cfg["scale_down_shard"], ckpt_dir=ckpt_dir,
        on_tick=on_tick)
    sync(dev)
    rec["wall_s"] = time.perf_counter() - t0
    ckpt = summary.scale_info["checkpoint"]
    if not (ckpt and os.path.exists(ckpt)):
        raise AssertionError("scale-down did not publish the dying shard's "
                             "drain checkpoint")
    fabric_check_contract(router, summary, cfg)
    rec.update(fleet=fleet, router=router, summary=summary)
    return rec


def fabric_phase(dev, model_768, kernel_q8, kernel_f32, smi) -> dict:
    """Phase 5e: the serving fabric on the card. (a) ``BENCH_fabric.json``'s
    configuration at its own width (I = 8, H = 16, L = 2, O = 3, θ = 0.05,
    ``quantize_delta_model`` of seed-0 ``init_gru_model``): its counts
    exactly, every completed stream bitwise its same-width reference, the
    drain checkpoint published. (b) The same traffic at 2L-768H
    (``model_768``, ``quantize_delta_model``, θx = θh = 0.25, frames of
    40): the counts twice, every stream bitwise, the first reference group
    against the CPU, the drain checkpoint restored into an engine equal to
    the dying shard's export, exact launches of ``kernel_q8`` and no other,
    no host sync on ticks that harvest nothing, and the tick profile of
    the second run. Then a ``fused`` fleet of 4 × 8 ``step_many`` over 20
    frames, bitwise 4 standalone 8-stream engines. Returns the launches a
    kernel and the timings."""
    import numpy as np
    import torch
    from repro_torch.core.program import compile_deltagru
    from repro_torch.dist import serving
    from repro_torch.dist.elastic import best_mesh
    from repro_torch.kernels import ops
    from repro_torch.models.gru_rnn import (PAPER_NETWORKS, GruTaskConfig,
                                            init_gru_model)
    from repro_torch.quant.export import quantize_delta_model
    from repro_torch.serve.loadgen import poisson_arrivals
    bench = json.loads(FABRIC_JSON.read_text())
    cfg, want_counts = bench["config"], bench["counts"]
    launches = {kernel_q8.name: 0, kernel_f32.name: 0}
    Recorded = recording(serving.DeltaStreamEngine)
    saved = serving.DeltaStreamEngine
    serving.DeltaStreamEngine = Recorded

    def arrivals_of(width):
        return poisson_arrivals(cfg["n_arrivals"], cfg["rate_per_tick"],
                                min_len=cfg["min_len"],
                                max_len=cfg["max_len"], input_size=width,
                                seed=cfg["seed"])

    def counted(what, run_fn, kinfo, layers):
        """``run_fn()`` from zero counts; the launches must be ``layers``
        a step of every engine it made (captures' warm-up steps and
        replays) of ``kinfo`` alone."""
        Recorded.made.clear()
        ops.reset_launch_counts()
        out = run_fn()
        sync(dev)
        n = {k: v for k, v in ops.launch_counts().items() if v}
        steps = sum(e.graph_stats["captures"] + e.graph_stats["replays"]
                    for e in Recorded.made)
        # (on the CPU no kernel launches)
        if n != ({kinfo.name: steps * layers} if dev.type == "cuda" else {}):
            raise AssertionError(f"{what}: launches {n}, want "
                                 f"{steps * layers} of {kinfo.name}")
        launches[kinfo.name] += n.get(kinfo.name, 0)
        return out, list(Recorded.made)

    res = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # (a) the committed configuration at its own width
            task_a = GruTaskConfig(cfg["input"], cfg["hidden"], cfg["layers"],
                                   3, task="regression", theta_x=0.05,
                                   theta_h=0.05)
            prog_a = quantize_delta_model(
                init_gru_model(0, task_a, device=dev), device=dev)
            arr_a = arrivals_of(cfg["input"])

            def run_a():
                run = fabric_run(prog_a, task_a, cfg, arr_a, dev,
                                 os.path.join(tmp, "a"), quiet_no_sync=False)
                run["parity_ok"], _ = fabric_parity(
                    arr_a, run["summary"].results, run["fleet"])
                return run

            run, _ = counted("fabric (a)", run_a, kernel_q8, task_a.num_layers)
            counts = fabric_counts(run["router"], run["summary"], run["fleet"],
                                   run["parity_ok"])
            if counts != want_counts:
                raise AssertionError(f"fabric (a): counts {counts}, "
                                     f"BENCH_fabric.json {want_counts}")
            log(f"fabric (a) I={cfg['input']} H={cfg['hidden']} "
                f"L={cfg['layers']} fused_q8, {cfg['n_shards']} shards x "
                f"{cfg['streams_per_shard']} on {dev}: counts equal "
                f"BENCH_fabric.json key for key ({counts['completed']} "
                f"completed, {counts['rejected']} rejected, "
                f"{counts['rebalanced']} rebalanced, {counts['ticks']} "
                f"ticks); {counts['parity_ok']} streams bitwise their "
                f"reference; wall {run['wall_s']:.4f} s [{smi}]")
            del run

            # (b) the same traffic at 2L-768H
            task_b = dataclasses.replace(PAPER_NETWORKS["2L-768H"],
                                         theta_x=THETA, theta_h=THETA)
            prog_b = quantize_delta_model(model_768, device=dev)
            arr_b = arrivals_of(task_b.input_size)
            layers = task_b.num_layers

            def run_b1():
                run = fabric_run(prog_b, task_b, cfg, arr_b, dev,
                                 os.path.join(tmp, "b1"), quiet_no_sync=True)
                run["parity_ok"], run["first"] = fabric_parity(
                    arr_b, run["summary"].results, run["fleet"],
                    keep_first=True)
                run["restored"] = Recorded.restore(
                    os.path.join(tmp, "b1"), run["fleet"].program, task_b,
                    n_streams=cfg["streams_per_shard"], device=dev)
                return run

            run, made = counted("fabric (b) run 1", run_b1, kernel_q8, layers)
            fleet, router = run["fleet"], run["router"]
            fleet_steps = fleet.graph_stats["replays"]
            if (fleet_steps != run["shard_steps"] and dev.type == "cuda") \
                    or run["quiet_ticks"] < 1:
                raise AssertionError(
                    f"fabric (b): {fleet_steps} shard replays, want live "
                    f"shards summed over the ticks, {run['shard_steps']}; "
                    f"{run['quiet_ticks']} ticks without a harvest")
            counts = fabric_counts(router, run["summary"], fleet,
                                   run["parity_ok"])
            if counts != want_counts:
                raise AssertionError(f"fabric (b): counts {counts}, "
                                     f"BENCH_fabric.json {want_counts}")
            # the first reference group again on the CPU
            first = run["first"]
            cpu_ref = fleet.reference_engine(device="cpu")
            cpu_outs = cpu_ref.step_many(first["xs"]).numpy()
            state_same = all(torch.equal(a, b) for a, b in zip(
                first["state"], tree_leaves(cpu_ref.state)))
            cpu_err = float(np.abs(cpu_outs - first["outs"]).max())
            if not state_same or cpu_err > TOL_HEAD:
                raise AssertionError(
                    f"fabric (b): the first group on the CPU: state bitwise "
                    f"{state_same}, outputs {cpu_err:.3e} > {TOL_HEAD}")
            # the drain checkpoint against the dying shard's export
            back, exported = run["restored"], run["before_remove"]
            if not (same_buffers(back, exported)
                    and back.report() == exported.report()
                    and back._slot_busy == exported._slot_busy
                    and back._n_steps == exported._n_steps):
                raise AssertionError("fabric (b): the drain checkpoint "
                                     "restores into another engine than "
                                     "the dying shard's export")
            walls = router.tick_wall_s
            res["b"] = {
                "wall_s": run["wall_s"],
                "streams_per_s": counts["completed"] / run["wall_s"],
                "frames_per_s": counts["frames_out"] / run["wall_s"],
                "p50_tick_ms": 1e3 * steady_percentile(walls, 0.50),
                "p99_tick_ms": 1e3 * steady_percentile(walls, 0.99),
                "median_tick_ms": 1e3 * float(np.median(walls)),
                "max_tick_ms": 1e3 * max(walls),
                "replays_per_tick": fleet_steps / fleet.graph_stats["ticks"],
                "scale_ms": run["scale_ms"],
                "quiet_ticks": run["quiet_ticks"],
                "engines": len(made),
                "ticks_ms": 1e3 * sum(walls),
                "host_ms": {k: 1e3 * v for k, v in run["host_s"].items()}}
            log(f"fabric (b) 2L-768H fused_q8, {cfg['n_shards']} shards x "
                f"{cfg['streams_per_shard']} on {dev}: counts equal "
                f"BENCH_fabric.json; {counts['parity_ok']} streams bitwise "
                f"their reference on the card; first group on the CPU: "
                f"state bitwise, outputs {cpu_err:.3e}; drain checkpoint "
                f"restored equal to the export; {fleet_steps} shard replays "
                f"in {fleet.graph_stats['ticks']} ticks, "
                f"{launches[kernel_q8.name]} launches of {kernel_q8.name} "
                f"and no other ({len(made)} engines); "
                f"{run['quiet_ticks']} ticks without a harvest under "
                f"set_sync_debug_mode('error') [{smi}]")
            # one surviving shard's replay at B = 128, 20 steps of frames
            # like the arrivals': kernels, busy, the int8 tile kernel's time
            shard = fleet.engines[0]
            xs = np.random.default_rng(SEED + 3).standard_normal(
                (20, cfg["streams_per_shard"], task_b.input_size)).astype(
                np.float32)
            if dev.type == "cuda":
                ops.reset_launch_counts()
                res["shard_profile"] = engine_profile(
                    lambda: shard.step_many(xs), len(xs),
                    match="delta_q8_kernel")
                n = {k: v for k, v in ops.launch_counts().items() if v}
                if n != {kernel_q8.name: len(xs) * layers}:
                    raise AssertionError(f"fabric shard profile: launches "
                                         f"{n}")
                launches[kernel_q8.name] += len(xs) * layers
            del run, fleet, router, made, back, exported, cpu_ref, shard

            # (b) again, counts equal; ticks FABRIC_PROFILE_TICKS profiled
            prof = TickProfile(*FABRIC_PROFILE_TICKS)

            def run_b2():
                return fabric_run(prog_b, task_b, cfg, arr_b, dev,
                                  os.path.join(tmp, "b2"),
                                  quiet_no_sync=False, on_tick=prof)

            run, _ = counted("fabric (b) run 2", run_b2, kernel_q8, layers)
            # parity was held on the first run; the counts' parity_ok is
            # the completed streams that equal their reference there
            counts2 = fabric_counts(run["router"], run["summary"],
                                    run["fleet"], counts["parity_ok"])
            if counts2 != want_counts or prof.result is None:
                raise AssertionError(f"fabric (b) run 2: counts {counts2}")
            res["b"]["profile"] = prof.result
            res["b"]["wall2_s"] = run["wall_s"]
            res["b"]["p50_tick2_ms"] = 1e3 * steady_percentile(
                run["router"].tick_wall_s, 0.50)
            res["b"]["p99_tick2_ms"] = 1e3 * steady_percentile(
                run["router"].tick_wall_s, 0.99)
            del run

            # a fused (fp32) fleet of 4 x 8 against 4 standalone engines
            prog_f = compile_deltagru(model_768, "fused", device=dev)
            xs = smooth_frames(np.random.default_rng(SEED + 2), 20, 32,
                               task_b.input_size)

            def run_f():
                mesh = best_mesh(4, devices=[dev] * 4)
                fl = serving.ShardedStreamFleet(prog_f, task_b, n_streams=32,
                                                mesh=mesh)
                got = fl.step_many(xs)
                solo = [serving.DeltaStreamEngine(prog_f, task_b,
                                                  n_streams=8, device=dev)
                        for _ in range(4)]
                want = [e.step_many(xs[:, 8 * s:8 * (s + 1)])
                        for s, e in enumerate(solo)]
                return fl, got, solo, want

            (fl, got, solo, want), _ = counted("fabric fp32 fleet", run_f,
                                               kernel_f32, layers)
            same = all(
                torch.equal(got[:, 8 * s:8 * (s + 1)], want[s])
                and all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(fl.engines[s].state),
                    tree_leaves(solo[s].state)))
                for s in range(4))
            if not same:
                raise AssertionError("fabric fp32 fleet: a shard differs "
                                     "from its standalone engine")
            log(f"fabric fp32 fleet 4 x 8 (2L-768H fused, step_many of 20 "
                f"frames): every shard's state and outputs bitwise a "
                f"standalone 8-stream engine; {fl.graph_stats['replays']} "
                f"replays [{smi}]")
    finally:
        serving.DeltaStreamEngine = saved
    res["launches"] = launches
    return res


# -- phase 5f: the LM zoo's serving path -------------------------------------

LM_SLOTS = 4
LM_MAX_LEN = 256
LM_REQUESTS = 12
LM_NEW = 32            # new tokens a request, and decode steps of (b), (c)
LM_T = 128             # the prompt length of (b) and (c)
# recurrentgemma-9b cut to one (rglru, rglru, local_attn) period of its 38
# layers, at its full width (time and host memory)
RG_LAYERS = 3
# prefill-then-decode logits against the teacher-forced forward of the same
# model on the card, relative RMS over a step's logits. One function over
# other matmul shapes (one row a decode step, 72 rows in the forward): on
# the CPU the two agree bitwise, but the card's matmuls pick kernels by
# shape and round a step apart here and there, and the layers pass that
# on. In bf16: measured 1.2e-2 over llama3.2-1b's 16 layers and 7.0e-3 over
# recurrentgemma's 3 (first run); a wrong cache position or carried state
# moves the logits by their own size (~1). In fp32 at 2 layers (phase 5f
# (d)) the check is TOL_F32. The seeded random RWKV6 is chaotic in depth
# (a 1e-6 change of its input moves its logits 1.7e-3 at 16 layers and
# 3.8e-2 at 24, D = 512 on the CPU; ROADMAP.md R20), so at 24 layers its
# check is printed, not held: 6.2e-2 in bf16 and 1.1e-3 in fp32 (runs 0
# and 1), rounding amplified, not a fault.
TOL_LM_BF16_RMS = 2.0 ** -3


def rel_rms(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).square().mean().sqrt()
                 / want.square().mean().sqrt())


def scan_row(kern, ref, args, nbytes, nops) -> dict:
    """A scan's times at one shape of the path (its recorded inputs): the
    kernel warm (graph replay) and with a cold L2, its plain version, and
    the bound: the larger of the bytes over HBM_BYTES_PER_S and the
    operations over FP32_OPS_PER_S."""
    row = {"ms": device_ms(lambda: kern(*args)),
           "cold_ms": device_ms_cold(lambda: kern(*args)),
           "eager_ms": eager_ms(lambda: kern(*args)),
           "plain_ms": device_ms(lambda: ref(*args), calls=2, reps=3),
           "library_ms": None, "bytes": nbytes, "ops": nops}
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * nops / FP32_OPS_PER_S
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


def lm_build(cfg, dev, base: dict):
    """The model's seeded weights drawn on the card (``init_lm``), the
    seconds it took and the peak bytes the init held above what the
    process held before (``base["bytes"]``, set here: the earlier phases'
    tensors); the peak memory counts from the end of the init on."""
    import torch
    from repro_torch.models.lm import init_lm
    gc.collect()          # an engine wrapped by counting() is a cycle
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base["bytes"] = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(SEED, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base["bytes"]
    torch.cuda.reset_peak_memory_stats()
    return params, init_s, init_peak


class RouteLog:
    """Within a ``with``: every MoE router call of the port (``moe._route``,
    which ``moe_apply`` reaches through the module, and
    ``moe_ep._route_local``, one a data shard of the expert-parallel
    dispatch) keeps its top-k choice in ``calls``. With ``replay`` (a list
    of ``[T, K]`` choices, one a call in order, from another run of the
    same tokens) the calls take those choices instead, their gates
    renormalized from their own probabilities, so the two runs' hidden
    states stay comparable; :meth:`flips` then counts the tokens whose own
    choice differed."""

    def __init__(self, replay=None):
        self.calls, self.replay, self.own = [], replay, []

    def __enter__(self):
        import torch
        from repro_torch.models import moe, moe_ep
        self.patched = [(moe, "_route", moe._route),
                        (moe_ep, "_route_local", moe_ep._route_local)]

        def wrap(orig, router_of):
            def route(*args):
                out = orig(*args)
                vals, idx = out[0], out[1]
                if self.replay is not None:
                    router_w, xt = router_of(args)
                    probs = torch.softmax(xt.float() @ router_w, dim=-1)
                    self.own.append((probs, idx))
                    idx = self.replay[len(self.calls)].to(idx.device)
                    vals = probs.gather(1, idx)
                    vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
                self.calls.append(idx)
                return (vals, idx) + tuple(out[2:])
            return route
        moe._route = wrap(moe._route, lambda a: (a[0]["router"], a[1]))
        moe_ep._route_local = wrap(moe_ep._route_local,
                                   lambda a: (a[0], a[1]))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.patched:
            setattr(mod, name, orig)

    def flips(self) -> tuple:
        """Tokens whose own top-k set differed from the replayed one, and
        the largest gap, in their own probabilities, between such a
        token's k-th and (k+1)-th probability."""
        n, gap = 0, 0.0
        for (probs, own), used in zip(self.own, self.calls):
            bad = (own.sort(-1).values != used.sort(-1).values).any(-1)
            if bad.any():
                k = own.shape[1]
                p = probs[bad].sort(-1, descending=True).values
                n += int(bad.sum())
                gap = max(gap, float((p[:, k - 1] - p[:, k]).max()))
        return n, gap


def flips_allowed(what, n, gap, margin) -> str:
    """Hold a run's routing flips to ``margin``; their summary."""
    if n and gap > margin:
        raise AssertionError(f"{what}: {n} routing flips, one at a gap of "
                             f"{gap:.3e} (margin {margin:.1e})")
    return (f"{n} routing flips" + (f" (largest gap {gap:.3e}, margin "
                                    f"{margin:.1e})" if n else ""))


def no_drop(cfg):
    """``cfg`` with MoE capacity for every token (capacity factor E / K
    makes the capacity the token count), for checks that compare two
    token counts (prefill then decode against one forward): at the
    config's own factor each drops other assignments by design."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.top_k)


def lm_forced(params, cfg, dev, rng, what, tol=TOL_LM_BF16_RMS,
              modality=None, margin=None) -> dict:
    """Prefill 64 tokens and decode 8 greedy ones, against the
    teacher-forced forward over the same 72 tokens: the largest relative
    RMS of a step's logits, held within ``tol`` (``None``: measured only).
    MoE runs at ``no_drop(cfg)``, and the forward takes the prefill's and
    the decode steps' expert choices; the tokens whose own choice differed
    (routing flips) are held to ``margin``. Returns ``{"err", "flips",
    "gap"}``."""
    import torch
    from repro_torch.models.lm import (init_lm_caches, lm_decode,
                                       lm_forward, lm_prefill)
    cfg = no_drop(cfg)
    mod = modality or {}
    b = LM_SLOTS
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (b, 64))).to(dev)
    caches = init_lm_caches(cfg, b, LM_MAX_LEN, dev)
    with torch.no_grad(), RouteLog() as seq_log:
        lg, caches = lm_prefill(params, cfg, toks, caches, **mod)
        got, seq = [lg], [toks]
        for _ in range(8):
            seq.append(torch.argmax(got[-1][:, -1:], dim=-1))
            lg, caches = lm_decode(params, cfg, seq[-1], caches)
            got.append(lg)
    # the prefill's and the decode steps' choices, in the forward's order
    layers = len(seq_log.calls) // 9
    seq_idx = [torch.cat([seq_log.calls[layer].reshape(b, 64, -1)] + [
        seq_log.calls[layers * (1 + i) + layer].reshape(b, 1, -1)
        for i in range(8)], dim=1).reshape(b * 72, -1)
        for layer in range(layers)]
    with torch.no_grad(), RouteLog(replay=seq_idx) as full_log:
        full, _ = lm_forward(params, cfg, torch.cat(seq, dim=1), **mod)
    n, gap = full_log.flips()
    flips_allowed(what, n, gap, margin if margin is not None else 0.0)
    errs = [rel_rms(g[:, 0], full[:, 63 + i]) for i, g in enumerate(got)]
    if (tol is not None and max(errs) > tol) or not all(
            torch.isfinite(g).all() for g in got):
        raise AssertionError(f"{what}: prefill/decode against the "
                             f"teacher-forced forward {errs}")
    return {"err": max(errs), "flips": n, "gap": gap}


def host_syncs(fn) -> int:
    """Host synchronisations (each a wait for the card) while ``fn()``
    runs, counted by ``torch.cuda.set_sync_debug_mode("warn")``."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def lm_timed(name, cfg, params, init_s, t_prompt, dev, rng, base, smi,
             extra="", modality=None) -> dict:
    """Prefill ms at [4, t_prompt] (median of 3 after a warm one, the last
    the prefill of ``generate_greedy``), decode ms a step (each
    synchronised) over ``generate_greedy``'s LM_NEW steps, the profiled
    decode step (5 steps), peak memory; ``"tokens"``: the greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.models.common import count_params
    from repro_torch.serve.engine import LmEngine
    eng = LmEngine(params, cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
    toks = rng.integers(1, cfg.vocab, (LM_SLOTS, t_prompt))
    mod = modality or {}
    pre, dec = [], []

    def timing(fn, into):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            into.append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    prefill, decode = eng.prefill, eng.decode_step
    eng.prefill, eng.decode_step = timing(prefill, pre), timing(decode, dec)
    for _ in range(3):
        eng.prefill(toks, **mod)
    new = eng.generate_greedy(toks, LM_NEW, **mod)
    eng.prefill, eng.decode_step = prefill, decode
    cur = new[:, -1:]
    prof = engine_profile(lambda: [eng.decode_step(cur)
                                   for _ in range(5)], 5)
    prof["syncs_per_step"] = host_syncs(lambda: eng.decode_step(cur))
    out = {"init_s": init_s, "prefill_ms": float(np.median(pre[1:])),
           "tokens": new,
           "decode_p50_ms": float(np.percentile(dec, 50)),
           "decode_p95_ms": float(np.percentile(dec, 95)),
           "profile": prof, "params": count_params(params),
           "peak_gib": (torch.cuda.max_memory_allocated()
                        - base["bytes"]) / 2 ** 30}
    log(f"time lm {name}: {out['params']} parameters, init "
        f"{init_s:.3f} s; prefill [{LM_SLOTS}, {t_prompt}] "
        f"{out['prefill_ms']:.3f} ms (each "
        + ", ".join(f"{v:.3f}" for v in pre)
        + f"); decode a step at B={LM_SLOTS} p50 "
        f"{out['decode_p50_ms']:.3f} ms, p95 {out['decode_p95_ms']:.3f} "
        f"ms over {LM_NEW} steps; profiled decode step: "
        f"{prof['kernels_per_step']:.1f} kernels, device busy "
        f"{prof['device_busy_us_per_step']:.1f} us, idle share "
        f"{prof['idle_share']:.4f} (wall {prof['wall_us_per_step']:.1f} "
        f"us under the profiler), {prof['syncs_per_step']} host syncs a "
        f"step; peak memory after the init, above the "
        f"{base['bytes']} B held before the model, {out['peak_gib']:.3f} "
        f"GiB{extra} [{smi}]")
    return out


def lm_phase(dev, smi) -> dict:
    """Phase 5f: the LM zoo's serving path on the card, from seeded random
    weights drawn on the card (``init_lm``). (a) llama3.2-1b at full size in
    bf16: an ``LmEngine(batch=4, max_len=256)`` and a ``ContinuousBatcher``
    drain 12 prompts of 16-96 tokens, 32 new tokens each, twice with the
    same tokens; a staggered admission leaves the live request's tokens
    those of its solo run; prefill-then-decode logits within
    ``TOL_LM_BF16_RMS`` of the teacher-forced forward. (b) rwkv6-1.6b at
    full size in bf16: ``generate_greedy`` on 4 prompts of 128 tokens for
    32 steps, row 9b (``rwkv6_scan_bf16``) launched exactly 24 times by the
    prefill and by each decode step and no other kernel, each launch of the
    prefill and of the first decode step held against the plain version on
    the card at the inputs the path gave it. (c) recurrentgemma-9b at full
    width, 3 of its 38 layers: prefill at T = 128 then 32 decode steps,
    ``rglru_scan`` launched twice by the prefill and never by a decode
    step, each launch bitwise its plain version. (d) llama3.2-1b and
    rwkv6-1.6b in fp32 at full width and 2 layers: the prefill's and the
    first decode step's logits and the caches on the card within
    ``TOL_LM`` of the same weights on the CPU, and their prefill-then-decode
    logits within ``TOL_F32`` (relative RMS) of their teacher-forced
    forward. The bf16 prefill-then-decode logits of (a) and (c) are held
    within ``TOL_LM_BF16_RMS`` of their teacher-forced forward; (b)'s are
    measured (R20). Times per model: init, prefill at T = 128,
    decode a step (p50 / p95), kernels a decode step and idle share, peak
    memory after the init; the second drain's tokens a second; rows 8 and
    9b (and 9's fp32 instance) at the path's shapes, on the inputs the path
    gave them. Returns the launches and errors of the kernels and their
    time rows."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.rglru_scan import (rglru_scan,
                                                rglru_scan_batched_ref)
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan,
                                                rwkv6_scan_batched_ref)
    from repro_torch.models.common import tree_map
    from repro_torch.models.common import tree_leaves as lm_leaves
    from repro_torch.models.lm import init_lm_caches, lm_decode, lm_prefill
    from repro_torch.serve.engine import LmEngine
    from repro_torch.serve.scheduler import ContinuousBatcher

    rng = np.random.default_rng(SEED)
    res = {"launches": {}, "max_err": {}, "rows": {}}
    wkv16, wkv32, lru = (ops.RWKV6_SCAN_BF16, ops.RWKV6_SCAN_F32,
                         ops.RGLRU_SCAN_F32)

    base = {}

    def build(cfg):
        return lm_build(cfg, dev, base)[:2]

    def forced(params, cfg, what, tol=TOL_LM_BF16_RMS):
        return lm_forced(params, cfg, dev, rng, what, tol)["err"]

    def counting(eng):
        """Wrap the engine's prefill and decode_step to keep the launches
        each call made."""
        per_call = []

        def wrap(fn):
            def call(tokens):
                before = ops.launch_counts()
                out = fn(tokens)
                after = ops.launch_counts()
                per_call.append({k: v - before[k] for k, v in after.items()
                                 if v != before[k]})
                return out
            return call
        eng.prefill, eng.decode_step = wrap(eng.prefill), wrap(
            eng.decode_step)
        return per_call

    def recording(name, keep):
        """Replace ``ops.<name>`` (what the blocks call) by a wrapper that
        keeps the inputs and outputs of the calls ``keep`` selects."""
        orig, kept = getattr(ops, name), []

        def call(*args):
            out = orig(*args)
            if keep(args, len(kept)):
                kept.append(([None if a is None else a.clone() for a in args],
                             [o.clone() for o in out]))
            return out
        setattr(ops, name, call)
        return orig, kept

    def timed(name, cfg, params, init_s, t_prompt, extra=""):
        out = lm_timed(name, cfg, params, init_s, t_prompt, dev, rng, base,
                       smi, extra)
        del out["tokens"]
        return out

    # (a) llama3.2-1b, full size, bf16
    cfg = get_config("llama3.2-1b")
    params, init_s = build(cfg)
    prompts = [rng.integers(1, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, 97, LM_REQUESTS)]

    def drain():
        cb = ContinuousBatcher(LmEngine(params, cfg, LM_SLOTS, LM_MAX_LEN,
                                        device=dev))
        for p in prompts:
            cb.submit(p, max_new_tokens=LM_NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = cb.run_until_drained()
        torch.cuda.synchronize()
        return {r.uid: r.output for r in done}, time.perf_counter() - t0

    ops.reset_launch_counts()
    outs, wall = drain()
    outs2, wall2 = drain()
    n = {k: v for k, v in ops.launch_counts().items() if v}
    if n or outs != outs2 or sorted(outs) != list(range(LM_REQUESTS)) or any(
            len(o) != LM_NEW for o in outs.values()):
        raise AssertionError(f"llama3.2-1b drain: launches {n} (want none), "
                             f"{len(outs)} requests, two runs equal "
                             f"{outs == outs2}")

    def staggered(stagger):
        cb = ContinuousBatcher(LmEngine(params, cfg, LM_SLOTS, LM_MAX_LEN,
                                        device=dev))
        cb.submit(prompts[0], max_new_tokens=LM_NEW)
        done, submitted = [], not stagger
        while cb.queue or any(cb.slots):
            done += cb.step()
            if (not submitted and cb.slots[0] is not None
                    and len(cb.slots[0].output) >= 3):
                for p in prompts[1:4]:
                    cb.submit(p, max_new_tokens=8)
                submitted = True
        return {r.uid: r.output for r in done}

    solo, mixed = staggered(False), staggered(True)
    if mixed[0] != solo[0] or len(mixed) != 4:
        raise AssertionError("llama3.2-1b: a staggered admission changed the "
                             "live request's tokens")
    err_a = forced(params, cfg, "llama3.2-1b")
    n_tok = LM_REQUESTS * LM_NEW
    log(f"lm llama3.2-1b (bf16, full size) batcher: {LM_REQUESTS} prompts "
        f"of {min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
        f"{LM_NEW} new each, {LM_SLOTS} slots: {n_tok} tokens in "
        f"{wall2:.3f} s ({n_tok / wall2:.1f} tokens/s; the first run, warm-up "
        f"included, {wall:.3f} s, the same tokens); staggered admission: the "
        f"live "
        f"request's tokens equal its solo run's; prefill-then-decode "
        f"against the teacher-forced forward: relative RMS {err_a:.3e} "
        f"(within {TOL_LM_BF16_RMS}); no hand-written kernel launched "
        f"[{smi}]")
    res["llama"] = timed("llama3.2-1b", cfg, params, init_s, LM_T,
                         f"; drain {n_tok / wall2:.1f} tokens/s")
    res["llama"]["tokens_per_s"] = n_tok / wall2
    del params

    # (b) rwkv6-1.6b, full size, bf16
    cfg = get_config("rwkv6-1.6b")
    params, init_s = build(cfg)
    toks = rng.integers(1, cfg.vocab, (LM_SLOTS, LM_T))
    eng = LmEngine(params, cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
    per_call = counting(eng)
    orig, kept = recording("rwkv6_scan",
                           lambda args, k: k < 2 * cfg.n_layers)
    try:
        ops.reset_launch_counts()
        new = eng.generate_greedy(toks, LM_NEW)
        torch.cuda.synchronize()
    finally:
        ops.rwkv6_scan = orig
    want = {wkv16.name: cfg.n_layers}
    if len(per_call) != 1 + LM_NEW or any(c != want for c in per_call):
        raise AssertionError(f"rwkv6-1.6b generate_greedy: launches a call "
                             f"{per_call}, want {want} each of {1 + LM_NEW}")
    res["launches"][wkv16.name] = sum(c[wkv16.name] for c in per_call)
    errs = {}
    for args, out in kept:
        t = args[0].shape[2]
        want_out = rwkv6_scan_batched_ref(*args)
        errs[t] = max([errs.get(t, 0.0)] + [
            scaled_err(a, b) for a, b in zip(out, want_out)])
        res["max_err"][wkv16.name] = max(
            res["max_err"].get(wkv16.name, 0.0),
            max(float((a - b).abs().max()) for a, b in zip(out, want_out)))
    if (sorted(errs) != [1, LM_T] or max(errs.values()) > TOL_F32
            or not all(a[0].dtype == torch.bfloat16 for a, _ in kept)):
        raise AssertionError(f"rwkv6_scan_bf16 on the path against its "
                             f"plain version: scaled {errs}")
    if new.shape != (LM_SLOTS, LM_NEW) or not (0 <= new).all() or not (
            new < cfg.vocab).all():
        raise AssertionError(f"rwkv6-1.6b tokens {new.shape}")
    err_b = forced(params, cfg, "rwkv6-1.6b", None)
    log(f"lm rwkv6-1.6b (bf16, full size) generate_greedy: {LM_SLOTS} "
        f"prompts of {LM_T}, {LM_NEW} steps; {wkv16.name} launched "
        f"{cfg.n_layers} times by the prefill and by each decode step "
        f"({res['launches'][wkv16.name]} in all) and no other kernel; the "
        f"{len(kept)} launches of the prefill [{LM_SLOTS}, 32, {LM_T}, 64] "
        f"and the first decode step [{LM_SLOTS}, 32, 1, 64] against the "
        f"plain version on the card: scaled {errs[LM_T]:.3e} / {errs[1]:.3e}"
        f" (within {TOL_F32}); prefill-then-decode against the "
        f"teacher-forced forward: relative RMS {err_b:.3e} (not held: the "
        f"random 24-layer RWKV6 amplifies rounding, R20) [{smi}]")
    res["rwkv6"] = timed("rwkv6-1.6b", cfg, params, init_s, LM_T)
    # rows 9b and 9 at the path's shapes, on the inputs the path gave them
    prefill_args = next(a for a, _ in kept if a[0].shape[2] == LM_T)
    decode_args = next(a for a, _ in kept if a[0].shape[2] == 1)
    for kinfo, cast in ((wkv16, None), (wkv32, torch.float32)):
        shapes = {}
        for key, args in (("t1", decode_args), ("t128", prefill_args)):
            if cast is not None:
                args = [a.to(cast) for a in args[:3]] + list(args[3:])
            b, h, t, d = args[0].shape
            in_bytes = args[0].element_size()
            nbytes = (3 * in_bytes + 8) * b * h * t * d + 4 * h * d + (
                2 * 4 * b * h * d * d)
            shapes[key] = scan_row(rwkv6_scan, rwkv6_scan_batched_ref, args,
                                   nbytes, 7 * b * h * t * d * d)
            r = shapes[key]
            log(f"time {kinfo.name} [{b}, {h}, {t}, {d}] (the path's "
                f"{'decode' if t == 1 else 'prefill'} inputs"
                f"{'' if cast is None else ', r k v cast to fp32'}): kernel "
                f"{r['ms']:.5f} ms warm, {r['cold_ms']:.5f} ms with a cold "
                f"L2 ({r['eager_ms']:.4f} ms launched from Python), plain "
                f"{r['plain_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms "
                f"({r['bytes']} B, {r['ops']} operations, {r['bound_by']}) "
                f"[{smi}]")
        res["rows"][kinfo.name] = shapes
    del params, eng, kept, prefill_args, decode_args

    # (c) recurrentgemma-9b at full width, one period of 3 layers
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              n_layers=RG_LAYERS)
    params, init_s = build(cfg)
    toks = rng.integers(1, cfg.vocab, (LM_SLOTS, LM_T))
    eng = LmEngine(params, cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
    per_call = counting(eng)
    orig, kept = recording("rglru_scan", lambda args, k: True)
    try:
        new = eng.generate_greedy(toks, LM_NEW)
        torch.cuda.synchronize()
    finally:
        ops.rglru_scan = orig
    if (per_call[0] != {lru.name: 2} or any(per_call[1:])
            or len(per_call) != 1 + LM_NEW or len(kept) != 2):
        raise AssertionError(f"recurrentgemma-9b: launches a call {per_call}"
                             f", want {{{lru.name}: 2}} then nothing")
    res["launches"][lru.name] = 2
    same = True
    for args, out in kept:
        want_out = rglru_scan_batched_ref(*args)
        same = same and all(torch.equal(a, b) for a, b in zip(out, want_out))
    if not same or tuple(kept[0][0][0].shape) != (LM_SLOTS, LM_T,
                                                    cfg.d_model):
        raise AssertionError("rglru_scan on the path differs from its plain "
                             "version")
    res["max_err"][lru.name] = 0.0
    err_c = forced(params, cfg, "recurrentgemma-9b")
    log(f"lm recurrentgemma-9b (bf16, D={cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.n_kv_heads} kv head, window {cfg.attn_window}; "
        f"reduced: {RG_LAYERS} of 38 layers) prefill [{LM_SLOTS}, {LM_T}] "
        f"then {LM_NEW} decode steps: {lru.name} launched 2 times by the "
        f"prefill and 0 by each decode step, no other kernel; both launches "
        f"[{LM_SLOTS}, {LM_T}, {cfg.d_model}] bitwise their plain version on "
        f"the card; prefill-then-decode against the teacher-forced forward: "
        f"relative RMS {err_c:.3e} [{smi}]")
    res["recurrentgemma"] = timed(
        f"recurrentgemma-9b ({RG_LAYERS} layers)", cfg, params, init_s, LM_T)
    args = kept[0][0]
    b, t, w = args[0].shape
    res["rows"][lru.name] = {"t128": scan_row(
        rglru_scan, rglru_scan_batched_ref, args,
        4 * (3 * b * t * w + 2 * b * w), 6 * b * t * w)}
    r = res["rows"][lru.name]["t128"]
    log(f"time {lru.name} [{b}, {t}, {w}] (the path's prefill inputs): "
        f"kernel {r['ms']:.5f} ms warm, {r['cold_ms']:.5f} ms with a cold L2 "
        f"({r['eager_ms']:.4f} ms launched from Python), plain "
        f"{r['plain_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms ({r['bytes']} "
        f"B, {r['bound_by']}) [{smi}]")
    del params, eng, kept, args

    # (d) fp32 at full width, 2 layers: the card against the CPU, and the
    # prefill-then-decode logits against the teacher-forced forward
    res["launches"][wkv32.name] = 0
    for arch in ("llama3.2-1b", "rwkv6-1.6b"):
        cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                  dtype="float32")
        params, _ = build(cfg)
        cpu = torch.device("cpu")
        cpu_params = tree_map(lambda x: x.to(cpu), params)
        toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 32)))
        ops.reset_launch_counts()
        with torch.no_grad():
            caches = init_lm_caches(cfg, 2, 64, dev)
            lg_p, caches = lm_prefill(params, cfg, toks.to(dev), caches)
            cur = torch.argmax(lg_p[:, -1:], dim=-1)
            lg_d, caches = lm_decode(params, cfg, cur, caches)
            torch.cuda.synchronize()
            n = {k: v for k, v in ops.launch_counts().items() if v}
            c_caches = init_lm_caches(cfg, 2, 64, cpu)
            c_p, c_caches = lm_prefill(cpu_params, cfg, toks, c_caches)
            c_d, c_caches = lm_decode(cpu_params, cfg, cur.cpu(), c_caches)
        want_n = {wkv32.name: 4} if arch.startswith("rwkv") else {}
        err = max([scaled_err(lg_p, c_p), scaled_err(lg_d, c_d)] + [
            scaled_err(a.float(), b.float()) for a, b in zip(
                lm_leaves(caches), lm_leaves(c_caches))])
        if err > TOL_LM or n != want_n:
            raise AssertionError(f"{arch} fp32 2 layers: card against CPU "
                                 f"{err:.3e}; launches {n}, want {want_n}")
        res["launches"][wkv32.name] += n.get(wkv32.name, 0)
        err_f = forced(params, cfg, f"{arch} fp32", TOL_F32)
        log(f"lm {arch} (fp32, full width, 2 layers) card against CPU: "
            f"prefill [2, 32] and first decode logits and every cache leaf "
            f"within {err:.3e} of max(1, |CPU|) (tolerance {TOL_LM}); "
            f"launches {n}; on the card, prefill-then-decode against the "
            f"teacher-forced forward: relative RMS {err_f:.3e} (within "
            f"{TOL_F32}) [{smi}]")
        del params, cpu_params, caches, c_caches
    torch.cuda.empty_cache()
    return res


# -- phase 5g: the rest of the LM zoo: MLA, MoE, cross-attention ----------

# A routing flip: MoE top-k over near-tied router probabilities picks
# another expert in one of two runs of the same tokens. One run takes the
# other's expert choices (so the hidden states stay comparable: a flip
# left free moves its token's state by its own size and cascades through
# the later layers), and a token whose own top-k differs is allowed only
# where its k-th and (k+1)-th probabilities lie within this of each other.
# A probability p moves by ~p * dlogit when its logit (of order 1) moves
# by dlogit; p <= 2**-3 at the top-k boundary of 40-64 experts. fp32: the
# runs' hidden states differ by ~1e-6 relative (phase 5f (d)), dp ~1e-7:
# 1e-5 keeps a factor of 100. bf16: by 1-3 % at 16-40 layers (5f: 1.2e-2
# at 16), tails to 4 times that, dlogit up to ~0.1, a gap up to
# 2 * 2**-3 * 0.1 = 2.5e-2: 2**-5.
ROUTE_MARGIN_F32 = 1e-5
ROUTE_MARGIN_BF16 = 2.0 ** -5
# (a)'s staggered admission: the live request's new tokens (the wave
# joins at its third; a decode step of deepseek takes ~0.2 s)
ZOO_STAGGER_NEW = 12
# the fp32 runs of (e): the fewest layers that hold every block kind of
# the arch (the VLM: one period of four self-attention layers and a cross
# one; seamless: two encoder and two decoder layers)
ZOO_F32_LAYERS = {"deepseek-v2-lite-16b": {"n_layers": 2},
                  "granite-moe-3b-a800m": {"n_layers": 2},
                  "llama-3.2-vision-11b": {"n_layers": 5},
                  "seamless-m4t-large-v2": {"n_layers": 2,
                                            "n_encoder_layers": 2}}


def modality_inputs(cfg, b: int, dev, dtype, gen) -> dict:
    """Seeded stub modality inputs drawn on ``dev``: image embeddings
    ``[b, n_image_tokens, vision_dim]`` (normal, scaled 0.02 as the
    reference's ``lm_batch``) or audio frames ``[b, n_audio_frames,
    audio_dim]`` (standard normal)."""
    import torch
    out = {}
    if cfg.cross_attn_every:
        out["image_embeds"] = (torch.randn(
            (b, cfg.n_image_tokens, cfg.vision_dim), generator=gen,
            device=dev) * 0.02).to(dtype)
    if cfg.encdec:
        out["audio_frames"] = torch.randn(
            (b, cfg.n_audio_frames, cfg.audio_dim), generator=gen,
            device=dev).to(dtype)
    return out


def host_rss_gib() -> tuple:
    """The process's resident host memory now and at its peak, GiB."""
    import resource
    with open("/proc/self/status") as f:
        now = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return now / 2 ** 20, peak / 2 ** 20


def zoo_phase(dev, smi) -> dict:
    """Phase 5g: the rest of the LM zoo on the card, seeded ``init_lm`` on
    the card, bf16, at full size. (a) deepseek-v2-lite-16b (MLA, 64 routed
    experts top-6 and 2 shared): an ``LmEngine(4, 256)`` under a
    ``ContinuousBatcher`` drains 12 prompts of 16-96 tokens, 32 new each,
    twice with the same tokens, and a staggered admission leaves the live
    request's tokens those of a run with the same waves; (b)
    granite-moe-3b-a800m (40 experts padded to 48, top-8), (c)
    llama-3.2-vision-11b (8 cross layers of 40, image embeddings [4, 1601,
    7680]) and (d) seamless-m4t-large-v2 (24 encoder and 24 decoder layers,
    audio frames [4, 1536, 160]): ``generate_greedy`` on 4 prompts of 128
    tokens for 32 steps. For each, the prefill-then-decode logits within
    ``TOL_LM_BF16_RMS`` of the teacher-forced forward (``lm_forced``; MoE
    at a capacity for every token, routing flips within
    ``ROUTE_MARGIN_BF16``). (e) all four in fp32 at full width and the
    fewest layers that hold each block kind (``ZOO_F32_LAYERS``): prefill
    [2, 32] and a decode step on the card and on the CPU within ``TOL_LM``
    (the CPU takes the card's expert choices; flips within
    ``ROUTE_MARGIN_F32``),
    and prefill-then-decode against the forward within ``TOL_F32``. No
    hand-written kernel is launched. Times per model as phase 5f's
    (``lm_timed``), with the init's peak memory. Returns the time rows."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_map
    from repro_torch.models.common import tree_leaves as lm_leaves
    from repro_torch.models.lm import init_lm_caches, lm_decode, lm_prefill
    from repro_torch.serve.engine import LmEngine
    from repro_torch.serve.scheduler import ContinuousBatcher

    rng = np.random.default_rng(SEED + 7)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base, res = {}, {}
    ops.reset_launch_counts()
    t_phase = time.perf_counter()

    def no_kernels(what):
        n = {k: v for k, v in ops.launch_counts().items() if v}
        if n:
            raise AssertionError(f"{what}: hand-written kernels launched {n}")

    # (a) deepseek-v2-lite-16b, full size, bf16, under the batcher
    cfg = get_config("deepseek-v2-lite-16b")
    params, init_s, init_peak = lm_build(cfg, dev, base)
    prompts = [rng.integers(1, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, 97, LM_REQUESTS)]

    def batcher():
        return ContinuousBatcher(LmEngine(params, cfg, LM_SLOTS, LM_MAX_LEN,
                                          device=dev))

    def drain():
        cb = batcher()
        for p in prompts:
            cb.submit(p, max_new_tokens=LM_NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = cb.run_until_drained()
        torch.cuda.synchronize()
        return {r.uid: r.output for r in done}, time.perf_counter() - t0

    def staggered(stagger):
        cb = batcher()
        cb.submit(prompts[0], max_new_tokens=ZOO_STAGGER_NEW)
        done, submitted = [], not stagger
        while cb.queue or any(cb.slots):
            done += cb.step()
            if (not submitted and cb.slots[0] is not None
                    and len(cb.slots[0].output) >= 3):
                for p in prompts[1:4]:
                    cb.submit(p, max_new_tokens=8)
                submitted = True
        return {r.uid: r.output for r in done}

    outs, wall = drain()
    outs2, wall2 = drain()
    if outs != outs2 or sorted(outs) != list(range(LM_REQUESTS)) or any(
            len(o) != LM_NEW for o in outs.values()):
        raise AssertionError(f"deepseek-v2-lite-16b drain: {len(outs)} "
                             f"requests, two runs equal {outs == outs2}")
    solo, mixed = staggered(False), staggered(True)
    if mixed[0] != solo[0] or len(mixed) != 4:
        raise AssertionError("deepseek-v2-lite-16b: a staggered admission "
                             "changed the live request's tokens")
    f = lm_forced(params, cfg, dev, rng, "deepseek-v2-lite-16b",
                  margin=ROUTE_MARGIN_BF16)
    no_kernels("deepseek-v2-lite-16b")
    n_tok = LM_REQUESTS * LM_NEW
    log(f"lm deepseek-v2-lite-16b (bf16, full size: MLA kv_lora "
        f"{cfg.kv_lora}, {cfg.n_experts} experts top-{cfg.top_k} + "
        f"{cfg.n_shared_experts} shared) batcher: {LM_REQUESTS} prompts of "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
        f"{LM_NEW} new each, {LM_SLOTS} slots: {n_tok} tokens in "
        f"{wall2:.3f} s ({n_tok / wall2:.1f} tokens/s; the first run, "
        f"warm-up included, {wall:.3f} s, the same tokens); staggered "
        f"admission: the live request's tokens equal those of its run with "
        f"the same waves; prefill-then-decode against the teacher-forced "
        f"forward: relative RMS {f['err']:.3e} (within {TOL_LM_BF16_RMS}), "
        + flips_allowed("deepseek", f["flips"], f["gap"], ROUTE_MARGIN_BF16)
        + f"; init {init_s:.3f} s, its peak {init_peak / 2 ** 30:.3f} GiB "
        f"above the {base['bytes']} B held before; no hand-written kernel "
        f"launched [{smi}]")
    res["deepseek-v2-lite-16b"] = lm_timed(
        "deepseek-v2-lite-16b", cfg, params, init_s, LM_T, dev, rng, base,
        smi, f"; drain {n_tok / wall2:.1f} tokens/s")
    del res["deepseek-v2-lite-16b"]["tokens"]
    res["deepseek-v2-lite-16b"].update(
        tokens_per_s=n_tok / wall2, init_peak_gib=init_peak / 2 ** 30,
        forced=f)
    del params

    # (b)-(d): generate_greedy on 4 prompts of 128 tokens, 32 steps
    for arch in ("granite-moe-3b-a800m", "llama-3.2-vision-11b",
                 "seamless-m4t-large-v2"):
        cfg = get_config(arch)
        params, init_s, init_peak = lm_build(cfg, dev, base)
        mod = modality_inputs(cfg, LM_SLOTS, dev, torch.bfloat16, gen)
        res[arch] = lm_timed(arch, cfg, params, init_s, LM_T, dev, rng, base,
                             smi, modality=mod)
        new = res[arch].pop("tokens")
        if new.shape != (LM_SLOTS, LM_NEW) or not (0 <= new).all() or not (
                new < cfg.vocab).all():
            raise AssertionError(f"{arch} tokens {new.shape}")
        f = lm_forced(params, cfg, dev, rng, arch, modality=mod,
                      margin=ROUTE_MARGIN_BF16)
        no_kernels(arch)
        what = ", ".join(f"{k} {list(v.shape)}" for k, v in mod.items())
        log(f"lm {arch} (bf16, full size) generate_greedy: {LM_SLOTS} "
            f"prompts of {LM_T}{', ' + what if what else ''}, {LM_NEW} "
            f"steps; prefill-then-decode against the teacher-forced "
            f"forward: relative RMS {f['err']:.3e} (within "
            f"{TOL_LM_BF16_RMS}), "
            + flips_allowed(arch, f["flips"], f["gap"], ROUTE_MARGIN_BF16)
            + f"; init peak {init_peak / 2 ** 30:.3f} GiB; no hand-written "
            f"kernel launched [{smi}]")
        res[arch].update(init_peak_gib=init_peak / 2 ** 30, forced=f)
        del params, mod, new

    # (e) fp32 at full width and few layers: the card against the CPU
    cpu = torch.device("cpu")
    for arch, layers in ZOO_F32_LAYERS.items():
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  **layers)
        params, _, _ = lm_build(cfg, dev, base)
        cpu_params = tree_map(lambda x: x.to(cpu), params)
        mod = modality_inputs(cfg, LM_SLOTS, dev, torch.float32, gen)
        mod2 = {k: v[:2] for k, v in mod.items()}
        toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 32)))

        def run(p, where, m, replay=None):
            with torch.no_grad(), RouteLog(replay) as routes:
                caches = init_lm_caches(cfg, 2, 64, where)
                lg_p, caches = lm_prefill(p, cfg, toks.to(where), caches,
                                          **{k: v.to(where)
                                             for k, v in m.items()})
                lg_d, caches = lm_decode(p, cfg, cur.to(where), caches)
            return lg_p, lg_d, caches, routes

        cur = torch.zeros((2, 1), dtype=torch.long)
        with torch.no_grad():
            caches = init_lm_caches(cfg, 2, 64, dev)
            lg, _ = lm_prefill(params, cfg, toks.to(dev), caches, **mod2)
            cur = torch.argmax(lg[:, -1:], dim=-1).cpu()
        lg_p, lg_d, caches, card_routes = run(params, dev, mod2)
        t0 = time.perf_counter()
        c_p, c_d, c_caches, cpu_routes = run(cpu_params, cpu, mod2,
                                             card_routes.calls)
        cpu_s = time.perf_counter() - t0
        n, gap = cpu_routes.flips()
        flips = flips_allowed(f"{arch} fp32 card against CPU", n, gap,
                              ROUTE_MARGIN_F32)
        err = max([scaled_err(lg_p, c_p), scaled_err(lg_d, c_d)] + [
            scaled_err(a.float(), b.float()) for a, b in zip(
                lm_leaves(caches), lm_leaves(c_caches))])
        if err > TOL_LM:
            raise AssertionError(f"{arch} fp32: card against CPU {err:.3e}")
        f = lm_forced(params, cfg, dev, rng, f"{arch} fp32", TOL_F32,
                      modality=mod, margin=ROUTE_MARGIN_F32)
        no_kernels(f"{arch} fp32")
        rss, rss_peak = host_rss_gib()
        shape = ", ".join(f"{k}={v}" for k, v in layers.items())
        log(f"lm {arch} (fp32, full width, {shape}) card against CPU: "
            f"prefill [2, 32] and first decode logits and every cache leaf "
            f"within {err:.3e} of max(1, |CPU|) (tolerance {TOL_LM}), the "
            f"CPU taking the card's expert choices: {flips}; CPU run "
            f"{cpu_s:.1f} s, host RSS {rss:.2f} GiB (peak {rss_peak:.2f}); "
            f"on the card, prefill-then-decode against the teacher-forced "
            f"forward: relative RMS {f['err']:.3e} (within {TOL_F32}), "
            + flips_allowed(arch, f["flips"], f["gap"], ROUTE_MARGIN_F32)
            + f" [{smi}]")
        res[f"{arch} fp32"] = {"err": err, "forced": f, "flips": n}
        del params, cpu_params, caches, c_caches, mod, mod2
        gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 5g took {time.perf_counter() - t_phase:.1f} s")
    return res


# -- phase 5h: LM training ------------------------------------------------------

# (a) the launcher at full size: llama3.2-1b, bf16 weights, fp32 Adam
# moments, remat on, 8 steps of [8, 128]; then 5 steps of
# make_lm_train_step on one fixed batch with the launcher's optimizer at
# its defaults (AdamW, weight decay 0.1, warmup to 3e-4 over 20 steps):
# the loss must fall; two more steps profiled. (At a constant 3e-4 or
# 1e-3 the first steps' near-sign updates of every weight overshoot and
# the loss swings up and down on a fixed batch.)
LM_TRAIN_ARCH = "llama3.2-1b"
LM_TRAIN_STEPS = 8
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128
LM_FIXED_STEPS = 5
# bf16 dense rate of an H100 SXM's tensor cores, from the data sheet (not
# measured here), for the step's bound
BF16_OPS_PER_S = 989e12
# (b) one train step on the card against the same step on the CPU, in fp32,
# from the same weights and batch [2, 32]: the loss within TOL_LM, each
# gradient leaf within TOL_LM_TRAIN_GRAD of the leaf's largest magnitude
# (the CPU suite holds the packages to 1e-5 at D = 64; the card sums the
# same products in other orders over D up to 4096, ~8 times the terms of a
# dot product, a factor of ~3 under sqrt growth, and 1e-4 keeps three over
# that), the parameters after Adam within adam_first_step_bound of that.
# The families at full width and few layers (recurrentgemma-9b: one period
# of 3 layers, its vocabulary cut to LM_GRAD_RG_VOCAB: the 256,000-row
# embedding alone is 4.2 GB in fp32, and the CPU's copies of a training
# step hold it ~8 times); deepseek-v2-lite-16b, llama-3.2-vision-11b and
# seamless-m4t-large-v2 at reduced() widths: at full width two of their
# layers are 1.3-6.0 G fp32 parameters, whose training copies on the CPU
# would take ~50 GB and most of the phase's time
TOL_LM_TRAIN_GRAD = 1e-4
# RWKV6's group norm divides each head by rsqrt(var + 1e-5), and its
# backward subtracts near-equal terms where a head's variance is small: the
# CPU suite holds RWKV6's leaves to 5e-4 (measured 1.2e-4 on a microbatch
# of 2 at D = 64) where it holds the others to 1e-5; the card against the
# CPU at full width measured 1.2e-4 (first run), and 1e-3 keeps a factor
# of eight
TOL_LM_TRAIN_GRAD_RWKV6 = 1e-3
LM_GRAD_BATCH, LM_GRAD_SEQ = 2, 32
LM_GRAD_RG_VOCAB = 32768
LM_GRAD_FULL = {"llama3.2-1b": {"n_layers": 2},
                "rwkv6-1.6b": {"n_layers": 2},
                "recurrentgemma-9b": {"n_layers": 3,
                                      "vocab": LM_GRAD_RG_VOCAB},
                "granite-moe-3b-a800m": {"n_layers": 2}}
LM_GRAD_REDUCED = ("deepseek-v2-lite-16b", "llama-3.2-vision-11b",
                   "seamless-m4t-large-v2")
# the leaves whose gradient flows only through a scan: a zero gradient on
# any of them on the card fails (b)
SCAN_LEAVES = {"rwkv6-1.6b": ("time_mix/w_r", "time_mix/w_k", "time_mix/w_v",
                              "time_mix/decay_w1", "time_mix/bonus_u"),
               "recurrentgemma-9b": ("rglru/w_rg", "rglru/w_ig",
                                     "rglru/b_rg", "rglru/lambda")}


def adam_first_step_excess(p, cp, cg, delta, scale, lr, eps=1e-8) -> float:
    """``adam_first_step_bound`` on the card, in float64: the most by which
    ``|p - cp|`` (the parameters after Adam's first step from the gradients
    ``g`` and ``cg``, the CPU's, ``|g - cg| <= delta``) exceeds the bound
    plus an ulp of ``cp``; negative when every element is within it."""
    import torch
    g = cg.double()

    def upd(v):
        v = scale * v
        return v / (v.abs() + eps)
    u = upd(g)
    reach = torch.maximum((upd(g + delta) - u).abs(), (upd(g - delta) - u).abs())
    a = cp.abs()
    if a.dtype == torch.bfloat16:        # the next bf16 up, by its bits
        ulp = (a.view(torch.int16) + 1).view(torch.bfloat16).double() - (
            a.double())
    else:
        ulp = (torch.nextafter(a, torch.full_like(a, float("inf")))
               - a).double()
    return float(((p.double() - cp.double()).abs() - lr * (reach + 8 * 2.0 ** -24)
                  - ulp).max())


def steps_apart(grads, ref_grads, params, ref_params, ref_grad_norm, tol,
                lr, dev, scan_leaves=()) -> tuple:
    """Two Adam first steps from the same state, leaf by leaf on ``dev``:
    the largest gradient error as a share of the reference leaf's largest
    (and its leaf), the most by which a parameter exceeds Adam's
    first-step bound of ``tol`` (``adam_first_step_excess``; negative
    within it), and the ``scan_leaves`` whose gradient is zero."""
    from repro_torch.ft.checkpoint import tree_paths
    scale = min(1.0, 1.0 / (ref_grad_norm + 1e-9))
    grad_err, worst, excess, zero = 0.0, "none", -float("inf"), []
    for (path, g), (_, cg), (_, p), (_, cp) in zip(
            tree_paths(grads), tree_paths(ref_grads), tree_paths(params),
            tree_paths(ref_params)):
        cg, cp = cg.to(dev), cp.to(dev)
        top = float(cg.abs().max())
        diff = float((g - cg).abs().max())
        err = diff / top if top else (0.0 if diff == 0 else float("inf"))
        if err > grad_err:
            grad_err, worst = err, path
        if any(path.endswith(leaf) for leaf in scan_leaves) and not float(
                g.abs().max()) > 0:
            zero.append(path)
        excess = max(excess, adam_first_step_excess(p, cp, cg, tol * top,
                                                    scale, lr))
    return grad_err, worst, excess, zero


def lm_step_against_cpu(what, cfg, dev, smi, meshes=None,
                        shape=(LM_GRAD_BATCH, LM_GRAD_SEQ),
                        on_card=None) -> dict:
    """(b) for one config: seeded ``init_lm`` on the card, copied to the
    CPU; one batch ``shape`` (``lm_batch``, default [2, 32]) on both; one
    ``make_lm_train_step`` step on each, its gradients kept by a
    ``grad_transform`` that returns them unchanged; the card's MoE choices
    replayed on the CPU (flips within ``ROUTE_MARGIN_F32``). Compared on
    the card, leaf by leaf. ``meshes``: a (card mesh, CPU mesh) pair the
    two steps run under (``use_mesh`` with ``AxisRules()``, the batch put
    by ``shard_batch``); ``on_card(grads, route_calls)`` sees the card's
    gradients and router choices."""
    import contextlib

    import torch
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist.sharding import AxisRules, use_mesh
    from repro_torch.models.common import count_params, tree_map
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optim import AdamConfig, constant_schedule
    from repro_torch.train.trainer import (init_train_state,
                                           make_lm_train_step)
    cpu = torch.device("cpu")
    arch = what.split(" ")[0]
    tol = TOL_LM_TRAIN_GRAD_RWKV6 if arch.startswith("rwkv6") else (
        TOL_LM_TRAIN_GRAD)
    t0 = time.perf_counter()
    params = init_lm(SEED, cfg, device=dev)
    n_params = count_params(params)
    cpu_params = tree_map(lambda t: t.to(cpu), params)
    batch = lm_batch((SEED, 5), cfg, *shape, device="cpu")
    kept = {}

    def under(i):
        if meshes is None:
            return contextlib.nullcontext()
        return use_mesh(meshes[i], AxisRules())

    def put(b, i):
        return b if meshes is None else shard_batch(b, meshes[i])

    def step_on(where):
        def keep(grads):
            kept[where] = grads
            return grads
        return make_lm_train_step(cfg, AdamConfig(
            schedule=constant_schedule(TRAIN_LR)), grad_transform=keep)

    with under(0), RouteLog() as card_log:
        new, metrics = step_on("card")(
            init_train_state(params), put({k: v.to(dev) for k, v in
                                           batch.items()}, 0))
    del params
    if on_card is not None:
        on_card(kept["card"], card_log.calls)
    c_t0 = time.perf_counter()
    with under(1), RouteLog(card_log.calls) as cpu_log:
        c_new, c_metrics = step_on("cpu")(init_train_state(cpu_params),
                                          put(batch, 1))
    cpu_s = time.perf_counter() - c_t0
    del cpu_params
    n_flip, gap = cpu_log.flips()
    flip_text = flips_allowed(f"{arch} train step", n_flip, gap,
                              ROUTE_MARGIN_F32)
    loss_err = abs(float(metrics["loss"]) - float(c_metrics["loss"])) / abs(
        float(c_metrics["loss"]))
    scan_leaves = SCAN_LEAVES.get(arch, ())
    grad_err, worst, excess, zero = steps_apart(
        kept["card"], kept["cpu"], new.params, c_new.params,
        float(c_metrics["grad_norm"]), tol, TRAIN_LR, dev, scan_leaves)
    report = (f"train {what} (fp32, {n_params} parameters) card against "
              f"CPU, one make_lm_train_step on [{shape[0]}, {shape[1]}]"
              + ("" if meshes is None else
                 f" under a {meshes[0].shape} mesh on each")
              + f": loss {loss_err:.3e} relative (tolerance "
              f"{TOL_LM}), gradients {grad_err:.3e} of the leaf's largest at "
              f"the worst ({worst}; tolerance {tol}), parameters after Adam "
              f"within its first-step bound with {-excess:.3e} to spare at "
              f"the closest; {flip_text}"
              + (f"; nonzero card gradients on {', '.join(scan_leaves)}"
                 if scan_leaves else "")
              + f"; {time.perf_counter() - t0:.1f} s ({cpu_s:.1f} the CPU's "
              f"step) [{smi}]")
    if (loss_err > TOL_LM or grad_err > tol or excess > 0 or zero
            or not math.isfinite(float(metrics["loss"]))):
        raise AssertionError(f"{report}: outside the bounds; zero card "
                             f"gradients on {zero}")
    log(report)
    return {"loss_err": loss_err, "grad_err": grad_err, "worst": worst,
            "flips": n_flip, "cpu_s": cpu_s}


# substrings of the names of cuBLAS's matmul kernels on an H100
MATMUL_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


def lm_step_split(cfg, state, batch, opt_cfg) -> dict:
    """One LM train step cut at its joints, each part ended by a
    synchronise (ms): the forward with its loss, the backward (remat's
    second forward in it), the Adam update; and the device time of one
    step by kernel group (``torch.profiler``): the library's matmuls
    (``MATMUL_KERNELS`` in the kernel's name), the rest, and the six
    kernels that took the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import lm_forward
    from repro_torch.train.losses import lm_loss
    from repro_torch.train.optim import adam_update
    from repro_torch.train.trainer import make_lm_train_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    live = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
    logits, aux = lm_forward(live, cfg, batch["tokens"])
    loss = lm_loss(logits, batch["tokens"])[0] + 0.01 * torch.as_tensor(aux)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    adam_update(tree_map(lambda p: p.grad, live), state.opt, state.params,
                opt_cfg)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del live, logits, loss
    step = make_lm_train_step(cfg, opt_cfg)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    gemm = sum(us for name, (_, us) in by_name.items()
               if any(m in name.lower() for m in MATMUL_KERNELS))
    rest = sum(us for _, us in by_name.values()) - gemm
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]

    def short(name):
        for cut in ("void ", "at::native::", "(anonymous namespace)::"):
            name = name.replace(cut, "")
        return name[:150]
    return {"forward_ms": 1e3 * (t1 - t0), "backward_ms": 1e3 * (t2 - t1),
            "adam_ms": 1e3 * (t3 - t2), "gemm_us": gemm, "other_us": rest,
            "top": [(short(name), n, us) for name, (n, us) in top]}


def lm_train_phase(dev, smi) -> dict:
    """Phase 5h: LM training on the card. (a) ``launch.train.main`` trains
    llama3.2-1b at full size (the registry config: bf16 weights, fp32 Adam
    moments, remat) for 8 steps of [8, 128], every loss finite; 5 steps of
    ``make_lm_train_step`` on one fixed batch, whose loss falls, 2 of them
    profiled (``engine_profile``); ``--grad-accum 2`` for 2 steps. (b) One
    train step on the card against the CPU in fp32 per family
    (``LM_GRAD_FULL``, ``LM_GRAD_REDUCED``; ``lm_step_against_cpu``). (c)
    The same 3 steps of ``--reduced`` llama3.2-1b and granite-moe-3b-a800m
    twice, losses bitwise equal; a run stopped at step 4 by its checkpoint
    and resumed to step 6 gives the losses of steps 5-6 of an
    uninterrupted run, bitwise. No hand-written kernel launches: the
    blocks run the plain scans under autograd. Returns the numbers."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.common import count_params
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optim import AdamConfig, warmup_cosine_schedule
    from repro_torch.train.trainer import (init_train_state,
                                           make_lm_train_step)

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    res = {}

    def finite(what, losses, n):
        if len(losses) != n or not all(np.isfinite(losses)):
            raise AssertionError(f"{what}: losses {losses}")

    # (a) the launcher at full size
    args = ["--arch", LM_TRAIN_ARCH, "--steps", str(LM_TRAIN_STEPS),
            "--batch", str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ),
            "--log-every", "1"]
    t0 = time.perf_counter()
    run = train_main(args)
    run_s = time.perf_counter() - t0
    finite("launch.train " + " ".join(args), run["losses"], LM_TRAIN_STEPS)
    log(f"train {LM_TRAIN_ARCH} (full size, bf16) launch.train "
        f"{' '.join(args)}: {LM_TRAIN_STEPS} finite losses "
        + ", ".join(f"{v:.4f}" for v in run["losses"])
        + f"; steps 2-{LM_TRAIN_STEPS} p50 "
        f"{float(np.median(run['step_ms'][1:])):.3f} ms (the first, warm-up "
        f"included, {run['step_ms'][0]:.3f} ms); {run_s:.1f} s in all "
        f"[{smi}]")
    run2 = train_main(args[:2] + ["--steps", "2", "--batch",
                                  str(LM_TRAIN_BATCH), "--seq",
                                  str(LM_TRAIN_SEQ), "--grad-accum", "2",
                                  "--log-every", "1"])
    finite("launch.train --grad-accum 2", run2["losses"], 2)
    log(f"train {LM_TRAIN_ARCH} --grad-accum 2 (2 microbatches of "
        f"[{LM_TRAIN_BATCH // 2}, {LM_TRAIN_SEQ}]): losses "
        + ", ".join(f"{v:.4f}" for v in run2["losses"])
        + "; step ms " + ", ".join(f"{v:.3f}" for v in run2["step_ms"])
        + f" [{smi}]")

    cfg = get_config(LM_TRAIN_ARCH)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(SEED, cfg, device=dev)
    n_params = count_params(params)
    state = {"s": init_train_state(params)}
    del params
    step_opt = AdamConfig(schedule=warmup_cosine_schedule(3e-4, 20, 100),
                          weight_decay=0.1)
    step = make_lm_train_step(cfg, step_opt)
    batch = lm_batch((SEED, 9), cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                     device=dev)
    losses, walls = [], []
    for _ in range(LM_FIXED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state["s"], m = step(state["s"], batch)
        losses.append(float(m["loss"]))
        walls.append(1e3 * (time.perf_counter() - t0))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{LM_TRAIN_ARCH} fixed batch: losses {losses}"
                             " (want finite and falling)")

    def two_steps():
        for _ in range(2):
            state["s"], mm = step(state["s"], batch)
        float(mm["loss"])
    prof = engine_profile(two_steps, 2)
    split = lm_step_split(cfg, state["s"], batch, step_opt)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    p50 = float(np.median(walls[1:]))
    # the step's least time: 6 N T operations of forward and backward plus
    # remat's second forward (2 N T) at the bf16 tensor-core rate, or the
    # bytes of the Adam update (bf16 weights read and written, bf16
    # gradients read, fp32 moments read and written) at HBM_BYTES_PER_S
    t_ops = 8 * n_params * tokens / BF16_OPS_PER_S
    t_bytes = (2 * 2 + 2 + 4 * 4) * n_params / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    res["a"] = {"launcher_losses": run["losses"],
                "launcher_step_ms": run["step_ms"],
                "fixed_losses": losses, "fixed_step_ms": walls,
                "step_p50_ms": p50, "profile": prof, "peak_gib": peak,
                "tokens_per_s": 1e3 * tokens / p50, "bound_ms": bound_ms,
                "params": n_params, "split": split}
    log(f"time train {LM_TRAIN_ARCH} (full size: {n_params} parameters, "
        f"bf16, fp32 Adam moments, remat) make_lm_train_step on one "
        f"[{LM_TRAIN_BATCH}, {LM_TRAIN_SEQ}] batch: losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f" (falling); step wall p50 {p50:.3f} ms over steps 2-"
        f"{LM_FIXED_STEPS} (each " + ", ".join(f"{v:.3f}" for v in walls)
        + f"), {1e3 * tokens / p50:.1f} tokens/s; profiled step: "
        f"{prof['kernels_per_step']:.1f} kernels, device busy "
        f"{prof['device_busy_us_per_step']:.1f} us, idle share "
        f"{prof['idle_share']:.4f} (wall {prof['wall_us_per_step']:.1f} us "
        f"under the profiler); peak memory {peak:.3f} GiB above the "
        f"{base} B held before; bound {bound_ms:.3f} ms (8 N T = "
        f"{8 * n_params * tokens:.4e} bf16 operations at "
        f"{BF16_OPS_PER_S:.3e}/s: {1e3 * t_ops:.3f} ms; Adam's "
        f"{(2 * 2 + 2 + 4 * 4) * n_params} B at {HBM_BYTES_PER_S:.3e} B/s: "
        f"{1e3 * t_bytes:.3f} ms) [{smi}]")
    log(f"time train {LM_TRAIN_ARCH} step split (each part synchronised): "
        f"forward and loss {split['forward_ms']:.3f} ms, backward (remat's "
        f"second forward in it) {split['backward_ms']:.3f} ms, Adam "
        f"{split['adam_ms']:.3f} ms; device time of one step: matmul "
        f"kernels {split['gemm_us']:.1f} us, the rest "
        f"{split['other_us']:.1f} us; the six largest: "
        + "; ".join(f"{name} x{n} {us:.1f} us" for name, n, us in
                    split["top"]) + f" [{smi}]")
    del state, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the card against the CPU, per family, fp32
    res["b"] = {}
    for arch, shape in LM_GRAD_FULL.items():
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **shape)
        cut = ", ".join(f"{k}={v}" for k, v in shape.items())
        res["b"][arch] = lm_step_against_cpu(f"{arch} ({cut}, full width)",
                                             cfg, dev, smi)
        gc.collect()
        torch.cuda.empty_cache()
    for arch in LM_GRAD_REDUCED:
        cfg = get_config(arch).reduced()
        res["b"][arch] = lm_step_against_cpu(
            f"{arch} (reduced: D={cfg.d_model}, {cfg.n_layers} layers)", cfg,
            dev, smi)
    rss, rss_peak = host_rss_gib()
    log(f"train card against CPU: host RSS {rss:.2f} GiB (peak "
        f"{rss_peak:.2f})")

    # (c) determinism and resume, --reduced
    res["c"] = {}
    for arch in (LM_TRAIN_ARCH, "granite-moe-3b-a800m"):
        args = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "8",
                "--seq", "128", "--log-every", "1"]
        a, b = train_main(args)["losses"], train_main(args)["losses"]
        finite(f"{arch} --reduced", a, 3)
        if a != b:
            raise AssertionError(f"{arch} --reduced: two runs of 3 steps "
                                 f"differ: {a} / {b}")
        res["c"][arch] = a
        log(f"train {arch} --reduced: two runs of 3 steps, losses bitwise "
            f"equal: " + ", ".join(repr(v) for v in a) + f" [{smi}]")
    base_args = ["--arch", LM_TRAIN_ARCH, "--reduced", "--batch", "8",
                 "--seq", "128", "--log-every", "1"]
    whole = train_main(base_args + ["--steps", "6"])["losses"]
    with tempfile.TemporaryDirectory() as tmp:
        ck = ["--ckpt-dir", tmp, "--ckpt-every", "4"]
        first = train_main(base_args + ["--steps", "4"] + ck)
        resumed = train_main(base_args + ["--steps", "6"] + ck)
    if (first["losses"] != whole[:4] or resumed["start"] != 4
            or resumed["losses"] != whole[4:]):
        raise AssertionError(f"resume: uninterrupted {whole}, stopped at 4 "
                             f"{first['losses']}, resumed from "
                             f"{resumed['start']} {resumed['losses']}")
    log(f"train {LM_TRAIN_ARCH} --reduced resume: stopped at step 4 by its "
        f"checkpoint, resumed to 6; steps 5-6 "
        + ", ".join(repr(v) for v in resumed["losses"])
        + f" bitwise those of an uninterrupted run [{smi}]")

    n = {k: v for k, v in ops.launch_counts().items() if v}
    if n:
        raise AssertionError(f"phase 5h launched hand-written kernels {n}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 5h took {res['seconds']:.1f} s; no hand-written kernel "
        f"launched")
    return res


# -- phase 5i: the mesh paths ----------------------------------------------------

# The phase's mesh: (data, model) = (4, 2) over the card listed 8 times
# (best_mesh(devices=[card] * 8, model_parallel=2)), and its twin over the
# CPU. The port's mesh lists one device: GSPMD over several cards is
# ROADMAP.md Queue 1 item 9.
MESH_DEVICES, MESH_MODEL = 8, 2
# (a) the expert-parallel forward at full width and 2 layers in fp32, at a
# capacity that drops nothing (no_drop: the local capacity is then the
# shard's token count, so EP and the sorted path keep every assignment), on
# [8, 32], whose 8 rows split over the 4 data shards; then granite at full
# size in bf16 on [8, 128]
MESH_EP_ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
MESH_EP_BATCH, MESH_EP_SEQ = 8, 32
# (b) llama3.2-1b at full size as 5h (a), [8, 128] in two microbatches;
# timed steps after the compared one
MESH_TRAIN_ACCUM = 2
MESH_TRAIN_STEPS = 3
# (d) pipeline_forward: 4 stages tanh(x @ w) at llama3.2-1b's width, 8
# microbatches of [4, 128, D]
PIPE_STAGES, PIPE_MICRO, PIPE_D = 4, 8, 2048
PIPE_MB = (4, 128)


def free_card():
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def mesh_ep_forward(arch, mesh, cpu_mesh, dev, rng, merged, ep_calls,
                    smi) -> dict:
    """5i (a) for one config: ``lm_forward`` at full width, 2 layers, fp32,
    ``no_drop``, on [8, 32] under ``mesh`` (the expert-parallel branch),
    under ``cpu_mesh`` on the CPU (the card's choices replayed) and without
    a mesh (the sorted path, the card's choices merged and replayed)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.sharding import AxisRules, use_mesh
    from repro_torch.models.common import count_params, tree_map
    from repro_torch.models.lm import init_lm, lm_forward
    t0 = time.perf_counter()
    dp = mesh.shape["data"]
    rules = AxisRules()
    cfg = no_drop(dataclasses.replace(get_config(arch), dtype="float32",
                                      n_layers=2))
    params = init_lm(SEED, cfg, device=dev)
    n_params = count_params(params)
    cpu_params = tree_map(lambda t: t.to("cpu"), params)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab, (MESH_EP_BATCH, MESH_EP_SEQ))).to(dev)
    ep_calls.clear()
    with torch.no_grad():
        with use_mesh(mesh, rules), RouteLog() as ep_log:
            logits, aux = lm_forward(params, cfg, tokens)
        n_ep = len(ep_calls)
        with use_mesh(cpu_mesh, rules), RouteLog(ep_log.calls) as cpu_log:
            c_logits, c_aux = lm_forward(cpu_params, cfg, tokens.cpu())
        with RouteLog(merged(ep_log.calls)) as s_log:
            s_logits, s_aux = lm_forward(params, cfg, tokens)

        def under_mesh():
            with use_mesh(mesh, rules):
                lm_forward(params, cfg, tokens)
        syncs = host_syncs(under_mesh)
    n_moe = len(s_log.calls)
    if not n_moe or n_ep != n_moe or len(ep_log.calls) != dp * n_moe:
        raise AssertionError(
            f"{arch}: {n_ep} expert-parallel calls and {len(ep_log.calls)} "
            f"router calls for {n_moe} MoE layers")
    flips = [flips_allowed(f"{arch} EP against {what}", *log_.flips(),
                           ROUTE_MARGIN_F32)
             for what, log_ in (("the CPU", cpu_log),
                                ("the sorted path", s_log))]
    errs = {"card_cpu": scaled_err(logits, c_logits),
            "ep_sorted": scaled_err(logits, s_logits),
            "aux_card_cpu": abs(float(aux) - float(c_aux)) / abs(float(c_aux)),
            "aux_ep_sorted": abs(float(aux) - float(s_aux))
            / abs(float(s_aux))}
    if max(errs.values()) > TOL_LM or not torch.isfinite(logits).all():
        raise AssertionError(f"{arch} EP forward: {errs}")
    log(f"mesh (a) {arch} (fp32, full width, 2 layers, {n_params} "
        f"parameters) lm_forward [{MESH_EP_BATCH}, {MESH_EP_SEQ}] under the "
        f"{mesh.shape} mesh: the expert-parallel branch ({n_ep} calls, "
        f"{len(ep_log.calls)} router calls, {dp} a layer); card against CPU "
        f"under its mesh: logits {errs['card_cpu']:.3e}, aux "
        f"{errs['aux_card_cpu']:.3e}; against the sorted path without a "
        f"mesh: logits {errs['ep_sorted']:.3e}, aux "
        f"{errs['aux_ep_sorted']:.3e} (tolerance {TOL_LM}); {flips[0]} (CPU),"
        f" {flips[1]} (sorted); {syncs} host syncs a forward under the mesh; "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    return dict(errs, syncs=syncs)


def mesh_ep_timed(mesh, dev, rng, smi) -> dict:
    """5i (a): granite-moe-3b-a800m at full size in bf16, ``lm_forward`` on
    [8, 128] once without a mesh (the sorted path) and once under ``mesh``
    (expert-parallel), each after a warm-up: wall, kernels, device busy,
    peak memory above the weights."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.sharding import AxisRules, use_mesh
    from repro_torch.models.common import count_params
    from repro_torch.models.lm import init_lm, lm_forward
    arch = "granite-moe-3b-a800m"
    cfg = get_config(arch)
    params = init_lm(SEED, cfg, device=dev)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab, (LM_TRAIN_BATCH, LM_TRAIN_SEQ))).to(dev)
    outs, rows = {}, {}
    for name, on in (("sorted", None), ("expert-parallel", mesh)):
        def run():
            with torch.no_grad():
                if on is None:
                    return lm_forward(params, cfg, tokens)
                with use_mesh(on, AxisRules()):
                    return lm_forward(params, cfg, tokens)
        run()
        free_card()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs[name] = run()[0]
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        prof = engine_profile(run, 1)
        if not torch.isfinite(outs[name]).all():
            raise AssertionError(f"{arch} bf16 {name}: logits not finite")
        rows[name] = {"wall_ms": wall, "peak_gib": peak, "profile": prof}
    apart = rel_rms(outs["expert-parallel"], outs["sorted"])
    log(f"time mesh (a) {arch} (full size, bf16, {count_params(params)} "
        f"parameters) lm_forward [{LM_TRAIN_BATCH}, {LM_TRAIN_SEQ}] once "
        f"each: " + "; ".join(
            f"{name}: wall {r['wall_ms']:.3f} ms, "
            f"{r['profile']['kernels_per_step']:.0f} kernels, device busy "
            f"{r['profile']['device_busy_us_per_step']:.1f} us, peak "
            f"{r['peak_gib']:.3f} GiB above the weights"
            for name, r in rows.items())
        + f"; logits {apart:.3e} relative RMS apart (at the capacity factor "
        f"1.25 EP drops by the local token count, by design) [{smi}]")
    return dict(rows, rel_rms=apart)


def mesh_train_step(mesh, dev, smi) -> dict:
    """5i (b): llama3.2-1b at full size, ``make_lm_train_step_fn`` with
    ``grad_accum=2`` and the ZeRO-1 ``accum_rules`` under ``mesh`` against
    the same step without a mesh, from one state and batch; then timed
    steps under the mesh, one profiled."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist.sharding import AxisRules, use_mesh
    from repro_torch.ft.checkpoint import tree_paths
    from repro_torch.models.common import count_params
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optim import AdamConfig, constant_schedule
    from repro_torch.train.trainer import (init_train_state,
                                           make_lm_train_step_fn)
    arch = LM_TRAIN_ARCH
    cfg = get_config(arch)
    rules = AxisRules()
    base = torch.cuda.memory_allocated()
    params = init_lm(SEED, cfg, device=dev)
    n_params = count_params(params)
    state0 = init_train_state(params)
    del params
    batch = lm_batch((SEED, 13), cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                     device=dev)
    opt = AdamConfig(schedule=constant_schedule(TRAIN_LR))
    kept = {}

    def keeping(tag, accum_rules):
        def keep(grads):
            kept[tag] = grads
            return grads
        return make_lm_train_step_fn(cfg, opt, grad_transform=keep,
                                     grad_accum=MESH_TRAIN_ACCUM,
                                     accum_rules=accum_rules)
    with use_mesh(mesh, rules):
        new_m, met_m = keeping("mesh", AxisRules())(
            state0, shard_batch(batch, mesh, rules))
    new_p, met_p = keeping("plain", None)(state0, batch)
    same_loss = torch.equal(met_m["loss"], met_p["loss"])
    # The forward is bitwise the gather's, so is every gradient but the
    # embedding's. There the one-hot's backward is a matmul that sums a
    # row's tokens in fp32 and rounds once; the gather's is an index
    # accumulation that adds a repeated token's rows in bf16 one by one.
    # So rows whose token occurs at most once in each microbatch (or never)
    # are held bitwise, the repeated ones are measured; the parameters are
    # held within Adam's first-step bound of the measured difference.
    counts = torch.stack([torch.bincount(t.flatten(), minlength=cfg.vocab)
                          for t in batch["tokens"].chunk(MESH_TRAIN_ACCUM)])
    single = counts.max(0).values <= 1
    scale = min(1.0, 1.0 / (float(met_p["grad_norm"]) + 1e-9))
    excess, differ, rep_err = -float("inf"), [], 0.0
    for (path, g), (_, gp), (_, pm), (_, pp) in zip(
            tree_paths(kept["mesh"]), tree_paths(kept["plain"]),
            tree_paths(new_m.params), tree_paths(new_p.params)):
        top = float(gp.abs().max())
        delta = TOL_LM_TRAIN_GRAD * top
        if path == "embedding":
            diff = (g - gp).abs()
            if float(diff[single].max()) > 0:
                differ.append(path + " (single rows)")
            rep_err = float(diff.max()) / top
            delta = max(delta, float(diff.max()))
            del diff
        elif not torch.equal(g, gp):
            differ.append(path)
        excess = max(excess, adam_first_step_excess(pm, pp, gp, delta, scale,
                                                    TRAIN_LR))
    report = (f"train {arch} (full size, bf16, remat, {n_params} "
              f"parameters) make_lm_train_step_fn(grad_accum="
              f"{MESH_TRAIN_ACCUM}, accum_rules=AxisRules()) on "
              f"[{LM_TRAIN_BATCH}, {LM_TRAIN_SEQ}] under the {mesh.shape} "
              f"mesh (one-hot embedding) against the step without a mesh: "
              f"loss {float(met_m['loss'])!r} / {float(met_p['loss'])!r} "
              f"({'bitwise' if same_loss else 'not bitwise'}); every "
              f"gradient bitwise (differing: {differ or 'none'}) but the "
              f"embedding's {int((~single).sum())} rows of repeated tokens, "
              f"{rep_err:.3e} of its largest apart there (the gather's bf16 "
              f"accumulation); parameters within Adam's first-step bound of "
              f"that with {-excess:.3e} to spare")
    if not same_loss or differ or excess > 0:
        raise AssertionError(report)
    log(report + f" [{smi}]")
    del kept, new_p, state0, met_p, met_m
    free_card()

    step = make_lm_train_step_fn(cfg, opt, grad_accum=MESH_TRAIN_ACCUM,
                                 accum_rules=AxisRules())
    state = {"s": new_m}
    del new_m
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    with use_mesh(mesh, rules):
        placed = shard_batch(batch, mesh, rules)
        for _ in range(MESH_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state["s"], m = step(state["s"], placed)
            losses.append(float(m["loss"]))
            walls.append(1e3 * (time.perf_counter() - t0))
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30

        def one_step():
            state["s"], mm = step(state["s"], placed)
            float(mm["loss"])
        prof = engine_profile(one_step, 1)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{arch} mesh steps: losses {losses}")
    p50 = float(np.median(walls))
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    log(f"time train {arch} under the {mesh.shape} mesh (grad_accum "
        f"{MESH_TRAIN_ACCUM}, ZeRO-1 accumulator, one-hot embedding): "
        f"{MESH_TRAIN_STEPS} steps on one batch, losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; wall p50 {p50:.3f} ms (each "
        + ", ".join(f"{v:.3f}" for v in walls)
        + f"), {1e3 * tokens / p50:.1f} tokens/s; profiled step: "
        f"{prof['kernels_per_step']:.1f} kernels, device busy "
        f"{prof['device_busy_us_per_step']:.1f} us, idle share "
        f"{prof['idle_share']:.4f}; peak memory {peak:.3f} GiB above the "
        f"{base} B held before the model [{smi}]")
    return {"embedding_err": rep_err, "step_ms": walls, "p50_ms": p50,
            "peak_gib": peak, "profile": prof}


def mesh_pipeline(dev, smi) -> dict:
    """5i (d): ``pipeline_forward`` over ``PIPE_STAGES`` stages on the card
    listed that many times, against the stages applied in turn on the card
    (bitwise) and the pipeline on the CPU (``TOL_F32``)."""
    import numpy as np
    import torch
    from repro_torch.dist.elastic import Mesh
    from repro_torch.dist.pipeline import pipeline_forward, split_microbatches
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ws = torch.randn(PIPE_STAGES, PIPE_D, PIPE_D, generator=gen,
                     device=dev) * PIPE_D ** -0.5
    xs = split_microbatches(torch.randn(
        PIPE_MICRO * PIPE_MB[0], PIPE_MB[1], PIPE_D, generator=gen,
        device=dev), PIPE_MICRO)

    def stage(w, xm):
        return torch.tanh(xm @ w)

    def in_turn():
        outs = []
        for m in range(PIPE_MICRO):
            y = xs[m]
            for s in range(PIPE_STAGES):
                y = stage(ws[s], y)
            outs.append(y)
        return torch.stack(outs)

    def over(device):
        return Mesh(np.array([device] * PIPE_STAGES, dtype=object),
                    ("stage",))
    fwd = pipeline_forward(stage, over(dev), "stage", PIPE_MICRO)
    got, want = fwd(ws, xs), in_turn()
    cpu_got = pipeline_forward(stage, over(torch.device("cpu")), "stage",
                               PIPE_MICRO)(ws.cpu(), xs.cpu())
    err = scaled_err(got, cpu_got)
    if not torch.equal(got, want) or err > TOL_F32:
        raise AssertionError(f"pipeline_forward: bitwise the stages in turn "
                             f"{torch.equal(got, want)}, against the CPU "
                             f"{err:.3e}")
    walls = {}
    for name, fn in (("pipeline", lambda: fwd(ws, xs)), ("in turn", in_turn)):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        walls[name] = float(np.median(ts))
    log(f"mesh (d) pipeline_forward: {PIPE_STAGES} stages tanh(x @ w) at D "
        f"= {PIPE_D} on the card listed {PIPE_STAGES} times, {PIPE_MICRO} "
        f"microbatches of [{PIPE_MB[0]}, {PIPE_MB[1]}, {PIPE_D}] fp32: "
        f"bitwise the stages applied in turn on the card, {err:.3e} from the "
        f"CPU (tolerance {TOL_F32}); wall (median of 3) "
        f"{walls['pipeline']:.3f} ms over {PIPE_MICRO + PIPE_STAGES - 1} "
        f"ticks, in turn {walls['in turn']:.3f} ms [{smi}]")
    return {"cpu_err": err, "walls_ms": walls}


def mesh_phase(dev, smi) -> dict:
    """Phase 5i: the mesh paths on a (4, 2) mesh over the card listed 8
    times (and its twin over the CPU). (a) ``mesh_ep_forward`` for
    granite-moe-3b-a800m and deepseek-v2-lite-16b: the expert-parallel
    branch, 4 router calls a layer, card against CPU and against the
    sorted path within ``TOL_LM``, choices replayed (``RouteLog``, flips
    within ``ROUTE_MARGIN_F32``); ``mesh_ep_timed``, granite at full size
    in bf16 under the mesh once beside the sorted path. (b)
    ``mesh_train_step``: llama3.2-1b at full size, the mesh step's loss
    bitwise the plain step's (the one-hot embedding picks its rows
    exactly), gradients within ``TOL_LM_TRAIN_GRAD`` of each leaf's
    largest, parameters within Adam's first-step bound; timed steps. (c)
    One granite-moe-3b-a800m step (fp32, full width, 2 layers, [8, 32])
    under the mesh, card against CPU (``lm_step_against_cpu``), every
    expert a layer routed a token to with a nonzero gradient there. (d)
    ``mesh_pipeline``. (e) ``launch.train --model-parallel 2 --reduced``
    repeats ``--model-parallel 1``'s losses bitwise; ``prefetch_to_mesh``
    puts batches on the card with the reference's spec. No hand-written
    kernel launches. Returns the numbers."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import lm_batch_stream
    from repro_torch.data.pipeline import prefetch_to_mesh
    from repro_torch.dist.elastic import best_mesh
    from repro_torch.dist.sharding import AxisRules
    from repro_torch.ft.checkpoint import tree_paths
    from repro_torch.kernels import ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import moe_ep

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    mesh = best_mesh(devices=[dev] * MESH_DEVICES, model_parallel=MESH_MODEL)
    cpu_mesh = best_mesh(devices=[torch.device("cpu")] * MESH_DEVICES,
                         model_parallel=MESH_MODEL)
    if mesh.shape != {"data": 4, "model": 2}:
        raise AssertionError(f"best_mesh gave {mesh.shape}")
    dp = mesh.shape["data"]
    rng = np.random.default_rng(SEED + 24)
    res = {}
    ep_calls = []
    orig_ep = moe_ep.moe_apply_ep

    def counted(*a, **kw):
        ep_calls.append(1)
        return orig_ep(*a, **kw)

    def merged(calls):
        """The expert-parallel choices as the sorted path's: one [T, K] a
        layer, the data shards' rows in order."""
        return [torch.cat(calls[i:i + dp]) for i in range(0, len(calls), dp)]

    moe_ep.moe_apply_ep = counted
    try:
        res["a"] = {arch: mesh_ep_forward(arch, mesh, cpu_mesh, dev, rng,
                                          merged, ep_calls, smi)
                    for arch in MESH_EP_ARCHS}
        free_card()
        res["a"]["bf16"] = mesh_ep_timed(mesh, dev, rng, smi)
        free_card()
        res["b"] = mesh_train_step(mesh, dev, smi)
        free_card()

        # (c) the MoE mesh train step, card against CPU
        arch = "granite-moe-3b-a800m"
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  n_layers=2)
        fed = {}

        def experts_fed(grads, calls):
            """Every expert a layer's forward routed a token to has a
            nonzero gradient in that layer's slice of each expert leaf
            (the forward's choices: the first ``dp`` calls a layer)."""
            for path, g in tree_paths(grads):
                if "experts_" not in path:
                    continue
                for layer in range(cfg.n_layers):
                    used = torch.unique(torch.cat(
                        calls[layer * dp:(layer + 1) * dp]).flatten())
                    zero = [int(e) for e in used
                            if not float(g[layer, e].abs().max()) > 0]
                    if zero:
                        raise AssertionError(f"{arch} EP: zero gradients of "
                                             f"{path} layer {layer} experts "
                                             f"{zero}")
                    fed[(path, layer)] = int(used.numel())
        ep_calls.clear()
        res["c"] = lm_step_against_cpu(
            f"{arch} (n_layers=2, full width)", cfg, dev, smi,
            meshes=(mesh, cpu_mesh), shape=(MESH_EP_BATCH, MESH_EP_SEQ),
            on_card=experts_fed)
        if len(ep_calls) < 2 * cfg.n_layers or not fed:
            raise AssertionError(f"{arch} mesh step: {len(ep_calls)} "
                                 f"expert-parallel calls, {len(fed)} leaves")
        log(f"train {arch} mesh step: {len(ep_calls)} expert-parallel calls "
            f"(card and CPU, remat's recompute included); nonzero gradients "
            f"on every fed expert of {len(fed)} leaf layers ("
            + ", ".join(sorted({str(v) for v in fed.values()}))
            + " experts fed a layer)")
        free_card()
    finally:
        moe_ep.moe_apply_ep = orig_ep

    res["d"] = mesh_pipeline(dev, smi)
    free_card()

    # (e) the launcher's mesh flag and the mesh-placed batches
    args = ["--arch", LM_TRAIN_ARCH, "--reduced", "--steps", "3", "--batch",
            "8", "--seq", "128", "--log-every", "1", "--device", dev.type]
    one = train_main(args + ["--model-parallel", "1"])["losses"]
    two = train_main(args + ["--model-parallel", "2"])["losses"]
    if one != two or len(one) != 3:
        raise AssertionError(f"--model-parallel 2 {two} against 1 {one}")
    cfg = get_config(LM_TRAIN_ARCH).reduced()
    stream = prefetch_to_mesh(lm_batch_stream((1, 0), cfg, 8, 128,
                                              device=dev), mesh, AxisRules())
    # the reference's shard_batch spec on a (data, model) mesh: the batch
    # dim on "data", the rest replicated
    for _ in range(2):
        b = next(stream)["tokens"]
        if (b.device.type != dev.type or b.sharding.mesh is not mesh
                or tuple(b.sharding.spec) != ("data", None)):
            raise AssertionError(f"prefetch_to_mesh: {b.device} "
                                 f"{b.sharding.spec}")
    stream.close()
    for _ in stream:
        pass
    res["e"] = one
    log(f"mesh (e) launch.train --reduced --model-parallel 2 (one card: "
        f"mesh {{'data': 1, 'model': 1}}) repeats --model-parallel 1 "
        f"bitwise: " + ", ".join(repr(v) for v in two) + "; "
        f"prefetch_to_mesh batches on {dev} with spec ('data', None) "
        f"[{smi}]")

    n = {k: v for k, v in ops.launch_counts().items() if v}
    if n:
        raise AssertionError(f"phase 5i launched hand-written kernels {n}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 5i took {res['seconds']:.1f} s; no hand-written kernel "
        f"launched")
    return res


def main() -> int:
    import functools

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
    from repro_torch.configs.recurrentgemma_9b import CONFIG as RGLRU_CONFIG
    from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV6_CONFIG
    from repro_torch.core.delta import DeltaState, delta_encode
    from repro_torch.core.deltagru import deltagru_step, init_deltagru_state
    from repro_torch.core.deltarglru import init_deltarglru_model
    from repro_torch.core.deltarwkv import init_deltarwkv_model
    from repro_torch.core.program import (compile_delta_program,
                                          compile_deltagru)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.delta_spmv import (delta_spmv, delta_spmv_ref,
                                                pack_spmv_weights,
                                                spmv_launch_plan)
    from repro_torch.kernels.delta_step_f32 import f32_step_plan
    from repro_torch.kernels.deltagru_cell import (deltagru_act,
                                                   deltagru_act_plan,
                                                   deltagru_act_ref)
    from repro_torch.kernels.rglru_scan import (rglru_scan,
                                                rglru_scan_batched_ref,
                                                rglru_scan_plan)
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan,
                                                rwkv6_scan_batched_ref,
                                                rwkv6_scan_plan)
    from repro_torch.kernels.delta_q8 import (deltagru_q8_step,
                                              deltagru_q8_step_ref,
                                              deltalstm_q8_step,
                                              deltalstm_q8_step_ref,
                                              lut_activation_grid,
                                              lut_activation_grid_ref,
                                              pack_delta_weights_q8,
                                              q8_launch_plan)
    from repro_torch.kernels.deltagru_seq import (deltagru_seq_step,
                                                  deltagru_seq_step_ref)
    from repro_torch.kernels.deltalstm_seq import (deltalstm_seq_step,
                                                   deltalstm_seq_step_ref)
    from repro_torch.models.gru_rnn import (PAPER_NETWORKS, GruTaskConfig,
                                            init_gru_model, init_lstm_model)
    from repro_torch.quant.export import quantize_delta_model
    from repro_torch.serve import resilience
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
    for src, text in sorted(logs.items()):
        for line in ptxas_summary(text):
            log(f"  {src}: {line}")

    cfg = CONFIG_2L768H
    backends = ("fused", "fused_q8", "fused_q4")
    models = {"gru": init_gru_model(SEED, cfg, device="cuda"),
              "lstm": init_lstm_model(SEED, cfg, device="cuda")}
    models_cpu = {"gru": init_gru_model(SEED, cfg, device="cpu"),
                  "lstm": init_lstm_model(SEED, cfg, device="cpu")}
    # the main paths: the GRU through compile_deltagru, the LSTM through
    # compile_delta_program(cell="lstm")
    progs = {("gru", be): compile_deltagru(models["gru"], be)
             for be in backends}
    progs.update({("lstm", be): compile_delta_program(models["lstm"], be,
                                                      cell="lstm")
                  for be in backends})
    cpu_progs = {(cell, be): compile_delta_program(models_cpu[cell], be,
                                                   cell=cell, device="cpu")
                 for cell, be in progs}
    kernel_of = {("gru", "fused"): ops.DELTAGRU_SEQ_F32,
                 ("gru", "fused_q8"): ops.DELTA_Q8_GRU_I8,
                 ("gru", "fused_q4"): ops.DELTA_Q8_GRU_I4,
                 ("lstm", "fused"): ops.DELTALSTM_SEQ_F32,
                 ("lstm", "fused_q8"): ops.DELTA_Q8_LSTM_I8,
                 ("lstm", "fused_q4"): ops.DELTA_Q8_LSTM_I4}
    gru_q8 = (deltagru_q8_step, deltagru_q8_step_ref)
    lstm_q8 = (deltalstm_q8_step, deltalstm_q8_step_ref)
    step_of = {("gru", "fused"): (deltagru_seq_step, deltagru_seq_step_ref),
               ("gru", "fused_q8"): gru_q8, ("gru", "fused_q4"): gru_q8,
               ("lstm", "fused"): (deltalstm_seq_step,
                                   deltalstm_seq_step_ref),
               ("lstm", "fused_q8"): lstm_q8, ("lstm", "fused_q4"): lstm_q8}
    # the double-buffered instances: (cell, backend) of their unbuffered twin
    buffered = {(cell, be): ops.q8_kernel(3 if cell == "gru" else 4,
                                          8 if be == "fused_q8" else 4, True)
                for cell, be in progs if be != "fused"}
    buffered_path = {"gru": "repro_torch.kernels.delta_q8.deltagru_q8_step"
                            "(buffered=True)",
                     "lstm": "repro_torch.kernels.delta_q8.deltalstm_q8_step"
                             "(buffered=True)"}

    # -- 3. kernels against their plain versions --------------------------
    rng = np.random.default_rng(SEED)
    max_err = {k.name: 0.0 for k in ops.KERNELS}

    def check(name, ok, err, what):
        max_err[name] = max(max_err[name], err)
        log(f"kernel {name} {what}: max|kernel-plain|={err:.3e} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"({what})")

    def max_diff(xs, ys):
        return max(float((x.cpu() - y.cpu()).abs().max())
                   for x, y in zip(xs, ys))

    def same(xs, ys):
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(xs, ys))

    def offset_view(a):
        """``a`` copied into a buffer one float in: contiguous, 4-byte but
        not 16-byte aligned."""
        buf = torch.empty(a.numel() + 4, dtype=a.dtype, device=a.device)
        view = buf[1:1 + a.numel()].view(a.shape)
        view.copy_(a)
        return view

    # deltagru_act at B in {1, 2, 8, 9} and H in {768, 770, 4097} (grids
    # whose last block is ragged), with all operands 16-byte aligned and
    # with each of the four in turn one float into its buffer (4-byte
    # aligned), within TOL_F32 of its plain version on the card and the
    # CPU; every case launched twice, the two results bitwise equal
    n_act = 0
    for b in (1, 2, 8, 9):
        for h in (768, 770, 4097):
            act = [rng.normal(0, 2, (b, 4 * h)), rng.normal(0, 1, (b, 3 * h)),
                   rng.normal(0, 1, (b, 3 * h)), rng.uniform(-1, 1, (b, h))]
            act = [torch.from_numpy(a.astype(np.float32)) for a in act]
            gpu = [a.to(dev) for a in act]
            for moved in (None, 0, 1, 2, 3):
                ins = list(gpu)
                if moved is not None:
                    ins[moved] = offset_view(gpu[moved])
                plan = deltagru_act_plan(b, h)
                k = deltagru_act(*ins)
                k2 = deltagru_act(*ins)
                r = deltagru_act_ref(*ins)
                c = deltagru_act_ref(*act)
                torch.cuda.synchronize()
                err, err_c = max_diff(k, r), max_diff(k, c)
                twice = same(k, k2)
                where = ("all 16-byte aligned" if moved is None else
                         f"{('m_prev', 'zx', 'zh', 'h_prev')[moved]} 4-byte "
                         "aligned")
                check(ops.DELTAGRU_ACT_F32.name,
                      err <= TOL_F32 and err_c <= TOL_F32 and twice, err,
                      f"[{b}, 4*{h}] {where} ({plan.threads} threads a "
                      f"block, grid {plan.grid}), "
                      f"within {TOL_F32} on the card and the CPU (CPU: "
                      f"{err_c:.3e}), two launches bitwise equal {twice}")
                n_act += 1
    log(f"deltagru_act cases: {n_act}, each launched twice")
    # ops.deltagru_cell_fused (two unpacked spmvs, I = 40 with its ragged
    # edge and I = 768, then deltagru_act) against the dense GRU step
    h_dim = cfg.hidden_size
    for li, p in enumerate(models["gru"]["gru"]):
        st = init_deltagru_state(p, (8,))
        st = st._replace(
            h=torch.from_numpy(rng.uniform(-1, 1, (8, h_dim)).astype(
                np.float32)).to(dev),
            h_mem=DeltaState(torch.from_numpy(rng.uniform(
                -1, 1, (8, h_dim)).astype(np.float32)).to(dev)))
        x = torch.from_numpy(rng.normal(0, 1, (8, p.input_size)).astype(
            np.float32)).to(dev)
        want = deltagru_step(p, st, x, THETA, THETA, backend="dense")
        dx = delta_encode(x, st.x_mem, THETA).delta
        dh = delta_encode(st.h, st.h_mem, THETA).delta
        got = ops.deltagru_cell_fused(p.w_x, p.w_h, st.m, st.h, dx, dh)
        torch.cuda.synchronize()
        err = max_diff(got, (want.state.m, want.h))
        check(ops.DELTAGRU_ACT_F32.name, err <= TOL_F32, err,
              f"ops.deltagru_cell_fused layer {li} (I={p.input_size}) "
              "against the dense GRU step")

    def walk_sets(lay, u, b):
        """The fired sets of the walk's tails: exactly 0, 1, U - 1, U, U + 1
        and all column blocks (U: the blocks one unrolled group of the walk
        covers), a group across the x/h seam and, at B > 1, every block
        fired by one stream other than stream 0 alone. Returns the counts,
        the seam group and ``(fired blocks, solo)`` pairs."""
        nbk = lay.nbk
        seam = tuple(range(max(0, lay.nbk_x - 2), min(nbk, lay.nbk_x + 2)))
        counts = sorted({n for n in (0, 1, u - 1, u, u + 1, nbk)
                         if 0 <= n <= nbk})
        sets = [(tuple(sorted(rng.choice(nbk, n, replace=False))), False)
                for n in counts] + [(seam, False)]
        if b > 1:
            sets.append((tuple(range(nbk)), True))
        return counts, seam, sets

    # fp32: the same tails, B = 1 (one-stream instance), 2, 8 (tile) and 9
    # (two tile passes), within TOL_F32 of the plain version on the card
    # and on the CPU
    n_f32 = 0
    for (cell, be), prog in progs.items():
        if be != "fused":
            continue
        kern, ref = step_of[(cell, be)]
        for li, lay in enumerate(prog.layouts):
            lay_cpu = cpu_progs[(cell, be)].layouts[li]
            for b in (1, 2, 8, 9):
                plan = f32_step_plan(lay.block_k, lay.ip, lay.ip + lay.hk,
                                     lay.hidden_size, b)
                counts, seam, sets = walk_sets(lay, plan.blocks_per_group, b)
                err = err_c = 0.0
                for fired, solo in sets:
                    args = [torch.from_numpy(a) for a in fired_inputs(
                        rng, b, lay, fired, solo, quant=False)]
                    gpu = [a.to(dev) for a in args]
                    k = run_step(cell, kern, lay, gpu)
                    r = run_step(cell, ref, lay, gpu)
                    c = run_step(cell, ref, lay_cpu, args)
                    torch.cuda.synchronize()
                    err = max(err, max_diff(k, r))
                    err_c = max(err_c, max_diff(k, c))
                n_f32 += len(sets)
                solo = ", every block in one stream > 0" if b > 1 else ""
                check(kernel_of[(cell, be)].name,
                      err <= TOL_F32 and err_c <= TOL_F32, err,
                      f"layer {li} B={b} ({plan.instance}, "
                      f"U={plan.blocks_per_group}): fired blocks {counts} of "
                      f"{lay.nbk}, {list(seam)} across the seam{solo}, "
                      f"within {TOL_F32} on the card and the CPU")
    log(f"fp32 walk cases: {n_f32} fired sets")

    def q8_cases(cell, kern, ref, lay, lay_cpu, b, fired_sets):
        """The unbuffered and buffered step on each fired set, against the
        plain version on the card and on the CPU: ``(unbuffered ok,
        buffered ok, max|kernel - plain|, max|buffered - plain|)``.
        ``fired_sets`` holds ``(fired blocks, solo)`` pairs
        (``fired_inputs``)."""
        ok = ok_b = True
        err = err_b = 0.0
        for fired, solo in fired_sets:
            args = [torch.from_numpy(a)
                    for a in fired_inputs(rng, b, lay, fired, solo)]
            gpu = [a.to(dev) for a in args]
            k = run_step(cell, kern, lay, gpu)
            kb = run_step(cell, functools.partial(kern, buffered=True), lay,
                          gpu)
            r = run_step(cell, ref, lay, gpu)
            c = run_step(cell, ref, lay_cpu, args)
            torch.cuda.synchronize()
            ok = ok and same(k, r) and same(k, c)
            ok_b = ok_b and same(kb, k) and same(kb, c)
            err = max(err, max_diff(k, r))
            err_b = max(err_b, max_diff(kb, r))
        return ok, ok_b, err, err_b

    # int8 / int4: exactly 0, 1, U - 1, U, U + 1 and all column blocks
    # fired, U the fired blocks one unrolled group of the walk covers (the
    # tails of the unroll and of the int4 two-blocks-a-load split), and a
    # group across the x/h seam; B = 1 (one-stream instance), 2, 8 (tile)
    # and 9 (two tile passes). At B > 1 one more set fires every block,
    # each in one stream other than stream 0 alone: the fired list is the
    # union over the streams of a pass, not stream 0's blocks
    n_q8 = 0
    for (cell, be), prog in progs.items():
        if be == "fused":
            continue
        kern, ref = step_of[(cell, be)]
        gates = 3 if cell == "gru" else 4
        for li, lay in enumerate(prog.layouts):
            lay_cpu = cpu_progs[(cell, be)].layouts[li]
            nbk = lay.nbk
            for b in (1, 2, 8, 9):
                plan = q8_launch_plan(gates, lay.weight_bits, lay.block_k,
                                      lay.ip, lay.ip + lay.hk,
                                      lay.hidden_size, b, False)
                u = plan.blocks_per_group
                counts, seam, sets = walk_sets(lay, u, b)
                ok, ok_b, err, err_b = q8_cases(cell, kern, ref, lay,
                                                lay_cpu, b, sets)
                n_q8 += len(sets)
                solo = ", every block in one stream > 0" if b > 1 else ""
                what = (f"layer {li} B={b} ({plan.instance}, U={u}): fired "
                        f"blocks {counts} of {nbk}, {list(seam)} across "
                        f"the seam{solo}, bitwise on the card and the CPU")
                check(kernel_of[(cell, be)].name, ok, err, what)
                check(buffered[(cell, be)].name, ok_b, err_b,
                      what + ", and equal to the unbuffered kernel")
    log(f"int8/int4 walk cases: {n_q8} fired sets, each through both forms")

    # the LSTM cell state at the Q8.8 rail: gates i, f, g driven to 1.0 by
    # their delta memories, c_prev one step below the rail in stream 0 (it
    # must clip to act_max, never wrap) and near the other rail in stream 1.
    # M = 1.5 * 2**14 in the code domain dequantizes to about 8 (int8) or
    # 150 (int4) and keeps every sum with the Q8.8 products exact in fp32.
    for be in ("fused_q8", "fused_q4"):
        lay = progs[("lstm", be)].layouts[0]
        lay_cpu = cpu_progs[("lstm", be)].layouts[0]
        ins, _ = layer_inputs(rng, 2, lay, 0.1, True)
        h_dim = lay.hidden_size
        ins[0][:, :3 * h_dim] = 24576.0
        ins[2][0], ins[2][1] = 255.5, -255.5
        args = [torch.from_numpy(a) for a in ins]
        gpu = [a.to(dev) for a in args]
        k = deltalstm_q8_step(lay, *gpu)
        kb = deltalstm_q8_step(lay, *gpu, buffered=True)
        r = deltalstm_q8_step_ref(lay, *gpu)
        c = deltalstm_q8_step_ref(lay_cpu, *args)
        torch.cuda.synchronize()
        at_rail = bool((k[2][0] == lay.act_max).all())
        log(f"saturating cell state {be}: c[0] max {float(k[2][0].max())} "
            f"(act_max {lay.act_max}), all at the rail {at_rail}, "
            f"c[1] min {float(k[2][1].min())}")
        check(kernel_of[("lstm", be)].name,
              at_rail and same(k, r) and same(k, c), max_diff(k, r),
              "saturating c")
        check(buffered[("lstm", be)].name, same(kb, k) and same(kb, c),
              max_diff(kb, r), "saturating c")

    # narrow layouts at the first layer's shape: block rows that are not a
    # multiple of 16 bytes run the narrow-load instance, and the buffered
    # form fills its ring without tensor copies: cp.async of 8 bytes (int8
    # block_k 8, int4 block_k 16), of 4 bytes (int8 block_k 4) or 2-byte
    # copies (int4 block_k 4). Each bitwise against the plain version on
    # the card and the CPU, the buffered form against the unbuffered one
    narrow = {8: (8, 4), 4: (16, 4)}
    for cell in ("gru", "lstm"):
        gates = 3 if cell == "gru" else 4
        kern, ref = step_of[(cell, "fused_q8")]
        p0 = models_cpu[cell][cell][0]
        for bits, block_ks in narrow.items():
            for block_k in block_ks:
                lay_cpu = pack_delta_weights_q8(p0.w_x, p0.w_h, p0.b,
                                                gates=gates, block_k=block_k,
                                                weight_bits=bits)
                lay = lay_cpu.to(dev)
                nbk = lay.nbk
                counts = (0, 1, 5, nbk)
                sets = [(tuple(sorted(rng.choice(nbk, n, replace=False))),
                         False) for n in counts]
                ok = ok_b = True
                err = err_b = 0.0
                for b in (1, 9):
                    plan = q8_launch_plan(gates, bits, block_k, lay.ip,
                                          lay.ip + lay.hk, lay.hidden_size,
                                          b, True)
                    o, o_b, e, e_b = q8_cases(cell, kern, ref, lay, lay_cpu,
                                              b, sets)
                    ok = ok and o and plan.instance == "narrow"
                    ok_b = ok_b and o_b
                    err, err_b = max(err, e), max(err_b, e_b)
                what = (f"narrow layout block_k={block_k} "
                        f"({plan.vector_bytes}-byte loads), B in (1, 9), "
                        f"fired blocks {list(counts)} of {nbk}: bitwise on "
                        f"the card and the CPU")
                check(ops.q8_kernel(gates, bits, False).name, ok, err, what)
                check(ops.q8_kernel(gates, bits, True).name, ok_b, err_b,
                      f"{what}, the ring filled by {plan.fill} "
                      f"({plan.copy_bytes} B), equal to the unbuffered "
                      f"kernel")

    # the narrow rings again with a cold L2: flushed before each buffered
    # launch, a stage's copies come from device memory and land late
    # enough that a consumer that read a stage before its barrier said the
    # copies were in would see the stage's old bytes (with the L2 warm,
    # such a read came too late to tell). Each narrow layout of the GRU,
    # B in (1, 9), 30 launches each on every block or half of them fired,
    # each bitwise equal to the unbuffered kernel
    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32, device=dev)
    flush.fill_(1.0)
    sink = torch.empty((), dtype=torch.float32, device=dev)
    kern = step_of[("gru", "fused_q8")][0]
    p0 = models_cpu["gru"]["gru"][0]
    for bits, block_ks in narrow.items():
        for block_k in block_ks:
            lay = pack_delta_weights_q8(p0.w_x, p0.w_h, p0.b, gates=3,
                                        block_k=block_k,
                                        weight_bits=bits).to(dev)
            ok, err = True, 0.0
            for b in (1, 9):
                plan = q8_launch_plan(3, bits, block_k, lay.ip,
                                      lay.ip + lay.hk, lay.hidden_size, b,
                                      True)
                for rep in range(30):
                    n = lay.nbk if rep % 2 == 0 else lay.nbk // 2
                    fired = tuple(sorted(rng.choice(lay.nbk, n,
                                                    replace=False)))
                    gpu = [torch.from_numpy(a).to(dev)
                           for a in fired_inputs(rng, b, lay, fired)]
                    k = run_step("gru", kern, lay, gpu)
                    torch.sum(flush, dim=0, out=sink)
                    kb = run_step("gru", functools.partial(kern,
                                                           buffered=True),
                                  lay, gpu)
                    torch.cuda.synchronize()
                    ok = ok and same(kb, k)
                    err = max(err, max_diff(kb, k))
            check(ops.q8_kernel(3, bits, True).name, ok, err,
                  f"narrow layout block_k={block_k}, the ring filled by "
                  f"{plan.fill} ({plan.stages} stages), B in (1, 9), 30 "
                  "launches each after an L2 flush: bitwise equal to the "
                  "unbuffered kernel")

    # the LM-path kernels: delta_spmv at the RWKV6 and RG-LRU layer shapes
    # ([I -> O]; the decay LoRA's 64 rows in a 128-padded layout, whose k
    # blocks the plan splits over a cluster), two unpacked ragged edges
    # (I = 1000: 16-byte loads, the last block masked; I = 999: ldw % 4 != 0,
    # the narrow instance) and a narrow split (I = 1002 -> 130), fp32 and
    # bf16, B in {1, 2, 8, 9}, on exactly 0, 1, U - 1, U, U + 1 and all
    # fired blocks (U: the blocks one unrolled group of the walk covers)
    # and, at B > 1, every block fired by one stream other than stream 0
    # alone; every case launched twice, the two results bitwise equal
    spmv_shapes = [("2048->2048", 2048, 2048, True),
                   ("2048->64", 2048, 64, True),
                   ("4096->4096", 4096, 4096, True),
                   ("1000->999 unpacked", 1000, 999, False),
                   ("999->1000 unpacked", 999, 1000, False),
                   ("1002->130 unpacked", 1002, 130, False)]
    spmv_kinfo = {torch.float32: (ops.DELTA_SPMV_F32, TOL_F32),
                  torch.bfloat16: (ops.DELTA_SPMV_BF16, TOL_BF16)}
    spmv_kinfo_all = [k for k, _ in spmv_kinfo.values()]
    n_spmv = 0
    for label, i_dim, o_dim, packed in spmv_shapes:
        w32 = torch.from_numpy(rng.normal(0, i_dim ** -0.5, (
            o_dim, i_dim)).astype(np.float32))
        nbk = -(-i_dim // 128)
        for dtype, (kinfo, tol) in spmv_kinfo.items():
            w = w32.to(dtype)
            w_op = (pack_spmv_weights(w) if packed else w).to(dev)
            w_dev = w.to(dev)
            for b in (1, 2, 8, 9):
                plan = spmv_launch_plan(o_dim, i_dim, w_op.shape[1], 128, b,
                                        dtype)
                u = plan.blocks_per_group
                counts = sorted({n for n in (0, 1, u - 1, u, u + 1, nbk)
                                 if 0 <= n <= nbk})
                sets = [(tuple(sorted(rng.choice(nbk, n, replace=False))),
                         False) for n in counts]
                if b > 1:
                    sets.append((tuple(range(nbk)), True))
                err = err_c = err_abs = 0.0
                twice = True
                for fired, solo in sets:
                    dx, acc = (torch.from_numpy(a).to(dtype) for a in
                               spmv_fired(rng, i_dim, o_dim, b, fired, solo))
                    gpu = [w_op, dx.to(dev), acc.to(dev)]
                    kw = dict(packed=packed, out_dim=o_dim if packed else None)
                    k = delta_spmv(*gpu, **kw)
                    k2 = delta_spmv(*gpu, **kw)
                    r = delta_spmv_ref(w_dev, gpu[1], gpu[2])
                    c = delta_spmv_ref(w, dx, acc)
                    torch.cuda.synchronize()
                    err = max(err, scaled_err(k.float(), r.float()))
                    err_c = max(err_c, scaled_err(k.float(), c.float()))
                    err_abs = max(err_abs, max_diff([k.float()], [r.float()]))
                    twice = (twice and torch.equal(k, k2)
                             and k.dtype == r.dtype == c.dtype)
                n_spmv += len(sets)
                solo = ", every block in one stream > 0" if b > 1 else ""
                check(kinfo.name, err <= tol and err_c <= tol and twice,
                      err_abs,
                      f"[{label}] B={b} ({plan.instance}, split "
                      f"{plan.split}, U={u}): fired blocks {counts} of "
                      f"{nbk}{solo}, within {tol:.3g} of max(1, |plain|) on "
                      f"the card and the CPU (scaled {max(err, err_c):.3e}), "
                      f"two launches bitwise equal {twice}")
    log(f"delta_spmv walk cases: {n_spmv} fired sets, each launched twice")
    # the scans: rwkv6_scan at B in {1, 2, 8, 9} (one stream, two, the
    # 8-slot batcher, more units than one block a unit) x T in {1, 37, 128}
    # x H in {32, 3} (the main path's heads, and fewer heads than the SMs),
    # with s0 and with a zero state (s0=None), within TOL_F32 of its plain
    # version on the card and the CPU; rglru_scan at W in {4096, 4094, 4097}
    # (the 16-byte path, and ragged rows of the 4-byte path) over the same B
    # and T, with h0 and without, bitwise equal to its plain version on the
    # card and within TOL_F32 of it on the CPU (PyTorch's float32 sqrt on
    # the CPU is not correctly rounded: up to an ulp off); each also with an
    # operand that is a contiguous view one float into its buffer (4-byte
    # aligned: the 4-byte path). Every case launched twice, the two results
    # bitwise equal
    def scan_case(kinfo, kern, ref, cpu_args, dev_args, exact, what):
        """``exact``: bitwise equal to the plain version on the card (and
        within TOL_F32 of it on the CPU, whose float32 sqrt is not
        correctly rounded); else within TOL_F32 of both."""
        k = kern(*dev_args)
        k2 = kern(*dev_args)
        r = ref(*dev_args)
        c = ref(*cpu_args)
        torch.cuda.synchronize()
        twice = same(k, k2)
        err_c = max(scaled_err(a, bb) for a, bb in zip(k, c))
        ok = err_c <= TOL_F32 and (
            same(k, r) if exact
            else max(scaled_err(a, bb) for a, bb in zip(k, r)) <= TOL_F32)
        check(kinfo.name, ok and twice, max_diff(k, r),
              f"{what} (CPU: scaled {err_c:.3e}), two launches bitwise "
              f"equal {twice}")

    n_scan = 0
    for b in (1, 2, 8, 9):
        for t in (1, 37, 128):
            for h in (32, 3):
                shape = (b, h, t, 64)
                wkv = [rng.normal(0, 1, shape), rng.normal(0, 1, shape),
                       rng.normal(0, 1, shape),
                       np.exp(-np.exp(rng.normal(-3, 1.5, shape))),
                       rng.normal(0, 0.1, (h, 64)),
                       rng.normal(0, 1, (b, h, 64, 64))]
                wkv = [torch.from_numpy(a.astype(np.float32)) for a in wkv]
                gpu = [a.to(dev) for a in wkv]
                plan = rwkv6_scan_plan(b, h, t, 64)
                for with_s0 in (True, False):
                    n = 6 if with_s0 else 5
                    scan_case(ops.RWKV6_SCAN_F32, rwkv6_scan,
                              rwkv6_scan_batched_ref, wkv[:n], gpu[:n],
                              False,
                              f"[{b}, {h}, {t}, 64] "
                              f"{'with s0' if with_s0 else 's0=None'} "
                              f"({plan.cols} columns a block, grid "
                              f"{plan.grid} for {plan.units} units), within "
                              f"{TOL_F32} of max(1, |plain|) on the card "
                              "and the CPU")
                    n_scan += 1
                if (b, t) in ((1, 1), (2, 37)):
                    # the 4-byte path: r and s0 one float into their buffers
                    mis = [offset_view(gpu[0])] + gpu[1:5] + [
                        offset_view(gpu[5])]
                    scan_case(ops.RWKV6_SCAN_F32, rwkv6_scan,
                              rwkv6_scan_batched_ref, wkv, mis, False,
                              f"[{b}, {h}, {t}, 64] r and s0 4-byte aligned "
                              f"(4-byte loads), within {TOL_F32} on the "
                              "card and the CPU")
                    n_scan += 1
            for w in (4096, 4094, 4097):
                shape = (b, t, w)
                lru = [rng.normal(0, 1, shape),
                       1 / (1 + np.exp(-rng.normal(2, 1, shape))),
                       rng.normal(0, 1, (b, w))]
                lru = [torch.from_numpy(a.astype(np.float32)) for a in lru]
                gpu = [a.to(dev) for a in lru]
                plan = rglru_scan_plan(b, t, w)
                for with_h0 in (True, False):
                    n = 3 if with_h0 else 2
                    scan_case(ops.RGLRU_SCAN_F32, rglru_scan,
                              rglru_scan_batched_ref, lru[:n], gpu[:n], True,
                              f"[{b}, {t}, {w}] "
                              f"{'with h0' if with_h0 else 'h0=None'} "
                              f"({plan.vec * 4}-byte loads, {plan.threads} "
                              f"threads a block, grid {plan.grid}), bitwise "
                              "on the card")
                    n_scan += 1
                if w == 4096 and t in (1, 37):
                    for i in range(3):     # x, a and h0 in turn
                        mis = list(gpu)
                        mis[i] = offset_view(gpu[i])
                        scan_case(ops.RGLRU_SCAN_F32, rglru_scan,
                                  rglru_scan_batched_ref, lru, mis, True,
                                  f"[{b}, {t}, {w}] {'xah'[i]}"
                                  f"{'' if i < 2 else '0'} 4-byte aligned "
                                  "(4-byte loads), bitwise on the card")
                        n_scan += 1
    # row 9b, rwkv6_scan's bf16 instance (bf16 r, k, v; fp32 w, u, s0): B
    # in {1, 4, 9} (one stream, the LM engine's 4 slots, more units than
    # blocks at H = 32) x T in {1, 37, 128} x H in {32, 3}, with s0 and
    # without, and r one element into its buffer (2-byte aligned: the scalar
    # loads); within TOL_F32 of the plain version on the card and the CPU,
    # which round k v to bf16 as the kernel does
    bf16 = torch.bfloat16
    for b in (1, 4, 9):
        for t in (1, 37, 128):
            for h in (32, 3):
                shape = (b, h, t, 64)
                wkv = [torch.from_numpy(rng.normal(0, 1, shape).astype(
                    np.float32)).to(bf16) for _ in range(3)]
                wkv += [torch.from_numpy(a.astype(np.float32)) for a in (
                    np.exp(-np.exp(rng.normal(-3, 1.5, shape))),
                    rng.normal(0, 0.1, (h, 64)),
                    rng.normal(0, 1, (b, h, 64, 64)))]
                gpu = [a.to(dev) for a in wkv]
                plan = rwkv6_scan_plan(b, h, t, 64, bf16)
                for with_s0 in (True, False):
                    n = 6 if with_s0 else 5
                    scan_case(ops.RWKV6_SCAN_BF16, rwkv6_scan,
                              rwkv6_scan_batched_ref, wkv[:n], gpu[:n],
                              False,
                              f"bf16 r k v [{b}, {h}, {t}, 64] "
                              f"{'with s0' if with_s0 else 's0=None'} "
                              f"(grid {plan.grid} for {plan.units} units), "
                              f"within {TOL_F32} of max(1, |plain|) on the "
                              "card and the CPU")
                    n_scan += 1
                if t == 37:
                    mis = [offset_view(gpu[0])] + gpu[1:]
                    scan_case(ops.RWKV6_SCAN_BF16, rwkv6_scan,
                              rwkv6_scan_batched_ref, wkv, mis, False,
                              f"bf16 r k v [{b}, {h}, {t}, 64], r 2-byte "
                              f"aligned (scalar loads), within {TOL_F32} on "
                              "the card and the CPU")
                    n_scan += 1
    log(f"scan cases: {n_scan}, each launched twice")
    phase3 = ops.launch_counts()

    # -- 4. exhaustive activation grid ------------------------------------
    lay_q = progs[("gru", "fused_q8")].layouts[0]
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
    eager_us = {}
    batch_fps = {}
    # each path's 1-stream engine after its run, its program and task, the
    # launches of one of its steps, and frames for the resilience phase
    # (drawn from a generator of their own: the other phases' inputs stay)
    main_engines = {}
    res_rng = np.random.default_rng(SEED + 1)

    for (cell, be), prog in progs.items():
        path = f"{cell} {be}"
        kinfo = kernel_of[(cell, be)]
        # warm-up (cuBLAS handle, allocator), then the counted runs; each
        # engine captures its step at construction
        DeltaStreamEngine(prog, task).step_many(frames[:4])
        torch.cuda.synchronize()

        eng = DeltaStreamEngine(prog, task)
        ref = DeltaStreamEngine(prog, task)
        t0 = time.perf_counter()
        ref_outs = eager_steps(ref, frames)
        torch.cuda.synchronize()
        eager_us[path] = 1e6 * (time.perf_counter() - t0) / N_FRAMES
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = eng.step_many(frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall_us[path] = 1e6 * (time.perf_counter() - t0) / N_FRAMES
        n1 = ops.launch_counts()
        want = N_FRAMES * cfg.num_layers
        if n1[kinfo.name] != want or sum(n1.values()) != want:
            raise AssertionError(f"{path}: launches {n1}, want {want} of "
                                 f"{kinfo.name}")
        graph_check(path, eng, N_FRAMES)
        log(graph_against_eager(path, eng, ref, outs, ref_outs))
        main_engines[path] = (eng, prog, task, {kinfo.name: cfg.num_layers},
                              smooth_frames(res_rng, 41, 1,
                                            cfg.input_size)[:, 0])

        eng8 = DeltaStreamEngine(prog, task, n_streams=8)
        batcher = GruStreamBatcher(eng8)
        for fr in requests:
            batcher.submit(fr)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = batcher.run_until_drained()
        torch.cuda.synchronize()
        batch_fps[path] = sum(len(fr) for fr in requests) / (
            time.perf_counter() - t0)
        n8 = ops.launch_counts()
        want8 = batcher.counters["ticks"] * cfg.num_layers
        if n8[kinfo.name] != want8 or sum(n8.values()) != want8:
            raise AssertionError(f"{path} batcher: launches {n8}, want "
                                 f"{want8}")
        graph_check(f"{path} batcher", eng8, batcher.counters["ticks"])
        launches[kinfo.name] = n1[kinfo.name] + n8[kinfo.name]
        log(f"main path {path}: 1 stream {N_FRAMES} steps -> "
            f"{n1[kinfo.name]} launches; 8-slot batcher {len(done)} "
            f"requests in {batcher.counters['ticks']} ticks -> "
            f"{n8[kinfo.name]} launches; {wall_us[path]:.1f} us/step wall "
            f"(eager {eager_us[path]:.1f}); report "
            f"{eng.report()['gamma_dx']:.4f} gamma_dx; graphs: 1 stream "
            f"{eng.graph_stats}, batcher {eng8.graph_stats}")

        # the same program on the CPU
        cpu_prog = cpu_progs[(cell, be)]
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
            log(f"  {path} vs cpu: theta=0 outputs {err0:.3e}, "
                f"theta={THETA} lockstep state {errs:.3e}")
            if err0 > TOL_F32 or errs > TOL_F32:
                raise AssertionError(f"{path} main path disagrees with the "
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
            log(f"  {path} vs cpu: final state bitwise {same_state}, "
                f"outputs {head_err:.3e}, batcher outputs {b_err:.3e}")
            if not same_state or head_err > TOL_HEAD or b_err > TOL_HEAD:
                raise AssertionError(f"{path} main path disagrees with the "
                                     "CPU program")
        if not torch.isfinite(outs).all():
            raise AssertionError(f"{path}: non-finite outputs")

    # -- 5b. main path of the delta-ized LM cells -------------------------
    lm_specs = {"rwkv6": (init_deltarwkv_model, RWKV6_CONFIG.d_model,
                          RWKV6_CONFIG.n_layers, ops.RWKV6_SCAN_F32),
                "rglru": (init_deltarglru_model, RGLRU_CONFIG.d_model,
                          RGLRU_LAYERS, ops.RGLRU_SCAN_F32)}
    spmv = ops.DELTA_SPMV_F32
    launches[spmv.name] = 0
    lm = {}
    for cell, (init, d, n_layers, scan) in lm_specs.items():
        path = f"{cell} fused"
        t0 = time.perf_counter()
        lm_model = init(SEED, d, n_layers, LM_OUTPUT, device="cpu")
        lm_prog = compile_delta_program(lm_model, "fused", cell=cell)
        lm_cpu = compile_delta_program(lm_model, "fused", cell=cell,
                                       device="cpu")
        torch.cuda.synchronize()
        n_w = sum(t.numel() for p in lm_model[cell] for t in p)
        n_pack = sum(t.numel() for lay in lm_prog.layouts for t in lay)
        log(f"{path}: D={d}, {n_layers} layers, {n_w} weights "
            f"({4 * n_w / 1e9:.3f} GB) + {4 * n_pack / 1e9:.3f} GB packed, "
            f"built and compiled in {time.perf_counter() - t0:.1f} s")
        lm_task = GruTaskConfig(d, d, n_layers, LM_OUTPUT, theta_x=THETA,
                                theta_h=THETA)
        frames_lm = lm_stream(rng, N_FRAMES, d)
        requests_lm = [lm_stream(rng, int(t), d)
                       for t in rng.integers(20, 61, 16)]
        DeltaStreamEngine(lm_prog, lm_task).step_many(frames_lm[:4])
        torch.cuda.synchronize()

        lm_eng = DeltaStreamEngine(lm_prog, lm_task)
        lm_ref = DeltaStreamEngine(lm_prog, lm_task)
        t0 = time.perf_counter()
        lm_ref_outs = eager_steps(lm_ref, frames_lm)
        torch.cuda.synchronize()
        eager_us[path] = 1e6 * (time.perf_counter() - t0) / N_FRAMES
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lm_outs = lm_eng.step_many(frames_lm)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall_us[path] = 1e6 * (time.perf_counter() - t0) / N_FRAMES
        n1 = {k: v for k, v in ops.launch_counts().items() if v}
        want = {spmv.name: 4 * N_FRAMES * n_layers,
                scan.name: N_FRAMES * n_layers}
        if n1 != want:
            raise AssertionError(f"{path}: launches {n1}, want {want}")
        graph_check(path, lm_eng, N_FRAMES)
        log(graph_against_eager(path, lm_eng, lm_ref, lm_outs, lm_ref_outs))
        del lm_ref, lm_ref_outs
        main_engines[path] = (lm_eng, lm_prog, lm_task,
                              {spmv.name: 4 * n_layers, scan.name: n_layers},
                              lm_stream(res_rng, 41, d))

        lm_batcher = GruStreamBatcher(DeltaStreamEngine(lm_prog, lm_task,
                                                     n_streams=8))
        for fr in requests_lm:
            lm_batcher.submit(fr)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        lm_done = lm_batcher.run_until_drained()
        torch.cuda.synchronize()
        batch_fps[path] = sum(len(fr) for fr in requests_lm) / (
            time.perf_counter() - t0)
        ticks = lm_batcher.counters["ticks"]
        n8 = {k: v for k, v in ops.launch_counts().items() if v}
        want8 = {spmv.name: 4 * ticks * n_layers, scan.name: ticks * n_layers}
        if n8 != want8 or len(lm_done) != len(requests_lm):
            raise AssertionError(f"{path} batcher: launches {n8}, want "
                                 f"{want8}; {len(lm_done)} requests done")
        graph_check(f"{path} batcher", lm_batcher.engine, ticks)
        launches[spmv.name] += n1[spmv.name] + n8[spmv.name]
        launches[scan.name] = n1[scan.name] + n8[scan.name]
        lm_rep = lm_eng.report()
        log(f"main path {path}: 1 stream {N_FRAMES} steps -> {n1}; 8-slot "
            f"batcher {len(lm_done)} requests in {ticks} ticks -> {n8}; "
            f"{wall_us[path]:.1f} us/step wall (eager "
            f"{eager_us[path]:.1f}); report gamma_dx "
            f"{lm_rep['gamma_dx']:.4f} gamma_dh {lm_rep['gamma_dh']:.4f}; "
            f"graphs: 1 stream {lm_eng.graph_stats}, batcher "
            f"{lm_batcher.engine.graph_stats}")
        if not torch.isfinite(lm_outs).all():
            raise AssertionError(f"{path}: non-finite outputs")

        # the same program on the CPU: θ = 0 over 50 frames (nothing can
        # flip), then layer by layer in lockstep at θ = 0.25
        lm_task0 = GruTaskConfig(d, d, n_layers, LM_OUTPUT)
        ge = DeltaStreamEngine(lm_prog, lm_task0)
        ce = DeltaStreamEngine(lm_cpu, lm_task0, device="cpu")
        g = ge.step_many(frames_lm[:50])
        c = ce.step_many(frames_lm[:50])
        err0 = max([scaled_err(g, c)] + [
            scaled_err(a, bb) for a, bb in zip(tree_leaves(ge.state),
                                               tree_leaves(ce.state))])
        err_ls, flips, n_ls, in_max = lm_layer_lockstep(
            lm_prog, lm_cpu, frames_lm[:20], THETA, tree_to, tree_leaves)
        log(f"  {path} vs cpu: theta=0 outputs and final state {err0:.3e} "
            f"(scaled), theta={THETA} lockstep {err_ls:.3e} over "
            f"{n_ls - flips} layer steps, {flips} with a flipped firing "
            f"decision; max |layer input| per layer "
            f"{[float(f'{v:.3g}') for v in in_max]}")
        if err0 > TOL_LM or err_ls > TOL_LM or flips > n_ls // 100:
            raise AssertionError(f"{path} main path disagrees with the CPU "
                                 "program")
        lm[cell] = (lm_prog, lm_task, frames_lm)
        del lm_cpu, ge, ce

    # -- 5c. resilience ---------------------------------------------------
    # (a) a checkpoint/restore round trip on each path's 1-stream engine,
    # then corruption and rollback on the restored one; each engine's exact
    # launches, no other kernel
    Recorded = recording(DeltaStreamEngine)
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        for path, (eng, prog_p, task_p, per_step, fr) in main_engines.items():
            ops.reset_launch_counts()
            rt = restore_round_trip(path, eng, prog_p, task_p, fr, Recorded,
                                    os.path.join(tmp, path.replace(" ", "_")))
            n = {k: v for k, v in ops.launch_counts().items() if v}
            want = {k: rt["steps"] * v for k, v in per_step.items()}
            if n != want:
                raise AssertionError(f"{path} round trip: launches {n}, "
                                     f"want {want}")
            for k, v in n.items():
                launches[k] += v
            log(f"resilience {path}: checkpoint {rt['ckpt_ms']:.3f} ms, "
                f"restore {rt['restore_ms']:.3f} ms (capture "
                f"{rt['capture_ms']:.3f} ms), round trip bitwise over 20 "
                "replays, corruption flagged by the next replay, rollback "
                f"bitwise; launches {n} [{smi}]")
        del main_engines

        # (b) the seeded chaos soak through serve_resumable at 2L-768H,
        # fused_q8 on 8 slots: twice on the card, once on the CPU
        q8 = ops.DELTA_Q8_GRU_I8
        soak_prog = quantize_delta_model(models["gru"])
        soak_cpu = quantize_delta_model(models_cpu["gru"], device="cpu")
        runs = []
        saved = resilience.DeltaStreamEngine
        resilience.DeltaStreamEngine = Recorded
        try:
            for k in range(2):
                Recorded.made.clear()
                ops.reset_launch_counts()
                run = chaos_soak(soak_prog, task, dev,
                                 os.path.join(tmp, f"soak{k}"))
                n = {k2: v for k2, v in ops.launch_counts().items() if v}
                made = list(Recorded.made)
                steps = sum(e.graph_stats["replays"]
                            + e.graph_stats["captures"] for e in made)
                if n != {q8.name: steps * cfg.num_layers}:
                    raise AssertionError(f"soak {k}: launches {n}, want "
                                         f"{steps * cfg.num_layers} of "
                                         f"{q8.name}")
                if len(made) != 2 or not all(
                        e.graph_stats["captures"] == 1
                        and e.captured_ptrs == buffer_ptrs(e) for e in made):
                    raise AssertionError(
                        f"soak {k}: engines {[e.graph_stats for e in made]}"
                        ", want 2 (one restored after the crash), each "
                        "one capture over the buffers it still has")
                launches[q8.name] += n[q8.name]
                check_soak(run, f"soak {k} on the card")
                run["restore_capture_ms"] = 1e3 * made[1].graph_stats[
                    "capture_s"]
                runs.append(run)
            cpu_run = chaos_soak(soak_cpu, task, cpu,
                                 os.path.join(tmp, "soak_cpu"))
        finally:
            resilience.DeltaStreamEngine = saved
        check_soak(cpu_run, "soak on the CPU")
        for other, what in ((runs[1], "the second card run"),
                            (cpu_run, "the CPU run")):
            if (other["statuses"] != runs[0]["statuses"]
                    or other["counters"] != runs[0]["counters"]
                    or other["srv"].theta_peak != runs[0]["srv"].theta_peak
                    or other["srv"].tick_no != runs[0]["srv"].tick_no):
                raise AssertionError(
                    f"soak: {what} differs: {other['counters']} against "
                    f"{runs[0]['counters']}")
        checked = soak_reference_check(soak_prog, task, runs[0], dev)
        soak_err = max(
            float(np.abs(np.stack(r.outputs) - np.stack(
                cpu_run["results"][i].outputs)).max())
            for i, r in runs[0]["results"].items() if r.status == "ok")
        if soak_err > TOL_HEAD:
            raise AssertionError(f"soak outputs: card against CPU "
                                 f"{soak_err:.3e} > {TOL_HEAD}")
        for k, run in enumerate(runs):
            srv = run["srv"]
            statuses = {s: sum(v == s for v in run["statuses"].values())
                        for s in ("ok", "shed", "rejected", "quarantined")}
            log(f"soak {k} (fused_q8 2L-768H, 8 slots, serve_resumable): "
                f"{SOAK_ARRIVALS} arrivals in {srv.tick_no} ticks, "
                f"{run['wall_s']:.4f} s wall, {run['ok_frames']} frames of "
                f"ok streams, {run['ok_frames'] / run['wall_s']:.1f} "
                f"frames/s; p99 tick "
                f"wall {1e3 * srv.p99_tick_wall_s():.4f} ms, median "
                f"{1e3 * float(np.median(srv.tick_wall_s)):.4f} ms; restart "
                f"capture {run['restore_capture_ms']:.3f} ms; restarts "
                f"{run['restarts']}; statuses {statuses}; counters "
                f"{run['counters']} [{smi}]")
        log(f"soak: the two card runs and the CPU run agree in every "
            f"status and counter; {checked} ok streams bitwise equal to a "
            f"clean 8-slot run on the card; card against CPU outputs "
            f"{soak_err:.3e}")
        del runs, cpu_run, soak_cpu

    # -- 5d. training: the paper's recipe at 2L-768H ----------------------
    train, batches, opt_cfg = training_phase(dev, PAPER_NETWORKS["2L-768H"])
    launches[ops.DELTA_Q8_GRU_I8.name] += train["serve"]["launches"]

    # -- 5e. the serving fabric -------------------------------------------
    fabric = fabric_phase(dev, models["gru"], ops.DELTA_Q8_GRU_I8,
                          ops.DELTAGRU_SEQ_F32, smi)
    for name, n in fabric["launches"].items():
        launches[name] += n

    # -- 5f. the LM zoo's serving path ------------------------------------
    zoo = lm_phase(dev, smi)
    for name, n in zoo["launches"].items():
        launches[name] = launches.get(name, 0) + n
    for name, err in zoo["max_err"].items():
        max_err[name] = max(max_err[name], err)

    # -- 5g. the rest of the LM zoo: MLA, MoE, cross-attention ------------
    zoo_phase(dev, smi)

    # -- 5h. LM training --------------------------------------------------
    lm_train_phase(dev, smi)

    # -- 5i. the mesh paths -------------------------------------------------
    mesh_phase(dev, smi)

    # -- 6. times on the card ---------------------------------------------
    ops.reset_launch_counts()
    instances = [(kernel_of[key], key, *step_of[key]) for key in progs]
    instances += [(kinfo, key,
                   functools.partial(step_of[key][0], buffered=True),
                   step_of[key][1]) for key, kinfo in buffered.items()]
    rows = {}
    # the floor under a launch: an empty kernel of the q8 build at the main
    # path's grid (the LSTM int8 step at B = 1), two launches a 2-layer step
    lay_f = progs[("lstm", "fused_q8")].layouts[1]
    plan_f = q8_launch_plan(4, 8, lay_f.block_k, lay_f.ip,
                            lay_f.ip + lay_f.hk, lay_f.hidden_size, 1, False)
    empty = _build.load("delta_q8.cu").delta_q8_empty
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    empty.restype = ctypes.c_int

    def empty_launch():
        if empty(plan_f.grid, plan_f.threads,
                 torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("delta_q8_empty launch failed")

    floor = {"ms": 2 * device_ms(empty_launch),
             "cold_ms": 2 * device_ms_cold(empty_launch)}
    log(f"launch floor: two launches of an empty kernel of delta_q8.cu "
        f"({plan_f.grid} blocks of {plan_f.threads} threads): "
        f"{floor['ms']:.5f} ms warm, {floor['cold_ms']:.5f} ms timed as "
        f"the cold rows are [{smi}]")
    for kinfo, (cell, be), kern, ref in instances:
        fp32 = progs[(cell, "fused")].layouts
        for fire in (0.1, 1.0):
            row = {"ms": 0.0, "cold_ms": 0.0, "eager_ms": 0.0,
                   "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0}
            for li, lay in enumerate(progs[(cell, be)].layouts):
                ins, fired_cols = layer_inputs(rng, 1, lay, fire,
                                               be != "fused")
                gpu = [torch.from_numpy(a).to(dev) for a in ins]
                row["ms"] += device_ms(lambda: run_step(cell, kern, lay, gpu))
                row["cold_ms"] += device_ms_cold(
                    lambda: run_step(cell, kern, lay, gpu))
                row["eager_ms"] += eager_ms(
                    lambda: run_step(cell, kern, lay, gpu))
                row["plain_ms"] += device_ms(
                    lambda: run_step(cell, ref, lay, gpu))
                wf = fp32[li].w
                w2 = wf.reshape(-1, wf.shape[-1])
                d_cat = torch.zeros((1, wf.shape[-1]), device=dev)
                acc = torch.zeros((1, w2.shape[0]), device=dev)
                row["library_ms"] += device_ms(
                    lambda: torch.addmm(acc, d_cat, w2.T))
                row["bytes"] += step_bytes(cell, be, lay, fired_cols)
            row["bound_ms"] = 1e3 * row["bytes"] / HBM_BYTES_PER_S
            log(f"time {kinfo.name} B=1 fire={fire} per 2-layer step: kernel "
                f"{row['ms']:.5f} ms warm, {row['cold_ms']:.5f} ms with a "
                f"cold L2 ({row['eager_ms']:.4f} ms launched from Python), "
                f"plain {row['plain_ms']:.5f} ms, addmm "
                f"{row['library_ms']:.5f} ms, bound {row['bound_ms']:.5f} ms "
                f"({row['bytes']} B), launch floor {floor['ms']:.5f} ms "
                f"[{smi}]")
        rows[kinfo.name] = row               # the 100 % firing row
        # the tile instance (8 streams a pass), as the 8-slot batcher
        # launches it: each stream fires ``fire`` of the blocks on its own
        for fire in (0.1, 1.0):
            tile = {"ms": 0.0, "bytes": 0}
            for lay in progs[(cell, be)].layouts:
                ins, fired_cols = layer_inputs(rng, 8, lay, fire,
                                               be != "fused")
                gpu = [torch.from_numpy(a).to(dev) for a in ins]
                tile["ms"] += device_ms(lambda: run_step(cell, kern, lay, gpu))
                tile["bytes"] += step_bytes(cell, be, lay, fired_cols, 8)
            log(f"time {kinfo.name} B=8 (tile) fire={fire} per 2-layer "
                f"step: kernel {tile['ms']:.5f} ms warm, bound "
                f"{1e3 * tile['bytes'] / HBM_BYTES_PER_S:.5f} ms "
                f"({tile['bytes']} B) [{smi}]")
        row["tile_ms"] = tile["ms"]
    def bound(row):
        t_bytes = 1e3 * row["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e3 * row["ops"] / FP32_OPS_PER_S
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"

    def f32(*shape, lo=None):
        a = (rng.normal(0, 1, shape) if lo is None
             else rng.uniform(lo, 1.0, shape))
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    # delta_spmv: the four calls of one layer step of each LM cell at 0 %,
    # ~10 % and 100 % fired, warm (CUDA-graph replay) and with the L2
    # flushed before each call; fp32 (the main path's) and bf16 weights,
    # deltas and accumulator (its addmm in bf16 as library_ms, 2 bytes a
    # weight in the bound)
    lm_shapes = {"rwkv6": [(2048, 2048)] * 3 + [(2048, 64)],
                 "rglru": [(4096, 4096)] * 4}
    for dtype, (kinfo, _) in spmv_kinfo.items():
        size = dtype.itemsize
        spmv_row = {"ms": 0.0, "cold_ms": 0.0, "eager_ms": 0.0,
                    "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0}
        for cell, shapes in lm_shapes.items():
            for fire in (0.0, 0.1, 1.0):
                row = dict.fromkeys(spmv_row, 0.0)
                calls = []
                for i_dim, o_dim in shapes:
                    w, dx, acc, fired_cols = spmv_case(rng, i_dim, o_dim, 1,
                                                       fire)
                    wp = pack_spmv_weights(torch.from_numpy(w)).to(
                        dtype=dtype, device=dev)
                    w, dx, acc = (torch.from_numpy(a).to(dtype=dtype,
                                                         device=dev)
                                  for a in (w, dx, acc))

                    def kern():
                        return delta_spmv(wp, dx, acc, packed=True,
                                          out_dim=o_dim)

                    calls.append(device_ms(kern))
                    row["ms"] += calls[-1]
                    row["cold_ms"] += device_ms_cold(kern)
                    row["eager_ms"] += eager_ms(kern)
                    row["plain_ms"] += device_ms(
                        lambda: delta_spmv_ref(w, dx, acc))
                    row["library_ms"] += device_ms(
                        lambda: torch.addmm(acc, dx, w.T))
                    row["bytes"] += size * (o_dim * fired_cols + i_dim
                                            + 2 * o_dim)
                    row["ops"] += 2 * o_dim * fired_cols
                bound(row)
                log(f"time {kinfo.name} {cell} layer step (4 calls) B=1 "
                    f"fire={fire}: kernel {row['ms']:.5f} ms warm "
                    f"(calls {', '.join(f'{c:.5f}' for c in calls)} ms), "
                    f"{row['cold_ms']:.5f} ms with a cold L2 "
                    f"({row['eager_ms']:.4f} ms launched from Python), plain "
                    f"{row['plain_ms']:.5f} ms, addmm "
                    f"{row['library_ms']:.5f} ms, bound "
                    f"{row['bound_ms']:.5f} ms ({int(row['bytes'])} B, "
                    f"{row['bound_by']}) [{smi}]")
            for key in spmv_row:             # the 100 % firing rows, summed
                spmv_row[key] += row[key]
        bound(spmv_row)
        rows[kinfo.name] = spmv_row

    # the scans and the activation at the main path's shapes, B = 1; no
    # single PyTorch call computes any of the three (library_ms null). The
    # scans also with a cold L2, at B = 8 (the 8-slot batcher's launch), at
    # T = 128 (a prefill, not on the main path), and beside the floor under
    # their launch: an empty kernel of their build at the same grid
    def wkv_args(b, t):
        shape = (b, 32, t, 64)
        return [f32(*shape), f32(*shape), f32(*shape), f32(*shape, lo=0.9),
                f32(32, 64) * 0.1, f32(b, 32, 64, 64)]

    def lru_args(b, t):
        return [f32(b, t, 4096), f32(b, t, 4096, lo=0.5), f32(b, 4096)]

    scans = {
        ops.RWKV6_SCAN_F32.name: (
            rwkv6_scan, rwkv6_scan_batched_ref, wkv_args,
            lambda b, t: 4 * (5 * b * 32 * t * 64 + 32 * 64
                              + 2 * b * 32 * 64 * 64),
            lambda b, t: 7 * b * t * 32 * 64 * 64,
            lambda: rwkv6_scan_plan(1, 32, 1, 64), "rwkv6_scan.cu",
            "rwkv6_scan_empty"),
        ops.RGLRU_SCAN_F32.name: (
            rglru_scan, rglru_scan_batched_ref, lru_args,
            lambda b, t: 4 * (3 * b * t * 4096 + 2 * b * 4096),
            lambda b, t: 6 * b * t * 4096,
            lambda: rglru_scan_plan(1, 1, 4096), "rglru_scan.cu",
            "rglru_scan_empty"),
    }
    for name, (kern, ref, make, nbytes, nops, plan_of, src,
               empty_name) in scans.items():
        args = make(1, 1)
        row = {"ms": device_ms(lambda: kern(*args)),
               "cold_ms": device_ms_cold(lambda: kern(*args)),
               "eager_ms": eager_ms(lambda: kern(*args)),
               "plain_ms": device_ms(lambda: ref(*args)),
               "library_ms": None, "bytes": nbytes(1, 1),
               "ops": nops(1, 1)}
        bound(row)
        plan = plan_of()
        empty_fn = getattr(_build.load(src), empty_name)
        empty_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        empty_fn.restype = ctypes.c_int

        def empty_scan():
            if empty_fn(plan.grid, plan.threads,
                        torch.cuda.current_stream().cuda_stream):
                raise RuntimeError(f"{empty_name} launch failed")

        row["launch_floor_ms"] = device_ms(empty_scan)
        row["launch_floor_cold_ms"] = device_ms_cold(empty_scan)
        log(f"time {name} B=1 T=1: kernel {row['ms']:.5f} ms warm, "
            f"{row['cold_ms']:.5f} ms with a cold L2 "
            f"({row['eager_ms']:.4f} ms launched from Python), plain "
            f"{row['plain_ms']:.5f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bytes']} B, {row['bound_by']}); launch floor (an empty "
            f"kernel of {plan.grid} blocks of {plan.threads} threads) "
            f"{row['launch_floor_ms']:.5f} ms warm, "
            f"{row['launch_floor_cold_ms']:.5f} ms timed cold [{smi}]")
        for key, (b, t) in (("tile", (8, 1)), ("t128", (1, 128))):
            args = make(b, t)
            t_bytes = 1e3 * nbytes(b, t) / HBM_BYTES_PER_S
            t_ops = 1e3 * nops(b, t) / FP32_OPS_PER_S
            row[f"{key}_ms"] = device_ms(lambda: kern(*args))
            row[f"{key}_cold_ms"] = device_ms_cold(lambda: kern(*args))
            row[f"{key}_bound_ms"] = max(t_bytes, t_ops)
            log(f"time {name} B={b} T={t}: kernel {row[f'{key}_ms']:.5f} ms "
                f"warm, {row[f'{key}_cold_ms']:.5f} ms with a cold L2, bound "
                f"{row[f'{key}_bound_ms']:.6f} ms ({nbytes(b, t)} B) [{smi}]")
        rows[name] = row
    # deltagru_act at the 2L-768H width: B = 1, also cold, at B = 8, and
    # beside the floor under its launch (an empty kernel of its build at
    # its grid, launched as it is); then ops.deltagru_cell_fused (two
    # unpacked delta_spmv calls, every column fired, then deltagru_act) at
    # the network's two layer shapes, I = 40 and I = 768
    def act_args(b):
        return [f32(b, 4 * h_dim), f32(b, 3 * h_dim), f32(b, 3 * h_dim),
                f32(b, h_dim)]

    act = act_args(1)
    row = {"ms": device_ms(lambda: deltagru_act(*act)),
           "cold_ms": device_ms_cold(lambda: deltagru_act(*act)),
           "eager_ms": eager_ms(lambda: deltagru_act(*act)),
           "plain_ms": device_ms(lambda: deltagru_act_ref(*act)),
           "library_ms": None, "bytes": 4 * 16 * h_dim, "ops": 30 * h_dim}
    bound(row)
    act8 = act_args(8)
    row["tile_ms"] = device_ms(lambda: deltagru_act(*act8))
    row["tile_bound_ms"] = 8 * row["bound_ms"]
    plan = deltagru_act_plan(1, h_dim)
    act_empty = _build.load("deltagru_cell.cu").deltagru_act_empty
    act_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    act_empty.restype = ctypes.c_int

    def empty_act():
        if act_empty(plan.grid, plan.threads,
                     torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("deltagru_act_empty launch failed")

    row["launch_floor_ms"] = device_ms(empty_act)
    row["launch_floor_cold_ms"] = device_ms_cold(empty_act)
    rows[ops.DELTAGRU_ACT_F32.name] = row
    log(f"time {ops.DELTAGRU_ACT_F32.name} B=1: kernel {row['ms']:.5f} ms "
        f"warm, {row['cold_ms']:.5f} ms with a cold L2 "
        f"({row['eager_ms']:.4f} ms launched from Python), plain "
        f"{row['plain_ms']:.5f} ms, bound {row['bound_ms']:.6f} ms "
        f"({row['bytes']} B, {row['bound_by']}); B=8: {row['tile_ms']:.5f} "
        f"ms, bound {row['tile_bound_ms']:.6f} ms; launch floor (an empty "
        f"kernel of {plan.grid} blocks of {plan.threads} threads) "
        f"{row['launch_floor_ms']:.5f} ms warm, "
        f"{row['launch_floor_cold_ms']:.5f} ms timed cold [{smi}]")
    for p in models["gru"]["gru"]:
        m, hp = f32(1, 4 * h_dim), f32(1, h_dim)
        dx, dh = f32(1, p.input_size), f32(1, h_dim)
        ms = device_ms(lambda: ops.deltagru_cell_fused(p.w_x, p.w_h, m, hp,
                                                       dx, dh))
        log(f"time ops.deltagru_cell_fused I={p.input_size} H={h_dim} B=1, "
            f"every column fired: {ms:.5f} ms warm (two delta_spmv and "
            f"deltagru_act) [{smi}]")

    phase6 = ops.launch_counts()
    for name in ([k.name for k in buffered.values()]
                 + [ops.DELTA_SPMV_BF16.name, ops.DELTAGRU_ACT_F32.name]):
        launches[name] = phase3[name] + phase6[name]

    # the engine per path, through its captured graph and, as before it
    # was one, op by op (eager_steps): kernels a step, device busy, idle
    # share, wall and CUDA-event time a step (torch.profiler over 50 steps
    # of the GRU/LSTM, 10 of the LM paths, which issue thousands of
    # kernels a step), the latency of one step, and the capture's time
    engine_paths = [(f"{cell} {be}", prog, task, frames, 50)
                    for (cell, be), prog in progs.items()]
    engine_paths += [(f"{cell} fused", lm_prog, lm_task, frames_lm, 10)
                     for cell, (lm_prog, lm_task, frames_lm) in lm.items()]
    for path, prog, eng_task, fr, n_prof in engine_paths:
        eng = DeltaStreamEngine(prog, eng_task)
        prof = engine_profile(lambda: eng.step_many(fr[:n_prof]), n_prof)
        lat = step_latencies_us(DeltaStreamEngine(prog, eng_task).step, fr)
        ref = DeltaStreamEngine(prog, eng_task)
        prof_e = engine_profile(lambda: eager_steps(ref, fr[:n_prof]),
                                n_prof)
        lat_e = step_latencies_us(lambda x: eager_steps(ref, x[None]), fr)
        log(f"engine {path} graph: capture {1e3 * eng.graph_stats['capture_s']:.1f} "
            f"ms; frame-to-output latency at 1 stream over {len(lat)} "
            f"frames: median {np.median(lat):.1f} us, p95 "
            f"{np.percentile(lat, 95):.1f} us; step_many {wall_us[path]:.1f} "
            f"us/step; 8-slot batcher {batch_fps[path]:.1f} frames/s; "
            f"profiled: {json.dumps(prof)} [{smi}]")
        log(f"engine {path} eager (op by op): latency median "
            f"{np.median(lat_e):.1f} us, p95 {np.percentile(lat_e, 95):.1f} "
            f"us; step_many {eager_us[path]:.1f} us/step; profiled: "
            f"{json.dumps(prof_e)} [{smi}]")

    # the train step of each stage: wall ms a step (median of the timed
    # steps 2-10, each ended by reading its metrics), frames a second,
    # kernels a step, device busy and idle share (torch.profiler over one
    # step, as engine_profile; also the share against the unprofiled wall),
    # the step cut into forward, backward and Adam, the timed loop's peak
    # memory above what the process held when the loop began (earlier
    # phases' tensors, the batches and the first step's state, which the
    # loop replaces: its activations, gradients and a second state); and
    # the export's time
    for name in ("dense", "qat"):
        tr = train[name]
        st, bt = tr["state"], batches[TRAIN_STEPS - 1]
        wall_ms = float(np.median(tr["step_ms"]))
        frames = bt["features"].shape[0] * bt["features"].shape[1]
        prof = engine_profile(lambda: tr["step"](st, bt), 1)
        split = train_split_ms(st.params, tr["task"], bt, tr["qat"],
                               tr["use_delta"], st.opt, opt_cfg)
        busy_ms = prof["device_busy_us_per_step"] / 1e3
        log(f"time train {name} (2L-768H CTC, B={bt['features'].shape[1]}, "
            f"T={bt['features'].shape[0]}): {wall_ms:.3f} ms a step wall "
            f"(median of steps 2-10; each "
            + ", ".join(f"{v:.3f}" for v in tr["step_ms"])
            + f"), {1e3 * frames / wall_ms:.1f} frames/s; profiled step: "
            f"{prof['kernels_per_step']:.0f} kernels, device busy "
            f"{busy_ms:.3f} ms, idle share {prof['idle_share']:.4f} (wall "
            f"{prof['wall_us_per_step'] / 1e3:.3f} ms under the profiler), "
            f"{1 - busy_ms / wall_ms:.4f} against the unprofiled wall; "
            f"forward {split['forward_ms']:.3f} ms, backward "
            f"{split['backward_ms']:.3f} ms, Adam {split['adam_ms']:.3f} ms; "
            f"peak memory {tr['peak_bytes'] / 2 ** 30:.3f} GiB "
            f"({tr['peak_bytes']} B) above the {tr['base_bytes']} B "
            f"allocated before the loop [{smi}]")
    log(f"time train export: quantize_delta_model of the trained 2L-768H "
        f"stack {train['serve']['export_ms']:.3f} ms [{smi}]")

    # the fabric at 2L-768H (phase 5e (b)): the first run's wall, streams
    # and frames a second and steady tick walls (loadgen_fabric's rule),
    # replays a tick, the second run's profiled ticks, the scale-down
    fb = fabric["b"]
    pr = fb["profile"]
    log(f"time fabric (b) 2L-768H fused_q8, 8 shards x 128: wall "
        f"{fb['wall_s']:.4f} s, {fb['streams_per_s']:.2f} streams/s, "
        f"{fb['frames_per_s']:.2f} frames/s; steady tick p50 "
        f"{fb['p50_tick_ms']:.4f} ms, p99 {fb['p99_tick_ms']:.4f} ms "
        f"(median {fb['median_tick_ms']:.4f}, max {fb['max_tick_ms']:.4f}); "
        f"{fb['replays_per_tick']:.4f} replays a tick; ticks "
        f"{FABRIC_PROFILE_TICKS[0]}-{FABRIC_PROFILE_TICKS[1]} of the second "
        f"run profiled: {pr['kernels_per_tick']:.1f} kernels a tick, device "
        f"busy {pr['device_busy_us_per_tick']:.1f} us a tick, idle share "
        f"{pr['idle_share']:.4f} (wall {pr['wall_us_per_tick']:.1f} us, "
        f"events {pr['event_us_per_tick']:.1f} us a tick under the "
        f"profiler); scale-down (drain checkpoint and remove) "
        f"{fb['scale_ms']:.3f} ms; second run (profiled) wall "
        f"{fb['wall2_s']:.4f} s, tick p50 {fb['p50_tick2_ms']:.4f} ms, p99 "
        f"{fb['p99_tick2_ms']:.4f} ms [{smi}]")
    sp = fabric["shard_profile"]
    log(f"time fabric (b) one shard's replay at B=128 (20 steps): "
        f"{sp['kernels_per_step']:.1f} kernels a step, device busy "
        f"{sp['device_busy_us_per_step']:.1f} us a step, of which the int8 "
        f"tile kernel {sp['match_us_per_step']:.1f} us (2 launches); events "
        f"{sp['event_us_per_step']:.1f} us, wall "
        f"{sp['wall_us_per_step']:.1f} us a step [{smi}]")
    host = fb["host_ms"]
    inside = sum(v for k, v in host.items() if k != "submit")
    log(f"time fabric (b) where the first run's {fb['ticks_ms']:.3f} ms of "
        f"ticks went (host ms): fleet.step (stage and 8 or 7 replays, no "
        f"sync) {host['step']:.3f}, open_stream {host['open_stream']:.3f}, "
        f"host_carry (waits for the replays) {host['host_carry']:.3f}, "
        f"close_stream {host['close_stream']:.3f}, the router's own (shed, "
        f"admit, staging, output rows, one output copy a harvest) "
        f"{fb['ticks_ms'] - inside:.3f}; submits between ticks "
        f"{host['submit']:.3f} of the {1e3 * fb['wall_s']:.3f} ms wall "
        f"[{smi}]")

    entries = []
    for kinfo, (cell, be), _, _ in instances:
        row = rows[kinfo.name]
        entry = {"name": kinfo.name, "route": "cuda", "source": kinfo.source,
                 "replaces": kinfo.replaces,
                 "launches": launches[kinfo.name],
                 "max_abs_err": max_err[kinfo.name], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": "bytes", "library_ms": row["library_ms"],
                 "eager_ms": row["eager_ms"], "cold_ms": row["cold_ms"]}
        entry["launch_floor_ms"] = floor["ms"]
        entry["tile_ms"] = row["tile_ms"]
        if kinfo in buffered.values():
            entry["path"] = buffered_path[cell]
        entries.append(entry)
    # row 9b at the LM path's decode shape [4, 32, 1, 64], and its prefill
    # [4, 32, 128, 64] (phase 5f, on the inputs the path gave it)
    zrows = zoo["rows"]
    rows[ops.RWKV6_SCAN_BF16.name] = dict(
        zrows[ops.RWKV6_SCAN_BF16.name]["t1"],
        t128_ms=zrows[ops.RWKV6_SCAN_BF16.name]["t128"]["ms"],
        t128_bound_ms=zrows[ops.RWKV6_SCAN_BF16.name]["t128"]["bound_ms"])
    for kinfo in (ops.DELTA_SPMV_F32, ops.DELTA_SPMV_BF16, ops.RGLRU_SCAN_F32,
                  ops.RWKV6_SCAN_F32, ops.RWKV6_SCAN_BF16,
                  ops.DELTAGRU_ACT_F32):
        row = rows[kinfo.name]
        entry = {"name": kinfo.name, "route": "cuda", "source": kinfo.source,
                 "replaces": kinfo.replaces,
                 "launches": launches[kinfo.name],
                 "max_abs_err": max_err[kinfo.name], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"],
                 "eager_ms": row["eager_ms"]}
        if kinfo in spmv_kinfo_all:
            entry["cold_ms"] = row["cold_ms"]
        if kinfo.name in scans:
            for key in ("cold_ms", "launch_floor_ms", "tile_ms", "t128_ms"):
                entry[key] = row[key]
            # at the LM path's prefill shape (phase 5f)
            lm_row = zrows[kinfo.name]["t128"]
            entry["lm_prefill_ms"] = lm_row["ms"]
            entry["lm_prefill_bound_ms"] = lm_row["bound_ms"]
        if kinfo is ops.RWKV6_SCAN_BF16:
            for key in ("cold_ms", "t128_ms", "t128_bound_ms"):
                entry[key] = row[key]
            entry["shape"] = "[4, 32, 1, 64] (t128: [4, 32, 128, 64])"
        if kinfo is ops.DELTAGRU_ACT_F32:
            for key in ("cold_ms", "launch_floor_ms", "tile_ms"):
                entry[key] = row[key]
        if kinfo is ops.DELTA_SPMV_BF16:
            entry["path"] = ("repro_torch.kernels.delta_spmv.delta_spmv on "
                             "bf16 weights")
        if kinfo is ops.DELTAGRU_ACT_F32:
            entry["path"] = "repro_torch.kernels.ops.deltagru_cell_fused"
        entries.append(entry)
    if len(entries) != len(ops.KERNELS) or not all(
            e["launches"] > 0 for e in entries):
        got = [(e["name"], e["launches"]) for e in entries]
        raise AssertionError(f"kernel line incomplete: {got}")
    log(smi)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
