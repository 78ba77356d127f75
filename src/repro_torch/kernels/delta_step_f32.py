"""Launching the fp32 fused layer steps of ``csrc/deltagru_seq.cu`` (GRU, 3
gate rows) and ``csrc/deltalstm_seq.cu`` (LSTM, 4), the two instances of
the template in ``csrc/delta_step_f32.cuh``.

:func:`f32_step_plan` is the launch plan (instance, streams a pass, dynamic
shared memory), computed on the host once per geometry, ``B`` and device
and cached, so a launch makes no CUDA API query; the C entries check every
plan against what the kernel lays out and refuse one whose shared memory
is not exactly its own. :func:`launch_f32_step` checks the operands and
launches one step; the wrappers in ``deltagru_seq.py`` and
``deltalstm_seq.py`` call it for CUDA tensors only.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.delta_q8 import N_MEM, SMEM_OPTIN_BYTES, _kpad
from repro_torch.kernels.ops import (DELTAGRU_SEQ_F32, DELTALSTM_SEQ_F32,
                                     cuda_stream, require)

# Constants of csrc/delta_step_f32.cuh the plan mirrors.
F32_ROWS = 6                   # output rows a block: kRows
F32_SPLIT = 3                  # warps a row's walk is spread over: kSplit
F32_UNROLL = 8                 # float4 loads in flight a lane: kUnroll
F32_MAX_STREAMS = 8            # streams a pass of the tile instance: kMaxB
F32_INSTANCES = ("one_stream", "tile")       # their codes: the index


@dataclass(frozen=True)
class F32StepPlan:
    """How one fp32 layer step launches (:func:`f32_step_plan`).

    ``instance``: ``"one_stream"`` (B = 1, one accumulator a lane) or
    ``"tile"`` (up to ``F32_MAX_STREAMS`` streams a pass). ``chunk``:
    streams a pass. ``blocks_per_group``: the fired ``block_k`` blocks one
    unrolled group of a warp's walk covers (``F32_UNROLL`` steps of 8
    float4 vectors a gate row; the ``F32_SPLIT`` warps of a row take the
    groups in turn). ``smem``: dynamic shared memory in bytes.
    ``device``: the CUDA device index (-1 for none)."""

    instance: str
    chunk: int
    smem: int
    grid: int
    threads: int
    blocks_per_group: int
    device: int


def f32_smem_bytes(k: int, block_k: int, chunk: int) -> int:
    """Dynamic shared memory of one launch, laid out as ``smem_bytes`` of
    ``csrc/delta_step_f32.cuh``: the staged deltas, the vote words, each
    warp's fired-block list and the partial memories a row's other warps
    hand to its first."""
    return (4 * chunk * _kpad(k) + 4 * ((chunk * (k // 4) + 31) // 32)
            + 4 * F32_ROWS * F32_SPLIT * (k // block_k)
            + 4 * (F32_SPLIT - 1) * F32_ROWS * 64)


@functools.lru_cache(maxsize=512)
def f32_step_plan(block_k: int, ip: int, k: int, hidden: int, b: int,
                  device: int = -1) -> F32StepPlan:
    """The launch plan of one fp32 layer step (either cell: the launch
    does not depend on the gate count) over ``k = ip + hk`` packed columns,
    ``b`` streams. Raises ``ValueError`` for what no instance takes:
    ``block_k`` not a multiple of 4 dividing ``ip`` and ``k``, or deltas
    of one stream that do not fit ``SMEM_OPTIN_BYTES``."""
    if block_k <= 0 or block_k % 4 or k % block_k or ip % block_k:
        raise ValueError(f"the fp32 step kernels take block_k a multiple of "
                         f"4 dividing ip={ip} and k={k}; got {block_k}")
    instance = "one_stream" if b == 1 else "tile"
    chunk = min(b, F32_MAX_STREAMS)
    while True:
        smem = f32_smem_bytes(k, block_k, chunk)
        if smem <= SMEM_OPTIN_BYTES or chunk == 1:
            break
        chunk -= 1
    if smem > SMEM_OPTIN_BYTES:
        raise ValueError(f"one stream's deltas at k={k} need {smem} B of "
                         f"shared memory, more than {SMEM_OPTIN_BYTES}")
    group = max(1, 8 * F32_UNROLL // (block_k // 4))
    return F32StepPlan(instance=instance, chunk=chunk, smem=smem,
                       grid=-(-hidden // F32_ROWS),
                       threads=32 * F32_ROWS * F32_SPLIT,
                       blocks_per_group=group, device=device)


def _step_fn(gates: int):
    """The ``extern "C"`` entry of one cell (``deltagru_seq_step_f32`` takes
    ``h_prev`` and writes ``m, h``; ``deltalstm_seq_step_f32`` takes
    ``c_prev`` and writes ``m, h, c``)."""
    name = "deltagru_seq" if gates == 3 else "deltalstm_seq"
    fn = getattr(_build.load(f"{name}.cu"), f"{name}_step_f32")
    if fn.argtypes is None:
        n_ptr = 7 if gates == 3 else 8
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch_f32_step(layout, gates: int, m_prev, s_prev, dx, dh):
    """Launch the fp32 step of a ``gates``-row fused layout on CUDA
    operands. ``s_prev`` is ``h_prev`` (GRU) or ``c_prev`` (LSTM). Returns
    ``(m, h)`` or ``(m, h, c)``."""
    b, h_dim, i_dim = dx.shape[0], layout.hidden_size, layout.input_size
    k = layout.ip + layout.hk
    index = dx.device.index
    plan = f32_step_plan(layout.block_k, layout.ip, k, h_dim, b,
                         -1 if index is None else index)
    f32 = torch.float32
    require(layout.w, "w", f32, (gates, layout.hp, k))
    require(m_prev, "m_prev", f32, (b, N_MEM * h_dim))
    require(s_prev, "h_prev" if gates == 3 else "c_prev", f32, (b, h_dim))
    require(dx, "dx", f32, (b, i_dim))
    require(dh, "dh", f32, (b, h_dim))
    outs = [torch.empty_like(m_prev), torch.empty_like(s_prev)]
    if gates == 4:
        outs.append(torch.empty_like(s_prev))
    kinfo = DELTAGRU_SEQ_F32 if gates == 3 else DELTALSTM_SEQ_F32
    err = _step_fn(gates)(
        layout.w.data_ptr(), m_prev.data_ptr(), s_prev.data_ptr(),
        dx.data_ptr(), dh.data_ptr(), *(o.data_ptr() for o in outs),
        b, i_dim, h_dim, layout.hp, k, layout.ip, layout.block_k,
        F32_INSTANCES.index(plan.instance), plan.chunk, plan.smem,
        plan.device, cuda_stream(m_prev))
    if err:
        raise RuntimeError(f"{kinfo.name} launch failed: CUDA error {err}")
    kinfo.launches += 1
    return tuple(outs)
