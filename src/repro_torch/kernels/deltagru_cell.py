"""Fused DeltaGRU activation pipeline (paper Fig. 7), the PyTorch port of
:mod:`repro.kernels.deltagru_cell`.

The FPGA runs the post-MxV pointwise chain (sigmoid/tanh, the ``r * M_hc``
product, the ``(1 - u) c + u h`` blend) as one pipeline; here it is one
kernel over ``[B, H]``: one read per operand, one write per result.

:func:`deltagru_act` launches the CUDA kernel of ``csrc/deltagru_cell.cu``
for CUDA tensors and runs the plain version :func:`deltagru_act_ref` for
CPU tensors. :func:`repro_torch.kernels.ops.deltagru_cell_fused` composes it
with two :func:`~repro_torch.kernels.delta_spmv.delta_spmv` calls.
:func:`deltagru_act_plan` is its launch plan (threads a block, grid),
computed on the host once per shape and device and cached, so a launch
makes no CUDA API query; the C entry refuses a plan it cannot run.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (DELTAGRU_ACT_F32, H100_SMS,
                                     cuda_stream, launches_kernel, require)

# Constants of csrc/deltagru_cell.cu the plan mirrors.
ACT_THREADS = (32, 64, 128, 256)     # threads a block the kernel takes
# threads a block of the plan: 6 blocks at B = 1, H = 768, 48 for the
# 8-slot batcher; 32 to 256 time alike there (tools/act_times.py
# --breakdown)
ACT_PLAN_THREADS = 128
# blocks an SM of an H100 holds at once (its 2048 threads, at most 32
# blocks; the kernel's few registers never bind)
SM_THREADS, SM_BLOCKS = 2048, 32
# the largest [B, 4H] operand the C entry takes (its offsets in int)
ACT_MAX_ELEMS = 2 ** 31 - 1


@dataclass(frozen=True)
class ActPlan:
    """How one ``deltagru_act`` call launches (:func:`deltagru_act_plan`).

    A thread owns one channel ``(b, o)``; there are ``units = B * H``.
    ``grid`` blocks of ``threads`` threads take channels ``global thread,
    + grid * threads, ...``; the last block masks the channels past
    ``units``. ``device``: the CUDA device index (-1 for none)."""

    threads: int
    units: int
    grid: int
    device: int


def act_resident_blocks(threads: int) -> int:
    """Blocks of ``threads`` the SMs of an H100 hold at once."""
    return H100_SMS * min(SM_BLOCKS, SM_THREADS // threads)


@functools.lru_cache(maxsize=512)
def deltagru_act_plan(b: int, h: int, dtype: torch.dtype = torch.float32,
                      device: int = -1) -> ActPlan:
    """The launch plan of a call over ``[b, 4h]``, ``[b, 3h]`` and ``[b,
    h]`` operands of type ``dtype``: blocks of ``ACT_PLAN_THREADS``, a
    grid of at most the blocks the SMs hold at once. One path for every
    width and every 4-byte aligned operand. Raises ``ValueError`` for what
    the C entry refuses: negative sizes, operands that are not fp32,
    ``b * 4h`` beyond ``ACT_MAX_ELEMS``."""
    if dtype != torch.float32:
        raise ValueError(f"deltagru_act takes fp32 operands, not {dtype}")
    if min(b, h) < 0:
        raise ValueError(f"deltagru_act takes sizes >= 0; got B={b}, H={h}")
    if b * 4 * h > ACT_MAX_ELEMS:
        raise ValueError(f"deltagru_act takes at most {ACT_MAX_ELEMS} "
                         f"elements an operand; got B={b}, H={h}")
    units = b * h
    threads = ACT_PLAN_THREADS
    grid = min(-(-units // threads), act_resident_blocks(threads))
    return ActPlan(threads=threads, units=units, grid=grid, device=device)


def deltagru_act(m_prev: torch.Tensor, zx: torch.Tensor, zh: torch.Tensor,
                 h_prev: torch.Tensor):
    """The Eq. 3 pointwise update: ``m_prev: [B, 4H]`` delta memories (r,
    u, xc, hc), ``zx, zh: [B, 3H]`` = ``W_x dx``, ``W_h dh`` (r, u, c),
    ``h_prev: [B, H]`` -> ``(m_new: [B, 4H], h_new: [B, H])``."""
    if not launches_kernel(m_prev, zx, zh, h_prev):
        return deltagru_act_ref(m_prev, zx, zh, h_prev)
    return _launch(m_prev, zx, zh, h_prev)


def _fn():
    fn = _build.load("deltagru_cell.cu").deltagru_act_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(m_prev, zx, zh, h_prev):
    b, h = h_prev.shape
    f32 = torch.float32
    require(m_prev, "m_prev", f32, (b, 4 * h), align=4)
    require(zx, "zx", f32, (b, 3 * h), align=4)
    require(zh, "zh", f32, (b, 3 * h), align=4)
    require(h_prev, "h_prev", f32, (b, h), align=4)
    m_out = torch.empty((b, 4 * h), dtype=f32, device=h_prev.device)
    h_out = torch.empty((b, h), dtype=f32, device=h_prev.device)
    if not b * h:
        return m_out, h_out
    index = h_prev.device.index
    plan = deltagru_act_plan(b, h, f32, -1 if index is None else index)
    err = _fn()(m_prev.data_ptr(), zx.data_ptr(), zh.data_ptr(),
                h_prev.data_ptr(), m_out.data_ptr(), h_out.data_ptr(), b, h,
                plan.threads, plan.grid, cuda_stream(h_prev))
    if err:
        raise RuntimeError(f"deltagru_act_f32 launch failed: CUDA error "
                           f"{err}")
    DELTAGRU_ACT_F32.launches += 1
    return m_out, h_out


def deltagru_act_ref(m_prev, zx, zh, h_prev):
    """Plain version (the port of the JAX oracle ``deltagru_act_ref``)."""
    h = h_prev.shape[-1]
    m_r, m_u, m_xc, m_hc = (m_prev[..., :h], m_prev[..., h:2 * h],
                            m_prev[..., 2 * h:3 * h], m_prev[..., 3 * h:])
    zxr, zxu, zxc = zx[..., :h], zx[..., h:2 * h], zx[..., 2 * h:]
    zhr, zhu, zhc = zh[..., :h], zh[..., h:2 * h], zh[..., 2 * h:]
    m_r = m_r + zxr + zhr
    m_u = m_u + zxu + zhu
    m_xc = m_xc + zxc
    m_hc = m_hc + zhc
    r = torch.sigmoid(m_r)
    u = torch.sigmoid(m_u)
    c = torch.tanh(m_xc + r * m_hc)
    h_new = (1.0 - u) * c + u * h_prev
    m_new = torch.cat([m_r, m_u, m_xc, m_hc], dim=-1)
    return m_new, h_new
