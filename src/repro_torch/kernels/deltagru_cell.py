"""Fused DeltaGRU activation pipeline (paper Fig. 7), the PyTorch port of
:mod:`repro.kernels.deltagru_cell`.

The FPGA runs the post-MxV pointwise chain (sigmoid/tanh, the ``r * M_hc``
product, the ``(1 - u) c + u h`` blend) as one pipeline; here it is one
kernel over ``[B, H]``: one read per operand, one write per result.

:func:`deltagru_act` launches the CUDA kernel of ``csrc/deltagru_cell.cu``
for CUDA tensors and runs the plain version :func:`deltagru_act_ref` for
CPU tensors. :func:`repro_torch.kernels.ops.deltagru_cell_fused` composes it
with two :func:`~repro_torch.kernels.delta_spmv.delta_spmv` calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (DELTAGRU_ACT_F32, cuda_stream,
                                     launches_kernel, require)


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
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(m_prev, zx, zh, h_prev):
    b, h = h_prev.shape
    f32 = torch.float32
    require(m_prev, "m_prev", f32, (b, 4 * h))
    require(zx, "zx", f32, (b, 3 * h))
    require(zh, "zh", f32, (b, 3 * h))
    require(h_prev, "h_prev", f32, (b, h))
    m_out = torch.empty_like(m_prev)
    h_out = torch.empty_like(h_prev)
    err = _fn()(m_prev.data_ptr(), zx.data_ptr(), zh.data_ptr(),
                h_prev.data_ptr(), m_out.data_ptr(), h_out.data_ptr(), b, h,
                cuda_stream(h_prev))
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
