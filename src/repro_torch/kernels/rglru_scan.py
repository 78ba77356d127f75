"""RG-LRU diagonal recurrence (RecurrentGemma / Griffin), the PyTorch port of
:mod:`repro.kernels.rglru_scan`::

    h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t

:func:`rglru_scan` launches the CUDA kernel of ``csrc/rglru_scan.cu`` for
CUDA tensors and runs the plain version :func:`rglru_scan_batched_ref` for
CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (RGLRU_SCAN_F32, cuda_stream,
                                     launches_kernel, require)


def rglru_scan(x: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor | None = None):
    """RG-LRU over ``x, a: [B, T, D]`` (gated input, decay in (0, 1)) from
    ``h0: [B, D]`` (zeros if None). Returns ``(h_seq: [B, T, D], h_T:
    [B, D])``."""
    operands = [t for t in (x, a, h0) if t is not None]
    if not launches_kernel(*operands):
        return rglru_scan_batched_ref(x, a, h0)
    return _launch(x, a, h0)


def _fn():
    fn = _build.load("rglru_scan.cu").rglru_scan_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x, a, h0):
    b, t, d = x.shape
    f32 = torch.float32
    x, a = x.contiguous(), a.contiguous()
    require(x, "x", f32, (b, t, d))
    require(a, "a", f32, (b, t, d))
    if h0 is None:
        h0 = torch.zeros((b, d), dtype=f32, device=x.device)
    h0 = h0.contiguous()
    require(h0, "h0", f32, (b, d))
    y = torch.empty_like(x)
    h_t = torch.empty_like(h0)
    err = _fn()(x.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                h_t.data_ptr(), b, t, d, cuda_stream(x))
    if err:
        raise RuntimeError(f"rglru_scan_f32 launch failed: CUDA error {err}")
    RGLRU_SCAN_F32.launches += 1
    return y, h_t


def rglru_scan_batched_ref(x, a, h0=None):
    """Plain version over ``x, a: [B, T, D]`` (the port of the JAX oracle
    ``rglru_scan_batched_ref``): a loop over T, each product and sum
    rounded on its own."""
    h = (torch.zeros((x.shape[0], x.shape[-1]), dtype=x.dtype,
                     device=x.device) if h0 is None else h0)
    hs = []
    for i in range(x.shape[1]):
        a_t = a[:, i]
        norm = torch.sqrt(torch.clamp_min(1.0 - a_t * a_t, 0.0))
        h = a_t * h + norm * x[:, i]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_scan_ref(x, a, h0=None):
    """Single-sequence plain version: ``x, a: [T, D]``, ``h0: [D]``.
    Returns ``(h: [T, D], h_T)``."""
    hs, h = rglru_scan_batched_ref(x[None], a[None],
                                   None if h0 is None else h0[None])
    return hs[0], h[0]
