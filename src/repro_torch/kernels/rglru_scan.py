"""RG-LRU diagonal recurrence (RecurrentGemma / Griffin), the PyTorch port of
:mod:`repro.kernels.rglru_scan`::

    h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t

:func:`rglru_scan` launches the CUDA kernel of ``csrc/rglru_scan.cu`` for
CUDA tensors and runs the plain version :func:`rglru_scan_batched_ref` for
CPU tensors. :func:`rglru_scan_plan` is its launch plan (vector width,
threads a block, grid), computed on the host once per shape, alignment and
device and cached, so a launch makes no CUDA API query; the C entry
refuses a plan it cannot run.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (H100_SMS, RGLRU_SCAN_F32, aligned16,
                                     cuda_stream, launches_kernel,
                                     refuse_autograd, require)

# Constants of csrc/rglru_scan.cu the plan mirrors.
RGLRU_VEC = 4                         # channels a thread owns: kVec
RGLRU_THREADS = (32, 64, 128, 256)    # threads a block the kernel takes
# threads a block of the plan: at W = 4096 on an H100 the fastest of
# RGLRU_THREADS at B = 8 and within 0.03 us of the fastest at B = 1
# (tools/scan_times.py --breakdown)
RGLRU_PLAN_THREADS = 128
# blocks an SM of an H100 holds at once (its 2048 threads, at most 32
# blocks; the kernel's few registers never bind)
SM_THREADS, SM_BLOCKS = 2048, 32


@dataclass(frozen=True)
class RglruScanPlan:
    """How one ``rglru_scan`` call launches (:func:`rglru_scan_plan`).

    A work unit is 4 adjacent channels of one stream: ``row_units = ceil(W
    / 4)`` a stream, ``units = B * row_units``, the last of a row ragged
    where ``W % 4 != 0``. ``grid`` blocks of ``threads`` threads take units
    ``global thread, + grid * threads, ...``. ``vec``: 4 (16-byte loads
    and stores) or 1 (4-byte). ``device``: the CUDA device index (-1 for
    none)."""

    vec: int
    threads: int
    row_units: int
    units: int
    grid: int
    device: int


def rglru_resident_blocks(threads: int) -> int:
    """Blocks of ``threads`` the SMs of an H100 hold at once."""
    return H100_SMS * min(SM_BLOCKS, SM_THREADS // threads)


@functools.lru_cache(maxsize=512)
def rglru_scan_plan(b: int, t: int, w: int,
                    dtype: torch.dtype = torch.float32, aligned: bool = True,
                    device: int = -1) -> RglruScanPlan:
    """The launch plan of a call over ``[b, t, w]`` operands of type
    ``dtype``; ``aligned``: every operand starts on 16 bytes. The 16-byte
    path runs exactly when ``w % 4 == 0`` and the operands are aligned.
    Blocks of ``RGLRU_PLAN_THREADS``; the grid is at most the blocks the
    SMs hold at once. Raises ``ValueError`` for negative sizes or operands
    that are not fp32."""
    if dtype != torch.float32:
        raise ValueError(f"rglru_scan takes fp32 operands, not {dtype}")
    if min(b, t, w) < 0:
        raise ValueError(f"rglru_scan takes sizes >= 0; got B={b}, T={t}, "
                         f"W={w}")
    row_units = -(-w // RGLRU_VEC)
    units = b * row_units
    threads = RGLRU_PLAN_THREADS
    grid = min(-(-units // threads), rglru_resident_blocks(threads))
    vec = RGLRU_VEC if aligned and w % RGLRU_VEC == 0 else 1
    return RglruScanPlan(vec=vec, threads=threads, row_units=row_units,
                         units=units, grid=grid, device=device)


def rglru_scan(x: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor | None = None):
    """RG-LRU over ``x, a: [B, T, D]`` (gated input, decay in (0, 1)) from
    ``h0: [B, D]`` (zeros if None). Returns ``(h_seq: [B, T, D], h_T:
    [B, D])``. The kernel has no backward: on operands that require grad,
    with grad mode on, a CUDA call raises (call
    :func:`rglru_scan_batched_ref` to differentiate)."""
    operands = [t for t in (x, a, h0) if t is not None]
    if not launches_kernel(*operands):
        return rglru_scan_batched_ref(x, a, h0)
    refuse_autograd("rglru_scan", *operands)
    return _launch(x, a, h0)


def _fn():
    fn = _build.load("rglru_scan.cu").rglru_scan_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x, a, h0):
    b, t, d = x.shape
    f32 = torch.float32
    x, a = x.contiguous(), a.contiguous()
    require(x, "x", f32, (b, t, d), align=4)
    require(a, "a", f32, (b, t, d), align=4)
    if h0 is not None:
        h0 = require(h0.contiguous(), "h0", f32, (b, d), align=4)
    y = torch.empty((b, t, d), dtype=f32, device=x.device)
    h_t = torch.empty((b, d), dtype=f32, device=x.device)
    index = x.device.index
    plan = rglru_scan_plan(b, t, d, x.dtype, aligned16(x, a, h0, y, h_t),
                           -1 if index is None else index)
    err = _fn()(x.data_ptr(), a.data_ptr(),
                0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                h_t.data_ptr(), b, t, d, plan.vec, plan.threads, plan.grid,
                cuda_stream(x))
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
