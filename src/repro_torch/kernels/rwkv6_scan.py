"""WKV6 recurrence (RWKV-6 "Finch"), the PyTorch port of
:mod:`repro.kernels.rwkv6_scan`.

Per (stream, head) the state ``S: [D, D]`` (key-dim x value-dim, D = 64)
evolves with a data-dependent per-key decay ``w_t`` in (0, 1) and a bonus
``u`` on the current token::

    y_t = r_t (S + diag(u) k_t^T v_t)
    S  <- diag(w_t) S + k_t^T v_t

:func:`rwkv6_scan` launches the CUDA kernel of ``csrc/rwkv6_scan.cu`` for
CUDA tensors and runs the plain version :func:`rwkv6_scan_batched_ref` for
CPU tensors. The kernel has two instances: every operand fp32
(``rwkv6_scan_f32``), or ``r, k, v`` in bf16 with ``w``, ``u``, the state
and ``y`` fp32 (``rwkv6_scan_bf16``, the bf16 RWKV6 models). The bf16 one
computes what the plain version computes under PyTorch's type promotion,
which is JAX's: ``k_t^T v_t`` is a bf16 product (rounded to bf16), and
everything it meets after that is fp32. :func:`rwkv6_scan_plan` is the
launch plan (the value columns a block handles, the grid, the vector
width), computed on the host once per shape, type, alignment and device and
cached, so a launch makes no CUDA API query; the C entry refuses a plan it
cannot run.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (H100_SMS, RWKV6_SCAN_BF16,
                                     RWKV6_SCAN_F32, aligned16, cuda_stream,
                                     launches_kernel, refuse_autograd,
                                     require)

HEAD_DIM = 64                  # the only head size the kernel takes: kD
# Constants of csrc/rwkv6_scan.cu the plan mirrors.
RWKV6_VEC = 4                  # value columns a thread owns: kVec
RWKV6_COLS = 16                # value columns of a work unit: kCols
RWKV6_THREADS_PER_SM = 2048    # residency its launch bounds ask: kThreadsPerSM


@dataclass(frozen=True)
class Rwkv6ScanPlan:
    """How one ``rwkv6_scan`` call launches (:func:`rwkv6_scan_plan`).

    A work unit is one (stream, head) and ``cols`` (``RWKV6_COLS``) of its
    64 value columns; there are ``units = B * H * 64 / cols``. A block of
    ``threads = 16 * cols`` threads gives thread ``(i, q)`` key ``i`` and
    the columns ``4q .. 4q + 3`` of its unit; the ``grid`` blocks take
    units ``blockIdx, blockIdx + grid, ...``. ``vec``: 4 (16-byte loads and
    stores) or 1 (4-byte). ``device``: the CUDA device index (-1 for
    none)."""

    cols: int
    threads: int
    units: int
    grid: int
    vec: int
    device: int


def rwkv6_resident_blocks(threads: int) -> int:
    """Blocks of ``threads`` the SMs of an H100 hold at once at the
    kernel's launch bounds."""
    return H100_SMS * (RWKV6_THREADS_PER_SM // threads)


@functools.lru_cache(maxsize=512)
def rwkv6_scan_plan(b: int, h: int, t: int, d: int,
                    dtype: torch.dtype = torch.float32, aligned: bool = True,
                    device: int = -1) -> Rwkv6ScanPlan:
    """The launch plan of a call over ``[b, h, t, d]`` operands whose
    ``r, k, v`` are of type ``dtype`` (fp32 or bf16; the others are fp32);
    ``aligned``: every operand starts on 16 bytes. A block handles
    ``RWKV6_COLS`` value columns of a head (128 blocks at the decode shape
    B = 1, H = 32); the grid is at most the blocks the SMs hold at once.
    Raises ``ValueError`` for what the kernel does not take: ``d != 64``,
    negative sizes, ``r, k, v`` neither fp32 nor bf16."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rwkv6_scan takes fp32 or bf16 r, k, v, not "
                         f"{dtype}")
    if d != HEAD_DIM:
        raise ValueError(f"rwkv6_scan takes a head size of {HEAD_DIM}, "
                         f"not {d}")
    if min(b, h, t) < 0:
        raise ValueError(f"rwkv6_scan takes sizes >= 0; got B={b}, H={h}, "
                         f"T={t}")
    threads = HEAD_DIM * RWKV6_COLS // RWKV6_VEC
    units = b * h * (HEAD_DIM // RWKV6_COLS)
    grid = min(units, rwkv6_resident_blocks(threads))
    return Rwkv6ScanPlan(cols=RWKV6_COLS, threads=threads, units=units,
                         grid=grid, vec=RWKV6_VEC if aligned else 1,
                         device=device)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor | None = None):
    """WKV6 over ``r, k, v, w: [B, H, T, D]`` with bonus ``u: [H, D]`` and
    initial state ``s0: [B, H, D, D]`` (zeros if None); ``w`` is the decay
    factor in (0, 1). ``r, k, v`` are fp32 or bf16, everything else fp32.
    Returns ``(y: [B, H, T, D], s_T: [B, H, D, D])``, both fp32. The
    kernel has no backward: on operands that require grad, with grad mode
    on, a CUDA call raises (call :func:`rwkv6_scan_batched_ref` to
    differentiate)."""
    operands = [t for t in (r, k, v, w, u, s0) if t is not None]
    if not launches_kernel(*operands):
        return rwkv6_scan_batched_ref(r, k, v, w, u, s0)
    refuse_autograd("rwkv6_scan", *operands)
    return _launch(r, k, v, w, u, s0)


def _fn(name: str):
    fn = getattr(_build.load("rwkv6_scan.cu"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(r, k, v, w, u, s0):
    b, h, t, d = r.shape
    f32 = torch.float32
    in_dt = torch.bfloat16 if r.dtype == torch.bfloat16 else f32
    kinfo = RWKV6_SCAN_BF16 if in_dt == torch.bfloat16 else RWKV6_SCAN_F32
    r, k, v, w = (z.contiguous() for z in (r, k, v, w))
    for z, name in ((r, "r"), (k, "k"), (v, "v")):
        require(z, name, in_dt, (b, h, t, d), align=in_dt.itemsize)
    require(w, "w", f32, (b, h, t, d), align=4)
    require(u, "u", f32, (h, d), align=4)
    if s0 is not None:
        require(s0, "s0", f32, (b, h, d, d), align=4)
    y = torch.empty((b, h, t, d), dtype=f32, device=r.device)
    s_t = torch.empty((b, h, d, d), dtype=f32, device=r.device)
    index = r.device.index
    plan = rwkv6_scan_plan(b, h, t, d, r.dtype,
                           aligned16(r, k, v, w, u, s0, y, s_t),
                           -1 if index is None else index)
    err = _fn(kinfo.name)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        0 if s0 is None else s0.data_ptr(), y.data_ptr(), s_t.data_ptr(), b,
        h, t, d, plan.cols, plan.vec, plan.grid, cuda_stream(r))
    if err:
        raise RuntimeError(f"{kinfo.name} launch failed: CUDA error {err}")
    kinfo.launches += 1
    return y, s_t


def rwkv6_scan_batched_ref(r, k, v, w, u, s0=None):
    """Plain version over ``r, k, v, w: [B, H, T, D]``, ``u: [H, D]`` (the
    port of the JAX oracle ``rwkv6_scan_batched_ref``): a loop over T of the
    per-step update, all streams and heads at once, under PyTorch's type
    promotion, which is JAX's: with bf16 ``r, k, v`` and fp32 ``w, u, s0``
    the outer product ``kv`` is bf16 and everything after it fp32. (A
    matmul does not promote in PyTorch, so ``r_t`` is cast to the type of
    the matrix it meets, as ``jnp.matmul`` promotes it.)"""
    b, h, t, d = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, d, d), device=r.device,
                         dtype=torch.promote_types(r.dtype, w.dtype))
    s = s0
    ys = []
    for i in range(t):
        r_t, k_t, v_t, w_t = r[:, :, i], k[:, :, i], v[:, :, i], w[:, :, i]
        kv = k_t[..., :, None] * v_t[..., None, :]               # [B,H,D,D]
        m = s + u[:, :, None] * kv
        y = (r_t[..., None, :].to(m.dtype) @ m)[..., 0, :]
        s = w_t[..., :, None] * s + kv
        ys.append(y)
    return torch.stack(ys, dim=2), s


def rwkv6_scan_ref(r, k, v, w, u, s0=None):
    """Single-head plain version: ``r, k, v, w: [T, D]``, ``u: [D]``,
    ``s0: [D, D]``. Returns ``(y: [T, D], S_T)``."""
    y, s = rwkv6_scan_batched_ref(
        r[None, None], k[None, None], v[None, None], w[None, None], u[None],
        None if s0 is None else s0[None, None])
    return y[0, 0], s[0, 0]
